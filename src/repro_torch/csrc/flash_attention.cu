// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V
// with GQA, causal and sliding-window masks and an optional tanh softcap,
// fp32, bf16 or fp16 in, m/l/acc in fp32, output in the input dtype.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `flash_attention_fwd`
// (Pallas body `_attn_kernel`): an online-softmax forward over a
// (b, h, q_blocks, kv_blocks) grid whose kv dimension runs in order, so the
// running (m, l, acc) state lives in VMEM scratch between kv steps.
//
// What bounds it on this card: at the serving slice's shape (b 4, h 32,
// kv 8, s = t = 2048, d 128, causal) the work is 137 GFLOP against 168 MB
// of q, k, v and o, so it lies far above the ridge point: operations bound
// it, at the bf16 tensor cores' 989 TFLOP/s.
//
// Two hand kernels, chosen by dtype in the C entry point (not a fallback:
// each dtype has exactly one):
//
// * bf16 and fp16 (`attn_wgmma_kernel`, one instance each, and one with the
//   log-sum-exp store at each head dim up to 128): the two
//   products on the tensor cores with
//   `wgmma`, K/V fed by TMA.  One CTA of two warpgroups per (128 query rows,
//   head, batch); each warpgroup owns 64 rows.  Q (128 rows) and a 2-stage
//   ring of K and V tiles (128 keys; 64 at d = 256) are loaded by TMA through
//   4-D tensor maps over the strided (d, s, heads, b) views, in boxes of 64
//   columns with the 128-byte swizzle (32 columns with the 64-byte swizzle
//   at d <= 32).  A head dim that is not a whole number of boxes (16, 112,
//   224) is padded to one: the box's columns past d lie outside the tensor
//   map and arrive zero-filled, so the products run at 32, 128 or 256
//   columns (S = Q K^T stops at the last k16 step that holds the head) and
//   only d are stored.  At d = 256 a 128-key ring would need 320 KB of
//   shared memory and 224 accumulator registers a thread (O alone is 128),
//   so its tiles hold 64 keys: 192 KB, and S is 32 registers; d = 224 takes
//   the same layout.  One thread
//   issues the next tile's loads before the current one
//   is computed; completion is counted on an mbarrier (`complete_tx`), and
//   an "empty" mbarrier that every thread arrives at after its last read
//   frees a stage.  S = Q K^T is m64nKk16 (K the tile's keys) with both
//   operands K-major in
//   shared memory; the softmax runs in registers on the accumulator layout
//   (scaled by scale * log2(e), exp2f; a row's max and sum are reduced over
//   the 4 threads that hold it); P is rounded to the input's 16-bit type in
//   registers and fed
//   as wgmma's A operand to O += P V, with V from shared memory as an
//   MN-major B operand.  Rounding p to 16 bits is the one rounding the fp32
//   kernel does not make (l sums the unrounded p).  O stays in fp32
//   registers until the end.  Warp specialisation and overlapping the
//   softmax with the next product are later work.  Given an `lse` pointer
//   (the training step's forward; null when serving), the launch takes the
//   instance whose epilogue also writes each row's log-sum-exp, m + log2(l)
//   in natural log, which the backward (`flash_attention_bwd.cu`)
//   recomputes P from.  It is a template parameter, not a branch on the
//   pointer: the store costs the kernel 10 registers and 1-3% of its time,
//   which serving then never pays.
// * fp32 (`attn_f32_kernel`): the CUDA-core kernel, kept because the only
//   fp32 route to the tensor cores is TF32, which keeps about 3 digits and
//   would break the fp32 contract (2e-3 of the output's scale).  One block of
//   256 threads per (64 query rows, head, batch); Q and each 64-key K/V tile
//   are staged in shared memory (rows padded by one word); each thread
//   computes a 4x4 patch of S in registers, the 16 threads of a row group
//   reduce the row max and sum with shuffles, P goes through shared memory.
//
// Both: KV tiles wholly above the causal diagonal or wholly before the
// window are never loaded; masked entries get p = 0 explicitly and a row that
// has seen no visible key keeps acc = l = 0; only tiles that cross a mask edge
// or the end of t pay for masking (16-bit); ragged s and t are masked in the
// kernel, so the wrapper pads nothing.  GQA: head h reads kv head h / (H /
// KVH).  All tensors are taken with strides (unit stride on d), so the
// model's (b, s, heads, d) activations need no transpose copies.  Q tiles
// are issued last-first, so the longest causal rows start earliest.
#include "flash_common.cuh"
#include <math.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, KVH, S, T;
  long long qsb, qsh, qss, ksb, ksh, kst, vsb, vsh, vst, osb, osh, oss;
  int causal, window;
  float scale, softcap;
  float* lse;  // (b, h, s) natural-log sum of exp of each row's scores, or null
  long long lsb, lsh;
};

// ---------------------------------------------------------------- fp32 ----

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid per block

// sum or max over the 16 threads of a row group (one half of a warp)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int f32_smem_bytes() {
  return ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1)) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(Params p) {
  constexpr int LDD = D + 1;
  constexpr int LDP = kBK + 1;
  constexpr int TD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][LDD]
  float* Ks = Qs + kBQ * LDD;   // [kBK][LDD]
  float* Vs = Ks + kBK * LDD;   // [kBK][LDD]
  float* Ps = Vs + kBK * LDD;   // [kBQ][LDP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const float* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + kvh * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + kvh * p.vsh;
  float* o = static_cast<float*>(p.o) + b * p.osb + h * p.osh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gq = q0 + r;
    Qs[r * LDD + c] = gq < p.S ? q[gq * p.qss + c] : 0.f;
  }

  // the keys any row of this tile can see
  int kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q0 + kBQ);
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  kv_begin = (kv_begin / kBK) * kBK;

  float m[4], l[4], acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q staged; the previous tile's K, V and P are read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int gk = k0 + r;
      const bool in = gk < p.T;
      Ks[r * LDD + c] = in ? k[gk * p.kst + c] : 0.f;
      Vs[r * LDD + c] = in ? v[gk * p.vst + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float rq[4], rk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rq[i] = Qs[(ty + 16 * i) * LDD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) rk[j] = Ks[(tx + 16 * j) * LDD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(rq[i], rk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool ok = kp < p.T && (!p.causal || kp <= qp) &&
                        (p.window <= 0 || qp - kp < p.window);
        s[i][j] = ok ? x : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      // a row that has seen no visible key yet keeps acc = l = 0
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = pj;
        rs += pj;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float rp[4], rv[TD];
#pragma unroll
      for (int i = 0; i < 4; ++i) rp[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) rv[j] = Vs[c * LDD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(rp[i], rv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= p.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j) o[qp * p.oss + tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<D>();
  auto kern = attn_f32_kernel<D>;
  // the shared-memory limit is set once per instance, not at every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((unsigned)((p.S + kBQ - 1) / kBQ), (unsigned)p.H, (unsigned)B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16 and fp16 ----

constexpr int kRows = 128;     // query rows per CTA: two warpgroups of 64
constexpr int kWgThreads = 256;
// the K/V ring's depth: 2 at d 112, 128 and 256 (160, 160 and 192 KB of
// shared memory), and 2 at d <= 64 too, where 3 and 4 stages tie (d 32) or
// lose (d 64) on the H100; scripts/flash_ring_depth.py builds the other
// depths to measure them
#ifndef REPRO_FLASH_SMALL_D_STAGES
#define REPRO_FLASH_SMALL_D_STAGES 2
#endif
template <int D>
struct Tile {
  using X = Box<D>;
  static constexpr int kStages = D > 64 ? 2 : REPRO_FLASH_SMALL_D_STAGES;
  static constexpr int kKeys = D > 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int kBoxCols = X::kCols;
  static constexpr int kBoxes = X::kCount;
  static constexpr int kRowBytes = X::kRowBytes;
  static constexpr int kQBoxBytes = kRows * kRowBytes;   // a 128-row Q box
  static constexpr int kKVBoxBytes = kKeys * kRowBytes;  // a K or V box
  static constexpr int kQBytes = kBoxes * kQBoxBytes;    // the Q tile
  static constexpr int kKVBytes = kBoxes * kKVBoxBytes;  // a K or V tile
  static constexpr int kGroupBytes = X::kGroupBytes;
  static constexpr uint64_t kLayout = X::kLayout;
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;  // + alignment slack
  static_assert(kSmem <= 232448 - 1024, "over the shared memory a block may have");
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Tile<D>;
  constexpr int kKeys = L::kKeys;
  constexpr int kBoxHalf = L::kBoxCols / 2;  // accumulator floats a thread holds per V box
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * L::kStages];  // Q; full[s]; empty[s]
  // swizzled tiles start on a 1024-byte boundary, so the descriptors' base offset is 0
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full0 = smem_u32(&bars[1]);
  const uint32_t bar_empty0 = smem_u32(&bars[1 + L::kStages]);
#define K_TILE(s) (base + (uint32_t)(L::kQBytes + 2 * (s) * L::kKVBytes))
#define V_TILE(s) (base + (uint32_t)(L::kQBytes + (2 * (s) + 1) * L::kKVBytes))

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);

  // the keys any row of this tile can see
  int kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q0 + kRows);
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  kv_begin = (kv_begin / kKeys) * kKeys;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kKeys - 1) / kKeys : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_full0 + 8 * s, 1);
      mbar_init(bar_empty0 + 8 * s, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V tile `k0` into stage s (thread 0 only)
  auto load_kv = [&](int s, int k0) {
    const uint32_t full = bar_full0 + 8 * s;
    mbar_expect_tx(full, 2 * L::kKVBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(K_TILE(s) + c * L::kKVBoxBytes, &tm_k, full, c * L::kBoxCols, k0, kvh, b);
      tma_load_4d(V_TILE(s) + c * L::kKVBoxBytes, &tm_v, full, c * L::kBoxCols, k0, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c)
      tma_load_4d(sQ + c * L::kQBoxBytes, &tm_q, bar_q, c * L::kBoxCols, q0, h, b);
    for (int t = 0; t < L::kStages - 1 && t < n_tiles; ++t) load_kv(t, kv_begin + t * kKeys);
  }

  // this thread's accumulator rows (r0, r0 + 8) and columns (c0, c0 + 1 of every 8)
  const int wg_row0 = q0 + wg * 64;
  const int r0 = wg_row0 + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * kLog2e;
  const uint32_t q_rows = sQ + wg * 64 * L::kRowBytes;

  float o_acc[L::kBoxes][kBoxHalf];
#pragma unroll
  for (int c = 0; c < L::kBoxes; ++c)
#pragma unroll
    for (int i = 0; i < kBoxHalf; ++i) o_acc[c][i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l_r[2] = {0.f, 0.f};              // this thread's share of the row sums

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % L::kStages;
    const int k0 = kv_begin + j * kKeys;
    const int ahead = j + L::kStages - 1;  // the tile to load now
    if (tid == 0 && ahead < n_tiles) {
      // its stage is free once every thread has read tile j - 1
      const int ns = ahead % L::kStages;
      if (j >= 1) mbar_wait(bar_empty0 + 8 * ns, ((j - 1) / L::kStages) & 1);
      load_kv(ns, kv_begin + ahead * kKeys);
    }
    __syncwarp();
    mbar_wait(bar_full0 + 8 * s, (j / L::kStages) & 1);

    // S = Q K^T: both operands K-major, one k16 step per 32 bytes of a swizzled
    // row, over the D columns that hold the head (a padded box's zeros add
    // nothing)
    float sc[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk * 16 / L::kBoxCols;
      const uint32_t col = (kk * 16 % L::kBoxCols) * 2;
      wgmma_qk<T, kKeys>(
          sc, make_desc(q_rows + box * L::kQBoxBytes + col, 16, L::kGroupBytes, L::kLayout),
          make_desc(K_TILE(s) + box * L::kKVBoxBytes + col, 16, L::kGroupBytes, L::kLayout),
          kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in the log2 domain; sc[i] is row r0 + 8 * ((i >> 1) & 1),
    // key k0 + (i / 4) * 8 + c0 + (i & 1)
    if (p.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = p.softcap * kLog2e * tanhf(sc[i] * qk_scale);
    } else {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] *= qk_scale;
    }
    const bool edge = k0 + kKeys > p.T || (p.causal && k0 + kKeys - 1 > wg_row0) ||
                      (p.window > 0 && k0 < wg_row0 + 64 - p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int kp = k0 + (i / 4) * 8 + c0 + (i & 1);
        const int qp = r0 + 8 * ((i >> 1) & 1);
        const bool ok = kp < p.T && (!p.causal || kp <= qp) &&
                        (p.window <= 0 || qp - kp < p.window);
        if (!ok) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that has seen no visible key yet: p = 0, and acc and l stay 0
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m_r[r] - mu[r]);
      m_r[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      sc[i] = exp2f(sc[i] - mu[(i >> 1) & 1]);  // exp2(-inf) = 0 for a masked key
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < kBoxHalf; ++i) o_acc[c][i] *= alpha[(i >> 1) & 1];

    // P in T as wgmma's A fragments: the accumulator layout of S is the
    // register layout of A, 4 registers per 16 keys
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) fence_regs(o_acc[c]);
    wgmma_fence();
    // O += P V: V is the B operand, MN-major (d contiguous); one 8-key group
    // per kGroupBytes, one V box per L::kBoxCols output columns
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c) {
        const uint32_t v = V_TILE(s) + c * L::kKVBoxBytes + kk * 16 * L::kRowBytes;
        wgmma_pv<T, L::kBoxCols>(o_acc[c], pa[kk],
                              make_desc(v, L::kGroupBytes, L::kGroupBytes, L::kLayout));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) fence_regs(o_acc[c]);
    mbar_arrive(bar_empty0 + 8 * s);
  }
#undef K_TILE
#undef V_TILE

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }
  if (kLse && lane % 4 == 0) {
    // the row's log-sum-exp of its scaled (and capped) scores, for the
    // backward: m and log2(l) are in the log2 domain
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < p.S)
        p.lse[b * p.lsb + h * p.lsh + r0 + 8 * r] = (m_r[r] + log2f(l_r[r])) / kLog2e;
  }
  T* o = static_cast<T*>(p.o) + b * p.osb + h * p.osh;
#pragma unroll
  for (int c = 0; c < L::kBoxes; ++c)
#pragma unroll
    for (int jj = 0; jj < kBoxHalf / 4; ++jj) {
      const int col = c * L::kBoxCols + jj * 8 + c0;
      if (col >= D) continue;  // a padded box's zero columns
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < p.S)
          *reinterpret_cast<uint32_t*>(o + row * p.oss + col) =
              pack2<T>(o_acc[c][4 * jj + 2 * r] * inv[r], o_acc[c][4 * jj + 2 * r + 1] * inv[r]);
      }
    }
}

template <typename T, int D, bool kLse>
int launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  constexpr int keys = Tile<D>::kKeys;
  if (!make_map<T, D>(&mq, p.q, p.S, p.H, B, p.qss, p.qsh, p.qsb, kRows) ||
      !make_map<T, D>(&mk, p.k, p.T, p.KVH, B, p.kst, p.ksh, p.ksb, keys) ||
      !make_map<T, D>(&mv, p.v, p.T, p.KVH, B, p.vst, p.vsh, p.vsb, keys))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Tile<D>::kSmem;
  auto kern = attn_wgmma_kernel<T, D, kLse>;
  // the shared-memory limit is set once per instance, not at every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((unsigned)((p.S + kRows - 1) / kRows), (unsigned)p.H, (unsigned)B);
  kern<<<grid, kWgThreads, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}
// the instance with the log-sum-exp store where `lse` is given (none at d
// 224 and 256: the backward is not compiled there)
template <typename T, int D>
int launch_16bit(const Params& p, int B, cudaStream_t stream) {
  if (p.lse == nullptr) return launch_wgmma<T, D, false>(p, B, stream);
  if constexpr (D > 128) return (int)cudaErrorInvalidValue;
  else return launch_wgmma<T, D, true>(p, B, stream);
}
template <int D>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  return launch_16bit<__nv_bfloat16, D>(p, B, stream);
}
template <int D>
int launch_f16(const Params& p, int B, cudaStream_t stream) {
  return launch_16bit<__half, D>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16, 2 = float16 (wgmma +
// TMA kernel).  Strides are in elements, for the (batch, head, position)
// dims; the head dim has unit stride.  The wgmma kernel needs 16-byte
// aligned bases and byte
// strides (the launcher checks).  `lse`, if not null (16-bit only, d up to
// 128), is an fp32 (B, H, S) array with strides (lsb, lsh, 1) that receives
// each row's log-sum-exp.  Returns 0 or a cudaError_t code.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KVH, int S, int T, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, long long osb, long long osh, long long oss,
    int causal, int window, float scale, float softcap, void* lse, long long lsb,
    long long lsh, void* stream) {
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  if (lse != nullptr && dtype == 0) return (int)cudaErrorInvalidValue;  // 16-bit only
  Params p{q, k, v, o, H, KVH, S, T, qsb, qsh, qss, ksb, ksh, kst,
           vsb, vsh, vst, osb, osh, oss, causal, window, scale, softcap,
           static_cast<float*>(lse), lsb, lsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the head dims compiled: kernel.py's HEAD_DIMS
#define REPRO_FLASH_DISPATCH(LAUNCH)                    \
  switch (D) {                                          \
    case 16: return LAUNCH<16>(p, B, s);                \
    case 32: return LAUNCH<32>(p, B, s);                \
    case 64: return LAUNCH<64>(p, B, s);                \
    case 112: return LAUNCH<112>(p, B, s);              \
    case 128: return LAUNCH<128>(p, B, s);              \
    case 224: return LAUNCH<224>(p, B, s);              \
    case 256: return LAUNCH<256>(p, B, s);              \
    default: return (int)cudaErrorInvalidValue;         \
  }
  if (dtype == 0) REPRO_FLASH_DISPATCH(launch_f32)
  if (dtype == 1) REPRO_FLASH_DISPATCH(launch_bf16)
  if (dtype == 2) REPRO_FLASH_DISPATCH(launch_f16)
#undef REPRO_FLASH_DISPATCH
  return (int)cudaErrorInvalidValue;
}
