// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T * scale) V, with GQA, causal and sliding-window masks
// and an optional tanh softcap, bf16 or fp16 in and out, every sum in fp32.
//
// Replaces no TPU kernel: neither package had a backward kernel.  The
// reference's `custom_vjp` (src/repro/kernels/flash_attention/ops.py) takes
// the vjp of `attention_ref`, and the port's plain version recomputes
// `attention_ref` and differentiates it (fp32 einsums over a materialised
// (s, t) score matrix); this kernel is held to those gradients.
//
// What bounds it on this card: at the training cell's shape (b 6, h = kv =
// 20, s = t = 4096, d 128, causal) the yardstick counts 1.03e12 operations
// a call (two products per forward product, no recompute): 1.04 ms at the
// bf16 tensor cores' 989 TFLOP/s, 1.30 ms counting the recompute of S, far
// above the ridge point (q, k, v, o, their gradients and dO are 0.38 GB).
// So operations bound it, and the design keeps them on the tensor cores and
// never writes a score to device memory.
//
// Three kernels, launched in order on the caller's stream:
//
// * `flash_bwd_dot_kernel`: D = rowsum(dO * O) in fp32, one warp a row, and
//   the forward's log-sum-exp in the log2 domain, both into (b, h, Sp)
//   scratch (Sp: s rounded up to 64), +inf and 0 past s so that a padded
//   query gets p = 0.
// * `flash_bwd_dkdv_kernel`: one CTA of two warpgroups per (128 keys, kv
//   head, sequence); each warpgroup owns 64 keys.  K and V are loaded once
//   by TMA; the CTA loops over the group's query heads and, for each, the
//   64-query tiles that see its keys, with Q, dO, the LSE and D in a 2-stage
//   ring (TMA and a bulk copy on one mbarrier).  Per tile: S^T = K Q^T and
//   dP^T = V dO^T (`wgmma`, both operands K-major from shared memory),
//   P^T = exp2(S^T - LSE) and dS^T = P^T (dP^T - D) in registers on the
//   accumulator layout, rounded to the input's 16-bit type as wgmma's A
//   fragments (as the forward rounds P), then dV += P^T dO and dK += dS^T Q
//   with dO and Q as MN-major B operands.  dK and dV stay in fp32 registers
//   over the whole loop, so GQA's sum over the group happens in the CTA.
// * `flash_bwd_dq_kernel`: one CTA per (128 queries, head, sequence), the
//   forward's loop over 64-key tiles: S = Q K^T, dP = dO V^T, dS as above,
//   dQ += dS K with K as the MN-major B operand.
//
// Seven products instead of a single pass's five (S and dP are computed in
// both kernels), but no fp32 atomics and no dQ scratch: two calls give the
// same bits.  Masks are applied only on tiles that cross a mask edge or the
// end of t; tiles wholly outside the masks are never visited.  The softcap's
// derivative 1 - tanh^2 multiplies dS; the softmax scale multiplies dQ and
// dK once, in fp32, at the end.  Rows that see no key are refused (the op
// handles them, as for the forward).  Head dims 16, 32, 64, 112 and 128;
// 256 would need 256 accumulator registers a thread for dK and dV and stays
// on the plain version.
#include "flash_common.cuh"
#include <math.h>

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S): the forward's log-sum-exp, natural log
  float* lse2;       // (B, H, Sp) scratch: lse * log2(e); +inf past S
  float* dsum;       // (B, H, Sp) scratch: rowsum(dO * O); 0 past S
  void* dq;
  void* dk;
  void* dv;
  int H, KVH, S, T, Sp;
  long long qsb, qsh, qss, ksb, ksh, kst, vsb, vsh, vst, osb, osh, oss;
  long long gsb, gsh, gss, lsb, lsh;  // dO's and lse's strides
  long long dqsb, dqsh, dqss, dksb, dksh, dkst, dvsb, dvsh, dvst;
  int causal, window;
  float scale, softcap;
};

constexpr int kThreads = 256;  // two warpgroups
constexpr int kKeyRows = 128;  // keys of a dK/dV CTA
constexpr int kQStep = 64;     // queries of one step of the dK/dV loop
constexpr int kQRows = 128;    // queries of a dQ CTA
constexpr int kKStep = 64;     // keys of one step of the dQ loop
// the depth of both rings (Q, dO, LSE and D in dK/dV; K and V in dQ): a
// third stage timed no faster at the training cell's shape on the H100
constexpr int kStages = 2;
constexpr int kPad = 64;       // the scratch's rows are padded to a multiple of this

template <int D>
struct BwdTile {
  using X = Box<D>;
  static constexpr int kBig = X::tile_bytes(128);   // 128 rows (K or V; Q or dO in dQ)
  static constexpr int kSmall = X::tile_bytes(64);  // 64 rows (a ring's tile)
  static constexpr int kBigBox = 128 * X::kRowBytes;
  static constexpr int kSmallBox = 64 * X::kRowBytes;
  static constexpr int kVec = kQStep * 4;           // a tile's LSE or D, bytes
  static constexpr int kDkdvSmem = 2 * kBig + kStages * (2 * kSmall + 2 * kVec) + 1024;
  static constexpr int kDqSmem = 2 * kBig + kStages * 2 * kSmall + 1024;
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "over a block's shared memory");
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <> __device__ __forceinline__ float2 load2<__half>(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// the rows' D and log2-domain LSE, one warp a row of the padded (B, H, Sp) grid
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dot_kernel(const BwdParams p,
                                                                 long long rows, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = (int)(row % p.Sp);
  const long long bh = row / p.Sp;
  const int h = (int)(bh % p.H);
  const long long b = bh / p.H;
  float acc = 0.f;
  if (s < p.S) {
    const T* o = static_cast<const T*>(p.o) + b * p.osb + h * p.osh + s * p.oss;
    const T* g = static_cast<const T*>(p.dout) + b * p.gsb + h * p.gsh + s * p.gss;
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 x = load2<T>(o + c), y = load2<T>(g + c);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    p.dsum[row] = acc;
    p.lse2[row] = s < p.S ? p.lse[b * p.lsb + h * p.lsh + s] * kLog2e : INFINITY;
  }
}

// P and dS of one 64 x 64 block in place on the accumulator layout, in two
// steps so that P can be computed while dP's product still runs: `probs`
// turns the raw scores Q.K in sc (no softmax scale) into P, and `grads` the
// dP in dp into dS = P (dP - D).  lse2(i) and dsum(i) are the log2-domain
// LSE and D of element i's query, ok(i) its mask, read only on edge blocks;
// `qk_scale` is scale * log2(e).  With a softcap dS needs the tanh of each
// score, so `capped` computes both at once (scale / softcap in qk_scale).
template <typename Lse, typename Ok>
__device__ __forceinline__ void probs(float (&sc)[32], Lse lse2, Ok ok, bool edge,
                                      float qk_scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float pr = exp2f(sc[i] * qk_scale - lse2(i));
    sc[i] = edge && !ok(i) ? 0.f : pr;
  }
}

template <typename Dsum>
__device__ __forceinline__ void grads(float (&dp)[32], const float (&pr)[32], Dsum dsum) {
#pragma unroll
  for (int i = 0; i < 32; ++i) dp[i] = pr[i] * (dp[i] - dsum(i));
}

template <typename Lse, typename Dsum, typename Ok>
__device__ __forceinline__ void capped(float (&sc)[32], float (&dp)[32], Lse lse2, Dsum dsum,
                                       Ok ok, bool edge, float qk_scale, float softcap) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float t = tanhf(sc[i] * qk_scale);
    float pr = exp2f(softcap * kLog2e * t - lse2(i));
    if (edge && !ok(i)) pr = 0.f;
    sc[i] = pr;
    dp[i] = pr * (dp[i] - dsum(i)) * (1.f - t * t);
  }
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// 64 x 64 fp32 accumulator -> wgmma A fragments of the 16-bit type T, 4
// registers per 16 columns
template <typename T>
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack2<T>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// rows r0, r0 + 8 (if under `rows`) of a (64 x D) fp32 accumulator times
// `mul`, stored in T at `dst` + row * `st`
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long st, int r0, int rows, int c0,
                                           const float (&acc)[Box<D>::kCount][Box<D>::kCols / 2],
                                           float mul) {
  using X = Box<D>;
#pragma unroll
  for (int c = 0; c < X::kCount; ++c)
#pragma unroll
    for (int jj = 0; jj < X::kCols / 8; ++jj) {
      const int col = c * X::kCols + jj * 8 + c0;
      if (col >= D) continue;  // a padded box's zero columns
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < rows)
          *reinterpret_cast<uint32_t*>(dst + row * st + col) =
              pack2<T>(acc[c][4 * jj + 2 * r] * mul, acc[c][4 * jj + 2 * r + 1] * mul);
      }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                      const BwdParams p) {
  using X = Box<D>;
  using L = BwdTile<D>;
  constexpr int kHalf = X::kCols / 2;  // accumulator floats a thread holds per box
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // K/V; full[s]; empty[s]
  // swizzled tiles start on a 1024-byte boundary, so the descriptors' base offset is 0
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + L::kBig;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full0 = smem_u32(&bars[1]);
  const uint32_t bar_empty0 = smem_u32(&bars[1 + kStages]);
  constexpr int kRing = 2 * L::kBig;                          // Q, dO of each stage
  constexpr int kVecs = kRing + kStages * 2 * L::kSmall;      // LSE, D of each stage
#define Q_TILE(s) (base + (uint32_t)(kRing + (2 * (s)) * L::kSmall))
#define DO_TILE(s) (base + (uint32_t)(kRing + (2 * (s) + 1) * L::kSmall))
#define LSE_OFF(s) (kVecs + (2 * (s)) * L::kVec)
#define DSUM_OFF(s) (kVecs + (2 * (s) + 1) * L::kVec)

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int k0 = blockIdx.x * kKeyRows;  // the keys that see the most queries go first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.H / p.KVH;

  // the queries that see any of these keys
  const int q_begin = p.causal ? (k0 / kQStep) * kQStep : 0;
  const int q_end = p.window > 0 ? min(p.S, min(k0 + kKeyRows, p.T) - 1 + p.window) : p.S;
  const int nq = q_end > q_begin ? (q_end - q_begin + kQStep - 1) / kQStep : 0;
  const int n = group * nq;  // steps: every query tile of every head of the group

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full0 + 8 * s, 1);
      mbar_init(bar_empty0 + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step j's Q, dO, LSE and D into stage s (thread 0 only)
  auto load_q = [&](int s, int j) {
    const int h = kvh * group + j / nq;
    const int qs = q_begin + (j % nq) * kQStep;
    const uint32_t full = bar_full0 + 8 * s;
    mbar_expect_tx(full, 2 * L::kSmall + 2 * L::kVec);
#pragma unroll
    for (int c = 0; c < X::kCount; ++c) {
      tma_load_4d(Q_TILE(s) + c * L::kSmallBox, &tm_q, full, c * X::kCols, qs, h, b);
      tma_load_4d(DO_TILE(s) + c * L::kSmallBox, &tm_do, full, c * X::kCols, qs, h, b);
    }
    const long long row = ((long long)b * p.H + h) * p.Sp + qs;
    bulk_load(base + LSE_OFF(s), p.lse2 + row, L::kVec, full);
    bulk_load(base + DSUM_OFF(s), p.dsum + row, L::kVec, full);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::kBig);
#pragma unroll
    for (int c = 0; c < X::kCount; ++c) {
      tma_load_4d(sK + c * L::kBigBox, &tm_k, bar_kv, c * X::kCols, k0, kvh, b);
      tma_load_4d(sV + c * L::kBigBox, &tm_v, bar_kv, c * X::kCols, k0, kvh, b);
    }
    for (int t = 0; t < kStages - 1 && t < n; ++t) load_q(t, t);
  }

  // this thread's accumulator rows (keys kr0, kr0 + 8) and columns (c0, c0 + 1 of every 8)
  const int kw0 = k0 + wg * 64;
  const int kr0 = kw0 + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * kLog2e;
  const uint32_t k_rows = sK + wg * 64 * X::kRowBytes;
  const uint32_t v_rows = sV + wg * 64 * X::kRowBytes;

  float dk[X::kCount][kHalf], dv[X::kCount][kHalf];
#pragma unroll
  for (int c = 0; c < X::kCount; ++c)
#pragma unroll
    for (int i = 0; i < kHalf; ++i) dk[c][i] = dv[c][i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const int qs = q_begin + (j % nq) * kQStep;
    const int ahead = j + kStages - 1;  // the step to load now
    if (tid == 0 && ahead < n) {
      // its stage is free once every thread has read step j - 1
      const int ns = ahead % kStages;
      if (j >= 1) mbar_wait(bar_empty0 + 8 * ns, ((j - 1) / kStages) & 1);
      load_q(ns, ahead);
    }
    __syncwarp();
    mbar_wait(bar_full0 + 8 * s, (j / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries each, committed
    // apart so that P is computed while dP^T's product runs
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk * 16 / X::kCols;
      const uint32_t col = (kk * 16 % X::kCols) * 2;
      wgmma_ss_m64n64<T>(sc, make_desc(k_rows + box * L::kBigBox + col, 16, X::kGroupBytes, X::kLayout),
                         make_desc(Q_TILE(s) + box * L::kSmallBox + col, 16, X::kGroupBytes, X::kLayout),
                         kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk * 16 / X::kCols;
      const uint32_t col = (kk * 16 % X::kCols) * 2;
      wgmma_ss_m64n64<T>(dp, make_desc(v_rows + box * L::kBigBox + col, 16, X::kGroupBytes, X::kLayout),
                         make_desc(DO_TILE(s) + box * L::kSmallBox + col, 16, X::kGroupBytes, X::kLayout),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait_one();
    fence_regs(sc);

    // element i: key kr0 + 8 * ((i >> 1) & 1), query qs + (i / 4) * 8 + c0 + (i & 1)
    const float* lse_s = reinterpret_cast<const float*>(gbase + LSE_OFF(s));
    const float* dsum_s = reinterpret_cast<const float*>(gbase + DSUM_OFF(s));
    const bool edge = kw0 + 64 > p.T || (p.causal && kw0 + 63 > qs) ||
                      (p.window > 0 && qs + 63 - kw0 >= p.window);
    auto qcol = [&](int i) { return (i / 4) * 8 + c0 + (i & 1); };
    auto lse2 = [&](int i) { return lse_s[qcol(i)]; };
    auto dsum = [&](int i) { return dsum_s[qcol(i)]; };
    auto ok = [&](int i) {
      const int kp = kr0 + 8 * ((i >> 1) & 1), qp = qs + qcol(i);
      return kp < p.T && (!p.causal || kp <= qp) && (p.window <= 0 || qp - kp < p.window);
    };
    if (p.softcap > 0.f) {
      wgmma_wait_all();
      fence_regs(dp);
      capped(sc, dp, lse2, dsum, ok, edge, qk_scale, p.softcap);
    } else {
      probs(sc, lse2, ok, edge, qk_scale);
      wgmma_wait_all();
      fence_regs(dp);
      grads(dp, sc, dsum);
    }

    // dV += P^T dO and dK += dS^T Q: 16 queries a step, one box of columns a
    // product (issuing dV's before dS is computed keeps more registers live
    // than the 255 a thread has: slower on the H100)
    uint32_t pa[4][4], da[4][4];
    to_frags<T>(pa, sc);
    to_frags<T>(da, dp);
#pragma unroll
    for (int c = 0; c < X::kCount; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < X::kCount; ++c) {
        const uint32_t off = c * L::kSmallBox + kk * 16 * X::kRowBytes;
        wgmma_pv<T, X::kCols>(dv[c], pa[kk],
                              make_desc(DO_TILE(s) + off, X::kGroupBytes, X::kGroupBytes, X::kLayout));
        wgmma_pv<T, X::kCols>(dk[c], da[kk],
                              make_desc(Q_TILE(s) + off, X::kGroupBytes, X::kGroupBytes, X::kLayout));
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < X::kCount; ++c) {
      fence_regs(dv[c]);
      fence_regs(dk[c]);
    }
    mbar_arrive(bar_empty0 + 8 * s);
  }
#undef Q_TILE
#undef DO_TILE
#undef LSE_OFF
#undef DSUM_OFF

  store_rows<T, D>(static_cast<T*>(p.dk) + b * p.dksb + kvh * p.dksh, p.dkst, kr0, p.T, c0, dk,
                   p.scale);
  store_rows<T, D>(static_cast<T*>(p.dv) + b * p.dvsb + kvh * p.dvsh, p.dvst, kr0, p.T, c0, dv,
                   1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const BwdParams p) {
  using X = Box<D>;
  using L = BwdTile<D>;
  constexpr int kHalf = X::kCols / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // Q/dO; full[s]; empty[s]
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = base + L::kBig;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full0 = smem_u32(&bars[1]);
  const uint32_t bar_empty0 = smem_u32(&bars[1 + kStages]);
#define K_TILE(s) (base + (uint32_t)(2 * L::kBig + (2 * (s)) * L::kSmall))
#define V_TILE(s) (base + (uint32_t)(2 * L::kBig + (2 * (s) + 1) * L::kSmall))

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;  // the longest causal rows go first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);

  // the keys any row of this tile can see
  int kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q0 + kQRows);
  int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  kv_begin = (kv_begin / kKStep) * kKStep;
  const int n = kv_end > kv_begin ? (kv_end - kv_begin + kKStep - 1) / kKStep : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full0 + 8 * s, 1);
      mbar_init(bar_empty0 + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int s, int k0) {
    const uint32_t full = bar_full0 + 8 * s;
    mbar_expect_tx(full, 2 * L::kSmall);
#pragma unroll
    for (int c = 0; c < X::kCount; ++c) {
      tma_load_4d(K_TILE(s) + c * L::kSmallBox, &tm_k, full, c * X::kCols, k0, kvh, b);
      tma_load_4d(V_TILE(s) + c * L::kSmallBox, &tm_v, full, c * X::kCols, k0, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * L::kBig);
#pragma unroll
    for (int c = 0; c < X::kCount; ++c) {
      tma_load_4d(sQ + c * L::kBigBox, &tm_q, bar_q, c * X::kCols, q0, h, b);
      tma_load_4d(sDO + c * L::kBigBox, &tm_do, bar_q, c * X::kCols, q0, h, b);
    }
    for (int t = 0; t < kStages - 1 && t < n; ++t) load_kv(t, kv_begin + t * kKStep);
  }

  // this thread's accumulator rows (queries r0, r0 + 8) and columns
  const int wg_row0 = q0 + wg * 64;
  const int r0 = wg_row0 + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * kLog2e;
  const uint32_t q_rows = sQ + wg * 64 * X::kRowBytes;
  const uint32_t do_rows = sDO + wg * 64 * X::kRowBytes;
  float lse2[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const long long at = ((long long)b * p.H + h) * p.Sp + row;
    lse2[r] = row < p.S ? p.lse2[at] : INFINITY;
    dsum[r] = row < p.S ? p.dsum[at] : 0.f;
  }

  float dq[X::kCount][kHalf];
#pragma unroll
  for (int c = 0; c < X::kCount; ++c)
#pragma unroll
    for (int i = 0; i < kHalf; ++i) dq[c][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const int k0 = kv_begin + j * kKStep;
    const int ahead = j + kStages - 1;
    if (tid == 0 && ahead < n) {
      const int ns = ahead % kStages;
      if (j >= 1) mbar_wait(bar_empty0 + 8 * ns, ((j - 1) / kStages) & 1);
      load_kv(ns, kv_begin + ahead * kKStep);
    }
    __syncwarp();
    mbar_wait(bar_full0 + 8 * s, (j / kStages) & 1);

    // S = Q K^T and dP = dO V^T, 64 queries x 64 keys each, committed apart
    // so that P is computed while dP's product runs
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk * 16 / X::kCols;
      const uint32_t col = (kk * 16 % X::kCols) * 2;
      wgmma_ss_m64n64<T>(sc, make_desc(q_rows + box * L::kBigBox + col, 16, X::kGroupBytes, X::kLayout),
                         make_desc(K_TILE(s) + box * L::kSmallBox + col, 16, X::kGroupBytes, X::kLayout),
                         kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk * 16 / X::kCols;
      const uint32_t col = (kk * 16 % X::kCols) * 2;
      wgmma_ss_m64n64<T>(dp, make_desc(do_rows + box * L::kBigBox + col, 16, X::kGroupBytes, X::kLayout),
                         make_desc(V_TILE(s) + box * L::kSmallBox + col, 16, X::kGroupBytes, X::kLayout),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait_one();
    fence_regs(sc);

    // element i: query r0 + 8 * ((i >> 1) & 1), key k0 + (i / 4) * 8 + c0 + (i & 1)
    const bool edge = k0 + 64 > p.T || (p.causal && k0 + 63 > wg_row0) ||
                      (p.window > 0 && wg_row0 + 63 - k0 >= p.window);
    auto lse2_of = [&](int i) { return lse2[(i >> 1) & 1]; };
    auto dsum_of = [&](int i) { return dsum[(i >> 1) & 1]; };
    auto ok = [&](int i) {
      const int qp = r0 + 8 * ((i >> 1) & 1), kp = k0 + (i / 4) * 8 + c0 + (i & 1);
      return kp < p.T && (!p.causal || kp <= qp) && (p.window <= 0 || qp - kp < p.window);
    };
    if (p.softcap > 0.f) {
      wgmma_wait_all();
      fence_regs(dp);
      capped(sc, dp, lse2_of, dsum_of, ok, edge, qk_scale, p.softcap);
    } else {
      probs(sc, lse2_of, ok, edge, qk_scale);
      wgmma_wait_all();
      fence_regs(dp);
      grads(dp, sc, dsum_of);
    }

    // dQ += dS K: K is the MN-major B operand, 16 keys a step
    uint32_t da[4][4];
    to_frags<T>(da, dp);
#pragma unroll
    for (int c = 0; c < X::kCount; ++c) fence_regs(dq[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < X::kCount; ++c)
        wgmma_pv<T, X::kCols>(dq[c], da[kk],
                              make_desc(K_TILE(s) + c * L::kSmallBox + kk * 16 * X::kRowBytes,
                                        X::kGroupBytes, X::kGroupBytes, X::kLayout));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < X::kCount; ++c) fence_regs(dq[c]);
    mbar_arrive(bar_empty0 + 8 * s);
  }
#undef K_TILE
#undef V_TILE

  store_rows<T, D>(static_cast<T*>(p.dq) + b * p.dqsb + h * p.dqsh, p.dqss, r0, p.S, c0, dq,
                   p.scale);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  using L = BwdTile<D>;
  const long long rows = (long long)B * p.H * p.Sp;
  constexpr int per_block = kThreads / 32;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0, stream>>>(
      p, rows, D);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;

  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!make_map<T, D>(&q64, p.q, p.S, p.H, B, p.qss, p.qsh, p.qsb, kQStep) ||
      !make_map<T, D>(&do64, p.dout, p.S, p.H, B, p.gss, p.gsh, p.gsb, kQStep) ||
      !make_map<T, D>(&k128, p.k, p.T, p.KVH, B, p.kst, p.ksh, p.ksb, kKeyRows) ||
      !make_map<T, D>(&v128, p.v, p.T, p.KVH, B, p.vst, p.vsh, p.vsb, kKeyRows) ||
      !make_map<T, D>(&q128, p.q, p.S, p.H, B, p.qss, p.qsh, p.qsb, kQRows) ||
      !make_map<T, D>(&do128, p.dout, p.S, p.H, B, p.gss, p.gsh, p.gsb, kQRows) ||
      !make_map<T, D>(&k64, p.k, p.T, p.KVH, B, p.kst, p.ksh, p.ksb, kKStep) ||
      !make_map<T, D>(&v64, p.v, p.T, p.KVH, B, p.vst, p.vsh, p.vsb, kKStep))
    return (int)cudaErrorInvalidValue;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dq = flash_bwd_dq_kernel<T, D>;
  // the shared-memory limits are set once per instance, not at every launch
  static const cudaError_t attr_dkdv = allow_smem(dkdv, L::kDkdvSmem);
  static const cudaError_t attr_dq = allow_smem(dq, L::kDqSmem);
  if (attr_dkdv != cudaSuccess) return (int)attr_dkdv;
  if (attr_dq != cudaSuccess) return (int)attr_dq;
  const dim3 grid_kv((unsigned)((p.T + kKeyRows - 1) / kKeyRows), (unsigned)p.KVH, (unsigned)B);
  dkdv<<<grid_kv, kThreads, L::kDkdvSmem, stream>>>(q64, k128, v128, do64, p);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid_q((unsigned)((p.S + kQRows - 1) / kQRows), (unsigned)p.H, (unsigned)B);
  dq<<<grid_q, kThreads, L::kDqSmem, stream>>>(q128, k64, v64, do128, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const BwdParams& p, int B, cudaStream_t stream) {
  return launch_bwd<__nv_bfloat16, D>(p, B, stream);
}
template <int D>
int launch_f16(const BwdParams& p, int B, cudaStream_t stream) {
  return launch_bwd<__half, D>(p, B, stream);
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16.  q, k, v, o and dout in that dtype with
// element strides for the (batch, head, position) dims and a unit stride on
// d; q, k, v and dout are read by TMA (16-byte aligned bases and byte
// strides: the launcher checks).  lse: the forward's fp32 (B, H, S)
// log-sum-exp, strides (lsb, lsh, 1).  lse2 and dsum: fp32 scratch of B * H
// * Sp floats each, Sp = S rounded up to a multiple of 64.  dq, dk and dv:
// outputs in the dtype, with strides.  Every query row must see a key.
// Returns 0 or a cudaError_t code.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* lse2, void* dsum, void* dq, void* dk, void* dv, int dtype, int B,
    int H, int KVH, int S, int T, int D, int Sp, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long oss, long long gsb, long long gsh, long long gss,
    long long lsb, long long lsh, long long dqsb, long long dqsh, long long dqss,
    long long dksb, long long dksh, long long dkst, long long dvsb, long long dvsh,
    long long dvst, int causal, int window, float scale, float softcap, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || Sp % kPad != 0 || Sp < S) return (int)cudaErrorInvalidValue;
  BwdParams p{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(lse2),
              static_cast<float*>(dsum), dq, dk, dv, H, KVH, S, T, Sp,
              qsb, qsh, qss, ksb, ksh, kst, vsb, vsh, vst, osb, osh, oss,
              gsb, gsh, gss, lsb, lsh, dqsb, dqsh, dqss, dksb, dksh, dkst, dvsb, dvsh, dvst,
              causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the head dims compiled: kernel.py's BWD_HEAD_DIMS
#define REPRO_FLASH_BWD_DISPATCH(LAUNCH)     \
  switch (D) {                               \
    case 16: return LAUNCH<16>(p, B, s);     \
    case 32: return LAUNCH<32>(p, B, s);     \
    case 64: return LAUNCH<64>(p, B, s);     \
    case 112: return LAUNCH<112>(p, B, s);   \
    case 128: return LAUNCH<128>(p, B, s);   \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 1) REPRO_FLASH_BWD_DISPATCH(launch_bf16)
  if (dtype == 2) REPRO_FLASH_BWD_DISPATCH(launch_f16)
#undef REPRO_FLASH_BWD_DISPATCH
  return (int)cudaErrorInvalidValue;
}
