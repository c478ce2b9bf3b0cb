// Flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V
// with GQA, causal and sliding-window masks and an optional tanh softcap,
// fp32 or bf16 in, m/l/acc in fp32, output in the input dtype.
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
// * bf16 (`attn_bf16_kernel`): the two products on the tensor cores with
//   `wgmma`, K/V fed by TMA.  One CTA of two warpgroups per (128 query rows,
//   head, batch); each warpgroup owns 64 rows.  Q (128 rows) and a 2-stage
//   ring of 128-key K and V tiles are loaded by TMA through 4-D tensor maps
//   over the strided (d, s, heads, b) views, with the 128-byte swizzle (64
//   at d = 32, whose rows are 64 bytes); at d = 128 a tile is two boxes of 64
//   columns.  One thread issues the next tile's loads before the current one
//   is computed; completion is counted on an mbarrier (`complete_tx`), and
//   an "empty" mbarrier that every thread arrives at after its last read
//   frees a stage.  S = Q K^T is m64n128k16 with both operands K-major in
//   shared memory; the softmax runs in registers on the accumulator layout
//   (scaled by scale * log2(e), exp2f; a row's max and sum are reduced over
//   the 4 threads that hold it); P is rounded to bf16 in registers and fed
//   as wgmma's A operand to O += P V, with V from shared memory as an
//   MN-major B operand.  Rounding p to bf16 is the one rounding the fp32
//   kernel does not make (l sums the unrounded p).  O stays in fp32
//   registers until the end.  Warp specialisation and overlapping the
//   softmax with the next product are later work.
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
// or the end of t pay for masking (bf16); ragged s and t are masked in the
// kernel, so the wrapper pads nothing.  GQA: head h reads kv head h / (H /
// KVH).  All tensors are taken with strides (unit stride on d), so the
// model's (b, s, heads, d) activations need no transpose copies.  Q tiles
// are issued last-first, so the longest causal rows start earliest.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------- bf16 ----

constexpr int kRows = 128;     // query rows per CTA: two warpgroups of 64
constexpr int kKeys = 128;     // keys per K/V tile
constexpr int kWgThreads = 256;
// the K/V ring's depth: 2 at d = 128 (160 KB of shared memory), and 2 at d 32
// and 64 too, where 3 and 4 stages tie (d 32) or lose (d 64) on the H100;
// scripts/flash_ring_depth.py builds the other depths to measure them
#ifndef REPRO_FLASH_SMALL_D_STAGES
#define REPRO_FLASH_SMALL_D_STAGES 2
#endif
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kStages = D == 128 ? 2 : REPRO_FLASH_SMALL_D_STAGES;
  static constexpr int kBoxCols = D < 64 ? D : 64;  // columns of one TMA box
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;    // one swizzled row: 128 B (64 B at d 32)
  static constexpr int kBoxBytes = 128 * kRowBytes; // a 128-row box
  static constexpr int kBytes = kBoxes * kBoxBytes; // a Q, K or V tile (128 rows x D)
  static constexpr int kGroupBytes = 8 * kRowBytes; // 8 rows: one swizzle pattern
  static constexpr uint64_t kLayout = D < 64 ? 2 : 1;  // wgmma: 1 = 128-byte, 2 = 64-byte swizzle
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// spin until the phase of parity `parity` has completed; a wait of more than
// about 2^34 cycles (seconds) can only be a fault, and traps instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// one TMA box of a 4-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of an accumulator across the
// asynchronous product that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128) = Q (64 x 16) K^T (16 x 128), and O (64 x N) += P (64 x 16) V (16 x N):
// the accumulator is spread over the warpgroup's 128 threads (N / 2 floats each)
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V for one 16-key step over the N columns of one V box
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) {
    wgmma_rs_m64n32(d, a, db);
  } else {
    wgmma_rs_m64n64(d, a, db);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_bf16_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Tile<D>;
  constexpr int kBoxHalf = L::kBoxCols / 2;  // accumulator floats a thread holds per V box
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * L::kStages];  // Q; full[s]; empty[s]
  // swizzled tiles start on a 1024-byte boundary, so the descriptors' base offset is 0
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full0 = smem_u32(&bars[1]);
  const uint32_t bar_empty0 = smem_u32(&bars[1 + L::kStages]);
#define K_TILE(s) (base + (uint32_t)((1 + 2 * (s)) * L::kBytes))
#define V_TILE(s) (base + (uint32_t)((2 + 2 * (s)) * L::kBytes))

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
    mbar_expect_tx(full, 2 * L::kBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(K_TILE(s) + c * L::kBoxBytes, &tm_k, full, c * L::kBoxCols, k0, kvh, b);
      tma_load_4d(V_TILE(s) + c * L::kBoxBytes, &tm_v, full, c * L::kBoxCols, k0, kvh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c)
      tma_load_4d(sQ + c * L::kBoxBytes, &tm_q, bar_q, c * L::kBoxCols, q0, h, b);
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

    // S = Q K^T: both operands K-major, one k16 step per 32 bytes of a swizzled row
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk * 16 / L::kBoxCols) * L::kBoxBytes + (kk * 16 % L::kBoxCols) * 2;
      wgmma_ss_m64n128(sc, make_desc(q_rows + off, 16, L::kGroupBytes, L::kLayout),
                       make_desc(K_TILE(s) + off, 16, L::kGroupBytes, L::kLayout), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in the log2 domain; sc[i] is row r0 + 8 * ((i >> 1) & 1),
    // key k0 + (i / 4) * 8 + c0 + (i & 1)
    if (p.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = p.softcap * kLog2e * tanhf(sc[i] * qk_scale);
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= qk_scale;
    }
    const bool edge = k0 + kKeys > p.T || (p.causal && k0 + kKeys - 1 > wg_row0) ||
                      (p.window > 0 && k0 < wg_row0 + 64 - p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kp = k0 + (i / 4) * 8 + c0 + (i & 1);
        const int qp = r0 + 8 * ((i >> 1) & 1);
        const bool ok = kp < p.T && (!p.causal || kp <= qp) &&
                        (p.window <= 0 || qp - kp < p.window);
        if (!ok) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
    for (int i = 0; i < 64; ++i) {
      sc[i] = exp2f(sc[i] - mu[(i >> 1) & 1]);  // exp2(-inf) = 0 for a masked key
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < kBoxHalf; ++i) o_acc[c][i] *= alpha[(i >> 1) & 1];

    // P in bf16 as wgmma's A fragments: the accumulator layout of S is the
    // register layout of A, 4 registers per 16 keys
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) fence_regs(o_acc[c]);
    wgmma_fence();
    // O += P V: V is the B operand, MN-major (d contiguous); one 8-key group
    // per kGroupBytes, one V box per L::kBoxCols output columns
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int c = 0; c < L::kBoxes; ++c) {
        const uint32_t v = V_TILE(s) + c * L::kBoxBytes + kk * 16 * L::kRowBytes;
        wgmma_pv<L::kBoxCols>(o_acc[c], pa[kk],
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
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.osb + h * p.osh;
#pragma unroll
  for (int c = 0; c < L::kBoxes; ++c)
#pragma unroll
    for (int jj = 0; jj < kBoxHalf / 4; ++jj) {
      const int col = c * L::kBoxCols + jj * 8 + c0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < p.S)
          *reinterpret_cast<uint32_t*>(o + row * p.oss + col) =
              pack_bf16(o_acc[c][4 * jj + 2 * r] * inv[r], o_acc[c][4 * jj + 2 * r + 1] * inv[r]);
      }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver symbol: fetched through the runtime,
// so the library links nothing beyond it
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// a tensor map over a (d, rows, heads, batch) view with element strides
// (1, s_row, s_head, s_b) and a box of (L::kBoxCols, 128, 1, 1); rows past
// `rows` arrive zero-filled
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads, int B, long long s_row,
              long long s_head, long long s_b) {
  using L = Tile<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)B};
  const long long st[3] = {s_row, s_head, s_b};
  cuuint64_t strides[3];
  cuuint64_t packed = D * 2;
  for (int i = 0; i < 3; ++i) {
    // a dim of extent 1 is never stepped: it gets the packed stride
    strides[i] = dims[i + 1] == 1 ? packed : (cuuint64_t)st[i] * 2;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)L::kBoxCols, (cuuint32_t)kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, p.q, p.S, p.H, B, p.qss, p.qsh, p.qsb) ||
      !make_map<D>(&mk, p.k, p.T, p.KVH, B, p.kst, p.ksh, p.ksb) ||
      !make_map<D>(&mv, p.v, p.T, p.KVH, B, p.vst, p.vsh, p.vsb))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Tile<D>::kSmem;
  auto kern = attn_bf16_kernel<D>;
  // the shared-memory limit is set once per instance, not at every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((unsigned)((p.S + kRows - 1) / kRows), (unsigned)p.H, (unsigned)B);
  kern<<<grid, kWgThreads, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (wgmma + TMA kernel).
// Strides are in elements, for the (batch, head, position) dims; the head
// dim has unit stride.  The bf16 kernel needs 16-byte aligned bases and byte
// strides (the launcher checks).  Returns 0 or a cudaError_t code.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KVH, int S, int T, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, long long osb, long long osh, long long oss,
    int causal, int window, float scale, float softcap, void* stream) {
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, H, KVH, S, T, qsb, qsh, qss, ksb, ksh, kst,
           vsb, vsh, vst, osb, osh, oss, causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 32) return launch_f32<32>(p, B, s);
    if (D == 64) return launch_f32<64>(p, B, s);
    if (D == 128) return launch_f32<128>(p, B, s);
  } else if (dtype == 1) {
    if (D == 32) return launch_bf16<32>(p, B, s);
    if (D == 64) return launch_bf16<64>(p, B, s);
    if (D == 128) return launch_bf16<128>(p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
