// Block-tiled matrix product C = A @ B for Hopper (sm_90a), fp32 or bf16 in,
// fp32 accumulation, output in the input dtype.
//
// Replaces: src/repro/kernels/tiled_matmul/kernel.py, `tiled_matmul` (Pallas
// body `_mm_kernel`): a (M,K)@(K,N) block GEMM with an fp32 VMEM accumulator
// carried across a sequential K-minor grid, block_m/n/k as arguments (the
// paper's section V block-shape knob).
//
// What bounds it on this card: the products of the LeNet slice are small
// and skinny (N = 6..120, K = 25..400 forward; K = 100,352 for conv1's weight
// gradient), so at fp32 (67 TFLOP/s without tensor cores, 3.35 TB/s) they
// sit far below the ridge point and are bound by bytes and by launch
// overhead, not by operations.  fp32 has no tensor-core route but TF32,
// which would break the 1e-4 contract, so the products run on the CUDA cores.
//
// Design: one thread block per (block_m x block_n) output tile and K-split;
// the TPU's sequential K grid becomes a loop inside the block over the
// block_k slabs of its split, staged in shared memory in stages of at most
// 64 k (a block_k of 128 is two stages: the same order of sums).  Each of the
// 256 threads holds a (block_m/16 x block_n/16) register accumulator; a warp
// holds 16 rows by 2 columns of threads, and a warp whose columns all lie
// past N (N = 6 and 10 in LeNet) skips the products.
// * Split-K: a product with few output tiles and a long K (conv1's weight
//   gradient is one tile over K = 100,352) is cut into slab-aligned splits,
//   one block each (the launcher's `split_k_plan` picks the count).  Each
//   block writes its fp32 partial to a (splits, M, N) workspace, and a second
//   kernel sums the splits in a fixed order: no atomics, so a call gives the
//   same bits every time.
// * Asynchronous slab copies: a 2-stage ring; the next stage's copies
//   (`cp.async`) are in flight while the current one is multiplied.  Each
//   operand is staged with its unit-stride dim contiguous in shared memory;
//   16-byte copies where that dim's rows are 16-byte aligned, else 4-byte
//   copies (the backward's transposed views, e.g. a 100-byte row stride).
//   bf16 operands are converted to fp32 on a synchronous load instead.
// Rows past M and columns past N are never loaded (their sums are dropped),
// nor is k past the split's end (the last stage's loop stops there).  A and
// B are taken with arbitrary non-negative strides, so the backward pass hands
// in transposed views without copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid per block

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// How one operand tile (R rows of the M or N side x SK k) sits in global
// and shared memory.  Element (r, k) is g[r * sr + k * sk]; in shared memory
// it is at r * ldr + k * ldk, with the global unit-stride dim contiguous.
struct Operand {
  const void* g;
  long long sr, sk;
  int rows;      // M or N: rows at or past it are never loaded
  bool kmajor;   // k contiguous in shared memory (else r contiguous)
  bool vec;      // 16-byte copies along the contiguous dim
};

template <int R, int SK>
struct Stage {
  static constexpr int kLdR = R + 4;   // r-contiguous: one k row, padded to 16 bytes
  static constexpr int kLdK = SK + 4;  // k-contiguous, 16-byte copies: one r row
  static constexpr int kFloats = (SK * kLdR > R * kLdK) ? SK * kLdR : R * kLdK;
  // k-contiguous rows: 16-byte aligned for 16-byte copies, else padded by one
  // word, so a warp's 16 rows fall in 16 banks
  static __device__ __forceinline__ int ldk(const Operand& op) { return op.vec ? kLdK : SK + 1; }
};

// Issue the copies of one stage (k in [k0, min(k0 + SK, k_end))) of rows
// r0.. of an operand.  Groups of 4 along the contiguous dim.
template <typename T, int R, int SK>
__device__ __forceinline__ void load_stage(float* S, const Operand& op, int r0, int k0, int k_end,
                                           int tid) {
  using St = Stage<R, SK>;
  const T* g = static_cast<const T*>(op.g);
  constexpr int kGroups = R * SK / 4;
  for (int e = tid; e < kGroups; e += kThreads) {
    int r, k, step_r, step_k;  // the group's first element and its step
    float* dst;
    if (op.kmajor) {
      r = e / (SK / 4);
      k = (e % (SK / 4)) * 4;
      step_r = 0, step_k = 1;
      dst = S + r * St::ldk(op) + k;
    } else {
      k = e / (R / 4);
      r = (e % (R / 4)) * 4;
      step_r = 1, step_k = 0;
      dst = S + k * St::kLdR + r;
    }
    const int gr = r0 + r, gk = k0 + k;
    if (gr >= op.rows || gk >= k_end) continue;  // sums dropped (rows), k never summed
    if constexpr (sizeof(T) == 4) {
      if (op.vec && gk + 3 * step_k < k_end && gr + 3 * step_r < op.rows) {
        cp_async16(dst, g + gr * op.sr + (long long)gk * op.sk);
        continue;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int qr = gr + q * step_r, qk = gk + q * step_k;
      if (qr >= op.rows || qk >= k_end) break;
      const T* src = g + qr * op.sr + (long long)qk * op.sk;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + q, src);
      } else {
        dst[q] = __bfloat162float(*src);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const Operand a, const Operand b, T* __restrict__ c, float* __restrict__ ws, int M,
          int N, int K, int k_per_split) {
  constexpr int SK = BK < 64 ? BK : 64;  // k per stage
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  using SA = Stage<BM, SK>;
  using SB = Stage<BN, SK>;
  constexpr int kStageFloats = SA::kFloats + SB::kFloats;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int ty = tid % 16;  // a warp holds 16 rows and 2 columns of threads,
  const int tx = tid / 16;  // so on a skinny product whole warps idle
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // every column this warp would sum lies past N: it loads but does not multiply
  const bool idle = n0 + (tid / 32) * 2 >= N;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_stages = k_end > k_begin ? (k_end - k_begin + SK - 1) / SK : 0;
  // shared-memory steps along r and along k of each operand
  const int a_sr = a.kmajor ? SA::ldk(a) : 1, a_sk = a.kmajor ? 1 : SA::kLdR;
  const int b_sr = b.kmajor ? SB::ldk(b) : 1, b_sk = b.kmajor ? 1 : SB::kLdR;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (n_stages > 0) {
    load_stage<T, BM, SK>(smem, a, m0, k_begin, k_end, tid);
    load_stage<T, BN, SK>(smem + SA::kFloats, b, n0, k_begin, k_end, tid);
  }
  cp_async_commit();
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {  // the next stage's copies fly while this one is multiplied
      float* nxt = smem + ((st + 1) & 1) * kStageFloats;
      const int k0 = k_begin + (st + 1) * SK;
      load_stage<T, BM, SK>(nxt, a, m0, k0, k_end, tid);
      load_stage<T, BN, SK>(nxt + SA::kFloats, b, n0, k0, k_end, tid);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* As = smem + (st & 1) * kStageFloats;
    const float* Bs = As + SA::kFloats;
    // the stage's k past the split's end are zeros: skipping them changes no sum
    const int kn = min(SK, k_end - (k_begin + st * SK));
    if (!idle) {
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float ra[TM];
        float rb[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) ra[i] = As[(ty + 16 * i) * a_sr + kk * a_sk];
#pragma unroll
        for (int j = 0; j < TN; ++j) rb[j] = Bs[(tx + 16 * j) * b_sr + kk * b_sk];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
    }
    __syncthreads();  // this stage is read: the next iteration refills it
  }

  float* part = ws == nullptr ? nullptr : ws + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long gn = n0 + tx + 16 * j;
      if (gm >= M || gn >= N) continue;
      if (part != nullptr) {
        part[gm * N + gn] = acc[i][j];
      } else {
        c[gm * N + gn] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

// C = the sum of the splits' partials, in a fixed order.  LANES threads
// share an output: each sums every LANES-th split in order, then a fixed
// shuffle tree adds the lanes.
template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads)
splitk_sum(const float* __restrict__ ws, T* __restrict__ c, long long mn, int splits) {
  const long long idx = ((long long)blockIdx.x * kThreads + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  float s = 0.f;
  if (idx < mn)
    for (int z = lane; z < splits; z += LANES) s += ws[z * mn + idx];
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (idx < mn && lane == 0) c[idx] = from_f32<T>(s);
}

// the operand layout the kernel stages: unit-stride dim contiguous, 16-byte
// copies where that dim's rows start on 16-byte boundaries
Operand make_operand(const void* g, long long sr, long long sk, int rows, int esize) {
  Operand op{g, sr, sk, rows, sk == 1 && sr != 1, false};
  const long long row = op.kmajor ? sr : sk;  // the stride between contiguous runs
  const bool unit = op.kmajor || sr == 1;
  op.vec = esize == 4 && unit && (row * esize) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(g) % 16 == 0;
  return op;
}

template <typename T, int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, void* ws, int M, int N, int K, long long sam,
           long long sak, long long sbk, long long sbn, int splits, cudaStream_t stream) {
  constexpr int SK = BK < 64 ? BK : 64;
  constexpr int smem =
      2 * (Stage<BM, SK>::kFloats + Stage<BN, SK>::kFloats) * (int)sizeof(float);
  auto kern = mm_kernel<T, BM, BN, BK>;
  // the shared-memory limit is set once per instance, not at every launch
  // (the port drives one device per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (splits < 1 || (splits > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const int slabs = (K + BK - 1) / BK;
  const int k_per_split = ((slabs + splits - 1) / splits) * BK;
  const Operand oa = make_operand(a, sam, sak, M, (int)sizeof(T));
  const Operand ob = make_operand(b, sbn, sbk, N, (int)sizeof(T));
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN), (unsigned)splits);
  kern<<<grid, kThreads, smem, stream>>>(oa, ob, static_cast<T*>(c), part, M, N, K, k_per_split);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return (int)rc;
  const long long mn = (long long)M * N;
  if (splits >= 16) {
    splitk_sum<T, 32><<<(unsigned)((mn * 32 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        part, static_cast<T*>(c), mn, splits);
  } else {
    splitk_sum<T, 1><<<(unsigned)((mn + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        part, static_cast<T*>(c), mn, splits);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* c, void* ws, int M, int N, int K,
             long long sam, long long sak, long long sbk, long long sbn, int bm, int bn, int bk,
             int splits, cudaStream_t s) {
  if (bm == 64 && bn == 64 && bk == 64)
    return launch<T, 64, 64, 64>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, splits, s);
  if (bm == 128 && bn == 128 && bk == 64)
    return launch<T, 128, 128, 64>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, splits, s);
  if (bm == 128 && bn == 64 && bk == 128)
    return launch<T, 128, 64, 128>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, splits, s);
  if (bm == 128 && bn == 128 && bk == 128)
    return launch<T, 128, 128, 128>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `splits` K-splits (1: C is written
// directly; more: `ws` is a float32 (splits, M, N) workspace).  Returns 0
// or a cudaError_t code.
extern "C" int repro_tiled_matmul(const void* a, const void* b, void* c, void* ws,
                                  int dtype, int M, int N, int K,
                                  long long sam, long long sak, long long sbk,
                                  long long sbn, int bm, int bn, int bk, int splits,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, bm, bn, bk, splits, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, b, c, ws, M, N, K, sam, sak, sbk, sbn, bm, bn, bk, splits,
                                   s);
  return (int)cudaErrorInvalidValue;
}
