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
// overhead, not by operations.
//
// Design: one thread block per (block_m x block_n) output tile; the TPU's
// sequential K grid becomes a loop inside the block over block_k slabs of A
// and B staged in shared memory (converted to fp32 on load), with each of
// the 256 threads holding a (block_m/16 x block_n/16) register accumulator.
// Ragged M, N and K edges are masked inside the kernel, so the wrapper does
// no pad-and-slice copies.  A and B are taken with arbitrary non-negative
// strides, so the backward pass hands in transposed views without copies;
// each load walks whichever dimension has unit stride so global reads stay
// coalesced.  Shared-memory rows are padded by one word against bank
// conflicts.  Simple and right first: no wgmma, TMA or split-K yet, so a
// product with a long K and few output tiles (conv1's weight gradient) runs
// on one block walking all of K.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid per block

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
          int M, int N, int K, long long sam, long long sak, long long sbk,
          long long sbn) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LDA = BM + 1;
  constexpr int LDB = BN + 1;
  extern __shared__ float smem[];
  float* As = smem;             // [BK][LDA], k-major so a thread reads a column
  float* Bs = smem + BK * LDA;  // [BK][LDB]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;
  const bool a_k_fast = (sak == 1);
  const bool b_n_fast = (sbn == 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int mm = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const long long gm = m0 + mm;
      const int gk = k0 + kk;
      As[kk * LDA + mm] = (gm < M && gk < K) ? to_f32(a[gm * sam + gk * sak]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int nn = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const long long gn = n0 + nn;
      const int gk = k0 + kk;
      Bs[kk * LDB + nn] = (gn < N && gk < K) ? to_f32(b[gk * sbk + gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM];
      float rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = As[kk * LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = Bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) c[gm * N + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           long long sam, long long sak, long long sbk, long long sbn,
           cudaStream_t stream) {
  const int smem = (BK * (BM + 1) + BK * (BN + 1)) * (int)sizeof(float);
  auto kern = mm_kernel<T, BM, BN, BK>;
  // the shared-memory limit is set once per instance, not at every launch
  // (the port drives one device per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, sam, sak, sbk, sbn);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* a, const void* b, void* c, int M, int N, int K,
             long long sam, long long sak, long long sbk, long long sbn,
             int bm, int bn, int bk, cudaStream_t s) {
  if (bm == 64 && bn == 64 && bk == 64)
    return launch<T, 64, 64, 64>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
  if (bm == 128 && bn == 128 && bk == 64)
    return launch<T, 128, 128, 64>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
  if (bm == 128 && bn == 64 && bk == 128)
    return launch<T, 128, 64, 128>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
  if (bm == 128 && bn == 128 && bk == 128)
    return launch<T, 128, 128, 128>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 or a cudaError_t code.
extern "C" int repro_tiled_matmul(const void* a, const void* b, void* c,
                                  int dtype, int M, int N, int K,
                                  long long sam, long long sak, long long sbk,
                                  long long sbn, int bm, int bn, int bk,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(a, b, c, M, N, K, sam, sak, sbk, sbn, bm, bn, bk, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, b, c, M, N, K, sam, sak, sbk, sbn, bm, bn,
                                   bk, s);
  return (int)cudaErrorInvalidValue;
}
