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
// it.  The card's rate for them is the bf16 tensor cores' (989 TFLOP/s);
// this first kernel runs the two products on the fp32 CUDA cores (67
// TFLOP/s), so it cannot come within 15x of that bound.  wgmma and TMA
// come in later work.
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch);
// the TPU's sequential kv grid becomes a loop inside the block over kv tiles
// of 64 keys.  Q and each K/V tile are staged in shared memory as fp32
// (rows padded by one word against bank conflicts, 113 KB at d = 128).  Each
// thread computes a 4x4 patch of S = Q K^T in registers, the 16 threads of a
// row group reduce the row max and sum with warp shuffles, P goes through
// shared memory, and each thread keeps a 4 x (d/16) patch of the output
// accumulator in registers.  KV tiles wholly above the causal diagonal or
// wholly before the window are never loaded; masked entries get p = 0
// explicitly (a row's first tile may be fully masked under a window), and
// ragged s and t are masked in the kernel, so the wrapper pads nothing.
// GQA: head h reads kv head h / (H / KVH).  All tensors are taken with
// strides (unit stride on d), so the model's (b, s, heads, d) activations
// need no transpose copies.  Q tiles are issued last-first, so the longest
// causal rows start earliest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
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
constexpr int smem_bytes() {
  return ((kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1)) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_kernel(Params p) {
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
  const T* q = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
  T* o = static_cast<T*>(p.o) + b * p.osb + h * p.osh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gq = q0 + r;
    Qs[r * LDD + c] = gq < p.S ? to_f32(q[gq * p.qss + c]) : 0.f;
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
      Ks[r * LDD + c] = in ? to_f32(k[gk * p.kst + c]) : 0.f;
      Vs[r * LDD + c] = in ? to_f32(v[gk * p.vst + c]) : 0.f;
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
    for (int j = 0; j < TD; ++j) o[qp * p.oss + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  auto kern = attn_kernel<T, D>;
  // the shared-memory limit is set once per instance, not at every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((unsigned)((p.S + kBQ - 1) / kBQ), (unsigned)p.H, (unsigned)B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int B, int D, cudaStream_t s) {
  if (D == 32) return launch<T, 32>(p, B, s);
  if (D == 64) return launch<T, 64>(p, B, s);
  if (D == 128) return launch<T, 128>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, for the
// (batch, head, position) dims; the head dim has unit stride.  Returns 0 or
// a cudaError_t code.
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
  if (dtype == 0) return dispatch<float>(p, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}
