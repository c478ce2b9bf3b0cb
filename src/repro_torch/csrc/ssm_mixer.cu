// The pointwise work of a Mamba2 mixer's prefill for Hopper (sm_90a), in two
// launches a layer around its scan, bf16 or fp16 in and out, fp32 inside.
//
// Replaces no TPU kernel: the reference writes the mixer in jnp
// (src/repro/models/ssm.py, `ssm_mixer`), and the port's plain version
// (`models/ssm.py`, `kernels/ssm_mixer/ref.py`) is some twenty PyTorch
// launches a layer: a concatenation, a padded channels-first copy and a
// depthwise conv1d, the bias, SiLU, softplus and the products with dt before
// the scan; the skip, the gate and a grouped RMS norm over fp32 copies after.
//
// What bounds it on this card: bytes.  At the published Zamba2's prefill
// (b 4, s 4,088, d_inner 7,168, 2 groups of n 64, 112 heads of 64) the first
// kernel reads the in_proj output's xBC and dt columns (247 MB) and writes
// xdt, B, C, xh and dA (484 MB): 0.22 ms at 3.35 TB/s; the second reads y,
// xh and z and writes the normed gate (0.94 GB): 0.28 ms.  A few dozen
// operations an element, so each kernel reads every input byte once, keeps
// every intermediate on chip in fp32, and rounds each output once.
//
// ssm_conv_in: one CTA of 256 threads per (64 positions, 64 channels,
// sequence), the position tiles of a channel tile in consecutive CTAs, so
// that the CTAs in flight write whole rows of the positions-major outputs
// (at the cell's shape 0.38 ms against 0.46 ms with the channel tiles
// consecutive, on the H100).  It reads the in_proj output `zx` (b, s, *) in place, the conv's
// input from column `xbc0` and dt from column `dt0`: the tile's rows and a
// 3-row halo arrive in shared memory by 16-byte loads (2-byte loads where
// the rows are not 16-byte aligned, as at the smoke widths).  Each thread
// convolves one channel over 16 positions in registers (fp32, the bias and
// SiLU after), so that its outputs are one 32-byte run of the positions-major
// store the scan reads as it lies: xdt for x's channels (times the head's dt,
// one tile a head), B and C as they are, each channel's row of positions
// padded to a multiple of 8 with zeros.  x's tiles also stage the activation
// xh in shared memory, row by row, and store it positions by channels, the
// layout the second kernel reads; and write dt A (fp32, positions at unit
// stride) for their head.  The tiles that hold the last positions copy the
// raw conv inputs there to the decode cache.
//
// ssm_gated_norm: one CTA of 256 threads a position.  Each thread holds up to
// four 8-channel vectors (d_inner <= 8,192) of (y + D xh) silu(z) in fp32
// registers, the squares summed by warp and then, in a fixed order, by group;
// the second pass scales by rsqrt(mean + eps) (1 + gamma) and stores 16
// bytes at a time.  z is read in place from the in_proj output's first
// d_inner columns.
//
// Parameters (conv weight and bias, dt_bias, A_log, D, the norm's gamma) are
// in the activations' type, as the model stores them.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;             // positions a tile of the conv
constexpr int kTC = 64;             // channels a tile: one head of x
constexpr int kWidth = 4;           // the conv's width
constexpr int kHalo = kWidth - 1;
constexpr int kRun = 16;            // positions one thread convolves: 32 bytes
constexpr int kHeadDim = 64;
constexpr int kMaxVec = 4;          // 8-channel vectors a thread of the norm holds
constexpr int kMaxGroups = 8;
static_assert(kTC * (kTP / kRun) == kThreads, "one run of positions a thread");

// The 16-bit types: packing two values, and each half of a pair as fp32.
template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
  static __device__ __forceinline__ float hi(uint32_t v) {
    return __uint_as_float(v & 0xffff0000u);
  }
  static __device__ __forceinline__ float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Ty<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float lo(uint32_t v) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(v & 0xffffu)));
  }
  static __device__ __forceinline__ float hi(uint32_t v) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(v >> 16)));
  }
  static __device__ __forceinline__ float get(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half put(float v) { return __float2half_rn(v); }
};

template <typename T>
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = Ty<T>::lo(w[i]);
    f[2 * i + 1] = Ty<T>::hi(w[i]);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(Ty<T>::pack(f[0], f[1]), Ty<T>::pack(f[2], f[3]),
                    Ty<T>::pack(f[4], f[5]), Ty<T>::pack(f[6], f[7]));
}

// 8 consecutive values from `p`: one 16-byte load where `vec`, else 8.
template <typename T>
__device__ __forceinline__ void load8(const T* p, bool vec, float (&f)[8]) {
  if (vec) {
    unpack8<T>(*reinterpret_cast<const uint4*>(p), f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = Ty<T>::get(p[i]);
  }
}

// Parameter i of p, stored as T, in fp32.
template <typename T>
__device__ __forceinline__ float param(const void* p, long long i) {
  return Ty<T>::get(static_cast<const T*>(p)[i]);
}

// v sigmoid(v), the quotient by the fast reciprocal (2 ulp; 0 for v under
// -88, where exp(-v) is infinite)
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

struct ConvParams {
  const void* zx;          // (b, s, *): the in_proj output, channels at unit stride
  long long zsb, zss;      // its batch and position strides
  int xbc0, dt0;           // the columns of the conv's first input and of dt
  const void* w;           // (width, ch), contiguous
  const void* bias;        // (ch)
  const void* dt_bias;     // (h)
  const void* a_log;       // (h)
  void* xbc;               // (b, ch, spad): xdt, B, C, positions at unit stride
  float* dA;               // (b, h, s)
  void* xh;                // (b, s, d)
  void* tail;              // (b, tail_rows, ch): the last raw conv inputs
  int S, Spad, CH, D, tail_rows;
  bool vec;                // zx's rows take 16-byte loads
};

template <typename T>
__global__ void __launch_bounds__(kThreads) conv_in_kernel(const ConvParams p) {
  // 16-bit words, seen as T: row r of s_in is position p0 - 3 + r
  __shared__ __align__(16) uint16_t s_in_words[(kTP + kHalo) * kTC];
  __shared__ __align__(16) uint16_t s_xh_words[kTP * kTC];
  __shared__ float s_dt[kTP];
  T* s_in = reinterpret_cast<T*>(s_in_words);
  T* s_xh = reinterpret_cast<T*>(s_xh_words);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * kTC, p0 = blockIdx.x * kTP, b = blockIdx.z;
  const T* zx = static_cast<const T*>(p.zx) + b * p.zsb;
  const bool is_x = c0 < p.D;   // one head of x, or channels of B and C

  if (p.vec) {
    for (int i = tid; i < (kTP + kHalo) * (kTC / 8); i += kThreads) {
      const int r = i / (kTC / 8), v = i % (kTC / 8);
      const int q = p0 - kHalo + r, c = c0 + 8 * v;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (q >= 0 && q < p.S && c < p.CH)
        u = *reinterpret_cast<const uint4*>(zx + q * p.zss + p.xbc0 + c);
      *reinterpret_cast<uint4*>(s_in + r * kTC + 8 * v) = u;
    }
  } else {
    for (int i = tid; i < (kTP + kHalo) * kTC; i += kThreads) {
      const int r = i / kTC, cc = i % kTC;
      const int q = p0 - kHalo + r, c = c0 + cc;
      s_in[i] = (q >= 0 && q < p.S && c < p.CH) ? zx[q * p.zss + p.xbc0 + c] : Ty<T>::put(0.f);
    }
  }
  if (is_x && tid < kTP) {
    const int q = p0 + tid, h = c0 / kHeadDim;
    float dt = 0.f;
    if (q < p.S) {
      // softplus as PyTorch takes it (threshold 20), in fp32
      const float v = Ty<T>::get(zx[q * p.zss + p.dt0 + h]) + param<T>(p.dt_bias, h);
      dt = v > 20.f ? v : log1pf(expf(v));
      const float A = -expf(param<T>(p.a_log, h));
      p.dA[((long long)b * (p.D / kHeadDim) + h) * p.S + q] = dt * A;
    }
    s_dt[tid] = dt;
  }
  __syncthreads();

  // the decode cache: the raw inputs at positions S - tail_rows .. S - 1
  if (p0 + kTP > p.S - p.tail_rows && tid < kHalo * kTC) {
    const int k = tid / kTC, cc = tid % kTC;
    const int q = p.S - p.tail_rows + k, c = c0 + cc;
    if (k < p.tail_rows && q >= p0 && q < p0 + kTP && c < p.CH)
      static_cast<T*>(p.tail)[((long long)b * p.tail_rows + k) * p.CH + c] =
          s_in[(q - p0 + kHalo) * kTC + cc];
  }

  const int cc = tid % kTC, r0 = (tid / kTC) * kRun;
  const int c = c0 + cc;
  if (c < p.CH) {
    float w[kWidth];
#pragma unroll
    for (int k = 0; k < kWidth; ++k) w[k] = param<T>(p.w, (long long)k * p.CH + c);
    const float bias = param<T>(p.bias, c);
    float in[kRun + kHalo];
#pragma unroll
    for (int j = 0; j < kRun + kHalo; ++j) in[j] = Ty<T>::get(s_in[(r0 + j) * kTC + cc]);
    float out[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      float acc = bias;
#pragma unroll
      for (int k = 0; k < kWidth; ++k) acc = fmaf(w[k], in[i + k], acc);
      out[i] = p0 + r0 + i < p.S ? silu(acc) : 0.f;
    }
    if (is_x) {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        s_xh[(r0 + i) * kTC + cc] = Ty<T>::put(out[i]);
        out[i] *= s_dt[r0 + i];
      }
    }
    T* dst = static_cast<T*>(p.xbc) + ((long long)b * p.CH + c) * p.Spad + p0 + r0;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (p0 + r0 + 8 * half < p.Spad)
        *reinterpret_cast<uint4*>(dst + 8 * half) = pack8<T>(out + 8 * half);
  }

  if (is_x) {   // uniform over the CTA
    __syncthreads();
    T* xh = static_cast<T*>(p.xh) + (long long)b * p.S * p.D + c0;
    for (int i = tid; i < kTP * (kTC / 8); i += kThreads) {
      const int r = i / (kTC / 8), v = i % (kTC / 8);
      if (p0 + r < p.S)
        *reinterpret_cast<uint4*>(xh + (long long)(p0 + r) * p.D + 8 * v) =
            *reinterpret_cast<const uint4*>(s_xh + r * kTC + 8 * v);
    }
  }
}

struct NormParams {
  const void* y;           // (b, s, d), contiguous
  const void* xh;          // (b, s, d), contiguous
  const void* zx;          // z: the first d columns of the in_proj output's rows
  long long zsb, zss;
  const void* d_skip;      // (h)
  const void* gamma;       // (d)
  void* out;               // (b, s, d), contiguous
  int S, D, G;
  float eps;
  bool vec;                // z's rows take 16-byte loads
};

template <typename T>
__global__ void __launch_bounds__(kThreads) gated_norm_kernel(const NormParams p) {
  // each warp's sum of squares by group, added in a fixed order: the same
  // bits at every call
  __shared__ float s_part[kThreads / 32][kMaxGroups];
  __shared__ float s_sum[kMaxGroups];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / p.S), q = static_cast<int>(row % p.S);
  const int nv = p.D / 8, per_group = nv / p.G;
  const T* y = static_cast<const T*>(p.y) + row * p.D;
  const T* xh = static_cast<const T*>(p.xh) + row * p.D;
  const T* z = static_cast<const T*>(p.zx) + b * p.zsb + q * p.zss;
  if (lane < kMaxGroups) s_part[warp][lane] = 0.f;
  __syncwarp();

  // every load first, then the arithmetic, then the sums
  float v[kMaxVec][8], ss[kMaxVec];
  int g[kMaxVec];
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int j = tid + k * kThreads;
    g[k] = -1;
    ss[k] = 0.f;
    if (j < nv) {
      float fy[8], fx[8], fz[8];
      load8<T>(y + 8 * j, true, fy);
      load8<T>(xh + 8 * j, true, fx);
      load8<T>(z + 8 * j, p.vec, fz);
      const float dsk = param<T>(p.d_skip, (8 * j) / kHeadDim);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[k][e] = fmaf(dsk, fx[e], fy[e]) * silu(fz[e]);
        ss[k] = fmaf(v[k][e], v[k][e], ss[k]);
      }
      g[k] = j / per_group;
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    // the sums by group: the lanes' groups are consecutive, lane 0's the first
    const int g_lo = __shfl_sync(0xffffffffu, g[k], 0);
    if (g_lo < 0) continue;   // uniform over the warp
    const int g_hi = __reduce_max_sync(0xffffffffu, g[k]);
    for (int gg = g_lo; gg <= g_hi; ++gg) {
      float r = g[k] == gg ? ss[k] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
      if (lane == 0) s_part[warp][gg] += r;
    }
  }
  __syncthreads();
  if (tid < p.G) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += s_part[w][tid];
    s_sum[tid] = t;
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out) + row * p.D;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int j = tid + k * kThreads;
    if (j < nv) {
      const float rs = rsqrtf(s_sum[j / per_group] / (8.f * per_group) + p.eps);
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = v[k][e] * rs * (1.f + param<T>(p.gamma, 8 * j + e));
      *reinterpret_cast<uint4*>(out + 8 * j) = pack8<T>(o);
    }
  }
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (zx, w, bias, dt_bias, a_log, xbc, xh,
// tail); dA in fp32.  zx's channels
// have a unit stride; with `vec` its base, its strides and xbc0 fall on 16
// bytes.  D is a multiple of 64 (heads of 64), CH (the conv's channels, x then
// B and C) of 8, Spad >= S of 8; xbc (b, CH, Spad), dA (b, D / 64, S), xh
// (b, S, D) and tail (b, tail_rows, CH), tail_rows <= 3, are contiguous.  A
// conv of width 4.  One launch; returns the CUDA error.
extern "C" int repro_ssm_conv_in(const void* zx, long long zsb, long long zss, int xbc0,
                                 int dt0, const void* w, const void* bias, const void* dt_bias,
                                 const void* a_log, void* xbc, void* dA, void* xh,
                                 void* tail, int dtype, int batch, int S, int Spad, int CH,
                                 int D, int tail_rows, int vec, void* stream) {
  if (batch <= 0 || batch > 65535 || S <= 0 || Spad < S || Spad % 8 || D <= 0
      || D % kHeadDim || CH < D || CH % 8 || tail_rows < 0 || tail_rows > kHalo
      || (CH + kTC - 1) / kTC > 65535)
    return (int)cudaErrorInvalidValue;
  ConvParams p{zx, zsb, zss, xbc0, dt0, w, bias, dt_bias, a_log, xbc,
               static_cast<float*>(dA), xh, tail, S, Spad, CH, D, tail_rows, vec != 0};
  const dim3 grid((Spad + kTP - 1) / kTP, (CH + kTC - 1) / kTC, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) conv_in_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else if (dtype == 2) conv_in_kernel<__half><<<grid, kThreads, 0, s>>>(p);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype as above (y, xh, zx, d_skip, gamma, out).  y, xh and out (b, S, D)
// contiguous, D a multiple of 64 up to 8,192, split into G <= 8 groups of a
// multiple of 8 channels; z the first D columns of zx (unit stride on
// channels; with `vec` 16-byte aligned rows).  One launch; returns the CUDA
// error.
extern "C" int repro_ssm_gated_norm(const void* y, const void* xh, const void* zx,
                                    long long zsb, long long zss, const void* d_skip,
                                    const void* gamma, void* out, int dtype,
                                    int batch, int S, int D, int G, float eps, int vec,
                                    void* stream) {
  if (batch <= 0 || S <= 0 || D <= 0 || D % kHeadDim || D / 8 > kMaxVec * kThreads
      || G <= 0 || G > kMaxGroups || (D / 8) % G)
    return (int)cudaErrorInvalidValue;
  NormParams p{y, xh, zx, zsb, zss, d_skip, gamma, out, S, D, G, eps, vec != 0};
  const long long rows = (long long)batch * S;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) gated_norm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else if (dtype == 2) gated_norm_kernel<__half><<<grid, kThreads, 0, s>>>(p);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
