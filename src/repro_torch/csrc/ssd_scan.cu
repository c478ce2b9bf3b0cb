// The SSD (Mamba2) chunked scan of a prefill for Hopper (sm_90a): one launch
// a layer, bf16 or fp16 in and out, the state in fp32.
//
// Replaces no TPU kernel: the reference scans with `lax.scan` over chunks
// (src/repro/models/ssm.py, `ssd_chunked`), and the port's plain version is
// the same loop in PyTorch (`models/ssm.py`, `kernels/ssd_scan/ref.py`),
// some twenty small kernels a chunk that write the chunk's (l, l) decay and
// score matrices to device memory.
//
// What bounds it on this card: at the published Zamba2's prefill (b 4,
// s 4,088, h 112, p 64, g 2, n 64, chunks of 256) a layer needs 60.6 GFLOP
// of products (61 us at 989 TFLOP/s) and moves at least 499 MB (x and y in
// bf16, B, C, dA, the initial and the final state): 0.149 ms at 3.35 TB/s.
// So bytes bound it, and the design reads x, B, C and dA once, writes y and
// the state once, and keeps every (l, l) matrix and every per-chunk state on
// chip.
//
// One CTA of eight warps per (sequence, head) walks the chunks in order
// with the head's 64 x n state on chip; the next chunk's x, B, C and dA
// arrive by cp.async into the other half of a double buffer while the
// current one computes.  Per chunk (l <= 256 rows, the last one ragged):
//
// * warp 0 takes the fp32 cumulative sum a of the chunk's dA;
// * each warp owns two 16-row blocks, w and 15 - w, so that the causal
//   work is even.  For both at once (one read of the state) it forms
//   C_i . state on the tensor cores in TF32 with the state split into a
//   high and a low TF32 term (as the Winograd kernel's 3xTF32, the third
//   product dropped: C is exact in TF32).  Then for each block, for each
//   16-key block j before it, the scores C_i . B_j (`mma.sync`, 16-bit in,
//   fp32 sums) times exp(a_r - a_j), r the block's first row, rounded once
//   to the input's type as the A fragments of y_i += M_ij x_j; the row
//   factor exp(a_i - a_r), which the state's share exp(a_i) also holds,
//   multiplies the sum once (every factor at most 1, and two exponentials
//   a key where exp(a_i - a_j) would take four: the special-function unit,
//   not the tensor cores, set the pace).  The diagonal block takes
//   exp(a_i - a_j) whole, masked above the diagonal.  y is rounded once and
//   written;
// * then the state: state * exp(a_last) + sum_j B_j (x_j exp(a_last - a_j)),
//   the decays computed once a chunk, in TF32 with (x * decay) split in two
//   terms the same way, each warp keeping a 16 x n/2 part of the state in
//   fp32 registers across chunks; the split copy in shared memory is what
//   the next chunk's reads take.
//
// Measured at the cell's shape on the H100 (variants built with one part
// left out): the products, not the bytes, take most of the time, with two
// warps a scheduler to hide the latencies of `mma.sync` (one CTA fills an
// SM's shared memory), and 448 CTAs make 3.4 waves.
//
// x, B and C are read as the model's conv output lies, the positions at unit
// stride, and staged the same way: each feature a row of positions, in
// 16-byte units swizzled by row, so that ldmatrix (plain and transposed)
// reads them without bank conflicts.  Inputs laid out otherwise are copied
// into that layout by the wrapper (`kernels/ssd_scan/ops.py`).  Rows
// past a ragged chunk's end arrive as zeros (x, B, C) and dA as 0, so they
// neither decay nor feed the state.  State sizes 16 and 64, head dim 64.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;                    // head dim
constexpr int kLMax = 256;                // the longest chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowBlocks = kLMax / 16;    // 16-row blocks of the longest chunk

struct Params {
  const void* x;       // (b, s, h, p): inputs times dt
  const float* dA;     // (b, s, h)
  const void* B;       // (b, s, g, n)
  const void* C;       // (b, s, g, n)
  const float* state0; // (b, h, p, n), contiguous
  void* y;             // (b, s, h, p), contiguous
  float* state;        // (b, h, p, n), contiguous
  int S, H, G, L;
  // element strides of x (batch, head, p), dA (batch, position, head), B
  // and C (batch, group, n); x, B and C have a unit stride on positions
  long long xsb, xsh, xsp, asb, ass, ash, bsb, bsg, bsn, csb, csg, csn;
};

// the shared memory of one CTA at state size N: the split state, then two
// buffers of (x, B, C, dA)
template <int N>
struct Layout {
  static constexpr int kX = kLMax * kP * 2;      // x: 128-byte rows
  static constexpr int kB = kLMax * N * 2;       // B and C
  static constexpr int kBuf = kX + 2 * kB + kLMax * 4;
  static constexpr int kState = kP * N * 8;      // (hi, lo) of every state entry
  static constexpr int kBytes = kState + 2 * kBuf;
  static_assert(kBytes <= 232448, "more shared memory than a CTA may have");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The byte offset of 16-byte unit c (8 positions) of feature r of a staged
// tile: rows of kLMax positions, 32 units a row, the unit index XOR the
// row's low bits, so that eight consecutive rows (ldmatrix) use distinct
// banks.
__device__ __forceinline__ int swz_t(int r, int c) {
  return r * kLMax * 2 + ((c ^ (r & 7)) << 4);
}

// The split state: row p holds N / 2 units of (hi_n, hi_n+1, lo_n, lo_n+1).
template <int N>
__device__ __forceinline__ int state_unit(int p, int u) {
  return p * (N / 2) * 16 + ((u ^ ((p & 1) << 2)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a = hi + lo, hi a TF32 value (a's top 11 significant bits) and lo = a - hi,
// exact in fp32; the tensor core drops lo's low 13 bits: at most 2^-20 of a.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// The 16-bit input types: the tensor-core product, packing, and the two
// halves of a packed pair as fp32 (exact).
template <typename T> struct Ty;
template <> struct Ty<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
  static __device__ __forceinline__ float hi(uint32_t v) {
    return __uint_as_float(v & 0xffff0000u);
  }
};
template <> struct Ty<__half> {
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
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
};

// Stage chunk rows [c0, c0 + lc) of x, B, C and dA into `buf`: x, B and C
// (unit stride on positions) feature by feature, 16 bytes (8 positions) a
// copy, up to the next 16 rows (zeros past lc); dA for all kLMax rows (0
// past lc).
template <typename T, int N>
__device__ __forceinline__ void load_chunk(const Params& p, unsigned char* buf, const T* xg,
                                           const T* bg, const T* cg, const float* ag, int c0,
                                           int lc) {
  using Lay = Layout<N>;
  // a feature's row of kLMax positions is 32 units; those past the next 16
  // rows are never read, and the ones past lc arrive as zeros
  constexpr int kU = kLMax / 8;
  const int units = ((lc + 15) & ~15) / 8;
  for (int i = threadIdx.x; i < kP * kU; i += kThreads) {
    const int f = i / kU, u = i % kU, n = max(0, min(8, lc - 8 * u));
    if (u < units) cp_async16(buf + swz_t(f, u), n ? xg + f * p.xsp + c0 + 8 * u : xg, 2 * n);
  }
  for (int i = threadIdx.x; i < N * kU; i += kThreads) {
    const int f = i / kU, u = i % kU, n = max(0, min(8, lc - 8 * u));
    if (u >= units) continue;
    cp_async16(buf + Lay::kX + swz_t(f, u), n ? bg + f * p.bsn + c0 + 8 * u : bg, 2 * n);
    cp_async16(buf + Lay::kX + Lay::kB + swz_t(f, u), n ? cg + f * p.csn + c0 + 8 * u : cg,
               2 * n);
  }
  float* a = reinterpret_cast<float*>(buf + Lay::kX + 2 * Lay::kB);
  for (int r = threadIdx.x; r < kLMax; r += kThreads) {
    const bool ok = r < lc;
    cp_async4(a + r, ok ? ag + (long long)(c0 + r) * p.ass : ag, ok ? 4 : 0);
  }
}

// The fragments the products take from the staged tiles, stored feature by
// feature: the operands whose rows are positions are read transposed.
struct Frag {
  // C_i (16 rows from i0, columns 16q..16q+15) as the scores' A fragment
  static __device__ __forceinline__ void c_rows(uint32_t (&r)[4], const unsigned char* cs, int i0,
                                                int q, int lane) {
    ldsm_x4_t(r, cs + swz_t(16 * q + (lane & 7) + ((lane >> 4) << 3),
                            (i0 >> 3) + ((lane >> 3) & 1)));
  }
  // B_j (16 keys from j0, columns 16q..) as the scores' B fragments, two n-tiles
  static __device__ __forceinline__ void b_keys(uint32_t (&r)[4], const unsigned char* bs, int j0,
                                                int q, int lane) {
    ldsm_x4_t(r, bs + swz_t(16 * q + (lane & 7) + (((lane >> 3) & 1) << 3),
                            (j0 >> 3) + (lane >> 4)));
  }
  // x_j (16 keys from j0, p 16pq..16pq+15) as y's B fragments, two n-tiles
  static __device__ __forceinline__ void x_keys(uint32_t (&r)[4], const unsigned char* xs, int j0,
                                                int pq, int lane) {
    ldsm_x4(r, xs + swz_t(16 * pq + (lane & 7) + ((lane >> 4) << 3),
                          (j0 >> 3) + ((lane >> 3) & 1)));
  }
  // x (p from pu0, 16 keys from j0) as the state update's A fragments, two k-steps
  static __device__ __forceinline__ void x_state(uint32_t (&r)[4], const unsigned char* xs, int j0,
                                                 int pu0, int lane) {
    ldsm_x4(r, xs + swz_t(pu0 + (lane & 7) + (((lane >> 3) & 1) << 3), (j0 >> 3) + (lane >> 4)));
  }
  // B (16 keys from j0, n from n0) as the state update's B fragments: two
  // n-tiles of two k-steps each
  static __device__ __forceinline__ void b_state(uint32_t (&r)[4], const unsigned char* bs, int j0,
                                                 int n0, int lane) {
    ldsm_x4(r, bs + swz_t(n0 + (lane & 7) + ((lane >> 4) << 3), (j0 >> 3) + ((lane >> 3) & 1)));
  }
  // the same for one n-tile
  static __device__ __forceinline__ void b_state1(uint32_t (&r)[2], const unsigned char* bs, int j0,
                                                  int n0, int lane) {
    ldsm_x2(r, bs + swz_t(n0 + (lane & 7), (j0 >> 3) + ((lane >> 3) & 1)));
  }
};

// The scores of a 16-row block against the 16 keys from j0: C_i . B_j
// (b, 16 x 16, two n-tiles of 8 keys), fp32 sums of 16-bit products.
template <typename T, int N>
__device__ __forceinline__ void block_scores(float (&sc)[2][4], const uint32_t (&cf)[N / 16][4],
                                             const unsigned char* bs, int j0, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
  for (int q = 0; q < N / 16; ++q) {
    uint32_t bf[4];
    Frag::b_keys(bf, bs, j0, q, lane);
    Ty<T>::mma(sc[0], cf[q], bf[0], bf[1]);
    Ty<T>::mma(sc[1], cf[q], bf[2], bf[3]);
  }
}

// y (16 x 64) += M x_j for the 16 keys from j0, M (the scores times their
// decays) rounded once to T as the A fragments.
template <typename T, int N>
__device__ __forceinline__ void block_apply(float (&y)[8][4], const float (&sc)[2][4],
                                            const unsigned char* xs, int j0, int lane) {
  const uint32_t m[4] = {Ty<T>::pack(sc[0][0], sc[0][1]), Ty<T>::pack(sc[0][2], sc[0][3]),
                         Ty<T>::pack(sc[1][0], sc[1][1]), Ty<T>::pack(sc[1][2], sc[1][3])};
#pragma unroll
  for (int pq = 0; pq < 4; ++pq) {
    uint32_t xf[4];
    Frag::x_keys(xf, xs, j0, pq, lane);
    Ty<T>::mma(y[2 * pq], m, xf[0], xf[1]);
    Ty<T>::mma(y[2 * pq + 1], m, xf[2], xf[3]);
  }
}

// The (hi, lo) split of this warp's part of the state into shared memory.
template <int N>
__device__ __forceinline__ void store_state(unsigned char* s4, const float (&st)[N / 16][4],
                                            int pu0, int nu0, int g, int t) {
#pragma unroll
  for (int i = 0; i < N / 16; ++i) {
    const int u = (nu0 + 8 * i) / 2 + t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t h0, l0, h1, l1;
      split_tf32(st[i][2 * half], h0, l0);
      split_tf32(st[i][2 * half + 1], h1, l1);
      *reinterpret_cast<uint4*>(s4 + state_unit<N>(pu0 + g + 8 * half, u)) =
          make_uint4(h0, h1, l0, l1);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(Params p) {
  using Lay = Layout<N>;
  using X = Ty<T>;
  constexpr int kUT = N / 16;  // n-tiles of 8 in a warp's part of the state
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s4 = smem;
  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (p.H / p.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* xg = static_cast<const T*>(p.x) + b * p.xsb + h * p.xsh;
  const T* bg = static_cast<const T*>(p.B) + b * p.bsb + grp * p.bsg;
  const T* cg = static_cast<const T*>(p.C) + b * p.csb + grp * p.csg;
  const float* ag = p.dA + b * p.asb + h * p.ash;
  T* yg = static_cast<T*>(p.y) + (long long)b * p.S * p.H * kP + (long long)h * kP;
  const long long yrow = (long long)p.H * kP;
  const int nch = (p.S + p.L - 1) / p.L;

  // this warp's part of the state: rows [pu0, pu0 + 16), columns [nu0, nu0 + N / 2)
  const int pu0 = (warp & 3) * 16, nu0 = (warp >> 2) * (N / 2);
  const long long sbase = ((long long)b * p.H + h) * kP * N;
  float st[kUT][4];
#pragma unroll
  for (int i = 0; i < kUT; ++i) {
    const int n = nu0 + 8 * i + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = *reinterpret_cast<const float2*>(p.state0 + sbase +
                                                        (pu0 + g + 8 * half) * N + n);
      st[i][2 * half] = v.x;
      st[i][2 * half + 1] = v.y;
    }
  }
  store_state<N>(s4, st, pu0, nu0, g, t);

  load_chunk<T, N>(p, smem + Lay::kState, xg, bg, cg, ag, 0, min(p.L, p.S));
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    unsigned char* buf = smem + Lay::kState + (c & 1) * Lay::kBuf;
    if (c + 1 < nch) {
      const int c1 = (c + 1) * p.L;
      load_chunk<T, N>(p, smem + Lay::kState + ((c + 1) & 1) * Lay::kBuf, xg, bg, cg, ag,
                             c1, min(p.L, p.S - c1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = c * p.L, lc = min(p.L, p.S - c0);
    const unsigned char* xs = buf;
    const unsigned char* bs = buf + Lay::kX;
    const unsigned char* cs = buf + Lay::kX + Lay::kB;
    float* acum = reinterpret_cast<float*>(buf + Lay::kX + 2 * Lay::kB);

    // the inclusive cumulative sum of dA over the chunk, in fp32
    if (warp == 0) {
      float v[kLMax / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kLMax / 32; ++k) {
        run += acum[lane * (kLMax / 32) + k];
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float before = incl - run;
#pragma unroll
      for (int k = 0; k < kLMax / 32; ++k) acum[lane * (kLMax / 32) + k] = v[k] + before;
    }
    __syncthreads();

    // y: two 16-row blocks a warp, w and 15 - w (a block past a short
    // chunk's end is computed on whatever its rows hold and not written)
    const int nrb = (lc + 15) >> 4;
    const int rbs[2] = {warp, kRowBlocks - 1 - warp};
    uint32_t cf[2][N / 16][4];  // C_i as A fragments, a 16-column step each
    float y[2][8][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int q = 0; q < N / 16; ++q)
        Frag::c_rows(cf[pass][q], cs, 16 * rbs[pass], q, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        y[pass][nt][0] = y[pass][nt][1] = y[pass][nt][2] = y[pass][nt][3] = 0.f;
    }
    // C_i . state in TF32 for both blocks at once (one read of the state),
    // the state as hi + lo; the state's column k order is permuted (slot t =
    // column 2t, slot t + 4 = column 2t + 1) on both operands, which the sum
    // over k does not see
#pragma unroll
    for (int ks = 0; ks < N / 8; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const uint32_t r0 = cf[pass][ks >> 1][2 * (ks & 1)];
        const uint32_t r1 = cf[pass][ks >> 1][2 * (ks & 1) + 1];
        a[pass][0] = __float_as_uint(X::lo(r0));
        a[pass][1] = __float_as_uint(X::lo(r1));
        a[pass][2] = __float_as_uint(X::hi(r0));
        a[pass][3] = __float_as_uint(X::hi(r1));
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint4 v = *reinterpret_cast<const uint4*>(s4 + state_unit<N>(8 * nt + g,
                                                                             4 * ks + t));
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
          mma_tf32(y[pass][nt], a[pass], v.z, v.w);
          mma_tf32(y[pass][nt], a[pass], v.x, v.y);
        }
      }
    }
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int rb = rbs[pass];
      if (rb >= nrb) continue;
      const int i0 = rb * 16;
      // With r the block's first row, exp(a_i - a_j) = exp(a_i - a_r) exp(a_r - a_j)
      // for the keys before the block, both factors at most 1: the keys'
      // factors multiply the scores, the rows' the sum at the end, and the
      // state's share, exp(a_i) = exp(a_i - a_r) exp(a_r), takes the rows'
      // with it.  The diagonal block takes exp(a_i - a_j) whole.
      const float ar = acum[i0], ai0 = acum[i0 + g], ai1 = acum[i0 + g + 8];
      const float er = expf(ar);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[pass][nt][e] *= er;
      float sc[2][4];
#pragma unroll 2
      for (int kb = 0; kb < rb; ++kb) {
        const int j0 = kb * 16;
        block_scores<T, N>(sc, cf[pass], bs, j0, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 aj = *reinterpret_cast<const float2*>(acum + j0 + 8 * nt + 2 * t);
          const float k0 = __expf(ar - aj.x), k1 = __expf(ar - aj.y);
          sc[nt][0] *= k0;
          sc[nt][1] *= k1;
          sc[nt][2] *= k0;
          sc[nt][3] *= k1;
        }
        block_apply<T, N>(y[pass], sc, xs, j0, lane);
      }
      const float f0 = expf(ai0 - ar), f1 = expf(ai1 - ar);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        y[pass][nt][0] *= f0;
        y[pass][nt][1] *= f0;
        y[pass][nt][2] *= f1;
        y[pass][nt][3] *= f1;
      }
      block_scores<T, N>(sc, cf[pass], bs, i0, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = i0 + 8 * nt + 2 * t, ia = i0 + g, ib = i0 + g + 8;
        const float2 aj = *reinterpret_cast<const float2*>(acum + j);
        sc[nt][0] = j <= ia ? sc[nt][0] * __expf(ai0 - aj.x) : 0.f;
        sc[nt][1] = j + 1 <= ia ? sc[nt][1] * __expf(ai0 - aj.y) : 0.f;
        sc[nt][2] = j <= ib ? sc[nt][2] * __expf(ai1 - aj.x) : 0.f;
        sc[nt][3] = j + 1 <= ib ? sc[nt][3] * __expf(ai1 - aj.y) : 0.f;
      }
      block_apply<T, N>(y[pass], sc, xs, i0, lane);
      // y rounded once to the input's type
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + g + 8 * half;
        if (i >= lc) continue;
        T* row = yg + (long long)(c0 + i) * yrow;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<uint32_t*>(row + 8 * nt + 2 * t) =
              X::pack(y[pass][nt][2 * half], y[pass][nt][2 * half + 1]);
      }
    }
    __syncthreads();

    // the state after the chunk: state exp(a_last) + sum_j (x_j exp(a_last - a_j))^T B_j,
    // the keys' order within each 8 permuted on both operands as above; the
    // decays exp(a_last - a_j) replace the cumulative sums in shared memory
    const float alast = acum[lc - 1];
    const float dec = expf(alast);
    __syncthreads();
    for (int j = threadIdx.x; j < kLMax; j += kThreads) acum[j] = expf(alast - acum[j]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kUT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] *= dec;
    const int rows = (lc + 15) & ~15;
#pragma unroll 2
    for (int j0 = 0; j0 < rows; j0 += 16) {
      uint32_t xa[4];
      Frag::x_state(xa, xs, j0, pu0, lane);
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int k8 = 0; k8 < 2; ++k8) {
        const float2 d = *reinterpret_cast<const float2*>(acum + j0 + 8 * k8 + 2 * t);
        const uint32_t m0 = xa[2 * k8], m1 = xa[2 * k8 + 1];
        split_tf32(X::lo(m0) * d.x, ahi[k8][0], alo[k8][0]);
        split_tf32(X::lo(m1) * d.x, ahi[k8][1], alo[k8][1]);
        split_tf32(X::hi(m0) * d.y, ahi[k8][2], alo[k8][2]);
        split_tf32(X::hi(m1) * d.y, ahi[k8][3], alo[k8][3]);
      }
      if constexpr (kUT == 1) {
        uint32_t bb[2];
        Frag::b_state1(bb, bs, j0, nu0, lane);
#pragma unroll
        for (int k8 = 0; k8 < 2; ++k8) {
          const uint32_t b0 = __float_as_uint(X::lo(bb[k8])), b1 = __float_as_uint(X::hi(bb[k8]));
          mma_tf32(st[0], alo[k8], b0, b1);
          mma_tf32(st[0], ahi[k8], b0, b1);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kUT; i += 2) {
          uint32_t bb[4];
          Frag::b_state(bb, bs, j0, nu0 + 8 * i, lane);
#pragma unroll
          for (int k8 = 0; k8 < 2; ++k8) {
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const uint32_t v = bb[2 * s + k8];
              const uint32_t b0 = __float_as_uint(X::lo(v)), b1 = __float_as_uint(X::hi(v));
              mma_tf32(st[i + s], alo[k8], b0, b1);
              mma_tf32(st[i + s], ahi[k8], b0, b1);
            }
          }
        }
      }
    }
    if (c + 1 < nch) {
      store_state<N>(s4, st, pu0, nu0, g, t);
    } else {
#pragma unroll
      for (int i = 0; i < kUT; ++i) {
        const int n = nu0 + 8 * i + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(p.state + sbase + (pu0 + g + 8 * half) * N + n) =
              make_float2(st[i][2 * half], st[i][2 * half + 1]);
      }
    }
    __syncthreads();
  }
}

template <typename T, int N>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = Layout<N>::kBytes;
  cudaError_t rc = cudaFuncSetAttribute(ssd_scan_kernel<T, N>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  ssd_scan_kernel<T, N><<<dim3(p.H, batch), kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (x, B, C and y); dA, state0 and state in
// fp32.  x (b, s, h, 64) and B and C (b, s, g, n) have a unit stride on
// positions, as the model's conv output lies, and take element strides for
// the other dims (batch, head or group, feature); dA (b, s, h) takes them for
// every dim.  x's, B's and C's bases and strides are 16-byte aligned (the
// wrapper checks), and L is a multiple of 8: 8 positions are one 16-byte copy.
// state0, y and state are contiguous.  Chunks of L <= 256 rows, the last one
// s - (chunks - 1) L.  One launch; returns the CUDA error.
extern "C" int repro_ssd_scan(const void* x, const void* dA, const void* B, const void* C,
                              const void* state0, void* y, void* state, int dtype, int batch,
                              int S, int H, int G, int N, int L, long long xsb, long long xsh,
                              long long xsp, long long asb, long long ass, long long ash,
                              long long bsb, long long bsg, long long bsn, long long csb,
                              long long csg, long long csn, void* stream) {
  if (batch <= 0 || S <= 0 || G <= 0 || H % G != 0 || L <= 0 || L > kLMax || L % 8)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dA), B, C, static_cast<const float*>(state0), y,
           static_cast<float*>(state), S, H, G, L, xsb, xsh, xsp, asb, ass, ash,
           bsb, bsg, bsn, csb, csg, csn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the state sizes compiled: kernel.py's STATE_SIZES
  if (dtype == 1 && N == 16) return launch<__nv_bfloat16, 16>(p, batch, s);
  if (dtype == 1 && N == 64) return launch<__nv_bfloat16, 64>(p, batch, s);
  if (dtype == 2 && N == 16) return launch<__half, 16>(p, batch, s);
  if (dtype == 2 && N == 64) return launch<__half, 64>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}
