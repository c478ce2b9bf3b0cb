// Winograd F(2x2, 3x3) convolution for Hopper (sm_90a): one launch from an
// NHWC input x to an NHWC output y, fp32 or bf16 in and out, fp32 inside.
//
// Replaces: src/repro/kernels/winograd/kernel.py, `winograd_tiles` (Pallas
// body `_wino_kernel`): per 4x4 input tile V = B^T d B, then at each of the
// 16 transform positions a (tiles x cin) @ (cin x cout) contraction with
// U = G w G^T, then Y = A^T M A.  The reference wrapper extracts the
// overlapping tiles and reassembles the output with XLA around the kernel.
// Here one device body serves two entry points:
//   * image mode (`repro_winograd_conv`): reads x (b,H,W,cin) NHWC with any
//     strides whose channel stride is 1, and writes y (b,oh,ow,cout) NHWC.
//     The tile at (i, j) starts at row 2i - pad and column 2j - pad; pixels
//     outside the image (the SAME halo, the ragged last tile) are zeros.
//   * tiles mode (`repro_winograd_tiles`): exactly the TPU kernel's function,
//     tiles (T,4,4,cin) and U (4,4,cin,cout) to (T,2,2,cout).
//
// What bounds it on this card.  At the section V case study (x 64x28x28x16,
// w 3x3x16x32, SAME) the function moves 9.65 MB (x once, y once, U) against
// 0.21 GFLOP of contraction: 2.88 us of bytes at 3.35 TB/s, 0.42 us of
// operations at TF32's 495 TFLOP/s, so bytes bound it.  At a ResNet-50
// conv2_x layer (x 32x56x56x64, w 3x3x64x64) it moves 51.5 MB (15.4 us)
// for 3.29 GFLOP (6.8 us at 495 TFLOP/s): bytes again, but the three TF32
// products that fp32 needs (below) are 9.9 GFLOP of tensor-core work, 20 us
// at the TF32 peak, so there the tensor cores' issue rate is the kernel's
// own floor.
//
// What the design does about it:
// * No tile tensor: a block reads the halo box of a patch of 32 output tiles
//   (2 x 16, 4 x 8, 8 x 4 or 16 x 2, chosen by the launcher to waste the
//   fewest tiles) straight from x, so x is read about once from device
//   memory (the boxes of neighbouring patches overlap by two pixels, read
//   again from L2), where the unfused program wrote 4x x's bytes of tiles
//   and read them back.  y is written in place, so nothing reassembles it.
// * A cp.async ring of 2 stages over cin, 32 bytes of channels a pixel a
//   chunk (8 fp32, 16 bf16): one chunk's halo and U slab are in flight
//   while the previous chunk is transformed and multiplied.  16-byte copies
//   where x's pixel rows (and U's rows) are 16-byte aligned, 4-byte copies
//   (fp32) or plain loads (bf16) otherwise, as for cin = 3.  Pixels outside
//   the image and channels past cin are zero-filled by the copy's source
//   size, with no branch around the copy.
// * The input transform writes V for the chunk to shared memory in the A
//   operand layout of the tensor-core product.  Each of the 8 warps then
//   runs two of the 16 positions' products (`mma.sync`) over the whole
//   block, 32 tiles x 32 couts: every V and U fragment is loaded from shared
//   memory and split by one warp only, and a warp has 8 independent
//   accumulator chains.  (A warp owning one 16 x 8 fragment for all 16
//   positions, so that the output transform needs no shared memory, had
//   each V fragment loaded and split by 4 warps and each U fragment by 2,
//   and was bound by those loads and splits.)  After the last chunk M goes
//   through shared memory once, and the output transform stores the 2x2
//   outputs straight to y, consecutive threads on consecutive couts,
//   masking those past oh, ow and cout.
// * fp32 runs 3xTF32: a = a_hi + a_lo with a_hi = tf32(a) (the low 13
//   mantissa bits masked) and a_lo = a - a_hi (read by the tensor core as
//   TF32), then a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small ones first), which
//   keeps the error at fp32's order where plain TF32 would break 1e-4.
//   bf16: U is exact in bf16, so only V is split into bf16 hi + lo, two
//   m16n8k16 products accumulating in fp32.
// * No atomics and no sum across blocks: a second call gives the same bits.
// Shared memory: 83 KB (fp32) or 107 KB (bf16) a block in image mode, so
// two blocks of 256 threads share an SM; registers are capped at 128 a
// thread for the same reason (64 of them hold the accumulators).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 8 warps: 2 tile x 4 cout fragments
constexpr int kTiles = 32;                 // output tiles a block (the M side)
constexpr int kCout = 32;                  // output channels a block (the N side)
constexpr int kStages = 2;                 // depth of the cp.async ring
constexpr int kRawRow = 48;                // bytes a staged pixel: 32 of channels, 16 of pad
constexpr int kHaloMax = 6 * 34;           // pixels of the largest halo box (2x16 tiles)
constexpr int kTilePix = kTiles * 16;      // tiles mode: 16 pixels a tile, none shared
constexpr int kURow = kCout + 8;           // elements a staged U row, padded
constexpr int kVRow = 12;                  // 32-bit words a staged V row (tile), padded
constexpr int kMRow = kCout + 8;           // floats a row of M in shared memory, padded

template <typename T>
struct Cfg {
  static constexpr int kEpu = 16 / (int)sizeof(T);     // elements in 16 bytes
  static constexpr int kChunk = 32 / (int)sizeof(T);   // input channels a chunk
  static constexpr int kUBytes = 16 * kChunk * kURow * (int)sizeof(T);
  // fp32: one V array; bf16: its hi and lo halves
  static constexpr int kVBytes = 16 * kTiles * kVRow * 4 * (sizeof(T) == 4 ? 1 : 2);
};

template <typename T, bool kImage>
constexpr int smem_bytes() {
  return kStages * ((kImage ? kHaloMax : kTilePix) * kRawRow + Cfg<T>::kUBytes) +
         Cfg<T>::kVBytes;
}
// after the cin loop the block's M (16 positions x tiles x padded couts,
// fp32) reuses the ring and V
static_assert(16 * kTiles * kMRow * 4 <= smem_bytes<float, true>(), "M does not fit");

// What a launch reads and writes.
struct Geometry {
  const void* x;          // image: x (b,H,W,cin); tiles: (T,16,cin)
  const void* u;          // (16, cin, cout), contiguous
  void* y;                // image: (b,oh,ow,cout); tiles: (T,4,cout); contiguous
  long long sb, sh, sw;   // image: x's strides in elements (channel stride 1)
  long long n_tiles;      // tiles mode: T
  int H, W, cin, cout, pad, oh, ow;
  int tw_patch;           // image: tiles a patch row (th_patch = kTiles / tw_patch)
  int halo_w;             // image: pixels a halo row, 2 * tw_patch + 2
  int n_pix;              // pixels staged a chunk: the halo box, or kTilePix
  int n_pr, n_pc, n_cb;   // patches down and across an image; cout blocks
  int x_vec, u_vec;       // 16-byte copies of x's and U's channel runs
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of `size` bytes whose first `n` bytes come from src, the rest zeros
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
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage 16 bytes of one row whose first n elements come from src (src is a
// valid address even when n = 0), the rest zeros.
template <typename T>
__device__ __forceinline__ void copy_unit(void* dst, const T* src, int n, int vec) {
  constexpr int kEpu = Cfg<T>::kEpu;
  if (vec) {
    cp_async16(dst, src, n * (int)sizeof(T));
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < kEpu; ++i)
      cp_async4(static_cast<char*>(dst) + 4 * i, src + (i < n ? i : 0), i < n ? 4 : 0);
  } else {  // bf16 rows off a 4-byte boundary (odd cin): plain loads
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short* d = static_cast<unsigned short*>(dst);
#pragma unroll
    for (int i = 0; i < kEpu; ++i) d[i] = i < n ? s[i] : 0;
  }
}

// a = hi + lo with hi = a's top 11 significant bits (a TF32 value, its low
// 13 mantissa bits masked) and lo = a - hi, exact in fp32.  The tensor core
// reads lo as TF32 too, dropping its low 13 bits: an error of at most
// 2^-10 of lo, 2^-20 of a.  Two instructions, where cvt.rna.tf32.f32 is
// emulated in four.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// B operand of m16n8k16 from a row-major (k x n) bf16 tile: rows k = lane % 16
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* b, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_u32(row)));
}

// V = B^T d B of one 4x4 window: v[i * 4 + l] at transform position (i, l)
__device__ __forceinline__ void input_transform(const float (&d)[4][4], float (&v)[16]) {
  float m[4][4];  // B^T d
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[0][j] = d[0][j] - d[2][j];
    m[1][j] = d[1][j] + d[2][j];
    m[2][j] = d[2][j] - d[1][j];
    m[3][j] = d[1][j] - d[3][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // (B^T d) B
    v[i * 4 + 0] = m[i][0] - m[i][2];
    v[i * 4 + 1] = m[i][1] + m[i][2];
    v[i * 4 + 2] = m[i][2] - m[i][1];
    v[i * 4 + 3] = m[i][1] - m[i][3];
  }
}

// Y = A^T M A of one (tile, cout): m[i * 4 + l] at transform position (i, l)
__device__ __forceinline__ void output_transform(const float (&m)[16], float (&y)[2][2]) {
  float a[2][4];  // A^T M
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[0][k] = m[0 * 4 + k] + m[1 * 4 + k] + m[2 * 4 + k];
    a[1][k] = m[1 * 4 + k] - m[2 * 4 + k] - m[3 * 4 + k];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // (A^T M) A
    y[i][0] = a[i][0] + a[i][1] + a[i][2];
    y[i][1] = a[i][1] - a[i][2] - a[i][3];
  }
}

template <typename T> __device__ __forceinline__ void store1(T* p, float v);
template <> __device__ __forceinline__ void store1<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void store1<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
template <typename T, bool kImage>
__global__ void __launch_bounds__(kThreads, 2) wino_kernel(const Geometry g) {
  using C = Cfg<T>;
  constexpr int kRawBytes = (kImage ? kHaloMax : kTilePix) * kRawRow;
  constexpr int kStageBytes = kRawBytes + C::kUBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* vsm = smem + kStages * kStageBytes;

  const T* X = static_cast<const T*>(g.x);
  const T* U = static_cast<const T*>(g.u);
  T* Y = static_cast<T*>(g.y);
  const int tid = threadIdx.x;
  const int cb = blockIdx.x % g.n_cb;
  const long long patch = blockIdx.x / g.n_cb;
  const int n0 = cb * kCout;
  // image: the patch's image, first tile row and column, and halo origin
  int b = 0, ti0 = 0, tj0 = 0;
  long long t0 = 0;  // tiles: the block's first tile
  if constexpr (kImage) {
    tj0 = (int)(patch % g.n_pc) * g.tw_patch;
    ti0 = (int)((patch / g.n_pc) % g.n_pr) * (kTiles / g.tw_patch);
    b = (int)(patch / ((long long)g.n_pc * g.n_pr));
  } else {
    t0 = patch * kTiles;
  }
  const int y0 = 2 * ti0 - g.pad, x0 = 2 * tj0 - g.pad;

  // this thread's x copies, the same pixels in every chunk: the element
  // offset of each one's channel 0 (plus its 16-byte unit), or -1 when it
  // lies outside the image or past the staged pixels
  constexpr int kXItems = ((kImage ? kHaloMax : kTilePix) * 2 + kThreads - 1) / kThreads;
  long long xoff[kXItems];
#pragma unroll
  for (int i = 0; i < kXItems; ++i) {
    const int e = tid + i * kThreads;
    const int pix = e >> 1, unit = (e & 1) * C::kEpu;
    xoff[i] = -1;
    if (e < g.n_pix * 2) {
      if constexpr (kImage) {
        const int gy = y0 + pix / g.halo_w, gx = x0 + pix % g.halo_w;
        if (gy >= 0 && gy < g.H && gx >= 0 && gx < g.W)
          xoff[i] = b * g.sb + gy * g.sh + gx * g.sw + unit;
      } else {
        const long long gt = t0 + pix / 16;
        if (gt < g.n_tiles) xoff[i] = (gt * 16 + pix % 16) * g.cin + unit;
      }
    }
  }

  auto load_chunk = [&](int stage, int c0) {
    unsigned char* raw = smem + stage * kStageBytes;
    T* us = reinterpret_cast<T*>(raw + kRawBytes);
#pragma unroll
    for (int i = 0; i < kXItems; ++i) {  // two 16-byte units a pixel
      const int e = tid + i * kThreads;
      if (e >= g.n_pix * 2) break;
      const int ch = c0 + (e & 1) * C::kEpu;
      const int n = xoff[i] >= 0 ? max(0, min(C::kEpu, g.cin - ch)) : 0;
      copy_unit<T>(raw + (e >> 1) * kRawRow + (e & 1) * 16, n ? X + xoff[i] + c0 : X, n,
                   g.x_vec);
    }
    constexpr int kUnits = kCout / C::kEpu;  // 16-byte units a U row
#pragma unroll
    for (int e = tid; e < 16 * C::kChunk * kUnits; e += kThreads) {
      const int unit = e % kUnits;
      const int k = (e / kUnits) % C::kChunk;
      const int p = e / (kUnits * C::kChunk);
      const int gk = c0 + k, gn = n0 + unit * C::kEpu;
      const int n = gk < g.cin ? max(0, min(C::kEpu, g.cout - gn)) : 0;
      const T* src = U + ((long long)p * g.cin + gk) * g.cout + gn;
      copy_unit<T>(us + (p * C::kChunk + k) * kURow + unit * C::kEpu, n ? src : U, n,
                   g.u_vec);
    }
  };

  // this thread's (tile, channel) of the input transform: fp32 one channel,
  // bf16 a pair of channels (one 32-bit word)
  const int tt = tid >> 3, tc = tid & 7;
  const int win = kImage ? 2 * (tt / g.tw_patch) * g.halo_w + 2 * (tt % g.tw_patch) : tt * 16;
  const int win_row = kImage ? g.halo_w : 4;
  // this warp's transform positions 2 * warp and 2 * warp + 1, over the
  // block's 32 tiles (2 m16 fragments) and 32 couts (4 n8 fragments);
  // lane (gr, q)
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, q = lane & 3;

  float acc[2][2][4][4];  // [position][m fragment][n fragment][element]
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pp][mf][nf][e] = 0.f;

  const int n_chunks = (g.cin + C::kChunk - 1) / C::kChunk;
  if (n_chunks > 0) load_chunk(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) load_chunk((ch + 1) % kStages, (ch + 1) * C::kChunk);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const unsigned char* raw = smem + (ch % kStages) * kStageBytes;
    const T* us = reinterpret_cast<const T*>(raw + kRawBytes);

    // input transform of the chunk into V, in the A operand's layout:
    // V[p][tile][k], kVRow words a tile
    if constexpr (sizeof(T) == 4) {
      float d[4][4], v[16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d[i][j] = reinterpret_cast<const float*>(raw + (win + i * win_row + j) * kRawRow)[tc];
      input_transform(d, v);
      float* vs = reinterpret_cast<float*>(vsm);
#pragma unroll
      for (int p = 0; p < 16; ++p) vs[(p * kTiles + tt) * kVRow + tc] = v[p];
    } else {
      float d0[4][4], d1[4][4], v0[16], v1[16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
              raw + (win + i * win_row + j) * kRawRow)[tc]);
          d0[i][j] = f.x;
          d1[i][j] = f.y;
        }
      input_transform(d0, v0);
      input_transform(d1, v1);
      __nv_bfloat162* vh = reinterpret_cast<__nv_bfloat162*>(vsm);
      __nv_bfloat162* vl = vh + 16 * kTiles * kVRow;
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0[p], v1[p]);
        const float2 h = __bfloat1622float2(hi);
        vh[(p * kTiles + tt) * kVRow + tc] = hi;
        vl[(p * kTiles + tt) * kVRow + tc] = __floats2bfloat162_rn(v0[p] - h.x, v1[p] - h.y);
      }
    }
    __syncthreads();

    // this warp's two positions' products: every V and U fragment of the
    // chunk is loaded (and split) by one warp only.  Each sweep issues one
    // product into each of the 8 accumulators, so no product waits on the
    // one before it; fragments past cout multiply U's zero fill.
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int p = 2 * warp + pp;
      if constexpr (sizeof(T) == 4) {
        const float* vs = reinterpret_cast<const float*>(vsm);
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          const float* ub = us + (p * C::kChunk + q) * kURow + nf * 8 + gr;
          split_tf32(ub[0], bh[nf][0], bl[nf][0]);
          split_tf32(ub[4 * kURow], bh[nf][1], bl[nf][1]);
        }
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const float* va = vs + (p * kTiles + mf * 16 + gr) * kVRow + q;
          const float a[4] = {va[0], va[8 * kVRow], va[4], va[8 * kVRow + 4]};
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[mf][i], al[mf][i]);
        }
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) mma_tf32(acc[pp][mf][nf], al[mf], bh[nf]);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) mma_tf32(acc[pp][mf][nf], ah[mf], bl[nf]);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) mma_tf32(acc[pp][mf][nf], ah[mf], bh[nf]);
      } else {
        const uint32_t* vh = reinterpret_cast<const uint32_t*>(vsm);
        const uint32_t* vl = vh + 16 * kTiles * kVRow;
        uint32_t ah[2][4], al[2][4], bb[4][2];
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
          ldmatrix_x2_trans(bb[nf], us + (p * C::kChunk + (lane & 15)) * kURow + nf * 8);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const int o = (p * kTiles + mf * 16 + gr) * kVRow + q;
          const int off[4] = {o, o + 8 * kVRow, o + 4, o + 8 * kVRow + 4};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[mf][i] = vh[off[i]];
            al[mf][i] = vl[off[i]];
          }
        }
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) mma_bf16(acc[pp][mf][nf], al[mf], bb[nf]);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) mma_bf16(acc[pp][mf][nf], ah[mf], bb[nf]);
      }
    }
    __syncthreads();  // V and this stage are free for the next chunk
  }

  // M through shared memory, once a block: M[p][tile][cout]; accumulator
  // element e of a fragment is tile gr + 8 * (e / 2), cout 2q + (e % 2)
  float* ms = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              ms + ((2 * warp + pp) * kTiles + mf * 16 + gr + 8 * h) * kMRow + nf * 8 + 2 * q) =
              make_float2(acc[pp][mf][nf][2 * h], acc[pp][mf][nf][2 * h + 1]);
  __syncthreads();

  // the output transform of 4 (tile, cout) pairs a thread, consecutive
  // threads on consecutive couts of one pixel; outputs past oh, ow and
  // cout are not stored
  const int c = tid & 31, co = n0 + c;
  if (co >= g.cout) return;
#pragma unroll
  for (int j = 0; j < kTiles * kCout / kThreads; ++j) {
    const int t = (tid >> 5) + j * (kThreads / kCout);
    float m[16], y[2][2];
#pragma unroll
    for (int p = 0; p < 16; ++p) m[p] = ms[(p * kTiles + t) * kMRow + c];
    output_transform(m, y);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        long long off;
        if constexpr (kImage) {
          const int oy = 2 * (ti0 + t / g.tw_patch) + dy;
          const int ox = 2 * (tj0 + t % g.tw_patch) + dx;
          if (oy >= g.oh || ox >= g.ow) continue;
          off = (((long long)b * g.oh + oy) * g.ow + ox) * g.cout + co;
        } else {
          const long long gt = t0 + t;
          if (gt >= g.n_tiles) continue;
          off = (gt * 4 + dy * 2 + dx) * g.cout + co;
        }
        store1<T>(Y + off, y[dy][dx]);
      }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kImage>
int launch_t(const Geometry& g, long long blocks, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T, kImage>();
  cudaError_t err = cudaFuncSetAttribute(wino_kernel<T, kImage>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  wino_kernel<T, kImage><<<(unsigned)blocks, kThreads, kSmem, stream>>>(g);
  return (int)cudaGetLastError();
}

int launch(int dtype, bool image, const Geometry& g, long long blocks, void* stream) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return image ? launch_t<float, true>(g, blocks, s) : launch_t<float, false>(g, blocks, s);
  if (dtype == 1)
    return image ? launch_t<__nv_bfloat16, true>(g, blocks, s)
                 : launch_t<__nv_bfloat16, false>(g, blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory a block of one instance takes: dtype 0 fp32, 1 bf16;
// image 1 for the conv entry, 0 for the tiles entry.
extern "C" int repro_winograd_smem_bytes(int dtype, int image) {
  if (dtype == 0) return image ? smem_bytes<float, true>() : smem_bytes<float, false>();
  return image ? smem_bytes<__nv_bfloat16, true>() : smem_bytes<__nv_bfloat16, false>();
}

// Image mode: x (B,H,W,cin) with element strides sb, sh, sw and channel
// stride 1; u (16,cin,cout) and y (B,oh,ow,cout) contiguous, where
// oh = H + 2*pad - 2, ow = W + 2*pad - 2.  Patches of 32 tiles, tw_patch
// across (2, 4, 8 or 16).  Returns 0 or a cudaError_t code.
extern "C" int repro_winograd_conv(int dtype, const void* x, const void* u, void* y, int B,
                                   int H, int W, int cin, int cout, long long sb,
                                   long long sh, long long sw, int pad, int tw_patch,
                                   void* stream) {
  if (tw_patch != 2 && tw_patch != 4 && tw_patch != 8 && tw_patch != 16)
    return (int)cudaErrorInvalidValue;
  const long long es = dtype == 0 ? 4 : 2;
  Geometry g{};
  g.x = x, g.u = u, g.y = y;
  g.sb = sb, g.sh = sh, g.sw = sw;
  g.H = H, g.W = W, g.cin = cin, g.cout = cout, g.pad = pad;
  g.oh = H + 2 * pad - 2, g.ow = W + 2 * pad - 2;
  const int th = (g.oh + 1) / 2, tw = (g.ow + 1) / 2;
  const int th_patch = kTiles / tw_patch;
  g.tw_patch = tw_patch;
  g.halo_w = 2 * tw_patch + 2;
  g.n_pix = (2 * th_patch + 2) * g.halo_w;
  g.n_pr = (th + th_patch - 1) / th_patch;
  g.n_pc = (tw + tw_patch - 1) / tw_patch;
  g.n_cb = (cout + kCout - 1) / kCout;
  // a stride of a dim of extent 1 is never stepped
  g.x_vec = aligned16(x) && (B == 1 || (sb * es) % 16 == 0) &&
            (H == 1 || (sh * es) % 16 == 0) && (W == 1 || (sw * es) % 16 == 0);
  g.u_vec = aligned16(u) && (cout * es) % 16 == 0;
  return launch(dtype, true, g, (long long)B * g.n_pr * g.n_pc * g.n_cb, stream);
}

// Tiles mode, the TPU kernel's function: tiles (T,16,cin), u (16,cin,cout)
// -> out (T,4,cout), all contiguous.  Returns 0 or a cudaError_t code.
extern "C" int repro_winograd_tiles(int dtype, const void* tiles, const void* u, void* out,
                                    long long T, int cin, int cout, void* stream) {
  const long long es = dtype == 0 ? 4 : 2;
  Geometry g{};
  g.x = tiles, g.u = u, g.y = out;
  g.n_tiles = T, g.cin = cin, g.cout = cout;
  g.n_pix = kTilePix;
  g.n_cb = (cout + kCout - 1) / kCout;
  g.x_vec = aligned16(tiles) && (cin * es) % 16 == 0;
  g.u_vec = aligned16(u) && (cout * es) % 16 == 0;
  return launch(dtype, false, g, (T + kTiles - 1) / kTiles * g.n_cb, stream);
}
