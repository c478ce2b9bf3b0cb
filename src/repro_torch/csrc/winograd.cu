// Winograd F(2x2, 3x3) transform-domain convolution on pre-extracted tiles,
// for Hopper (sm_90a), computed in fp32.
//
// Replaces: src/repro/kernels/winograd/kernel.py, `winograd_tiles` (Pallas
// body `_wino_kernel`): per 4x4 input tile V = B^T d B, then at each of the
// 16 transform positions a (tiles x cin) @ (cin x cout) contraction with
// U = G w G^T, then Y = A^T M A.  tiles (b,th,tw,4,4,cin) and U (4,4,cin,cout)
// give Y (b,th,tw,2,2,cout).
//
// What bounds it on this card: at the section V case-study shape (x 64x28x28x16,
// w 3x3x16x32) there are 12,544 tiles; the kernel reads about 12.8 MB of
// pre-extracted tiles and writes 6.4 MB of output for 0.21 GFLOP of
// contraction, so at 3.35 TB/s and 67 TFLOP/s (fp32, no tensor cores) it is
// bound by bytes.  Fusing the tile extraction so the kernel reads x (3.2 MB)
// directly is later work.
//
// Design: the Pallas kernel loads the whole U into every grid step; that
// cannot be copied, since at cin = cout = 64 in fp32 U alone is 256 KiB,
// more than the 227 KB of shared memory a block can have.  Instead the grid
// is (tile blocks of 32, output-channel blocks of 32): cout is tiled over the
// grid, and cin is walked in chunks of 8.  Per chunk, each thread transforms
// one (tile, channel) pair's 4x4 input into V and stages it in shared memory,
// the block stages the matching 16 x 8 x 32 slab of U, and every thread
// accumulates the 16 transform positions of 4 (tile, output channel) pairs
// in registers.  The output transform runs on those registers and writes
// consecutive output channels from consecutive threads.  33 KB of static
// shared memory per block.  Simple and right first: no tensor cores yet.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTiles = 32;  // tiles per block
constexpr int kCout = 32;   // output channels per block
constexpr int kCin = 8;     // input channels per shared-memory stage
constexpr int kTilesPerThread = kTiles * kCout / kThreads;  // 4

__global__ void __launch_bounds__(kThreads)
wino_kernel(const float* __restrict__ tiles, const float* __restrict__ u,
            float* __restrict__ out, long long T, int cin, int cout) {
  __shared__ float Vs[16][kCin][kTiles + 1];
  __shared__ float Us[16][kCin][kCout];

  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kTiles;
  const int co0 = blockIdx.y * kCout;
  const int co = tid % kCout;  // this thread's output channel in the block
  const int tr = tid / kCout;  // its tiles are tr + 8 * r, r < 4

  float acc[kTilesPerThread][16];
#pragma unroll
  for (int r = 0; r < kTilesPerThread; ++r)
#pragma unroll
    for (int p = 0; p < 16; ++p) acc[r][p] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCin) {
    {  // input transform V = B^T d B of one (tile, channel) pair
      const int c = tid % kCin;
      const int t = tid / kCin;
      const long long gt = t0 + t;
      const int gc = c0 + c;
      float d[4][4];
      if (gt < T && gc < cin) {
        const float* src = tiles + gt * 16 * cin + gc;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] = src[(i * 4 + j) * cin];
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
      }
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
        Vs[i * 4 + 0][c][t] = m[i][0] - m[i][2];
        Vs[i * 4 + 1][c][t] = m[i][1] + m[i][2];
        Vs[i * 4 + 2][c][t] = m[i][2] - m[i][1];
        Vs[i * 4 + 3][c][t] = m[i][1] - m[i][3];
      }
    }
    for (int e = tid; e < 16 * kCin * kCout; e += kThreads) {
      const int col = e % kCout;
      const int c = (e / kCout) % kCin;
      const int p = e / (kCout * kCin);
      const int gc = c0 + c;
      const int gco = co0 + col;
      Us[p][c][col] = (gc < cin && gco < cout)
                          ? u[((long long)p * cin + gc) * cout + gco] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kCin; ++c) {
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const float uv = Us[p][c][co];
#pragma unroll
        for (int r = 0; r < kTilesPerThread; ++r)
          acc[r][p] = fmaf(Vs[p][c][tr + 8 * r], uv, acc[r][p]);
      }
    }
    __syncthreads();
  }

  const int gco = co0 + co;
#pragma unroll
  for (int r = 0; r < kTilesPerThread; ++r) {
    const long long gt = t0 + tr + 8 * r;
    if (gt >= T || gco >= cout) continue;
    float a[2][4];  // A^T M
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[0][k] = acc[r][0 * 4 + k] + acc[r][1 * 4 + k] + acc[r][2 * 4 + k];
      a[1][k] = acc[r][1 * 4 + k] - acc[r][2 * 4 + k] - acc[r][3 * 4 + k];
    }
    float* dst = out + gt * 4 * cout + gco;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // (A^T M) A
      dst[(i * 2 + 0) * cout] = a[i][0] + a[i][1] + a[i][2];
      dst[(i * 2 + 1) * cout] = a[i][1] - a[i][2] - a[i][3];
    }
  }
}

}  // namespace

// tiles: T x 16 x cin, u: 16 x cin x cout, out: T x 4 x cout, all fp32 and
// contiguous.  Returns 0 or a cudaError_t code.
extern "C" int repro_winograd_tiles(const void* tiles, const void* u, void* out,
                                    long long T, int cin, int cout,
                                    void* stream) {
  dim3 grid((unsigned)((T + kTiles - 1) / kTiles),
            (unsigned)((cout + kCout - 1) / kCout));
  wino_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tiles), static_cast<const float*>(u),
      static_cast<float*>(out), T, cin, cout);
  return (int)cudaGetLastError();
}
