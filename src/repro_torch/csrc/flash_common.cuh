// Hopper building blocks shared by the flash-attention kernels
// (`flash_attention.cu`, the forward, and `flash_attention_bwd.cu`, the
// backward): mbarriers, TMA loads through 4-D tensor maps, `wgmma`
// descriptors and the products both use, and the tensor maps over the
// strided (d, rows, heads, batch) views of q, k, v, o and their gradients.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// how a row of the head dim D lies in shared memory after a TMA load: boxes
// of 64 columns with the 128-byte swizzle (32 columns with the 64-byte
// swizzle at d <= 32); a head dim that is not a whole number of boxes (16,
// 112) is padded to one, the columns past D arriving zero-filled
template <int D>
struct Box {
  static_assert(D % 16 == 0 && D <= 256, "the head dim must be a multiple of 16, at most 256");
  static constexpr int kCols = D <= 32 ? 32 : 64;     // columns of one TMA box
  static constexpr int kCount = (D + kCols - 1) / kCols;  // boxes a row; columns past D: zeros
  static constexpr int kRowBytes = kCols * 2;           // one swizzled row: 128 B (64 B at d <= 32)
  static constexpr int kGroupBytes = 8 * kRowBytes;     // 8 rows: one swizzle pattern
  static constexpr uint64_t kLayout = kCols == 32 ? 2 : 1;  // wgmma: 1 = 128-byte, 2 = 64-byte swizzle
  // a tile of `rows` rows: kCount boxes of rows x kRowBytes
  static constexpr int tile_bytes(int rows) { return kCount * rows * kRowBytes; }
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

// two floats rounded to the 16-bit type T, packed in one register
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the operand type of the wgmma instructions for T
template <typename T> constexpr bool kF16 = false;
template <> constexpr bool kF16<__half> = true;

// S (64 x 128) = Q (64 x 16) K^T (16 x 128), and O (64 x N) += P (64 x 16) V (16 x N):
// the accumulator is spread over the warpgroup's 128 threads (N / 2 floats each)
#define WGMMA_SS_M64N128(TY)                                                                                  \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                        \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                       \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "l"(da), "l"(db), "r"(accumulate));
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  if constexpr (kF16<T>) {
    WGMMA_SS_M64N128("f16");
  } else {
    WGMMA_SS_M64N128("bf16");
  }
}

#define WGMMA_SS_M64N64(TY)                                                                                   \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "l"(da), "l"(db), "r"(accumulate));
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  if constexpr (kF16<T>) {
    WGMMA_SS_M64N64("f16");
  } else {
    WGMMA_SS_M64N64("bf16");
  }
}

// S += Q K^T for one 16-column step over the N keys of a K tile
template <typename T, int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_m64n64<T>(d, da, db, accumulate);
  } else {
    wgmma_ss_m64n128<T>(d, da, db, accumulate);
  }
}

#define WGMMA_RS_M64N32(TY)                                                                                \
  asm volatile(                                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                                           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "                              \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  if constexpr (kF16<T>) {
    WGMMA_RS_M64N32("f16");
  } else {
    WGMMA_RS_M64N32("bf16");
  }
}

#define WGMMA_RS_M64N64(TY)                                                                                   \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                       \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
template <typename T>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  if constexpr (kF16<T>) {
    WGMMA_RS_M64N64("f16");
  } else {
    WGMMA_RS_M64N64("bf16");
  }
}

// O += P V for one 16-key step over the N columns of one V box
template <typename T, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) {
    wgmma_rs_m64n32<T>(d, a, db);
  } else {
    wgmma_rs_m64n64<T>(d, a, db);
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
// (1, s_row, s_head, s_b) and a box of (Box<D>::kCols, box_rows, 1, 1); rows
// past `rows` and columns past D arrive zero-filled
template <typename T, int D>
bool make_map(CUtensorMap* map, const void* ptr, int rows, int heads, int B, long long s_row,
              long long s_head, long long s_b, int box_rows) {
  using X = Box<D>;
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
  const cuuint32_t box[4] = {(cuuint32_t)X::kCols, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      kF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             X::kCols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
