// Hopper building blocks shared by the TMA + wgmma kernels (int8_gemm.cu,
// int8_conv_tc.cu): mbarriers, TMA loads (tiled and im2col), wgmma shared
// memory descriptors and the s8 x s8 -> s32 m64n128k32 product, and the
// tensor-map encoders of libcuda, looked up through the CUDA runtime so
// that no library links -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t tfdl_g_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void tfdl_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tfdl_g_smem(bar)),
               "r"(count)
               : "memory");
}

// Spin until the phase of `parity` completes. A wait that never ends (a lost
// TMA completion) traps after about 2^26 tries instead of hanging the card.
__device__ __forceinline__ void tfdl_mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(tfdl_g_smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tfdl_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tfdl_g_smem(bar))
               : "memory");
}

__device__ __forceinline__ void tfdl_mbar_expect_tx(uint64_t* bar,
                                                    uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          tfdl_g_smem(bar)),
      "r"(bytes)
      : "memory");
}

// one TMA tile of a 2-D map at (inner coordinate c0, row c1) into `dst`
__device__ __forceinline__ void tfdl_tma_load(void* dst, const CUtensorMap* map,
                                              int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(tfdl_g_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tfdl_g_smem(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// one TMA im2col box of a 4-D NHWC map into `dst`: the map's pixels-per-
// column pixels from (w, h, n) on, walked W fastest inside the map's
// bounding box, then H, then N, each read at (h + off_h, w + off_w) with
// the map's channels-per-pixel channels from channel c; taps outside the
// image read as zeros
__device__ __forceinline__ void tfdl_tma_load_im2col(void* dst, const CUtensorMap* map, int c, int w, int h,
                                                     int n, uint16_t off_w, uint16_t off_h, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(tfdl_g_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tfdl_g_smem(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(off_w), "h"(off_h)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are SWIZZLE
// bytes (128, 64 or 32) under the TMA swizzle of that width: 8-row groups
// 8 * SWIZZLE bytes apart (SBO), start address in 16-byte units; the tile
// base is aligned to 8 * SWIZZLE bytes, so a k32 step is +32 bytes on the
// start address
template <int SWIZZLE>
__device__ __forceinline__ uint64_t tfdl_desc_sw(const void* p) {
  static_assert(SWIZZLE == 128 || SWIZZLE == 64 || SWIZZLE == 32, "wgmma swizzle widths");
  constexpr uint64_t layout = SWIZZLE == 128 ? 1 : SWIZZLE == 64 ? 2 : 3;
  const uint64_t addr = tfdl_g_smem(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((8 * SWIZZLE) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ uint64_t tfdl_desc_sw128(const void* p) { return tfdl_desc_sw<128>(p); }

__device__ __forceinline__ void tfdl_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void tfdl_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void tfdl_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tfdl_wgmma_commit_wait() {
  tfdl_wgmma_commit();
  tfdl_wgmma_wait<0>();
}

// d[64] += A (64 x 32 bytes) . B (128 x 32 bytes)^T, both from shared memory
__device__ __forceinline__ void tfdl_wgmma_s8(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

typedef CUresult (*TfdlEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*TfdlEncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                     const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
                                     const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                     CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a libcuda entry point looked up through the runtime, or null
static inline void* tfdl_libcuda_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) == cudaSuccess && q == cudaDriverEntryPointSuccess) {
    return p;
  }
  return nullptr;
}

// libcuda's cuTensorMapEncodeTiled, or null
static inline TfdlEncodeTiled tfdl_encode_fn() {
  static TfdlEncodeTiled fn = nullptr;
  if (fn == nullptr) fn = reinterpret_cast<TfdlEncodeTiled>(tfdl_libcuda_entry("cuTensorMapEncodeTiled"));
  return fn;
}

// libcuda's cuTensorMapEncodeIm2col, or null
static inline TfdlEncodeIm2col tfdl_encode_im2col_fn() {
  static TfdlEncodeIm2col fn = nullptr;
  if (fn == nullptr) fn = reinterpret_cast<TfdlEncodeIm2col>(tfdl_libcuda_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

// the TMA swizzle whose width is `bytes` (128, 64 or 32)
static inline CUtensorMapSwizzle tfdl_swizzle(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// [rows, K] int8, K contiguous, as box_rows x box_k-byte boxes swizzled at
// box_k bytes (128, 64 or 32); reads past the edges return zeros
static inline bool tfdl_map_kmajor(CUtensorMap* map, TfdlEncodeTiled encode, const void* base, int rows, int K,
                            int box_rows, int box_k = 128) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)box_k, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, tfdl_swizzle(box_k), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
