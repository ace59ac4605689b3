// Stride-1 SAME depthwise 2-D convolution with atrous rate, float32 or
// bfloat16: the forward pass and, on the spatially flipped filter, the input
// gradient.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   depthwise_conv2d (kernel body _dw_kernel, launched by _dw_pallas),
//   forward, and the dx half of its VJP (_dw_bwd: the same conv on the
//   flipped filter). The TPU kernel held one padded image per grid step in
//   VMEM and summed the kh*kw shifted taps with channels on the 128-wide
//   lanes.
//
// Computes out[b, y, x, c] = sum over taps (i, j) inside the image of
//   x[b, y + i*rate - ph, x + j*rate - pw, c] * w'[i, j, c]
// with ph = rate*(kh-1)/2, pw = rate*(kw-1)/2 (SAME, odd sides), w' = w for
// the forward and w'[i, j] = w[kh-1-i, kw-1-j] for dx (`flip`), as one fmaf
// chain from 0 in tap order (i, j), taps outside the image skipped. Both
// kernels below sum in exactly that order, so they agree bit for bit.
//
// What bounds it on an H100: memory. At the train and serve paths' calls
// (ASPP, x [64, 13, 13, 1024] f32, 3x3 taps at rates 2, 4, 8) a call reads
// 44 MB and writes 44 MB for about 0.2 GFLOP: ~26 us at 3.35 TB/s against
// ~3 us of f32 math.
//
// tfdl_depthwise_tiled_kernel (the one the wrapper launches): one block per
// (image, 32-channel group, output tile), the tile the whole image where
// its staged region fits. The block copies the in-image rows and columns
// its taps reach, the tile and its halo of ph rows and pw columns, into
// shared memory once, by 16-byte cp.async when C % 4 == 0 (4-byte
// otherwise), so x is read from device memory about once instead of once a
// tap from L2. The taps of a 3x3 filter sit in registers, loaded once per
// thread (any other side: staged in shared memory once per block); the
// flip is an index, so dx is one launch. Each thread owns 4 channels
// (float4; 1 when C % 4 != 0) and walks the tile's pixels, writing each
// result with one 16-byte store. Offsets come from blockIdx and 32-bit
// arithmetic: no 64-bit division. A region too large for shared memory
// even at a 1x1 tile (a huge rate) reads its taps from device memory, in
// the same order.
//
// The bf16 arm (tfdl_depthwise_tiled_bf16, the bf16-compute models' path)
// is the same tiled kernel on 2-byte elements: x, w and out bf16, the
// staged region bf16 (half the shared memory, so larger tiles fit), every
// tap widened to float32 and summed in the same fmaf chain, the result
// rounded once to bf16 (round to nearest even), as the TPU kernel sums in
// float32 and writes x.dtype. A thread's 4 channels are one 8-byte load and
// store; C % 4 != 0 or a base not 8-byte aligned takes one channel a
// thread, reading its taps from device memory (cp.async copies no 2-byte
// element). At the bf16 paths' calls a call moves half the float32 bytes.
//
// tfdl_depthwise_kernel (the earlier kernel, kept built so that its time
// can be set beside the new one's; no path calls it): one thread per
// output element, channels fastest, taps re-read from L2.
//
// Layout: x and out are NHWC contiguous, w is [kh, kw, C] contiguous.

#include <cuda_bf16.h>

#include "common.cuh"

__global__ void tfdl_depthwise_kernel(const float* __restrict__ x,
                                      const float* __restrict__ w,
                                      float* __restrict__ out, int H, int W,
                                      int C, int kh, int kw, int rate,
                                      int64_t total) {
  const int ph = rate * (kh - 1) / 2;
  const int pw = rate * (kw - 1) / 2;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    int64_t p = idx / C;
    const int ox = (int)(p % W);
    p /= W;
    const int oy = (int)(p % H);
    const int64_t b = p / H;
    const float* xb = x + b * (int64_t)H * W * C + c;
    float acc = 0.0f;
    for (int i = 0; i < kh; ++i) {
      const int iy = oy + i * rate - ph;
      if (iy < 0 || iy >= H) continue;
      for (int j = 0; j < kw; ++j) {
        const int ix = ox + j * rate - pw;
        if (ix < 0 || ix >= W) continue;
        acc = fmaf(xb[((int64_t)iy * W + ix) * C], w[(i * kw + j) * C + c], acc);
      }
    }
    out[idx] = acc;
  }
}

extern "C" int tfdl_depthwise_conv2d_f32(const void* x, const void* w,
                                         void* out, int B, int H, int W,
                                         int C, int kh, int kw, int rate,
                                         void* stream) {
  const int64_t total = (int64_t)B * H * W * C;
  if (total == 0) return (int)cudaSuccess;
  tfdl_depthwise_kernel<<<tfdl_blocks(total), TFDL_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, H, W, C, kh, kw, rate,
      total);
  return (int)cudaGetLastError();
}

// -- the tiled kernel ---------------------------------------------------------

#define TFDL_DWT_THREADS 128
#define TFDL_DWT_CG 32                 // channels per block
#define TFDL_DWT_SMEM_MAX (96 * 1024)  // staged bytes a block may use

__device__ __forceinline__ void tfdl_dwt_cp(void* dst, const void* src,
                                            bool valid, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

template <int VEC>
struct TfdlVec;
template <>
struct TfdlVec<4> {
  typedef float4 T;
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float4 fma(float4 a, float4 b, float4 c) {
    return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                       fmaf(a.w, b.w, c.w));
  }
};
template <>
struct TfdlVec<1> {
  typedef float T;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
};

// VEC consecutive elements of E at p, loaded widened to float32 and stored
// from float32 (bf16: the 16 high bits of a float, stored rounded to
// nearest even)
template <typename E, int VEC>
struct TfdlIo;
template <>
struct TfdlIo<float, 4> {
  static __device__ __forceinline__ float4 ld(const float* p) { return *reinterpret_cast<const float4*>(p); }
  static __device__ __forceinline__ void st(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
};
template <>
struct TfdlIo<float, 1> {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
};
__device__ __forceinline__ unsigned int tfdl_pack_bf16x2(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
template <>
struct TfdlIo<__nv_bfloat16, 4> {
  static __device__ __forceinline__ float4 ld(const __nv_bfloat16* p) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                       __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float4 v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(tfdl_pack_bf16x2(v.x, v.y), tfdl_pack_bf16x2(v.z, v.w));
  }
};
template <>
struct TfdlIo<__nv_bfloat16, 1> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// E the element type (float or __nv_bfloat16; sums in float32); VEC
// channels per thread (4 when C % 4 == 0); KH, KW the filter sides, or 0
// for sides given at run time; STAGED false reads taps from device memory.
template <typename E, int VEC, int KH, int KW, bool STAGED>
__global__ void __launch_bounds__(TFDL_DWT_THREADS)
    tfdl_depthwise_tiled_kernel(const E* __restrict__ x,
                                const E* __restrict__ w,
                                E* __restrict__ out, int H, int W, int C,
                                int kh_rt, int kw_rt, int rate, int flip,
                                int tile_h, int tile_w, int tiles_x,
                                int tiles_per_image) {
  typedef typename TfdlVec<VEC>::T vec;
  typedef TfdlIo<E, VEC> io;
  constexpr int NV = TFDL_DWT_CG / VEC;      // channel vectors per block
  constexpr int PL = TFDL_DWT_THREADS / NV;  // pixel lanes
  const int kh = KH ? KH : kh_rt, kw = KW ? KW : kw_rt;
  extern __shared__ __align__(16) float tfdl_dwt_smem[];
  // taps of run-time sides first ([kh*kw][CG], float32), then the staged
  // region (elements of E)
  float* ws = tfdl_dwt_smem;
  E* xs = reinterpret_cast<E*>(tfdl_dwt_smem + (KH ? 0 : kh * kw * TFDL_DWT_CG));

  const int b = blockIdx.x / tiles_per_image;
  const int tile = blockIdx.x - b * tiles_per_image;
  const int ty = tile / tiles_x;
  const int oy0 = ty * tile_h, ox0 = (tile - ty * tiles_x) * tile_w;
  const int c0 = blockIdx.y * TFDL_DWT_CG;
  const int cv = threadIdx.x % NV, lane = threadIdx.x / NV;
  const int c = c0 + cv * VEC;
  const bool cvalid = c < C;  // C % VEC == 0: a vector is whole or absent
  const int ph = rate * (kh - 1) / 2, pw = rate * (kw - 1) / 2;
  const int th = min(tile_h, H - oy0), tw = min(tile_w, W - ox0);
  const int ry0 = max(0, oy0 - ph), ry1 = min(H, oy0 + th + ph);
  const int rx0 = max(0, ox0 - pw), rx1 = min(W, ox0 + tw + pw);
  const int rw = rx1 - rx0;
  const int64_t image = (int64_t)b * H * W * C;
  const E* xb = x + image;
  E* ob = out + image;

  if (STAGED) {
    for (int r = ry0; r < ry1; ++r) {
      const E* src = xb + ((int64_t)r * W + rx0) * C + c0;
      E* dst = xs + (r - ry0) * rw * TFDL_DWT_CG;
      for (int i = threadIdx.x; i < rw * NV; i += TFDL_DWT_THREADS) {
        const int px = i / NV, v = i % NV;
        const bool valid = c0 + v * VEC < C;
        tfdl_dwt_cp(dst + px * TFDL_DWT_CG + v * VEC, valid ? src + px * C + v * VEC : x, valid,
                    VEC * (int)sizeof(E));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (!KH) {
    for (int i = threadIdx.x; i < kh * kw * NV; i += TFDL_DWT_THREADS) {
      const int t = i / NV, v = i % NV;
      const int ti = t / kw, tj = t - ti * kw;
      const int src = flip ? (kh - 1 - ti) * kw + (kw - 1 - tj) : t;
      if (c0 + v * VEC < C)
        *reinterpret_cast<vec*>(ws + t * TFDL_DWT_CG + v * VEC) = io::ld(w + (int64_t)src * C + c0 + v * VEC);
    }
  }
  if (STAGED) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (!cvalid) return;

  vec wr[KH ? KH * KW : 1];
  if (KH) {
#pragma unroll
    for (int t = 0; t < (KH ? KH * KW : 1); ++t) {
      const int src = flip ? KH * KW - 1 - t : t;  // (kh-1-i, kw-1-j) in row-major order
      wr[t] = io::ld(w + (int64_t)src * C + c);
    }
  }

  const int npix = th * tw;
  for (int p = lane; p < npix; p += PL) {
    const int py = p / tw;
    const int oy = oy0 + py, ox = ox0 + (p - py * tw);
    vec acc = TfdlVec<VEC>::zero();
#pragma unroll
    for (int i = 0; i < kh; ++i) {
      const int iy = oy + i * rate - ph;
      if (iy < 0 || iy >= H) continue;
#pragma unroll
      for (int j = 0; j < kw; ++j) {
        const int ix = ox + j * rate - pw;
        if (ix < 0 || ix >= W) continue;
        const vec xv = STAGED ? io::ld(xs + ((iy - ry0) * rw + (ix - rx0)) * TFDL_DWT_CG + cv * VEC)
                              : io::ld(xb + ((int64_t)iy * W + ix) * C + c);
        const vec wv = KH ? wr[KH ? i * KW + j : 0]
                          : *reinterpret_cast<const vec*>(ws + (i * kw + j) * TFDL_DWT_CG + cv * VEC);
        acc = TfdlVec<VEC>::fma(xv, wv, acc);
      }
    }
    io::st(ob + ((int64_t)oy * W + ox) * C + c, acc);
  }
}

template <typename E, int VEC, int KH, int KW, bool STAGED>
static int tfdl_dwt_launch(const E* x, const E* w, E* out, int B,
                           int H, int W, int C, int kh, int kw, int rate,
                           int flip, int tile_h, int tile_w, int smem,
                           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tfdl_depthwise_tiled_kernel<E, VEC, KH, KW, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const dim3 grid((unsigned int)(B * tiles_y * tiles_x),
                  (unsigned int)((C + TFDL_DWT_CG - 1) / TFDL_DWT_CG));
  tfdl_depthwise_tiled_kernel<E, VEC, KH, KW, STAGED>
      <<<grid, TFDL_DWT_THREADS, smem, stream>>>(x, w, out, H, W, C, kh, kw,
                                                 rate, flip, tile_h, tile_w,
                                                 tiles_x, tiles_y * tiles_x);
  return (int)cudaGetLastError();
}

// can_stage false (bf16 one channel a thread) reads the taps from device
// memory at any size
template <typename E, int VEC>
static int tfdl_dwt_dispatch(const E* x, const E* w, E* out,
                             int B, int H, int W, int C, int kh, int kw,
                             int rate, int flip, bool can_stage, cudaStream_t stream) {
  // the tile: the whole image, halved along its longer side until the
  // staged region (tile plus halo, clipped to the image) fits
  const int ph = rate * (kh - 1) / 2, pw = rate * (kw - 1) / 2;
  const bool reg_taps = kh == 3 && kw == 3;
  const int64_t taps = reg_taps ? 0 : (int64_t)kh * kw * TFDL_DWT_CG * 4;
  int tile_h = H, tile_w = W;
  int64_t region = 0;
  for (;;) {
    region = (int64_t)min(H, tile_h + 2 * ph) * min(W, tile_w + 2 * pw) * TFDL_DWT_CG * (int64_t)sizeof(E);
    if (taps + region <= TFDL_DWT_SMEM_MAX || (tile_h == 1 && tile_w == 1)) break;
    if (tile_h >= tile_w) tile_h = (tile_h + 1) / 2;
    else tile_w = (tile_w + 1) / 2;
  }
  const bool staged = can_stage && taps + region <= TFDL_DWT_SMEM_MAX;
  if (!staged) {
    tile_h = min(H, 8);
    tile_w = min(W, 8);
  }
  if (taps > TFDL_DWT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int smem = (int)(taps + (staged ? region : 0));
  if (reg_taps) {
    return staged ? tfdl_dwt_launch<E, VEC, 3, 3, true>(x, w, out, B, H, W, C, kh, kw, rate, flip, tile_h, tile_w, smem, stream)
                  : tfdl_dwt_launch<E, VEC, 3, 3, false>(x, w, out, B, H, W, C, kh, kw, rate, flip, tile_h, tile_w, smem, stream);
  }
  return staged ? tfdl_dwt_launch<E, VEC, 0, 0, true>(x, w, out, B, H, W, C, kh, kw, rate, flip, tile_h, tile_w, smem, stream)
                : tfdl_dwt_launch<E, VEC, 0, 0, false>(x, w, out, B, H, W, C, kh, kw, rate, flip, tile_h, tile_w, smem, stream);
}

// x, out: contiguous NHWC float32; w: contiguous [kh, kw, C] float32, odd
// sides; flip 1 computes dx (the conv on w flipped in space), 0 the forward.
// Four channels a thread when C % 4 == 0 and every base is 16-byte aligned,
// one otherwise.
extern "C" int tfdl_depthwise_tiled_f32(const void* x, const void* w,
                                        void* out, int B, int H, int W, int C,
                                        int kh, int kw, int rate, int flip,
                                        void* stream) {
  if ((int64_t)B * H * W * C == 0) return (int)cudaSuccess;
  if (kh % 2 != 1 || kw % 2 != 1 || rate < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15) == 0;
  if (C % 4 == 0 && aligned)
    return tfdl_dwt_dispatch<float, 4>((const float*)x, (const float*)w, (float*)out, B, H, W, C, kh, kw, rate, flip,
                                       true, st);
  return tfdl_dwt_dispatch<float, 1>((const float*)x, (const float*)w, (float*)out, B, H, W, C, kh, kw, rate, flip,
                                     true, st);
}

// x, out: contiguous NHWC bfloat16; w: contiguous [kh, kw, C] bfloat16, odd
// sides; flip as for tfdl_depthwise_tiled_f32. Four channels a thread (one
// 8-byte vector, staged by 8-byte cp.async) when C % 4 == 0 and every base
// is 8-byte aligned; one otherwise, taps from device memory.
extern "C" int tfdl_depthwise_tiled_bf16(const void* x, const void* w,
                                         void* out, int B, int H, int W, int C,
                                         int kh, int kw, int rate, int flip,
                                         void* stream) {
  if ((int64_t)B * H * W * C == 0) return (int)cudaSuccess;
  if (kh % 2 != 1 || kw % 2 != 1 || rate < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 7) == 0;
  typedef __nv_bfloat16 bf;
  if (C % 4 == 0 && aligned)
    return tfdl_dwt_dispatch<bf, 4>((const bf*)x, (const bf*)w, (bf*)out, B, H, W, C, kh, kw, rate, flip, true, st);
  return tfdl_dwt_dispatch<bf, 1>((const bf*)x, (const bf*)w, (bf*)out, B, H, W, C, kh, kw, rate, flip, false, st);
}
