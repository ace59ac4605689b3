// Stride-1 SAME depthwise 2-D convolution with atrous rate, float32: the
// forward pass and, on the spatially flipped filter, the input gradient.
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
// tfdl_depthwise_kernel (the earlier kernel, kept built so that its time
// can be set beside the new one's; no path calls it): one thread per
// output element, channels fastest, taps re-read from L2.
//
// Layout: x and out are NHWC contiguous, w is [kh, kw, C] contiguous.

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

__device__ __forceinline__ void tfdl_dwt_cp(float* dst, const float* src,
                                            bool valid, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
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

// VEC channels per thread (4 when C % 4 == 0); KH, KW the filter sides, or
// 0 for sides given at run time; STAGED false reads taps from device memory.
template <int VEC, int KH, int KW, bool STAGED>
__global__ void __launch_bounds__(TFDL_DWT_THREADS)
    tfdl_depthwise_tiled_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                float* __restrict__ out, int H, int W, int C,
                                int kh_rt, int kw_rt, int rate, int flip,
                                int tile_h, int tile_w, int tiles_x,
                                int tiles_per_image) {
  typedef typename TfdlVec<VEC>::T vec;
  constexpr int NV = TFDL_DWT_CG / VEC;      // channel vectors per block
  constexpr int PL = TFDL_DWT_THREADS / NV;  // pixel lanes
  const int kh = KH ? KH : kh_rt, kw = KW ? KW : kw_rt;
  extern __shared__ __align__(16) float tfdl_dwt_smem[];
  // taps of run-time sides first ([kh*kw][CG]), then the staged region
  float* ws = tfdl_dwt_smem;
  float* xs = tfdl_dwt_smem + (KH ? 0 : kh * kw * TFDL_DWT_CG);

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
  const float* xb = x + image;
  float* ob = out + image;

  if (STAGED) {
    for (int r = ry0; r < ry1; ++r) {
      const float* src = xb + ((int64_t)r * W + rx0) * C + c0;
      float* dst = xs + (r - ry0) * rw * TFDL_DWT_CG;
      for (int i = threadIdx.x; i < rw * NV; i += TFDL_DWT_THREADS) {
        const int px = i / NV, v = i % NV;
        const bool valid = c0 + v * VEC < C;
        tfdl_dwt_cp(dst + px * TFDL_DWT_CG + v * VEC, valid ? src + px * C + v * VEC : x, valid,
                    VEC * 4);
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
        *reinterpret_cast<vec*>(ws + t * TFDL_DWT_CG + v * VEC) =
            *reinterpret_cast<const vec*>(w + (int64_t)src * C + c0 + v * VEC);
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
      wr[t] = *reinterpret_cast<const vec*>(w + (int64_t)src * C + c);
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
        const vec xv =
            STAGED ? *reinterpret_cast<const vec*>(
                         xs + ((iy - ry0) * rw + (ix - rx0)) * TFDL_DWT_CG + cv * VEC)
                   : *reinterpret_cast<const vec*>(xb + ((int64_t)iy * W + ix) * C + c);
        const vec wv = KH ? wr[KH ? i * KW + j : 0]
                          : *reinterpret_cast<const vec*>(ws + (i * kw + j) * TFDL_DWT_CG + cv * VEC);
        acc = TfdlVec<VEC>::fma(xv, wv, acc);
      }
    }
    *reinterpret_cast<vec*>(ob + ((int64_t)oy * W + ox) * C + c) = acc;
  }
}

template <int VEC, int KH, int KW, bool STAGED>
static int tfdl_dwt_launch(const float* x, const float* w, float* out, int B,
                           int H, int W, int C, int kh, int kw, int rate,
                           int flip, int tile_h, int tile_w, int smem,
                           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tfdl_depthwise_tiled_kernel<VEC, KH, KW, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const dim3 grid((unsigned int)(B * tiles_y * tiles_x),
                  (unsigned int)((C + TFDL_DWT_CG - 1) / TFDL_DWT_CG));
  tfdl_depthwise_tiled_kernel<VEC, KH, KW, STAGED>
      <<<grid, TFDL_DWT_THREADS, smem, stream>>>(x, w, out, H, W, C, kh, kw,
                                                 rate, flip, tile_h, tile_w,
                                                 tiles_x, tiles_y * tiles_x);
  return (int)cudaGetLastError();
}

template <int VEC>
static int tfdl_dwt_dispatch(const float* x, const float* w, float* out,
                             int B, int H, int W, int C, int kh, int kw,
                             int rate, int flip, cudaStream_t stream) {
  // the tile: the whole image, halved along its longer side until the
  // staged region (tile plus halo, clipped to the image) fits
  const int ph = rate * (kh - 1) / 2, pw = rate * (kw - 1) / 2;
  const bool reg_taps = kh == 3 && kw == 3;
  const int64_t taps = reg_taps ? 0 : (int64_t)kh * kw * TFDL_DWT_CG * 4;
  int tile_h = H, tile_w = W;
  int64_t region = 0;
  for (;;) {
    region = (int64_t)min(H, tile_h + 2 * ph) * min(W, tile_w + 2 * pw) * TFDL_DWT_CG * 4;
    if (taps + region <= TFDL_DWT_SMEM_MAX || (tile_h == 1 && tile_w == 1)) break;
    if (tile_h >= tile_w) tile_h = (tile_h + 1) / 2;
    else tile_w = (tile_w + 1) / 2;
  }
  const bool staged = taps + region <= TFDL_DWT_SMEM_MAX;
  if (!staged) {
    tile_h = min(H, 8);
    tile_w = min(W, 8);
  }
  if (taps > TFDL_DWT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int smem = (int)(taps + (staged ? region : 0));
  if (reg_taps) {
    return staged ? tfdl_dwt_launch<VEC, 3, 3, true>(x, w, out, B, H, W, C, kh, kw, rate, flip, tile_h, tile_w, smem, stream)
                  : tfdl_dwt_launch<VEC, 3, 3, false>(x, w, out, B, H, W, C, kh, kw, rate, flip, tile_h, tile_w, smem, stream);
  }
  return staged ? tfdl_dwt_launch<VEC, 0, 0, true>(x, w, out, B, H, W, C, kh, kw, rate, flip, tile_h, tile_w, smem, stream)
                : tfdl_dwt_launch<VEC, 0, 0, false>(x, w, out, B, H, W, C, kh, kw, rate, flip, tile_h, tile_w, smem, stream);
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
    return tfdl_dwt_dispatch<4>((const float*)x, (const float*)w, (float*)out, B, H, W, C, kh, kw, rate, flip, st);
  return tfdl_dwt_dispatch<1>((const float*)x, (const float*)w, (float*)out, B, H, W, C, kh, kw, rate, flip, st);
}
