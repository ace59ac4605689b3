// Filter gradient of the stride-1 SAME depthwise 2-D convolution, float32 or
// bfloat16.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   _dw_bwd (the custom VJP of depthwise_conv2d), its dw half: kh*kw
//   reductions of g * shift(x) over (B, H, W), which the JAX package left to
//   XLA beside the Pallas forward. (dx is the forward kernel again, on the
//   spatially flipped filter: csrc/depthwise.cu.)
//
// Computes dw[i][j][c] = sum_{b,y,x} g[b,y,x,c] * x[b, y+i*r-ph, x+j*r-pw, c]
// with zero outside the image (ph = r*(kh-1)/2, pw = r*(kw-1)/2).
//
// What bounds it on an H100: memory. Each of x and g is read once; dw is a
// few KB. At the train path's largest call (ASPP, [64, 13, 13, 1024] f32,
// 3x3 taps) that is 88.6 MB, ~26 us at 3.35 TB/s, against ~0.2 GFLOP.
//
// tfdl_depthwise_dw_band_kernel (the one the wrapper launches where C % 4
// == 0, x and g are 16-byte aligned and a band fits): a block owns one slice
// of `channels` channels (4 a thread, float4) and one band of `band_rows`
// full-width rows of `images` consecutive images. Per image it stages the
// band of g and the band's rows of x with their halo (clipped to the image)
// in shared memory by 16-byte cp.async, the next image's copies in flight
// while the current one is summed (two stages), so x and g leave device
// memory once and the x halo is read from shared memory. A thread keeps all
// kh*kw tap sums for its 4 channels in registers. Taps are the outer loop:
// for tap (i, j) the output rows and columns whose shifted input lies in the
// image are one rectangle, computed once per tap, and the block's pixel
// lanes walk it with incremented offsets (one division per tap, none per
// pixel, no bounds test in the loop, so taps that reach few rows cost only
// those rows). Sums are fixed-order: each thread over its pixels in walk
// order and its images in order; the lanes of a warp by a butterfly of
// shuffles; the warps in index order through shared memory, into a
// [tiles, kh*kw, C] partial (tile = image group x band); then a second
// kernel sums the tiles in tile order, launched as a programmatic
// dependent so that its launch overlaps the band kernel's tail (measured
// faster on the card than summing a slice's tiles inside one thread-block
// cluster through distributed shared memory). No atomics: dw is bitwise
// equal from launch to launch. Its order differs from the earlier kernel's,
// so dw is not bit for bit the earlier kernel's (both hold the plain
// version's tolerance). The plan (channels, band_rows, images, stages) is
// chosen on the host (ops/kernels.py dw_plan) from the shape and the 227 KB
// of shared memory a block may use, so that the grid fills the 132 SMs.
//
// tfdl_depthwise_dw_partial_kernel (the earlier kernel: every other shape,
// and kept built so that its time can be set beside the band kernel's): a
// block owns 32 channels (threadIdx.x, fastest, so a warp reads 128
// contiguous bytes of one pixel) and a tile of `tile_rows` consecutive
// (b, y, x) pixels, spread over 8 lanes (threadIdx.y). Each thread keeps all
// kh*kw tap sums in registers and walks its pixels once, the kh*kw shifted
// reads of x served by L1/L2. The 8 lanes are summed through shared memory
// in a fixed order into the [tiles, kh*kw, C] partial, and the second kernel
// sums the tiles in order.
//
// The bf16 arms (tfdl_depthwise_dw_band_bf16, tfdl_depthwise_dw_bf16: the
// bf16-compute models' path) are the same two kernels on 2-byte x and g:
// the band kernel stages bf16 bands (half the shared memory, so its plan,
// ops/kernels.py dw_plan with itemsize 2, may take taller bands) by 8-byte
// cp.async, a thread's 4 channels one 8-byte vector; every product and
// sum is float32 (the partial too), and the tile sum rounds dw once to
// bf16 (round to nearest even): the TPU path sums in float32 and casts dw
// to the filter's dtype, which the JAX layer cast to bf16.
//
// Layout: x and g are NHWC contiguous; partial is [tiles, kh*kw, C]; dw is
// [kh, kw, C]. Filters up to 7x7 (odd sides) are instantiated.

#include <cuda_bf16.h>

#include "common.cuh"

__device__ __forceinline__ float tfdl_f32(float v) { return v; }
__device__ __forceinline__ float tfdl_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void tfdl_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void tfdl_store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// four consecutive elements widened to float32 (16-byte aligned floats,
// 8-byte aligned bf16)
__device__ __forceinline__ float4 tfdl_ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 tfdl_ld4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}

#define TFDL_DW_CH 32
#define TFDL_DW_LANES 8

template <typename E, int KH, int KW>
__global__ void tfdl_depthwise_dw_partial_kernel(
    const E* __restrict__ x, const E* __restrict__ g,
    float* __restrict__ partial, int H, int W, int C, int rate, int64_t P,
    int64_t tile_rows) {
  __shared__ float lanes[TFDL_DW_LANES][TFDL_DW_CH];
  const int c = blockIdx.x * TFDL_DW_CH + threadIdx.x;
  const int64_t tile = blockIdx.y;
  const int64_t p0 = tile * tile_rows;
  const int64_t p1 = p0 + tile_rows < P ? p0 + tile_rows : P;
  const int ph = rate * (KH - 1) / 2;
  const int pw = rate * (KW - 1) / 2;
  float acc[KH * KW];
#pragma unroll
  for (int t = 0; t < KH * KW; ++t) acc[t] = 0.0f;
  if (c < C) {
    for (int64_t p = p0 + threadIdx.y; p < p1; p += TFDL_DW_LANES) {
      const int ox = (int)(p % W);
      const int64_t q = p / W;
      const int oy = (int)(q % H);
      const int64_t b = q / H;
      const float gv = tfdl_f32(g[p * C + c]);
      const E* xb = x + b * (int64_t)H * W * C + c;
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        const int iy = oy + i * rate - ph;
        const bool row_in = iy >= 0 && iy < H;
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const int ix = ox + j * rate - pw;
          if (row_in && ix >= 0 && ix < W) {
            acc[i * KW + j] =
                fmaf(gv, tfdl_f32(xb[((int64_t)iy * W + ix) * C]), acc[i * KW + j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < KH * KW; ++t) {
    lanes[threadIdx.y][threadIdx.x] = acc[t];
    __syncthreads();
    if (threadIdx.y == 0 && c < C) {
      float s = lanes[0][threadIdx.x];
      for (int r = 1; r < TFDL_DW_LANES; ++r) s += lanes[r][threadIdx.x];
      partial[(tile * (KH * KW) + t) * C + c] = s;
    }
    __syncthreads();
  }
}

// dw[k] = sum over tiles, in tile order, of partial[tile][k], k = tap*C + c;
// stored as D (float, or bf16 rounded once)
template <typename D>
__global__ void tfdl_depthwise_dw_sum_kernel(const float* __restrict__ partial,
                                             D* __restrict__ dw,
                                             int64_t tiles, int64_t n) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int64_t t = 0; t < tiles; ++t) s += partial[t * n + k];
    tfdl_store(dw + k, s);
  }
}

#define TFDL_DW_CASE(KH_, KW_)                                               \
  if (kh == KH_ && kw == KW_) {                                              \
    tfdl_depthwise_dw_partial_kernel<E, KH_, KW_><<<grid, block, 0, s>>>(    \
        (const E*)x, (const E*)g, (float*)partial, H, W, C, rate, P,         \
        tile_rows);                                                          \
    launched = true;                                                         \
  }

// Returns a cudaError_t as int: cudaErrorInvalidValue for a filter side
// that is not odd and <= 7, or a tile count past the grid's y limit.
template <typename E>
static int tfdl_dw_tiles(const void* x, const void* g, void* partial,
                         void* dw, int B, int H, int W, int C, int kh,
                         int kw, int rate, int64_t tiles, int64_t tile_rows,
                         void* stream) {
  const int64_t P = (int64_t)B * H * W;
  const int64_t n = (int64_t)kh * kw * C;
  if (n == 0) return (int)cudaSuccess;
  if (tiles < 1 || tiles > 65535 || tiles * tile_rows < P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(TFDL_DW_CH, TFDL_DW_LANES);
  const dim3 grid((unsigned int)((C + TFDL_DW_CH - 1) / TFDL_DW_CH),
                  (unsigned int)tiles);
  bool launched = false;
  TFDL_DW_CASE(1, 1) TFDL_DW_CASE(1, 3) TFDL_DW_CASE(1, 5) TFDL_DW_CASE(1, 7)
  TFDL_DW_CASE(3, 1) TFDL_DW_CASE(3, 3) TFDL_DW_CASE(3, 5) TFDL_DW_CASE(3, 7)
  TFDL_DW_CASE(5, 1) TFDL_DW_CASE(5, 3) TFDL_DW_CASE(5, 5) TFDL_DW_CASE(5, 7)
  TFDL_DW_CASE(7, 1) TFDL_DW_CASE(7, 3) TFDL_DW_CASE(7, 5) TFDL_DW_CASE(7, 7)
  if (!launched) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tfdl_depthwise_dw_sum_kernel<E><<<tfdl_blocks(n), TFDL_THREADS, 0, s>>>(
      (const float*)partial, (E*)dw, tiles, n);
  return (int)cudaGetLastError();
}

// x, g: float32 NHWC; partial [tiles, kh*kw, C] and dw [kh, kw, C] float32
extern "C" int tfdl_depthwise_dw_f32(const void* x, const void* g,
                                     void* partial, void* dw, int B, int H,
                                     int W, int C, int kh, int kw, int rate,
                                     int64_t tiles, int64_t tile_rows,
                                     void* stream) {
  return tfdl_dw_tiles<float>(x, g, partial, dw, B, H, W, C, kh, kw, rate, tiles, tile_rows, stream);
}

// x, g: bfloat16 NHWC; partial float32; dw bfloat16
extern "C" int tfdl_depthwise_dw_bf16(const void* x, const void* g,
                                      void* partial, void* dw, int B, int H,
                                      int W, int C, int kh, int kw, int rate,
                                      int64_t tiles, int64_t tile_rows,
                                      void* stream) {
  return tfdl_dw_tiles<__nv_bfloat16>(x, g, partial, dw, B, H, W, C, kh, kw, rate, tiles, tile_rows, stream);
}

// -- the band kernel ------------------------------------------------------------

#define TFDL_DWB_THREADS 256
#define TFDL_DWB_WARPS (TFDL_DWB_THREADS / 32)
#define TFDL_DWB_SMEM_MAX 232448  // 227 KB: the most shared memory a block may use

// one thread's 4 channels: 16 bytes of float32, 8 of bf16
__device__ __forceinline__ void tfdl_dwb_cp4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void tfdl_dwb_cp4(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Copies image b's band: x rows [ry0, ry1) to buf, g rows [y0, y1) to
// buf + goff, `channels` (= 4 << lg_nv) channels from c0, then commits.
template <typename E>
__device__ __forceinline__ void tfdl_dwb_stage(
    const E* __restrict__ x, const E* __restrict__ g, E* buf,
    int goff, int b, int H, int W, int C, int c0, int lg_nv, int ry0, int ry1,
    int y0, int y1) {
  const int nv = 1 << lg_nv, cs = nv * 4;
  const E* xsrc = x + ((int64_t)b * H + ry0) * W * C + c0;
  const E* gsrc = g + ((int64_t)b * H + y0) * W * C + c0;
  const int xv = ((ry1 - ry0) * W) << lg_nv, gv = ((y1 - y0) * W) << lg_nv;
  for (int i = threadIdx.x; i < xv + gv; i += TFDL_DWB_THREADS) {
    const bool is_x = i < xv;
    const int k = is_x ? i : i - xv;
    const int px = k >> lg_nv, v = k & (nv - 1);
    if (c0 + v * 4 >= C) continue;  // the ragged last slice
    tfdl_dwb_cp4((is_x ? buf : buf + goff) + px * cs + v * 4,
                 (is_x ? xsrc : gsrc) + (int64_t)px * C + v * 4);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid: (tiles = groups * bands, slices); partial [tiles, KH*KW, C];
// stage_elems and goff count elements of E
template <typename E, int KH, int KW>
__global__ void __launch_bounds__(TFDL_DWB_THREADS)
    tfdl_depthwise_dw_band_kernel(const E* __restrict__ x,
                                  const E* __restrict__ g,
                                  float* __restrict__ partial, int B, int H,
                                  int W, int C, int rate, int lg_nv,
                                  int band_rows, int bands, int images,
                                  int stages, int stage_elems, int goff) {
  extern __shared__ __align__(16) float tfdl_dwb_smem[];
  E* const stage_base = reinterpret_cast<E*>(tfdl_dwb_smem);
  const int nv = 1 << lg_nv, cs = nv * 4, lg_cs = lg_nv + 2;
  const int lanes = TFDL_DWB_THREADS >> lg_nv;
  const int cv = threadIdx.x & (nv - 1), lane = threadIdx.x >> lg_nv;
  const int tile = blockIdx.x;
  const int group = tile / bands, band = tile - group * bands;
  const int c0 = blockIdx.y * cs;
  const bool cvalid = c0 + cv * 4 < C;  // C % 4 == 0: a vector is whole or absent
  const int ph = rate * (KH - 1) / 2, pw = rate * (KW - 1) / 2;
  const int y0 = band * band_rows, y1 = min(H, y0 + band_rows);
  const int ry0 = max(0, y0 - ph), ry1 = min(H, y1 + ph);
  const int b0 = group * images, b1 = min(B, b0 + images);

  float4 acc[KH * KW];
#pragma unroll
  for (int t = 0; t < KH * KW; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (stages == 2)
    tfdl_dwb_stage(x, g, stage_base, goff, b0, H, W, C, c0, lg_nv, ry0, ry1, y0, y1);
  for (int b = b0, k = 0; b < b1; ++b, ++k) {
    E* buf = stage_base + (stages == 2 ? (k & 1) * stage_elems : 0);
    if (stages == 2) {
      if (b + 1 < b1) {
        tfdl_dwb_stage(x, g, stage_base + ((k + 1) & 1) * stage_elems, goff, b + 1, H, W, C,
                       c0, lg_nv, ry0, ry1, y0, y1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
    } else {
      tfdl_dwb_stage(x, g, buf, goff, b, H, W, C, c0, lg_nv, ry0, ry1, y0, y1);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (cvalid) {
      const E* gb = buf + goff + cv * 4;
      const E* xb = buf + cv * 4;
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        const int dy = i * rate - ph;
        const int ylo = max(y0, -dy), ny = min(y1, H - dy) - ylo;
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const int dx = j * rate - pw;
          const int xlo = max(0, -dx), nx = min(W, W - dx) - xlo;
          // the rectangle of output pixels whose tap (i, j) lies in the image
          const int n = ny > 0 && nx > 0 ? ny * nx : 0;
          if (lane >= n) continue;
          const int sr = lanes / nx, sk = lanes - sr * nx;
          int r = lane / nx, kx = lane - r * nx;
          int o = (ylo - y0 + r) * W + xlo + kx;         // g pixel in the band
          const int xo = (y0 - ry0 + dy) * W + dx;       // its tap's x pixel: o + xo
          const int step = sr * W + sk, wrap = W - nx;
          float4 a = acc[i * KW + j];
          for (int q = lane; q < n; q += lanes) {
            const float4 gv = tfdl_ld4(gb + (o << lg_cs));
            const float4 xv = tfdl_ld4(xb + ((o + xo) << lg_cs));
            a.x = fmaf(gv.x, xv.x, a.x);
            a.y = fmaf(gv.y, xv.y, a.y);
            a.z = fmaf(gv.z, xv.z, a.z);
            a.w = fmaf(gv.w, xv.w, a.w);
            o += step;
            kx += sk;
            if (kx >= nx) {
              kx -= nx;
              o += wrap;
            }
          }
          acc[i * KW + j] = a;
        }
      }
    }
    __syncthreads();  // the buffer is staged again two images on
  }

  // the lanes of a warp (threads cv, cv + nv, ...) by a fixed butterfly,
  // then the warps in order through shared memory (the staging is done)
  float* red = tfdl_dwb_smem;  // [WARPS][KH*KW][cs]
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < KH * KW; ++t) {
    float4 a = acc[t];
    for (int off = nv; off < 32; off <<= 1) {
      a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
    }
    if (wl < nv)
      *reinterpret_cast<float4*>(red + ((warp * KH * KW + t) << lg_cs) + cv * 4) = a;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < (KH * KW) << lg_cs; k += TFDL_DWB_THREADS) {
    const int t = k >> lg_cs, ci = k & (cs - 1);
    if (c0 + ci >= C) continue;
    float s = red[k];
#pragma unroll
    for (int w = 1; w < TFDL_DWB_WARPS; ++w) s += red[w * ((KH * KW) << lg_cs) + k];
    partial[((int64_t)tile * (KH * KW) + t) * C + c0 + ci] = s;
  }
}

// dw[k] = sum over tiles, in tile order, of partial[tile][k], stored as D:
// the second pass of the band kernel, launched as a programmatic dependent
// of it so that its launch overlaps the band kernel's tail;
// griddepcontrol.wait holds it until the band kernel's partial is complete
// and visible.
template <typename D>
__global__ void tfdl_depthwise_dw_band_sum_kernel(
    const float* __restrict__ partial, D* __restrict__ dw, int64_t tiles,
    int64_t n) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int64_t t = 0; t < tiles; ++t) s += partial[t * n + k];
    tfdl_store(dw + k, s);
  }
}

template <typename E, int KH, int KW>
static int tfdl_dwb_launch(dim3 grid, int smem, cudaStream_t s, const E* x,
                           const E* g, float* partial, int B, int H,
                           int W, int C, int rate, int lg_nv, int band_rows,
                           int bands, int images, int stages, int stage_elems,
                           int goff) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tfdl_depthwise_dw_band_kernel<E, KH, KW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  tfdl_depthwise_dw_band_kernel<E, KH, KW><<<grid, TFDL_DWB_THREADS, smem, s>>>(
      x, g, partial, B, H, W, C, rate, lg_nv, band_rows, bands, images,
      stages, stage_elems, goff);
  return (int)cudaGetLastError();
}

#define TFDL_DWB_CASE(KH_, KW_)                                              \
  if (kh == KH_ && kw == KW_)                                                \
    code = tfdl_dwb_launch<E, KH_, KW_>(                                    \
        grid, (int)smem, s, (const E*)x, (const E*)g,                        \
        (float*)partial, B, H, W, C, rate, lg_nv, band_rows, bands, images,  \
        stages, (int)stage_elems, (int)goff);

// The plan (ops/kernels.py dw_plan): `channels` a block (4, 8, 16 or 32),
// `band_rows` rows a band, `images` images a block, `stages` 1 or 2. Needs
// C % 4 == 0 and x, g aligned to a thread's 4 channels (16 bytes of
// float32, 8 of bf16); partial is [tiles, kh*kw, C] float32 with tiles =
// ceil(B / images) * ceil(H / band_rows), summed in tile order by a second,
// dependent launch into dw (E). Returns a cudaError_t as int:
// cudaErrorInvalidValue for a plan that does not fit.
template <typename E>
static int tfdl_dw_band(const void* x, const void* g, void* partial, void* dw,
                        int B, int H, int W, int C, int kh, int kw, int rate,
                        int channels, int band_rows, int images, int stages,
                        void* stream) {
  const int64_t n = (int64_t)kh * kw * C;
  if (n == 0) return (int)cudaSuccess;
  int lg_nv = 0;
  while ((4 << lg_nv) < channels) ++lg_nv;
  const uintptr_t align = 4 * sizeof(E) - 1;
  if ((int64_t)B * H * W == 0 || C % 4 != 0 || (4 << lg_nv) != channels ||
      channels > 32 || band_rows < 1 || images < 1 ||
      (stages != 1 && stages != 2) || rate < 1 ||
      (((uintptr_t)x | (uintptr_t)g) & align) != 0)
    return (int)cudaErrorInvalidValue;
  const int ph = rate * (kh - 1) / 2;
  const int bands = (H + band_rows - 1) / band_rows;
  const int64_t groups = ((int64_t)B + images - 1) / images;
  const int64_t slices = ((int64_t)C + channels - 1) / channels;
  const int64_t region = (int64_t)(band_rows + 2 * ph < H ? band_rows + 2 * ph : H);
  const int64_t goff = region * W * channels;
  const int64_t stage_elems = goff + (int64_t)band_rows * W * channels;
  const int64_t red_floats = (int64_t)TFDL_DWB_WARPS * kh * kw * channels;
  const int64_t stage_bytes = (int64_t)sizeof(E) * stages * stage_elems;
  const int64_t smem = stage_bytes > 4 * red_floats ? stage_bytes : 4 * red_floats;
  if (smem > TFDL_DWB_SMEM_MAX || groups * bands > 0x7fffffff || slices > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = groups * bands;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned int)tiles, (unsigned int)slices);
  int code = (int)cudaErrorInvalidValue;
  TFDL_DWB_CASE(1, 1) TFDL_DWB_CASE(1, 3) TFDL_DWB_CASE(1, 5) TFDL_DWB_CASE(1, 7)
  TFDL_DWB_CASE(3, 1) TFDL_DWB_CASE(3, 3) TFDL_DWB_CASE(3, 5) TFDL_DWB_CASE(3, 7)
  TFDL_DWB_CASE(5, 1) TFDL_DWB_CASE(5, 3) TFDL_DWB_CASE(5, 5) TFDL_DWB_CASE(5, 7)
  TFDL_DWB_CASE(7, 1) TFDL_DWB_CASE(7, 3) TFDL_DWB_CASE(7, 5) TFDL_DWB_CASE(7, 7)
  if (code != (int)cudaSuccess) return code;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tfdl_blocks(n));
  config.blockDim = dim3(TFDL_THREADS);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, tfdl_depthwise_dw_band_sum_kernel<E>,
                                 (const float*)partial, (E*)dw, tiles, n);
}

// x, g: float32; partial and dw float32
extern "C" int tfdl_depthwise_dw_band_f32(const void* x, const void* g,
                                          void* partial, void* dw, int B,
                                          int H, int W, int C, int kh, int kw,
                                          int rate, int channels,
                                          int band_rows, int images,
                                          int stages, void* stream) {
  return tfdl_dw_band<float>(x, g, partial, dw, B, H, W, C, kh, kw, rate, channels, band_rows, images, stages,
                             stream);
}

// x, g: bfloat16; partial float32; dw bfloat16
extern "C" int tfdl_depthwise_dw_band_bf16(const void* x, const void* g,
                                           void* partial, void* dw, int B,
                                           int H, int W, int C, int kh, int kw,
                                           int rate, int channels,
                                           int band_rows, int images,
                                           int stages, void* stream) {
  return tfdl_dw_band<__nv_bfloat16>(x, g, partial, dw, B, H, W, C, kh, kw, rate, channels, band_rows, images,
                                     stages, stream);
}
