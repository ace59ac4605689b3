// Filter gradient of the stride-1 SAME depthwise 2-D convolution, float32.
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
// Design: a block owns 32 channels (threadIdx.x, fastest, so a warp reads
// 128 contiguous bytes of one pixel) and a tile of `tile_rows` consecutive
// (b, y, x) pixels, spread over 8 lanes (threadIdx.y). Each thread keeps all
// kh*kw tap sums in registers and walks its pixels once: g is read once per
// pixel, and the kh*kw shifted reads of x fall on neighbouring pixels of the
// same tile, which L1/L2 serve, so device memory sees x about once per tile.
// The 8 lanes are summed through shared memory in a fixed order into a
// [tiles, kh, kw, C] scratch, and a second pass sums the tiles in order.
// There are no atomics: dw is bit-identical from launch to launch.
//
// Layout: x and g are NHWC contiguous; partial is [tiles, kh*kw, C]; dw is
// [kh, kw, C]. Filters up to 7x7 (odd sides) are instantiated.

#include "common.cuh"

#define TFDL_DW_CH 32
#define TFDL_DW_LANES 8

template <int KH, int KW>
__global__ void tfdl_depthwise_dw_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
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
      const float gv = g[p * C + c];
      const float* xb = x + b * (int64_t)H * W * C + c;
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        const int iy = oy + i * rate - ph;
        const bool row_in = iy >= 0 && iy < H;
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          const int ix = ox + j * rate - pw;
          if (row_in && ix >= 0 && ix < W) {
            acc[i * KW + j] =
                fmaf(gv, xb[((int64_t)iy * W + ix) * C], acc[i * KW + j]);
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

// dw[k] = sum over tiles, in tile order, of partial[tile][k], k = tap*C + c.
__global__ void tfdl_depthwise_dw_sum_kernel(const float* __restrict__ partial,
                                             float* __restrict__ dw,
                                             int64_t tiles, int64_t n) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int64_t t = 0; t < tiles; ++t) s += partial[t * n + k];
    dw[k] = s;
  }
}

#define TFDL_DW_CASE(KH_, KW_)                                               \
  if (kh == KH_ && kw == KW_) {                                              \
    tfdl_depthwise_dw_partial_kernel<KH_, KW_><<<grid, block, 0, s>>>(       \
        (const float*)x, (const float*)g, (float*)partial, H, W, C, rate, P, \
        tile_rows);                                                          \
    launched = true;                                                         \
  }

// Returns a cudaError_t as int: cudaErrorInvalidValue for a filter side
// that is not odd and <= 7, or a tile count past the grid's y limit.
extern "C" int tfdl_depthwise_dw_f32(const void* x, const void* g,
                                     void* partial, void* dw, int B, int H,
                                     int W, int C, int kh, int kw, int rate,
                                     int64_t tiles, int64_t tile_rows,
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
  tfdl_depthwise_dw_sum_kernel<<<tfdl_blocks(n), TFDL_THREADS, 0, s>>>(
      (const float*)partial, (float*)dw, tiles, n);
  return (int)cudaGetLastError();
}
