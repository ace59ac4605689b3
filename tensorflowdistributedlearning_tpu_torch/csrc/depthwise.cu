// Stride-1 SAME depthwise 2-D convolution with atrous rate, float32.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   depthwise_conv2d (kernel body _dw_kernel, launched by _dw_pallas), forward.
//   The TPU kernel held one padded image per grid step in VMEM and summed the
//   kh*kw shifted taps with channels on the 128-wide lanes.
//
// What bounds it on an H100: memory. At the serve path's largest call
// (ASPP, x [64, 13, 13, 1024] f32, 3x3 taps) it reads 44 MB and writes
// 44 MB for about 0.2 GFLOP: ~26 us at 3.35 TB/s against ~3 us of f32 math.
//
// Design: one thread per output element, channels fastest, so the 32 threads
// of a warp read 32 neighbouring channels of the same pixel (128 coalesced
// bytes) for every tap, and read the filter row w[i][j][c..c+31] the same
// way. SAME zero padding is done by bounds checks instead of a padded copy.
// The sum runs in f32 in tap order (i, j), so it differs from a grouped
// convolution only in summation order. Taps are re-read from L2, which
// holds a whole 13x13x1024 image many times over.
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
