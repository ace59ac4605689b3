// Fused inference BatchNorm + activation (+ residual add), float32.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   fused_bn_act (kernel bodies _bn_act_kernel and _bn_act_res_kernel; the
//   fold _fold_bn stays outside the kernel, in f32 torch ops on [C] vectors).
//
// Computes out = act(x * m[c] + b[c] (+ r)), c = index % C, for NHWC x.
// act: 0 none, 1 relu, 2 relu6, 3 sigmoid, 4 gelu (tanh approximation,
// which is what jax.nn.gelu computes by default).
//
// What bounds it on an H100: memory. One f32 read of x (and r), one f32
// write of out, and a handful of flops per element; the [C] vectors stay in
// L1/L2. At the serve path's shapes the pass is bytes / 3.35 TB/s.
//
// Design: one thread per element with C fastest, so a warp's loads and
// stores are contiguous 128-byte lines. The multiply and the add are
// rounded separately (__fmul_rn, __fadd_rn) so the kernel repeats the plain
// PyTorch version's arithmetic exactly and is not contracted into an FMA.

#include "common.cuh"

__device__ __forceinline__ float tfdl_act(float y, int act) {
  switch (act) {
    case 1:
      return fmaxf(y, 0.0f);
    case 2:
      return fminf(fmaxf(y, 0.0f), 6.0f);
    case 3:
      return 1.0f / (1.0f + expf(-y));
    case 4: {
      const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
      const float kKappa = 0.044715f;
      const float inner = kBeta * (y + kKappa * y * y * y);
      return 0.5f * y * (1.0f + tanhf(inner));
    }
    default:
      return y;
  }
}

__global__ void tfdl_bn_act_kernel(const float* __restrict__ x,
                                   const float* __restrict__ m,
                                   const float* __restrict__ b,
                                   const float* __restrict__ r,
                                   float* __restrict__ out, int64_t total,
                                   int C, int act) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    float y = __fadd_rn(__fmul_rn(x[idx], m[c]), b[c]);
    if (r != nullptr) y = __fadd_rn(y, r[idx]);
    out[idx] = tfdl_act(y, act);
  }
}

extern "C" int tfdl_bn_act_f32(const void* x, const void* m, const void* b,
                               const void* r, void* out, int64_t total, int C,
                               int act, void* stream) {
  if (total == 0) return (int)cudaSuccess;
  tfdl_bn_act_kernel<<<tfdl_blocks(total), TFDL_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const float*)x, (const float*)m, (const float*)b, (const float*)r,
      (float*)out, total, C, act);
  return (int)cudaGetLastError();
}
