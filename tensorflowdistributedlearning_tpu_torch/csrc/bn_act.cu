// Fused inference BatchNorm + activation (+ residual add).
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   fused_bn_act (kernel bodies _bn_act_kernel and _bn_act_res_kernel; the
//   fold _fold_bn stays outside the kernel, in f32 torch ops on [C] vectors).
//
// Two entry points:
// - tfdl_bn_act_f32: out = act(x * m[c] + b[c] (+ r)), c = index % C, for
//   NHWC float32 x with the folded f32 vectors (float32 parameters);
// - tfdl_bn_act_unfolded: flax's own order for bfloat16 parameters (the
//   quantized serving specs), out = act(((x - mean[c]) * mul[c]) + bias[c])
//   with every step rounded to bf16 when x is bf16 (flax computes in the
//   promoted dtype of x and the bf16 statistics) and to f32 when x is f32;
//   out is always f32 (the BN module's dtype).
// act: see epilogue.cuh.
//
// What bounds it on an H100: memory. One read of x (and r), one f32 write
// of out, and a handful of flops per element; the [C] vectors stay in
// L1/L2. At the serve path's shapes the pass is bytes / 3.35 TB/s.
//
// Design: one thread per element with C fastest, so a warp's loads and
// stores are contiguous lines. Every multiply and add is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn) so the kernel repeats the plain PyTorch
// version's arithmetic exactly and is not contracted into an FMA.

#include <cuda_bf16.h>

#include "common.cuh"
#include "epilogue.cuh"

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

__device__ __forceinline__ float tfdl_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__global__ void tfdl_bn_act_unfolded_kernel(const void* __restrict__ x,
                                            const float* __restrict__ mean,
                                            const float* __restrict__ mul,
                                            const float* __restrict__ bias,
                                            float* __restrict__ out,
                                            int64_t total, int C, int act) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    float y;
    if (BF16) {
      y = __bfloat162float(((const __nv_bfloat16*)x)[idx]);
      y = tfdl_round_bf16(__fsub_rn(y, mean[c]));
      y = tfdl_round_bf16(__fmul_rn(y, mul[c]));
      y = tfdl_round_bf16(__fadd_rn(y, bias[c]));
    } else {
      y = ((const float*)x)[idx];
      y = __fadd_rn(__fmul_rn(__fsub_rn(y, mean[c]), mul[c]), bias[c]);
    }
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

extern "C" int tfdl_bn_act_unfolded(const void* x, int x_bf16,
                                    const void* mean, const void* mul,
                                    const void* bias, void* out,
                                    int64_t total, int C, int act,
                                    void* stream) {
  if (total == 0) return (int)cudaSuccess;
  if (x_bf16) {
    tfdl_bn_act_unfolded_kernel<true>
        <<<tfdl_blocks(total), TFDL_THREADS, 0, (cudaStream_t)stream>>>(
            x, (const float*)mean, (const float*)mul, (const float*)bias,
            (float*)out, total, C, act);
  } else {
    tfdl_bn_act_unfolded_kernel<false>
        <<<tfdl_blocks(total), TFDL_THREADS, 0, (cudaStream_t)stream>>>(
            x, (const float*)mean, (const float*)mul, (const float*)bias,
            (float*)out, total, C, act);
  }
  return (int)cudaGetLastError();
}
