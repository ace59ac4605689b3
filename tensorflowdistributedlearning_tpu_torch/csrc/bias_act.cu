// Fused per-channel bias + activation over the last axis.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   fused_bias_act (kernel body _fused_bias_act_kernel, the standalone face
//   of bias_act_epilogue). The TPU kernel held row blocks of [rows, C] in
//   VMEM with the bias row beside them.
//
// Computes out = act(float(x) + bias[c]) in f32, c = index % C, and stores
// it in x's dtype (float32 or bfloat16, rounded to nearest even). bias may
// be null (no add). The tail is epilogue.cuh's, the one the int8 kernels
// end in.
//
// What bounds it on an H100: memory. One read of x and one write of out per
// element (2 + 2 bytes in bf16, 4 + 4 in f32) against a few flops; the [C]
// bias stays in L1/L2: bytes / 3.35 TB/s.
//
// Design: one thread per element, C fastest, grid-stride loop, so a warp
// reads and writes contiguous lines.

#include <cuda_bf16.h>

#include "common.cuh"
#include "epilogue.cuh"

template <bool BF16>
__global__ void tfdl_bias_act_kernel(const void* __restrict__ x,
                                     const float* __restrict__ bias,
                                     void* __restrict__ out, int64_t total,
                                     int C, int act) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    if (BF16) {
      const float y = __bfloat162float(((const __nv_bfloat16*)x)[idx]);
      ((__nv_bfloat16*)out)[idx] =
          __float2bfloat16_rn(tfdl_bias_act(y, bias, c, act));
    } else {
      ((float*)out)[idx] = tfdl_bias_act(((const float*)x)[idx], bias, c, act);
    }
  }
}

extern "C" int tfdl_bias_act(const void* x, int x_bf16, const void* bias,
                             void* out, int64_t total, int C, int act,
                             void* stream) {
  if (total == 0) return (int)cudaSuccess;
  if (x_bf16) {
    tfdl_bias_act_kernel<true>
        <<<tfdl_blocks(total), TFDL_THREADS, 0, (cudaStream_t)stream>>>(
            x, (const float*)bias, out, total, C, act);
  } else {
    tfdl_bias_act_kernel<false>
        <<<tfdl_blocks(total), TFDL_THREADS, 0, (cudaStream_t)stream>>>(
            x, (const float*)bias, out, total, C, act);
  }
  return (int)cudaGetLastError();
}
