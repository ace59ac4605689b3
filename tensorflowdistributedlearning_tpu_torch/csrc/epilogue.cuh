// The shared f32 epilogue of the hand-written kernels: act(y + bias[n]).
//
// One home for the tail math, as the JAX package gives it one
// (ops/pallas_kernels.py bias_act_epilogue): fused_bn_act (bn_act.cu),
// fused_bias_act (bias_act.cu) and the int8 matmul/conv epilogue
// (int8_conv.cu) all end here, so a kernel and its plain version can only
// disagree about the tail where libm does (sigmoid, gelu).
//
// act: 0 none, 1 relu, 2 relu6, 3 sigmoid, 4 gelu (tanh approximation, what
// jax.nn.gelu computes by default); the codes are ops/kernels.py ACTIVATIONS.
#pragma once

#include <cuda_runtime.h>

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

// act(y + bias[n]); bias may be null (no add). The add is rounded on its
// own (__fadd_rn) so it is never contracted into an FMA with the product
// that produced y.
__device__ __forceinline__ float tfdl_bias_act(float y, const float* bias,
                                               int n, int act) {
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  return tfdl_act(y, act);
}
