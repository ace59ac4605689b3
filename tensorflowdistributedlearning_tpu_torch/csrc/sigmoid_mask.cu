// Fused segmentation serve head: probabilities and binary mask from one read
// of the logits, float32.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   fused_sigmoid_mask (kernel body _sigmoid_mask_kernel).
//
// Contract: bit-identical to the unfused PyTorch ops
//   p = torch.sigmoid(x); mask = (p > t).float()
// On CUDA, torch.sigmoid computes 1 / (1 + exp(-x)) in float with IEEE
// division and the accurate expf; this file is compiled without
// --use_fast_math so it computes the same bits.
//
// What bounds it on an H100: memory, one f32 read and two f32 writes per
// element (~7.8 MB at bucket 64, a few microseconds); at these sizes the
// launch itself is the larger cost.
//
// Design: one thread per element, grid-stride, contiguous loads and stores.

#include "common.cuh"

__global__ void tfdl_sigmoid_mask_kernel(const float* __restrict__ x,
                                         float* __restrict__ probs,
                                         float* __restrict__ mask,
                                         int64_t total, float threshold) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const float p = 1.0f / (1.0f + expf(-x[idx]));
    probs[idx] = p;
    mask[idx] = p > threshold ? 1.0f : 0.0f;
  }
}

extern "C" int tfdl_sigmoid_mask_f32(const void* x, void* probs, void* mask,
                                     int64_t total, float threshold,
                                     void* stream) {
  if (total == 0) return (int)cudaSuccess;
  tfdl_sigmoid_mask_kernel<<<tfdl_blocks(total), TFDL_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const float*)x, (float*)probs, (float*)mask, total, threshold);
  return (int)cudaGetLastError();
}
