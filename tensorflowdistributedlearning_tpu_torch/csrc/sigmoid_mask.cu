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
// --use_fast_math so it computes the same bits. Both kernels below take the
// one expression, tfdl_sigmoid.
//
// What bounds it on an H100: memory, one f32 read and two f32 writes per
// element (7.8 MB at bucket 64: 2.3 us at 3.35 TB/s).
//
// tfdl_sigmoid_mask_vec_kernel (the one the wrapper launches when the
// logits and both outputs are 16-byte aligned): each thread loads
// TFDL_SM_UNROLL float4s, all issued before any arithmetic, then stores two
// float4s for each; the grid covers the SMs once (at most as many threads as
// they hold) and strides over the rest. The n % 4 tail is computed by block
// 0's first threads, element by element.
//
// tfdl_sigmoid_mask_kernel (the earlier kernel, and the scalar arm for an
// unaligned base): one thread per element, grid-stride, 4-byte accesses.

#include "common.cuh"

#define TFDL_SM_UNROLL 4

__device__ __forceinline__ float tfdl_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void tfdl_sigmoid_mask_kernel(const float* __restrict__ x,
                                         float* __restrict__ probs,
                                         float* __restrict__ mask,
                                         int64_t total, float threshold) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const float p = tfdl_sigmoid(x[idx]);
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

__global__ void __launch_bounds__(TFDL_THREADS)
    tfdl_sigmoid_mask_vec_kernel(const float4* __restrict__ x,
                                 float4* __restrict__ probs,
                                 float4* __restrict__ mask, int64_t total,
                                 float threshold) {
  const int64_t n4 = total / 4;
  const int64_t span = (int64_t)TFDL_THREADS * TFDL_SM_UNROLL;
  for (int64_t base = (int64_t)blockIdx.x * span + threadIdx.x; base < n4;
       base += (int64_t)gridDim.x * span) {
    float4 v[TFDL_SM_UNROLL];
#pragma unroll
    for (int u = 0; u < TFDL_SM_UNROLL; ++u) {
      const int64_t i = base + u * TFDL_THREADS;
      v[u] = i < n4 ? x[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < TFDL_SM_UNROLL; ++u) {
      const int64_t i = base + u * TFDL_THREADS;
      if (i >= n4) break;
      const float4 p = make_float4(tfdl_sigmoid(v[u].x), tfdl_sigmoid(v[u].y),
                                   tfdl_sigmoid(v[u].z), tfdl_sigmoid(v[u].w));
      probs[i] = p;
      mask[i] = make_float4(p.x > threshold ? 1.0f : 0.0f, p.y > threshold ? 1.0f : 0.0f,
                            p.z > threshold ? 1.0f : 0.0f, p.w > threshold ? 1.0f : 0.0f);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < total - 4 * n4) {
    const int64_t idx = 4 * n4 + threadIdx.x;
    const float p = tfdl_sigmoid(reinterpret_cast<const float*>(x)[idx]);
    reinterpret_cast<float*>(probs)[idx] = p;
    reinterpret_cast<float*>(mask)[idx] = p > threshold ? 1.0f : 0.0f;
  }
}

// vec = 1 (x, probs and mask 16-byte aligned) takes the float4 kernel,
// vec = 0 the scalar one; the choice is the wrapper's, from the pointers.
extern "C" int tfdl_sigmoid_mask_vec_f32(const void* x, void* probs,
                                         void* mask, int64_t total,
                                         float threshold, int vec,
                                         void* stream) {
  if (!vec) return tfdl_sigmoid_mask_f32(x, probs, mask, total, threshold, stream);
  if (total == 0) return (int)cudaSuccess;
  if ((((uintptr_t)x | (uintptr_t)probs | (uintptr_t)mask) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  static int cached_device = -1;
  static int64_t resident_blocks = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return (int)err;
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
    if (err != cudaSuccess) return (int)err;
    resident_blocks = (int64_t)sms * (per_sm / TFDL_THREADS);
    cached_device = device;
  }
  const int64_t span = (int64_t)TFDL_THREADS * TFDL_SM_UNROLL;
  int64_t blocks = (total / 4 + span - 1) / span;
  if (blocks < 1) blocks = 1;
  if (blocks > resident_blocks) blocks = resident_blocks;
  tfdl_sigmoid_mask_vec_kernel<<<(unsigned int)blocks, TFDL_THREADS, 0,
                                 (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)probs, (float4*)mask, total, threshold);
  return (int)cudaGetLastError();
}
