// Fused per-channel bias + activation over the last axis.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   fused_bias_act (kernel body _fused_bias_act_kernel, the standalone face
//   of bias_act_epilogue). The TPU kernel held row blocks of [rows, C] in
//   VMEM with the bias row beside them.
//
// Computes out = act(float(x) + bias[c]) in f32 for x viewed as [P, C], and
// stores it in x's dtype (float32 or bfloat16, rounded to nearest even).
// bias may be null (no add). The per-element math is epilogue.cuh's
// tfdl_bias_act, the tail the int8 kernels end in, so both kernels below
// give the same bits.
//
// What bounds it on an H100: memory. One read of x and one write of out per
// element (2 + 2 bytes in bf16, 4 + 4 in f32) against a few flops; the [C]
// bias is read once per thread: bytes / 3.35 TB/s. The gelu arm's tanhf
// (libm, no fast-math) adds a few dozen instructions an element; in the
// vector arm they overlap the loads, and gelu runs about as fast as relu.
//
// tfdl_bias_act_vec_kernel (the arm ops/kernels.bias_act_plan picks when C
// is a multiple of the vector width, 8 bf16 or 4 floats, and x and out are
// 16-byte aligned): a thread owns one 16-byte column vector of the row. It
// computes its column once, in 32-bit arithmetic, holds that vector's bias
// values in registers, and walks the rows p, p + rows, ... with a fixed
// pointer stride: no division or modulo per element. Each step issues
// TFDL_BA_UNROLL rows' 16-byte loads before any arithmetic, then stores
// 16 bytes a row. The activation and whether there is a bias are template
// arguments, resolved at compile time. The host plan sizes the launch to at
// most one wave of TFDL_BA_BLOCKS_SM blocks on every SM.
//
// tfdl_bias_act_kernel (the earlier kernel, and the scalar arm for any
// other shape or base): one thread per element, C fastest, grid-stride, the
// channel a 64-bit index modulo C per element.

#include <cuda_bf16.h>

#include "common.cuh"
#include "epilogue.cuh"

#define TFDL_BA_UNROLL 4
// blocks of TFDL_THREADS resident on an SM: caps registers at 64 a thread
#define TFDL_BA_BLOCKS_SM 4

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

// -- the vector arm -----------------------------------------------------------

// 16 bytes as VEC floats
__device__ __forceinline__ void tfdl_unpack(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ float tfdl_bf16_lo(unsigned int w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
}

__device__ __forceinline__ float tfdl_bf16_hi(unsigned int w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
}

__device__ __forceinline__ void tfdl_unpack(const uint4& q, float (&v)[8]) {
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = tfdl_bf16_lo(w[i]);
    v[2 * i + 1] = tfdl_bf16_hi(w[i]);
  }
}

__device__ __forceinline__ uint4 tfdl_pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// each float rounded to bf16 on its own (__float2bfloat16_rn), as the
// earlier kernel stores it
__device__ __forceinline__ uint4 tfdl_pack(const float (&v)[8]) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned int lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
    const unsigned int hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x, out: [P, C] of T (16-byte aligned, C % VEC == 0); rows: the stride of
// a thread's walk, rows * (C / VEC) <= the launch's threads
template <typename T, int ACT, bool BIAS>
__global__ void __launch_bounds__(TFDL_THREADS, TFDL_BA_BLOCKS_SM)
    tfdl_bias_act_vec_kernel(const T* __restrict__ x, const float* __restrict__ bias, T* __restrict__ out,
                             int64_t P, int C, int rows) {
  constexpr int VEC = 16 / sizeof(T);
  const int G = C / VEC;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * G) return;
  const int c = (t % G) * VEC;  // once a thread
  int64_t p = t / G;
  float bv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) bv[e] = BIAS ? bias[c + e] : 0.0f;
  const int64_t step = (int64_t)rows * (C / VEC);  // uint4s between a thread's rows
  const uint4* src = reinterpret_cast<const uint4*>(x + p * C + c);
  uint4* dst = reinterpret_cast<uint4*>(out + p * C + c);
  for (; p < P; p += TFDL_BA_UNROLL * (int64_t)rows) {
    uint4 q[TFDL_BA_UNROLL];
#pragma unroll
    for (int u = 0; u < TFDL_BA_UNROLL; ++u) {
      if (p + u * (int64_t)rows < P) q[u] = src[u * step];
    }
#pragma unroll
    for (int u = 0; u < TFDL_BA_UNROLL; ++u) {
      if (p + u * (int64_t)rows >= P) break;
      float v[VEC];
      tfdl_unpack(q[u], v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = tfdl_bias_act(v[e], BIAS ? bv : nullptr, e, ACT);
      dst[u * step] = tfdl_pack(v);
    }
    src += TFDL_BA_UNROLL * step;
    dst += TFDL_BA_UNROLL * step;
  }
}

template <typename T, int ACT>
static void tfdl_bias_act_vec_launch(const T* x, const float* bias, T* out, int64_t P, int C, int rows,
                                     int blocks, cudaStream_t st) {
  if (bias != nullptr) {
    tfdl_bias_act_vec_kernel<T, ACT, true><<<blocks, TFDL_THREADS, 0, st>>>(x, bias, out, P, C, rows);
  } else {
    tfdl_bias_act_vec_kernel<T, ACT, false><<<blocks, TFDL_THREADS, 0, st>>>(x, bias, out, P, C, rows);
  }
}

template <typename T>
static int tfdl_bias_act_vec_act(const void* x, const float* bias, void* out, int64_t P, int C, int act,
                                 int rows, int blocks, cudaStream_t st) {
  const T* xt = (const T*)x;
  T* ot = (T*)out;
  switch (act) {
    case 0:
      tfdl_bias_act_vec_launch<T, 0>(xt, bias, ot, P, C, rows, blocks, st);
      break;
    case 1:
      tfdl_bias_act_vec_launch<T, 1>(xt, bias, ot, P, C, rows, blocks, st);
      break;
    case 2:
      tfdl_bias_act_vec_launch<T, 2>(xt, bias, ot, P, C, rows, blocks, st);
      break;
    case 3:
      tfdl_bias_act_vec_launch<T, 3>(xt, bias, ot, P, C, rows, blocks, st);
      break;
    case 4:
      tfdl_bias_act_vec_launch<T, 4>(xt, bias, ot, P, C, rows, blocks, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, out: [P, C] bf16 (x_bf16) or f32, 16-byte aligned, C a multiple of 8
// (bf16) or 4 (f32); bias: f32 [C] or null; rows and blocks from
// ops/kernels.bias_act_plan. Refuses (cudaErrorInvalidValue) what the walk
// does not cover.
extern "C" int tfdl_bias_act_vec(const void* x, int x_bf16, const void* bias, void* out, int64_t P, int C,
                                 int act, int rows, int blocks, void* stream) {
  if (P <= 0 || C <= 0) return (int)cudaSuccess;
  const int vec = x_bf16 ? 8 : 4;
  if (C % vec != 0 || rows < 1 || blocks < 1 || (int64_t)rows * (C / vec) > (int64_t)blocks * TFDL_THREADS ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)out % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    return tfdl_bias_act_vec_act<__nv_bfloat16>(x, (const float*)bias, out, P, C, act, rows, blocks, st);
  }
  return tfdl_bias_act_vec_act<float>(x, (const float*)bias, out, P, C, act, rows, blocks, st);
}
