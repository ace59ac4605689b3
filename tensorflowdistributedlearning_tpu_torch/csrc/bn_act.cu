// Fused inference BatchNorm + activation (+ residual add).
//
// Replaces: tensorflowdistributedlearning_tpu/ops/pallas_kernels.py
//   fused_bn_act (kernel bodies _bn_act_kernel and _bn_act_res_kernel; the
//   fold _fold_bn stays outside the kernel, in f32 torch ops on [C] vectors).
//
// Three entry points, the first two with their earlier kernels kept beside
// them (timed against them and held to them bit for bit; no path calls the
// earlier ones):
// - tfdl_bn_act_rows_f32 (earlier: tfdl_bn_act_f32): out = act(x * m[c] +
//   b[c] (+ r)) for NHWC float32 x with the folded f32 vectors (float32
//   parameters);
// - tfdl_bn_act_rows_bf16: the same with bfloat16 activations (x, r and
//   out bf16; the bf16-compute models' eval-mode BatchNorm), the f32 fold:
//   x and r widened to f32, the same f32 arithmetic, the result rounded
//   once to bf16 (round to nearest even), as the TPU kernel computes in
//   f32 and writes x.dtype. Its vector arm takes 8 channels a thread (one
//   16-byte load of x and r, one 16-byte store, two float4 loads of each
//   fold vector) where C % 8 == 0 and every base is 16-byte aligned
//   (ops/kernels.py bn_act_vectorized_bf16); else one channel a thread;
// - tfdl_bn_act_rows_unfolded (earlier: tfdl_bn_act_unfolded): flax's own
//   order for bfloat16 parameters (the quantized serving specs), out =
//   act(((x - mean[c]) * mul[c]) + bias[c]) with every step rounded to bf16
//   when x is bf16 (flax computes in the promoted dtype of x and the bf16
//   statistics) and to f32 when x is f32; out is always f32 (the BN
//   module's dtype).
// act: see epilogue.cuh.
//
// What bounds it on an H100: memory. One read of x (and r), one f32 write
// of out, and a handful of flops per element; the [C] vectors stay in
// registers. At the serve path's shapes (59 calls per bucket-64 forward,
// 51x51x128 down to 13x13x256 at batch 64) the pass is bytes / 3.35 TB/s.
//
// Design: x is a [P, C] matrix of P = B*H*W pixel rows. A thread owns VEC
// consecutive channels of one channel group (its group is its index modulo
// C / VEC, taken once), loads its vectors once into registers, and walks
// the pixel rows p, p + rows, ... two at a time, where rows = the launch's
// threads / (C / VEC): no division or modulo per element. VEC = 4 takes
// 16-byte loads and stores (8-byte loads for bf16 x); VEC = 1 (C % 4 != 0
// or a base not 16-byte aligned: the wrapper decides from shape and
// alignment) takes scalar ones. The launch holds as many threads as the
// card keeps resident (SMs x threads per SM), so even the 13x13x256 calls
// (2.77 M elements) fill every SM. Every multiply and add is rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn), as in the earlier kernels, so the
// kernels repeat the plain PyTorch version's arithmetic exactly and are not
// contracted into an FMA.
//
// The earlier kernels: one thread per element with C fastest, the channel
// as a 64-bit index modulo C per element, scalar loads.

#include <cuda_bf16.h>

#include "common.cuh"
#include "epilogue.cuh"

__device__ __forceinline__ float tfdl_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC consecutive floats at p (16-byte aligned when VEC is 4)
template <int VEC>
__device__ __forceinline__ void tfdl_ld(const float* __restrict__ p, float (&v)[VEC]) {
  if (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2 % VEC] = q.z;
    v[3 % VEC] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void tfdl_st(float* __restrict__ p, const float (&v)[VEC]) {
  if (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1 % VEC], v[2 % VEC], v[3 % VEC]);
  } else {
    *p = v[0];
  }
}

// VEC consecutive bf16 at p (8-byte aligned when VEC is 4), widened to f32
template <int VEC>
__device__ __forceinline__ void tfdl_ld(const __nv_bfloat16* __restrict__ p, float (&v)[VEC]) {
  if (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo);
    v[1 % VEC] = __high2float(lo);
    v[2 % VEC] = __low2float(hi);
    v[3 % VEC] = __high2float(hi);
  } else {
    v[0] = __bfloat162float(*p);
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

// -- the row kernels ----------------------------------------------------------

// folded: out = act(x * m[c] + b[c] (+ r)); see the header for the walk
template <int VEC>
__global__ void __launch_bounds__(TFDL_THREADS)
    tfdl_bn_act_rows_kernel(const float* __restrict__ x, const float* __restrict__ m,
                            const float* __restrict__ b, const float* __restrict__ r,
                            float* __restrict__ out, int64_t P, int C, int64_t rows, int act) {
  const int G = C / VEC;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * G) return;
  const int c = (int)(t % G) * VEC;
  float mv[VEC], bv[VEC];
  tfdl_ld<VEC>(m + c, mv);
  tfdl_ld<VEC>(b + c, bv);
  for (int64_t p = t / G; p < P; p += 2 * rows) {
    // two rows in flight: both loads issue before either row is computed
    const bool two = p + rows < P;
    float xv[2][VEC], rv[2][VEC];
    tfdl_ld<VEC>(x + p * C + c, xv[0]);
    if (two) tfdl_ld<VEC>(x + (p + rows) * C + c, xv[1]);
    if (r != nullptr) {
      tfdl_ld<VEC>(r + p * C + c, rv[0]);
      if (two) tfdl_ld<VEC>(r + (p + rows) * C + c, rv[1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = __fadd_rn(__fmul_rn(xv[u][e], mv[e]), bv[e]);
        if (r != nullptr) v = __fadd_rn(v, rv[u][e]);
        y[e] = tfdl_act(v, act);
      }
      tfdl_st<VEC>(out + (p + u * rows) * C + c, y);
    }
  }
}

// bf16 activations: out = bf16(act(x * m[c] + b[c] (+ r))), x and r bf16;
// VEC 8 or 1 channels a thread (8: 16-byte words of x, r and out)
__device__ __forceinline__ void tfdl_ld_bf16(const __nv_bfloat16* __restrict__ p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void tfdl_ld_bf16(const __nv_bfloat16* __restrict__ p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ unsigned int tfdl_pack_bf16x2(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void tfdl_st_bf16(__nv_bfloat16* __restrict__ p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(tfdl_pack_bf16x2(v[0], v[1]), tfdl_pack_bf16x2(v[2], v[3]),
                                            tfdl_pack_bf16x2(v[4], v[5]), tfdl_pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void tfdl_st_bf16(__nv_bfloat16* __restrict__ p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
// VEC f32 fold values at p (two float4 loads for 8)
template <int VEC>
__device__ __forceinline__ void tfdl_ld_fold(const float* __restrict__ p, float (&v)[VEC]) {
  if (VEC == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x;
    v[1 % VEC] = a.y;
    v[2 % VEC] = a.z;
    v[3 % VEC] = a.w;
    v[4 % VEC] = b.x;
    v[5 % VEC] = b.y;
    v[6 % VEC] = b.z;
    v[7 % VEC] = b.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__global__ void __launch_bounds__(TFDL_THREADS)
    tfdl_bn_act_rows_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ m,
                                 const float* __restrict__ b, const __nv_bfloat16* __restrict__ r,
                                 __nv_bfloat16* __restrict__ out, int64_t P, int C, int64_t rows, int act) {
  const int G = C / VEC;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * G) return;
  const int c = (int)(t % G) * VEC;
  float mv[VEC], bv[VEC];
  tfdl_ld_fold<VEC>(m + c, mv);
  tfdl_ld_fold<VEC>(b + c, bv);
  for (int64_t p = t / G; p < P; p += 2 * rows) {
    const bool two = p + rows < P;
    float xv[2][VEC], rv[2][VEC];
    tfdl_ld_bf16(x + p * C + c, xv[0]);
    if (two) tfdl_ld_bf16(x + (p + rows) * C + c, xv[1]);
    if (r != nullptr) {
      tfdl_ld_bf16(r + p * C + c, rv[0]);
      if (two) tfdl_ld_bf16(r + (p + rows) * C + c, rv[1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = __fadd_rn(__fmul_rn(xv[u][e], mv[e]), bv[e]);
        if (r != nullptr) v = __fadd_rn(v, rv[u][e]);
        y[e] = tfdl_act(v, act);
      }
      tfdl_st_bf16(out + (p + u * rows) * C + c, y);
    }
  }
}

// unfolded: out = act(((x - mean[c]) * mul[c]) + bias[c]), each step
// rounded to bf16 for bf16 x
template <int VEC, typename XT>
__global__ void __launch_bounds__(TFDL_THREADS)
    tfdl_bn_act_rows_unfolded_kernel(const XT* __restrict__ x, const float* __restrict__ mean,
                                     const float* __restrict__ mul, const float* __restrict__ bias,
                                     float* __restrict__ out, int64_t P, int C, int64_t rows, int act) {
  constexpr bool BF16 = sizeof(XT) == 2;
  const int G = C / VEC;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * G) return;
  const int c = (int)(t % G) * VEC;
  float mv[VEC], kv[VEC], bv[VEC];
  tfdl_ld<VEC>(mean + c, mv);
  tfdl_ld<VEC>(mul + c, kv);
  tfdl_ld<VEC>(bias + c, bv);
  for (int64_t p = t / G; p < P; p += 2 * rows) {
    const bool two = p + rows < P;
    float xv[2][VEC];
    tfdl_ld<VEC>(x + p * C + c, xv[0]);
    if (two) tfdl_ld<VEC>(x + (p + rows) * C + c, xv[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      float y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = xv[u][e];
        if (BF16) {
          v = tfdl_round_bf16(__fsub_rn(v, mv[e]));
          v = tfdl_round_bf16(__fmul_rn(v, kv[e]));
          v = tfdl_round_bf16(__fadd_rn(v, bv[e]));
        } else {
          v = __fadd_rn(__fmul_rn(__fsub_rn(v, mv[e]), kv[e]), bv[e]);
        }
        y[e] = tfdl_act(v, act);
      }
      tfdl_st<VEC>(out + (p + u * rows) * C + c, y);
    }
  }
}

// Pixel rows walked at once: as many threads as the card keeps resident
// (looked up once per device), over C / vec channel groups, at most P.
static int tfdl_bn_rows(int64_t P, int groups, int64_t* rows) {
  static int cached_device = -1;
  static int64_t resident = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
    if (err != cudaSuccess) return (int)err;
    resident = (int64_t)sms * per_sm;
    cached_device = device;
  }
  int64_t n = (resident + groups - 1) / groups;
  *rows = n < 1 ? 1 : (n > P ? P : n);
  return (int)cudaSuccess;
}

// x, r (may be null), out: f32 [P, C]; m, b: f32 [C]; vec = 1 takes the
// 16-byte path (C % 4 == 0 and every base 16-byte aligned), 0 the scalar one
extern "C" int tfdl_bn_act_rows_f32(const void* x, const void* m, const void* b, const void* r, void* out,
                                    int64_t P, int C, int act, int vec, void* stream) {
  if (P <= 0 || C <= 0) return (int)cudaSuccess;
  if (vec && C % 4 != 0) return (int)cudaErrorInvalidValue;
  const int groups = vec ? C / 4 : C;
  int64_t rows = 0;
  const int code = tfdl_bn_rows(P, groups, &rows);
  if (code != 0) return code;
  const unsigned int blocks = (unsigned int)((rows * groups + TFDL_THREADS - 1) / TFDL_THREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    tfdl_bn_act_rows_kernel<4><<<blocks, TFDL_THREADS, 0, st>>>(
        (const float*)x, (const float*)m, (const float*)b, (const float*)r, (float*)out, P, C, rows, act);
  } else {
    tfdl_bn_act_rows_kernel<1><<<blocks, TFDL_THREADS, 0, st>>>(
        (const float*)x, (const float*)m, (const float*)b, (const float*)r, (float*)out, P, C, rows, act);
  }
  return (int)cudaGetLastError();
}

// x, r (may be null), out: bf16 [P, C]; m, b: f32 [C]; vec = 1 takes the
// 8-channel path (C % 8 == 0 and every base 16-byte aligned), 0 the scalar
// one
extern "C" int tfdl_bn_act_rows_bf16(const void* x, const void* m, const void* b, const void* r, void* out,
                                     int64_t P, int C, int act, int vec, void* stream) {
  if (P <= 0 || C <= 0) return (int)cudaSuccess;
  if (vec && C % 8 != 0) return (int)cudaErrorInvalidValue;
  const int groups = vec ? C / 8 : C;
  int64_t rows = 0;
  const int code = tfdl_bn_rows(P, groups, &rows);
  if (code != 0) return code;
  const unsigned int blocks = (unsigned int)((rows * groups + TFDL_THREADS - 1) / TFDL_THREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (vec) {
    tfdl_bn_act_rows_bf16_kernel<8><<<blocks, TFDL_THREADS, 0, st>>>(
        (const bf*)x, (const float*)m, (const float*)b, (const bf*)r, (bf*)out, P, C, rows, act);
  } else {
    tfdl_bn_act_rows_bf16_kernel<1><<<blocks, TFDL_THREADS, 0, st>>>(
        (const bf*)x, (const float*)m, (const float*)b, (const bf*)r, (bf*)out, P, C, rows, act);
  }
  return (int)cudaGetLastError();
}

// x: bf16 (x_bf16) or f32 [P, C]; mean, mul, bias: f32 [C]; out: f32
// [P, C]; vec as for tfdl_bn_act_rows_f32
extern "C" int tfdl_bn_act_rows_unfolded(const void* x, int x_bf16, const void* mean, const void* mul,
                                         const void* bias, void* out, int64_t P, int C, int act, int vec,
                                         void* stream) {
  if (P <= 0 || C <= 0) return (int)cudaSuccess;
  if (vec && C % 4 != 0) return (int)cudaErrorInvalidValue;
  const int groups = vec ? C / 4 : C;
  int64_t rows = 0;
  const int code = tfdl_bn_rows(P, groups, &rows);
  if (code != 0) return code;
  const unsigned int blocks = (unsigned int)((rows * groups + TFDL_THREADS - 1) / TFDL_THREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* mn = (const float*)mean;
  const float* ml = (const float*)mul;
  const float* bs = (const float*)bias;
  float* o = (float*)out;
  if (x_bf16) {
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    if (vec) {
      tfdl_bn_act_rows_unfolded_kernel<4, __nv_bfloat16><<<blocks, TFDL_THREADS, 0, st>>>(xb, mn, ml, bs, o, P, C, rows, act);
    } else {
      tfdl_bn_act_rows_unfolded_kernel<1, __nv_bfloat16><<<blocks, TFDL_THREADS, 0, st>>>(xb, mn, ml, bs, o, P, C, rows, act);
    }
  } else {
    const float* xf = (const float*)x;
    if (vec) {
      tfdl_bn_act_rows_unfolded_kernel<4, float><<<blocks, TFDL_THREADS, 0, st>>>(xf, mn, ml, bs, o, P, C, rows, act);
    } else {
      tfdl_bn_act_rows_unfolded_kernel<1, float><<<blocks, TFDL_THREADS, 0, st>>>(xf, mn, ml, bs, o, P, C, rows, act);
    }
  }
  return (int)cudaGetLastError();
}
