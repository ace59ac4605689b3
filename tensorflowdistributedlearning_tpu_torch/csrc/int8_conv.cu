// int8 x int8 -> int32 stride-1 convolution (and matmul) with the fused
// scale + bias + activation epilogue.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/quant_kernels.py
//   int8_conv2d (kernel body _qconv_kernel: one pre-padded image per grid
//   step in VMEM, shift-and-matmul over the kh*kw taps on the MXU) and,
//   for the shapes int8_gemm.cu's TMA loads cannot describe (K % 16 != 0),
//   int8_matmul (kernel body _qmm_kernel: whole-K row blocks in VMEM). Here
//   both are one implicit GEMM; a matmul [M,K]x[K,N] is the 1x1 conv over a
//   [1, 1, M, K] image.
//
// Computes, for x int8 NHWC [B,H,W,Cin] (already quantized per tensor, with
// its f32 scale xs on the device), w int8 [Cout, kh, kw, Cin] (the filter
// with K = kh*kw*Cin contiguous per output channel), explicit pads (top,
// left; the bottom/right pads only set Ho and Wo):
//   acc[m, n] = sum_k A[m, k] * w[n, k]          exact, in int32
//   out[m, n] = act(f32(acc) * (xs * ws[n]) + bias[n])  in f32, stored as
//               bf16 or f32 (round to nearest even)
// with M = B*Ho*Wo output pixels, A the im2col view of x (padding taps read
// as zero). The epilogue runs in the order of the JAX kernel: the int->f32
// conversion rounds to nearest even (__int2float_rn, as XLA's convert;
// |acc| passes 2^24), the scale product xs*ws[n] is formed in f32 before it
// meets the accumulator, every multiply and add is rounded on its own.
//
// What bounds it on an H100: at the serve path's shapes (bucket 64 of the
// full-width segmenter) the 52 convs move ~1.5 GB (int8 x and w read once,
// bf16 out written once) against ~0.63 T int8 operations: bytes / 3.35 TB/s
// is the larger of the two bounds, just above int8 ops / 1979 TOPS.
//
// Design (simple and right first; wgmma/TMA are later work): a block of 128
// threads (4 warps, 2x2) owns a 64x64 tile of [M, N]; the K loop walks
// 64-byte slices. Each step loads the A and B slices from device memory
// into registers (16-byte loads when Cin % 16 == 0, so a 16-byte chunk
// never crosses a tap; byte loads with per-byte bounds otherwise), stores
// them into shared memory rows padded to 80 bytes (conflict-free 32-bit
// fragment reads), and each warp runs mma.sync.m16n8k32 s8.s8.s32 over its
// 32x32 sub-tile: 2 x 4 MMAs per 32-byte k step. The next slice's global
// loads are issued before the current slice's MMAs (register prefetch).
// Integer accumulation is exact, so the result does not depend on the
// order of the sums: the kernel equals its plain version bit for bit.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "epilogue.cuh"

#define TFDL_Q_BM 64
#define TFDL_Q_BN 64
#define TFDL_Q_BK 64
#define TFDL_Q_LDS 80  // bytes per shared-memory row: BK + 16 of padding
#define TFDL_Q_THREADS 128

struct TfdlConvShape {
  int B, H, W, Cin, Ho, Wo, Cout, kh, kw, pt, pl, K;
  int64_t M;
};

// One 16-byte chunk of the A (im2col) slice: row `m`, k columns k..k+15.
template <bool VEC>
__device__ __forceinline__ int4 tfdl_load_a(const int8_t* __restrict__ x,
                                            const TfdlConvShape& s, int64_t m,
                                            int k) {
  int4 v = make_int4(0, 0, 0, 0);
  if (m >= s.M || k >= s.K) return v;
  const int ox = (int)(m % s.Wo);
  const int64_t t = m / s.Wo;
  const int oy = (int)(t % s.Ho);
  const int64_t b = t / s.Ho;
  if (VEC) {
    const int tap = k / s.Cin;
    const int c = k - tap * s.Cin;
    const int i = tap / s.kw;
    const int j = tap - i * s.kw;
    const int iy = oy + i - s.pt;
    const int ix = ox + j - s.pl;
    if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W) {
      v = *reinterpret_cast<const int4*>(
          x + ((b * s.H + iy) * (int64_t)s.W + ix) * s.Cin + c);
    }
    return v;
  }
  union {
    int4 v;
    int8_t b[16];
  } u;
  u.v = v;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int kk = k + e;
    if (kk >= s.K) break;
    const int tap = kk / s.Cin;
    const int c = kk - tap * s.Cin;
    const int i = tap / s.kw;
    const int j = tap - i * s.kw;
    const int iy = oy + i - s.pt;
    const int ix = ox + j - s.pl;
    if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W) {
      u.b[e] = x[((b * s.H + iy) * (int64_t)s.W + ix) * s.Cin + c];
    }
  }
  return u.v;
}

// One 16-byte chunk of the B slice: filter row `n`, k columns k..k+15.
template <bool VEC>
__device__ __forceinline__ int4 tfdl_load_b(const int8_t* __restrict__ w,
                                            const TfdlConvShape& s, int n,
                                            int k) {
  int4 v = make_int4(0, 0, 0, 0);
  if (n >= s.Cout || k >= s.K) return v;
  const int8_t* row = w + (int64_t)n * s.K;
  if (VEC) return *reinterpret_cast<const int4*>(row + k);
  union {
    int4 v;
    int8_t b[16];
  } u;
  u.v = v;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (k + e >= s.K) break;
    u.b[e] = row[k + e];
  }
  return u.v;
}

__device__ __forceinline__ void tfdl_mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool VEC>
__global__ void __launch_bounds__(TFDL_Q_THREADS)
    tfdl_int8_conv_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ x_scale,
                          const float* __restrict__ w_scale,
                          const float* __restrict__ bias, void* __restrict__ out,
                          TfdlConvShape s, int act, int out_bf16) {
  __shared__ __align__(16) int8_t As[TFDL_Q_BM * TFDL_Q_LDS];
  __shared__ __align__(16) int8_t Bs[TFDL_Q_BN * TFDL_Q_LDS];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * TFDL_Q_BM;
  const int n0 = blockIdx.y * TFDL_Q_BN;

  // chunk r of this thread: tile row (tid + r*128) / 4, bytes ((..) % 4)*16
  int rows[2], cols[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int chunk = tid + r * TFDL_Q_THREADS;
    rows[r] = chunk >> 2;
    cols[r] = (chunk & 3) * 16;
  }
  int4 ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ra[r] = tfdl_load_a<VEC>(x, s, m0 + rows[r], cols[r]);
    rb[r] = tfdl_load_b<VEC>(w, s, n0 + rows[r], cols[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    *reinterpret_cast<int4*>(&As[rows[r] * TFDL_Q_LDS + cols[r]]) = ra[r];
    *reinterpret_cast<int4*>(&Bs[rows[r] * TFDL_Q_LDS + cols[r]]) = rb[r];
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // group id: fragment row (A, C) / column (B)
  const int t = lane & 3;   // thread in group: 4-byte k chunk
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int k0 = 0; k0 < s.K; k0 += TFDL_Q_BK) {
    const bool more = k0 + TFDL_Q_BK < s.K;
    if (more) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ra[r] = tfdl_load_a<VEC>(x, s, m0 + rows[r], k0 + TFDL_Q_BK + cols[r]);
        rb[r] = tfdl_load_b<VEC>(w, s, n0 + rows[r], k0 + TFDL_Q_BK + cols[r]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < TFDL_Q_BK / 32; ++ks) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int base = (wm + mi * 16 + g) * TFDL_Q_LDS + ks * 32 + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[base]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[base + 8 * TFDL_Q_LDS]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[base + 16]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[base + 8 * TFDL_Q_LDS + 16]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int base = (wn + ni * 8 + g) * TFDL_Q_LDS + ks * 32 + t * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[base]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[base + 16]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) tfdl_mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (more) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<int4*>(&As[rows[r] * TFDL_Q_LDS + cols[r]]) = ra[r];
        *reinterpret_cast<int4*>(&Bs[rows[r] * TFDL_Q_LDS + cols[r]]) = rb[r];
      }
      __syncthreads();
    }
  }

  // epilogue: accumulator element e of fragment (mi, ni) is row g (e < 2)
  // or g + 8, column 2t + (e & 1)
  const float xs = *x_scale;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm + mi * 16 + g + h * 8;
      if (m >= s.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + ni * 8 + t * 2 + e;
          if (n >= s.Cout) continue;
          const float scale = __fmul_rn(xs, w_scale[n]);
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + e]), scale);
          y = tfdl_bias_act(y, bias, n, act);
          const int64_t o = m * s.Cout + n;
          if (out_bf16) {
            ((__nv_bfloat16*)out)[o] = __float2bfloat16_rn(y);
          } else {
            ((float*)out)[o] = y;
          }
        }
      }
    }
  }
}

extern "C" int tfdl_int8_conv2d(const void* x, const void* w,
                                const void* x_scale, const void* w_scale,
                                const void* bias, void* out, int B, int H,
                                int W, int Cin, int Cout, int kh, int kw,
                                int pt, int pb, int pl, int pr, int act,
                                int out_bf16, int vec, void* stream) {
  TfdlConvShape s;
  s.B = B;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.kh = kh;
  s.kw = kw;
  s.pt = pt;
  s.pl = pl;
  s.Ho = H + pt + pb - kh + 1;
  s.Wo = W + pl + pr - kw + 1;
  s.K = kh * kw * Cin;
  s.M = (int64_t)B * s.Ho * s.Wo;
  if (s.M <= 0 || Cout <= 0 || s.K <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned int)((s.M + TFDL_Q_BM - 1) / TFDL_Q_BM),
                  (unsigned int)((Cout + TFDL_Q_BN - 1) / TFDL_Q_BN));
  if (vec) {
    tfdl_int8_conv_kernel<true>
        <<<grid, TFDL_Q_THREADS, 0, (cudaStream_t)stream>>>(
            (const int8_t*)x, (const int8_t*)w, (const float*)x_scale,
            (const float*)w_scale, (const float*)bias, out, s, act, out_bf16);
  } else {
    tfdl_int8_conv_kernel<false>
        <<<grid, TFDL_Q_THREADS, 0, (cudaStream_t)stream>>>(
            (const int8_t*)x, (const int8_t*)w, (const float*)x_scale,
            (const float*)w_scale, (const float*)bias, out, s, act, out_bf16);
  }
  return (int)cudaGetLastError();
}
