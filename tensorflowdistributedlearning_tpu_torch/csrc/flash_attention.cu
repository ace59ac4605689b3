// Softmax attention with an online softmax over K/V tiles (flash attention,
// forward only) on the CUDA cores.
//
// The wrapper (ops/flash_attention.py) sends float32 inputs here and
// bfloat16 inputs to the tensor-core kernel of flash_attention_tc.cu. The
// bfloat16 instantiation below is that kernel's predecessor: chip_smoke.py
// times it beside the tensor-core kernel on the same inputs.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/flash_attention.py
//   flash_attention (kernel body _attn_kernel via _flash_forward). The TPU
//   kernel held one 256-row query tile plus the WHOLE K and V rows of a
//   (batch, head) in VMEM, computed the [256, T] score tile in one shot and
//   took the softmax over the full row, after the wrapper had copied q, k
//   and v into [B*H, T, D] (three transposes through HBM). Its VMEM budget
//   (_VMEM_KV_LIMIT_BYTES) sent longer rows back to XLA.
//
// Computes, for q, k, v of one shape [B, T, H, D] (float32 or bfloat16, all
// three of one dtype, each read in place through its own element strides
// for b, t and h; d contiguous) and scale = 1/sqrt(D):
//   s[i, j] = scale * sum_d q[i, d] * k[j, d]          (float32)
//   s[i, j] = -1e30 where causal and j > i             (the JAX mask value)
//   out[i]  = sum_j exp(s[i, j] - m_i) v[j] / max(l_i, 1e-30)
// with m_i the row max and l_i the row sum of the exponentials, written to a
// contiguous [B, T, H, D] output in the input's dtype (round to nearest
// even for bf16). All arithmetic is float32 whatever the input dtype, as in
// the TPU kernel; expf and the final division are IEEE (no fast math).
//
// What bounds it on an H100: operations. Q.K^T and P.V are 4*B*H*T*T*D
// flops against 4*B*T*H*D elements moved once; at the ViT-S/16 serve shape
// (B = 64, T = 196, H = 6, D = 64) that is 3.8 GFLOP per call against 39
// MB in float32, so the float32 bound (67 TFLOP/s outside the tensor cores)
// is about five times the bytes bound.
//
// Design (simple and right first; mma.sync/wgmma on bf16 Q.K^T, TMA and a
// pipelined K loop are later work): one block of 128 threads per (b, h,
// 64-row query tile). The query tile is loaded once into shared memory
// (upcast to float32); the block then walks 64-row K/V tiles, each staged
// through shared memory, keeping per query row a running max m, a running
// sum l and a rescaled float32 accumulator (the online softmax), so no
// score row is ever held whole and no sequence length is too long. Threads
// form a 16 x 8 grid: thread (ty, tx) owns query rows ty + 16i (i < 4),
// score columns tx + 8j (j < 8) and output columns tx + 8c (c < D/8), so
// row maxima and sums reduce over 8 lanes of one warp with shuffles. Shared
// rows of Q and K are padded by one float, so the 8 lanes that read 8
// different rows at one d hit 8 different banks. Keys past T (the ragged
// last tile) are excluded, and under causal masking the walk stops at the
// tile that holds the query tile's last row: later keys are masked for
// every row of the tile and would add exp(-1e30 - m) = 0.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define TFDL_FA_BQ 64
#define TFDL_FA_BK 64
#define TFDL_FA_THREADS 128
#define TFDL_FA_MASK (-1e30f)

struct TfdlAttnStrides {
  int64_t sb, st, sh;
};

template <bool BF16>
__device__ __forceinline__ float tfdl_fa_load(const void* __restrict__ p,
                                              int64_t idx) {
  if (BF16) return __bfloat162float(((const __nv_bfloat16*)p)[idx]);
  return ((const float*)p)[idx];
}

// Rows [t0, t0 + 64) of one (b, h) slice of x into a shared [64][ld] tile,
// upcast to float32; rows at or past T read as zero.
template <int D, bool BF16>
__device__ __forceinline__ void tfdl_fa_stage(float* __restrict__ dst, int ld,
                                              const void* __restrict__ x,
                                              TfdlAttnStrides s, int b, int h,
                                              int t0, int T) {
  for (int i = threadIdx.x; i < TFDL_FA_BK * D; i += TFDL_FA_THREADS) {
    const int r = i / D, d = i % D, t = t0 + r;
    dst[r * ld + d] =
        t < T ? tfdl_fa_load<BF16>(x, b * s.sb + (int64_t)t * s.st + h * s.sh + d)
              : 0.0f;
  }
}

template <int D, bool BF16>
__global__ void __launch_bounds__(TFDL_FA_THREADS)
    tfdl_flash_attention_kernel(const void* __restrict__ q,
                                const void* __restrict__ k,
                                const void* __restrict__ v,
                                void* __restrict__ out, int T, int H,
                                TfdlAttnStrides qs, TfdlAttnStrides ks,
                                TfdlAttnStrides vs, int causal, float scale) {
  constexpr int LD = D + 1;               // padded Q and K rows
  constexpr int LDP = TFDL_FA_BK + 1;     // padded P rows
  constexpr int DC = D / 8;               // output columns per thread
  extern __shared__ float tfdl_fa_smem[];
  float* Qs = tfdl_fa_smem;               // [BQ][LD]
  float* Ks = Qs + TFDL_FA_BQ * LD;       // [BK][LD]
  float* Vs = Ks + TFDL_FA_BK * LD;       // [BK][D]
  float* Ps = Vs + TFDL_FA_BK * D;        // [BQ][LDP]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * TFDL_FA_BQ;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  tfdl_fa_stage<D, BF16>(Qs, LD, q, qs, b, h, q0, T);

  float o[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.0f;
  }

  const int kv_end = causal ? min(T, q0 + TFDL_FA_BQ) : T;
  for (int k0 = 0; k0 < kv_end; k0 += TFDL_FA_BK) {
    __syncthreads();  // the Q tile is in; the last tile's K, V, P are read
    tfdl_fa_stage<D, BF16>(Ks, LD, k, ks, b, h, k0, T);
    tfdl_fa_stage<D, BF16>(Vs, D, v, vs, b, h, k0, T);
    __syncthreads();
    const int kv_len = min(TFDL_FA_BK, kv_end - k0);

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[4], kc[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kc[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jj = tx + 8 * j;
        float val = s[i][j] * scale;
        if (jj >= kv_len) {
          val = -INFINITY;  // no such key: contributes nothing
        } else if (causal && k0 + jj > row) {
          val = TFDL_FA_MASK;
        }
        s[i][j] = val;
        mt = fmaxf(mt, val);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // key 0 is in the first tile and visible to every row, so m_new is
      // finite from the first tile on
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 8 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();  // P complete

    for (int j = 0; j < kv_len; ++j) {
      float pr[4], vc[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vc[c] = Vs[j * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) o[i][c] = fmaf(pr[i], vc[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const int64_t base = (((int64_t)b * T + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float y = o[i][c] / denom;
      if (BF16) {
        ((__nv_bfloat16*)out)[base + tx + 8 * c] = __float2bfloat16_rn(y);
      } else {
        ((float*)out)[base + tx + 8 * c] = y;
      }
    }
  }
}

template <int D, bool BF16>
static int tfdl_fa_launch(const void* q, const void* k, const void* v,
                          void* out, int B, int T, int H, TfdlAttnStrides qs,
                          TfdlAttnStrides ks, TfdlAttnStrides vs, int causal,
                          float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) *
                   (2 * TFDL_FA_BQ * (D + 1) + TFDL_FA_BK * D +
                    TFDL_FA_BQ * (TFDL_FA_BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      tfdl_flash_attention_kernel<D, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(B * H),
                  (unsigned int)((T + TFDL_FA_BQ - 1) / TFDL_FA_BQ));
  tfdl_flash_attention_kernel<D, BF16><<<grid, TFDL_FA_THREADS, smem, stream>>>(
      q, k, v, out, T, H, qs, ks, vs, causal, scale);
  return (int)cudaGetLastError();
}

template <bool BF16>
static int tfdl_fa_dispatch(const void* q, const void* k, const void* v,
                            void* out, int B, int T, int H, int D,
                            TfdlAttnStrides qs, TfdlAttnStrides ks,
                            TfdlAttnStrides vs, int causal, float scale,
                            cudaStream_t stream) {
  switch (D) {
    case 16:
      return tfdl_fa_launch<16, BF16>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, stream);
    case 32:
      return tfdl_fa_launch<32, BF16>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, stream);
    case 64:
      return tfdl_fa_launch<64, BF16>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, stream);
    case 128:
      return tfdl_fa_launch<128, BF16>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q, k, v: [B, T, H, D] with element strides (sb, st, sh) each and d
// contiguous; out: contiguous [B, T, H, D]; D in {16, 32, 64, 128}.
extern "C" int tfdl_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int bf16, int B,
                                    int T, int H, int D, int64_t q_sb,
                                    int64_t q_st, int64_t q_sh, int64_t k_sb,
                                    int64_t k_st, int64_t k_sh, int64_t v_sb,
                                    int64_t v_st, int64_t v_sh, int causal,
                                    float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaSuccess;
  const TfdlAttnStrides qs = {q_sb, q_st, q_sh}, ks = {k_sb, k_st, k_sh},
                        vs = {v_sb, v_st, v_sh};
  if (bf16) {
    return tfdl_fa_dispatch<true>(q, k, v, out, B, T, H, D, qs, ks, vs, causal,
                                  scale, (cudaStream_t)stream);
  }
  return tfdl_fa_dispatch<false>(q, k, v, out, B, T, H, D, qs, ks, vs, causal,
                                 scale, (cudaStream_t)stream);
}
