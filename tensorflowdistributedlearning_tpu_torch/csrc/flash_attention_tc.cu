// Softmax attention on bfloat16 inputs through the tensor cores (flash
// attention, forward only).
//
// Replaces: tensorflowdistributedlearning_tpu/ops/flash_attention.py
//   flash_attention (kernel body _attn_kernel via _flash_forward) for
//   bfloat16 q, k and v. The TPU kernel held one 256-row query tile and the
//   whole K and V rows of a (batch, head) in VMEM and took a one-shot
//   softmax in float32; float32 inputs keep the CUDA-core kernel of
//   flash_attention.cu.
//
// Computes, for q, k, v bf16 of one shape [B, T, H, D] (each read in place
// through its own element strides for b, t and h; d contiguous; bases and
// strides 16-byte aligned) and scale = 1/sqrt(D):
//   s[i, j] = scale * sum_d q[i, d] * k[j, d]          (float32)
//   s[i, j] = -1e30 where causal and j > i             (the JAX mask value)
//   out[i]  = sum_j exp(s[i, j] - m_i) v[j] / max(l_i, 1e-30)
// into a contiguous bf16 [B, T, H, D] (round to nearest even). The JAX
// kernel upcasts to float32 and computes in float32; so does this one where
// it matters:
//   - Q.K^T: mma.sync.m16n8k16 with bf16 operands and float32 accumulators.
//     The bf16 products are exact in float32, and the sums are float32.
//   - softmax: float32 in registers, expf (no fast math).
//   - P.V: p is float32, and one bf16 rounding of it would miss the JAX
//     contract (one bf16 step beyond the float32 tolerance) by up to 0.06.
//     So p = hi + mid + lo, each the bf16 rounding of what the terms
//     before it leave (hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi
//     - mid)), and three MMAs against the same V fragments add them times
//     V into one float32 accumulator. The three terms carry p's 24 bits;
//     two (16 bits) meet the contract too, but the output then sits about
//     1e-5 from the float32 value, rounds to the other bf16 neighbour of
//     the plain version's result about 30 times as often as a float32
//     kernel does, and under int8-compute each such step moves a later
//     layer's quantization: the served ViT's probabilities then left their
//     bound against the plain forward. The row sum l is taken from
//     unsplit p.
//
// What bounds it on an H100: bytes. At the ViT-S/16 serve shape (B = 64,
// T = 196, H = 6, D = 64) one launch moves 38.5 MB (q, k, v read once, out
// written once: 11.5 us at 3.35 TB/s) and does 3.8 GFLOP of Q.K^T and P.V,
// 7.6 GFLOP of tensor-core work with P.V three times (about 8 us at 989
// TFLOP/s, more at the rate mma.sync reaches). So the kernel can stand
// near its byte bound with mma.sync; wgmma's 64-row granularity would waste
// more of the ragged edge (T = 196 is 3 x 64 + 4) and is not used.
//
// Design: one block of 4 warps per (b, h, 64-row query tile); each warp owns
// 16 query rows. The query tile is copied to shared memory once and each
// warp keeps its rows as ldmatrix A fragments in registers. K and V walk in
// 64-key tiles, double-buffered in shared memory with 16-byte cp.async
// copies (the next tile's copy runs under the current tile's MMAs), read
// from device memory in place through the strides of the qkv projection's
// views, so no transposed copy is made. Shared rows are padded by 16 bytes,
// so the 8 rows an ldmatrix reads hit 8 different bank groups. K fragments
// come from ldmatrix, V fragments from ldmatrix.trans. The Q.K^T accumulator
// layout of m16n8k16 is the A operand layout of the next m16n8k16, so P goes
// from registers to the P.V MMAs without shared memory. Each row keeps a
// running max m and sum l (quad-partial, reduced across the 4 lanes of a
// quad with shuffles at the end) and a rescaled float32 accumulator.
// The ragged edge costs 16-row and 16-key granularity: a warp whose rows
// all lie at or past T does no MMAs, key chunks at or past T (or, under
// causal masking, past the warp's last row) are skipped, and keys past T
// inside a chunk score -inf (they add nothing). Rows and keys past T are
// copied as zeros (cp.async zero fill), so no stale value reaches an MMA.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define TFDL_FT_BQ 64
#define TFDL_FT_BK 64
#define TFDL_FT_THREADS 128
#define TFDL_FT_MASK (-1e30f)

struct TfdlTcStrides {
  int64_t sb, st, sh;
};

__device__ __forceinline__ uint32_t tfdl_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `valid` false writes 16 zero bytes.
__device__ __forceinline__ void tfdl_cp16(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tfdl_smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void tfdl_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void tfdl_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tfdl_ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tfdl_smem_u32(p)));
}

__device__ __forceinline__ void tfdl_ldsm_x4_t(uint32_t (&r)[4],
                                               const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(tfdl_smem_u32(p)));
}

__device__ __forceinline__ void tfdl_mma_bf16(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t tfdl_pack_bf16(__nv_bfloat16 lo,
                                                   __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// p = hi + mid + lo, each the bf16 (round to nearest even) of what the
// terms before it leave; two values at a time, packed in pairs. The
// subtractions are exact, so the three terms hold p to float32 precision.
__device__ __forceinline__ void tfdl_split(float p0, float p1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
  const float r0 = p0 - __bfloat162float(h0), r1 = p1 - __bfloat162float(h1);
  const __nv_bfloat16 m0 = __float2bfloat16_rn(r0);
  const __nv_bfloat16 m1 = __float2bfloat16_rn(r1);
  hi = tfdl_pack_bf16(h0, h1);
  mid = tfdl_pack_bf16(m0, m1);
  lo = tfdl_pack_bf16(__float2bfloat16_rn(r0 - __bfloat162float(m0)),
                      __float2bfloat16_rn(r1 - __bfloat162float(m1)));
}

// Rows [t0, t0 + 64) of one (b, h) slice of x into a shared [64][LD] tile by
// 16-byte cp.async; rows at or past T are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void tfdl_ft_stage(__nv_bfloat16* dst,
                                              const __nv_bfloat16* x,
                                              TfdlTcStrides s, int b, int h,
                                              int t0, int T) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TFDL_FT_BK * CHUNKS; i += TFDL_FT_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, t = t0 + r;
    const bool valid = t < T;
    const __nv_bfloat16* src =
        valid ? x + b * s.sb + (int64_t)t * s.st + h * s.sh + c : x;
    tfdl_cp16(dst + r * LD + c, src, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(TFDL_FT_THREADS)
    tfdl_flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   __nv_bfloat16* __restrict__ out, int T,
                                   int H, TfdlTcStrides qs, TfdlTcStrides ks,
                                   TfdlTcStrides vs, int causal, float scale) {
  constexpr int LD = D + 8;     // padded shared row, elements
  constexpr int KS = D / 16;    // k16 steps of Q.K^T
  constexpr int NT = TFDL_FT_BK / 8;  // n8 tiles of scores per K tile
  constexpr int DT = D / 8;     // n8 tiles of the output
  extern __shared__ __align__(16) __nv_bfloat16 tfdl_ft_smem[];
  __nv_bfloat16* Qs = tfdl_ft_smem;               // [BQ][LD]
  __nv_bfloat16* Kb = Qs + TFDL_FT_BQ * LD;       // [2][BK][LD]
  __nv_bfloat16* Vb = Kb + 2 * TFDL_FT_BK * LD;   // [2][BK][LD]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * TFDL_FT_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16;           // this warp's first query row
  const bool active = row0 < T;              // some of its rows are real
  // keys this warp can see: all of them, or up to its last row when causal
  const int klim = causal ? min(T, row0 + 16) : T;
  const int kv_end = causal ? min(T, q0 + TFDL_FT_BQ) : T;
  const int n_tiles = (kv_end + TFDL_FT_BK - 1) / TFDL_FT_BK;

  tfdl_ft_stage<D, LD>(Qs, q, qs, b, h, q0, T);
  tfdl_ft_stage<D, LD>(Kb, k, ks, b, h, 0, T);
  tfdl_ft_stage<D, LD>(Vb, v, vs, b, h, 0, T);
  tfdl_cp_commit();

  uint32_t qf[KS][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  // rows g = lane / 4 and g + 8 of the warp's 16; l is this lane's part
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int g = lane >> 2, tq = lane & 3;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * TFDL_FT_BK;
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      tfdl_ft_stage<D, LD>(Kb + nb * TFDL_FT_BK * LD, k, ks, b, h,
                           k0 + TFDL_FT_BK, T);
      tfdl_ft_stage<D, LD>(Vb + nb * TFDL_FT_BK * LD, v, vs, b, h,
                           k0 + TFDL_FT_BK, T);
      tfdl_cp_commit();
      tfdl_cp_wait<1>();
    } else {
      tfdl_cp_wait<0>();
    }
    __syncthreads();
    if (it == 0 && active) {
      // matrices (rows 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
      const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = (lane >> 4) * 8;
#pragma unroll
      for (int s = 0; s < KS; ++s) tfdl_ldsm_x4(qf[s], Qs + r * LD + s * 16 + c);
    }
    if (active && k0 < klim) {
      const __nv_bfloat16* Kt = Kb + (it & 1) * TFDL_FT_BK * LD;
      const __nv_bfloat16* Vt = Vb + (it & 1) * TFDL_FT_BK * LD;
      const int kv_len = klim - k0;  // keys of this tile the warp sees

      // S = Q K^T over the n8 tiles that hold a visible key
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
      for (int np = 0; np < NT; np += 2) {
        if (np * 8 >= kv_len) continue;
        // matrices (keys np*8.., d 0-7), (.., d 8-15), (keys np*8+8.., d 0-7), (.., d 8-15)
        const int kr = np * 8 + (lane & 7) + (lane >> 4) * 8;
        const int kc = ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          uint32_t kf[4];
          tfdl_ldsm_x4(kf, Kt + kr * LD + s * 16 + kc);
          tfdl_mma_bf16(sc[np], qf[s], kf[0], kf[1]);
          tfdl_mma_bf16(sc[np + 1], qf[s], kf[2], kf[3]);
        }
      }

      // scale and mask; element e of tile nt is row g + 8 * (e >= 2),
      // key k0 + nt * 8 + 2 * tq + (e & 1)
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * tq + (e & 1);
          const int row = row0 + g + 8 * (e >> 1);
          float val = sc[nt][e] * scale;
          if (key >= T || nt * 8 >= kv_len) {
            val = -INFINITY;  // no such key, or one no row of the warp sees
          } else if (causal && key > row) {
            val = TFDL_FT_MASK;
          }
          sc[nt][e] = val;
          mt[e >> 1] = fmaxf(mt[e >> 1], val);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        // key 0 lies in the first tile and every row sees it, so the new
        // max is finite from the first tile on
        const float m_new = fmaxf(m[r], mt[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(sc[nt][e] - m[e >> 1]);
          sc[nt][e] = p;
          l[e >> 1] += p;
        }
      }

      // O += P V over the k16 chunks that hold a visible key; the score
      // tiles 2j and 2j + 1 are the A fragment of chunk j
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j * 16 >= kv_len) continue;
        uint32_t ph[4], pm[4], pl[4];
        tfdl_split(sc[2 * j][0], sc[2 * j][1], ph[0], pm[0], pl[0]);
        tfdl_split(sc[2 * j][2], sc[2 * j][3], ph[1], pm[1], pl[1]);
        tfdl_split(sc[2 * j + 1][0], sc[2 * j + 1][1], ph[2], pm[2], pl[2]);
        tfdl_split(sc[2 * j + 1][2], sc[2 * j + 1][3], ph[3], pm[3], pl[3]);
        // matrices (keys 16j..+7, d), (keys 16j+8.., d), (.., d+8), (.., d+8)
        const int vr = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int vc = (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < DT; dp += 2) {
          uint32_t vf[4];
          tfdl_ldsm_x4_t(vf, Vt + vr * LD + dp * 8 + vc);
          // the chunk's three products in a fresh accumulator, smallest
          // term first; then one float32 add into the running output
          float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          tfdl_mma_bf16(t0, pl, vf[0], vf[1]);
          tfdl_mma_bf16(t0, pm, vf[0], vf[1]);
          tfdl_mma_bf16(t0, ph, vf[0], vf[1]);
          tfdl_mma_bf16(t1, pl, vf[2], vf[3]);
          tfdl_mma_bf16(t1, pm, vf[2], vf[3]);
          tfdl_mma_bf16(t1, ph, vf[2], vf[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[dp][e] += t0[e];
            o[dp + 1][e] += t1[e];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = out + (((int64_t)b * T + row) * H + h) * D + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const uint32_t y = tfdl_pack_bf16(__float2bfloat16_rn(o[dt][2 * r] / denom),
                                        __float2bfloat16_rn(o[dt][2 * r + 1] / denom));
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = y;
    }
  }
}

template <int D>
static int tfdl_ft_launch(const void* q, const void* k, const void* v,
                          void* out, int B, int T, int H, TfdlTcStrides qs,
                          TfdlTcStrides ks, TfdlTcStrides vs, int causal,
                          float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(__nv_bfloat16) * (D + 8) *
                   (TFDL_FT_BQ + 4 * TFDL_FT_BK);
  cudaError_t err = cudaFuncSetAttribute(
      tfdl_flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(B * H),
                  (unsigned int)((T + TFDL_FT_BQ - 1) / TFDL_FT_BQ));
  tfdl_flash_attention_tc_kernel<D><<<grid, TFDL_FT_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, T, H, qs, ks, vs, causal,
      scale);
  return (int)cudaGetLastError();
}

// q, k, v: bf16 [B, T, H, D] with element strides (sb, st, sh) each, d
// contiguous, bases and strides 16-byte aligned; out: contiguous bf16
// [B, T, H, D]; D a multiple of 16 up to 128 (the k16 steps of Q.K^T and
// the 16-wide V fragment pairs of P.V). The argument list is that of
// tfdl_flash_attention (flash_attention.cu); `bf16` must be 1.
extern "C" int tfdl_flash_attention_tc(const void* q, const void* k,
                                       const void* v, void* out, int bf16,
                                       int B, int T, int H, int D,
                                       int64_t q_sb, int64_t q_st,
                                       int64_t q_sh, int64_t k_sb,
                                       int64_t k_st, int64_t k_sh,
                                       int64_t v_sb, int64_t v_st,
                                       int64_t v_sh, int causal, float scale,
                                       void* stream) {
  if (!bf16) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaSuccess;
  const TfdlTcStrides qs = {q_sb, q_st, q_sh}, ks = {k_sb, k_st, k_sh},
                      vs = {v_sb, v_st, v_sh};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return tfdl_ft_launch<16>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 32:
      return tfdl_ft_launch<32>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 48:
      return tfdl_ft_launch<48>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 64:
      return tfdl_ft_launch<64>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 80:
      return tfdl_ft_launch<80>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 96:
      return tfdl_ft_launch<96>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 112:
      return tfdl_ft_launch<112>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 128:
      return tfdl_ft_launch<128>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
