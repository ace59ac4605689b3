// Softmax attention on float32 inputs with an online softmax over K/V tiles
// (flash attention, forward only) on the CUDA cores, in IEEE float32.
//
// Replaces: tensorflowdistributedlearning_tpu/ops/flash_attention.py
//   flash_attention (kernel body _attn_kernel via _flash_forward) for
//   float32 q, k and v. The TPU kernel held one 256-row query tile and the
//   whole K and V rows of a (batch, head) in VMEM and took a one-shot
//   softmax. bfloat16 inputs go to flash_attention_tc.cu; this kernel's
//   predecessor, flash_attention.cu, stays built for comparison only.
//
// Computes, for q, k, v float32 of one shape [B, T, H, D] (each read in
// place through its own element strides for b, t and h; d contiguous; bases
// and strides 16-byte aligned; D a multiple of 16 up to 128) and scale =
// 1/sqrt(D):
//   s[i, j] = scale * sum_d q[i, d] * k[j, d]
//   s[i, j] = -1e30 where causal and j > i             (the JAX mask value)
//   out[i]  = sum_j exp(s[i, j] - m_i) v[j] / max(l_i, 1e-30)
// into a contiguous float32 [B, T, H, D]. Every product and sum is an IEEE
// float32 FMA (no TF32, no split products), expf and the division are IEEE
// (no fast math).
//
// What bounds it on an H100: operations. Q.K^T and P.V are 4*B*H*T*T*D
// flops; at the ViT-S/16 shape (B = 64, T = 196, H = 6, D = 64) 3.8 GFLOP a
// call against 39 MB moved, so the float32 FMA bound (67 TFLOP/s outside
// the tensor cores) is about five times the bytes bound.
//
// Design. A block of 4 warps owns 64 query rows of one (b, h); a warp owns
// 16, as 4 row groups of RPT = 4 rows, and the KL = 8 lanes of a row group
// split the keys: lane tx holds keys tx + 8j (j < 4) of each 32-key tile.
//   - Register micro-tiles fed by 16-byte shared loads along d: per 4
//     values of d a thread loads 4 float4 of Q (the same address across
//     its 8 lanes) and 4 of K and does 64 FMAs; for P.V it holds the same
//     4 rows and the 4-wide output chunks tx + 8c, and per 4 keys loads 4
//     float4 of P and 4 of V per chunk for 64 FMAs per chunk. Shared-memory
//     wavefronts, not FMA issue, are still the tighter limit.
//   - P never leaves its row group: the lanes that write a row's P are the
//     ones that read it, so P.V follows after a __syncwarp, not a block
//     barrier.
//   - The ragged edge costs little: a warp whose rows all lie at or past T
//     does no math, so at T = 196 a (b, h) runs 208 rows, not 256; a key
//     chunk (8 keys) whose first key is past T or, under causal masking,
//     past the warp's last row, costs no FMAs; keys past T inside a chunk
//     score -inf.
//   - K and V tiles double-buffered by 16-byte cp.async: the next tile's
//     copy runs under the current tile's math (two block barriers a tile).
//     Rows past T are zero-filled, so no stale value reaches an FMA.
//   - 61 KB of shared memory and 168 registers a thread at D = 64, so three
//     blocks, 12 warps, share an SM. The query tiles of one (b, h) are
//     neighbours in the grid, so they read its K and V from L2 after the
//     first.
// Each row keeps a running max m (reduced over its 8 lanes with shuffles),
// a lane-partial running sum l (reduced at the end) and a rescaled float32
// accumulator.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

// rows a thread owns, and key lanes: a row's keys are spread over KL lanes
// of a warp, 4 keys a lane per K tile (BK = 4 KL); a warp holds 32 / KL row
// groups of RPT rows, a block 4 warps
#define TFDL_FF_RPT 4
#define TFDL_FF_KL 8
#define TFDL_FF_THREADS 128
#define TFDL_FF_MASK (-1e30f)

struct TfdlF32Strides {
  int64_t sb, st, sh;
};

__device__ __forceinline__ uint32_t tfdl_ff_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; `valid` false writes 16 zero bytes.
__device__ __forceinline__ void tfdl_ff_cp16(void* dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tfdl_ff_smem(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void tfdl_ff_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void tfdl_ff_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 tfdl_ff_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [t0, t0 + ROWS) of one (b, h) slice of x into a shared [ROWS][LD]
// tile by 16-byte cp.async; rows at or past T are zero-filled.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void tfdl_ff_stage(float* dst, const float* x,
                                              TfdlF32Strides s, int b, int h,
                                              int t0, int T) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += TFDL_FF_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4, t = t0 + r;
    const bool valid = t < T;
    const float* src = valid ? x + b * s.sb + (int64_t)t * s.st + h * s.sh + c : x;
    tfdl_ff_cp16(dst + r * LD + c, src, valid);
  }
}

// s[i][j] += q[row r0 + i] . k[key tx + KL j] over d, for the first NJ key
// chunks of the tile; one fmaf chain per entry, d ascending.
template <int D, int LD, int NJ>
__device__ __forceinline__ void tfdl_ff_qk(float (&s)[TFDL_FF_RPT][4],
                                           const float* __restrict__ Qs,
                                           const float* __restrict__ Kt,
                                           int r0, int tx) {
  constexpr int RPT = TFDL_FF_RPT, KL = TFDL_FF_KL;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[RPT], kv[NJ];
#pragma unroll
    for (int i = 0; i < RPT; ++i) qv[i] = tfdl_ff_ld4(Qs + (r0 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) kv[j] = tfdl_ff_ld4(Kt + (tx + KL * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float a = s[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        a = fmaf(qv[i].w, kv[j].w, a);
        s[i][j] = a;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TFDL_FF_THREADS, 3)
    tfdl_flash_attention_f32_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    float* __restrict__ out, int T, int H,
                                    TfdlF32Strides qs, TfdlF32Strides ks,
                                    TfdlF32Strides vs, int causal,
                                    float scale) {
  constexpr int RPT = TFDL_FF_RPT, KL = TFDL_FF_KL;
  constexpr int WR = RPT * (32 / KL);    // query rows per warp
  constexpr int BQ = 4 * WR;             // query rows per block
  constexpr int BK = 4 * KL;             // keys per K/V tile
  constexpr int LD = D + 4;              // padded Q, K, V rows (16 bytes)
  constexpr int LDP = BK + 4;            // padded P rows
  constexpr int DQ = D / 4;              // 16-byte chunks of an output row
  constexpr int CPT = (DQ + KL - 1) / KL;  // output chunks per thread
  extern __shared__ __align__(16) float tfdl_ff_smem_buf[];
  float* Qs = tfdl_ff_smem_buf;                // [BQ][LD]
  float* Kb = Qs + BQ * LD;                    // [2][BK][LD]
  float* Vb = Kb + 2 * BK * LD;                // [2][BK][LD]
  float* Ps = Vb + 2 * BK * LD;                // [BQ][LDP]

  // the query tiles of one (b, h) are neighbours in the grid, so they run
  // together and read its K and V from L2 after the first
  const int n_qt = (T + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int b = bh / H, h = bh - b * H;
  const int q0 = (blockIdx.x - bh * n_qt) * BQ;
  const int tx = threadIdx.x % KL;          // key lane, output chunk lane
  const int r0 = (threadIdx.x / KL) * RPT;  // first of this thread's rows
  const int wrow = q0 + (threadIdx.x >> 5) * WR;  // the warp's first row
  const bool active = wrow < T;             // some of the warp's rows are real
  // keys a row of the warp sees: all of them, or up to its last row; and
  // keys a row of the block sees
  const int klim = causal ? min(T, wrow + WR) : T;
  const int kv_end = causal ? min(T, q0 + BQ) : T;
  const int n_tiles = (kv_end + BK - 1) / BK;

  tfdl_ff_stage<D, LD, BQ>(Qs, q, qs, b, h, q0, T);
  tfdl_ff_stage<D, LD, BK>(Kb, k, ks, b, h, 0, T);
  tfdl_ff_stage<D, LD, BK>(Vb, v, vs, b, h, 0, T);
  tfdl_ff_commit();

  float o[RPT][CPT][4];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      tfdl_ff_stage<D, LD, BK>(Kb + nb * BK * LD, k, ks, b, h, k0 + BK, T);
      tfdl_ff_stage<D, LD, BK>(Vb + nb * BK * LD, v, vs, b, h, k0 + BK, T);
      tfdl_ff_commit();
      tfdl_ff_wait<1>();
    } else {
      tfdl_ff_wait<0>();
    }
    __syncthreads();
    // KL-key chunks of this tile that hold a key some row of the warp sees
    const int nj = min(4, (klim - k0 + KL - 1) / KL);
    if (active && nj > 0) {
      const float* Kt = Kb + (it & 1) * BK * LD;
      const float* Vt = Vb + (it & 1) * BK * LD;

      float s[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      switch (nj) {
        case 4: tfdl_ff_qk<D, LD, 4>(s, Qs, Kt, r0, tx); break;
        case 3: tfdl_ff_qk<D, LD, 3>(s, Qs, Kt, r0, tx); break;
        case 2: tfdl_ff_qk<D, LD, 2>(s, Qs, Kt, r0, tx); break;
        default: tfdl_ff_qk<D, LD, 1>(s, Qs, Kt, r0, tx); break;
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = q0 + r0 + i;
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + KL * j;
          float val = s[i][j] * scale;
          if (j >= nj || key >= T) {
            val = -INFINITY;  // no such key, or a chunk no row of the warp sees
          } else if (causal && key > row) {
            val = TFDL_FF_MASK;
          }
          s[i][j] = val;
          mt = fmaxf(mt, val);
        }
#pragma unroll
        for (int off = 1; off < KL; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        // key 0 lies in the first tile and every row sees it, so the new
        // max is finite from the first tile on
        const float m_new = fmaxf(m[i], mt);
        const float alpha = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          l[i] += p;
          Ps[(r0 + i) * LDP + tx + KL * j] = p;
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
      }
      __syncwarp();  // this row group's P rows are complete

      // O += P V over the same chunks, four keys at a time
      const int n_keys = nj * KL;
#pragma unroll 2
      for (int kk = 0; kk < n_keys; kk += 4) {
        float4 pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) pv[i] = tfdl_ff_ld4(Ps + (r0 + i) * LDP + kk);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int ch = tx + KL * c;
          if (ch < DQ) {
            float4 vv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) vv[u] = tfdl_ff_ld4(Vt + (kk + u) * LD + 4 * ch);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float pu[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                o[i][c][0] = fmaf(pu[u], vv[u].x, o[i][c][0]);
                o[i][c][1] = fmaf(pu[u], vv[u].y, o[i][c][1]);
                o[i][c][2] = fmaf(pu[u], vv[u].z, o[i][c][2]);
                o[i][c][3] = fmaf(pu[u], vv[u].w, o[i][c][3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int off = 1; off < KL; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r0 + i;
    if (row >= T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* dst = out + (((int64_t)b * T + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int ch = tx + KL * c;
      if (ch < DQ) {
        const float4 y = make_float4(o[i][c][0] / denom, o[i][c][1] / denom,
                                     o[i][c][2] / denom, o[i][c][3] / denom);
        *reinterpret_cast<float4*>(dst + 4 * ch) = y;
      }
    }
  }
}

template <int D>
static int tfdl_ff_launch(const void* q, const void* k, const void* v,
                          void* out, int B, int T, int H, TfdlF32Strides qs,
                          TfdlF32Strides ks, TfdlF32Strides vs, int causal,
                          float scale, cudaStream_t stream) {
  constexpr int BQ = 4 * TFDL_FF_RPT * (32 / TFDL_FF_KL), BK = 4 * TFDL_FF_KL;
  const int smem = (int)sizeof(float) * ((BQ + 4 * BK) * (D + 4) + BQ * (BK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      tfdl_flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((int64_t)B * H * ((T + BQ - 1) / BQ)));
  tfdl_flash_attention_f32_kernel<D>
      <<<grid, TFDL_FF_THREADS, smem, stream>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)out, T,
          H, qs, ks, vs, causal, scale);
  return (int)cudaGetLastError();
}

// q, k, v: float32 [B, T, H, D] with element strides (sb, st, sh) each, d
// contiguous, bases and strides 16-byte aligned; out: contiguous float32
// [B, T, H, D]; D in {16, 32, ..., 128}. The argument list is that of
// tfdl_flash_attention (flash_attention.cu); `bf16` must be 0.
extern "C" int tfdl_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* out, int bf16,
                                        int B, int T, int H, int D,
                                        int64_t q_sb, int64_t q_st,
                                        int64_t q_sh, int64_t k_sb,
                                        int64_t k_st, int64_t k_sh,
                                        int64_t v_sb, int64_t v_st,
                                        int64_t v_sh, int causal, float scale,
                                        void* stream) {
  if (bf16) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaSuccess;
  const TfdlF32Strides qs = {q_sb, q_st, q_sh}, ks = {k_sb, k_st, k_sh},
                       vs = {v_sb, v_st, v_sh};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return tfdl_ff_launch<16>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 32:
      return tfdl_ff_launch<32>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 48:
      return tfdl_ff_launch<48>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 64:
      return tfdl_ff_launch<64>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 80:
      return tfdl_ff_launch<80>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 96:
      return tfdl_ff_launch<96>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 112:
      return tfdl_ff_launch<112>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    case 128:
      return tfdl_ff_launch<128>(q, k, v, out, B, T, H, qs, ks, vs, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
