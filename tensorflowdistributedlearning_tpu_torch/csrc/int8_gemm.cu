// int8 x int8 -> int32 matrix product with the fused scale + bias +
// activation epilogue, as a Hopper GEMM (TMA loads, wgmma, warp roles).
//
// Replaces: tensorflowdistributedlearning_tpu/ops/quant_kernels.py
//   int8_matmul (kernel body _qmm_kernel: the whole [M, K] activation and a
//   [K, nt] weight column block in VMEM, one MXU product, the epilogue in
//   the same grid step), and int8_conv2d's stride-1 1x1 convs without pads
//   (kernel body _qconv_kernel with one tap): over NHWC rows such a conv is
//   this GEMM, [B*H*W, Cin] x [Cout, Cin]^T. int8_conv_tc.cu takes the k x k
//   convs; int8_conv.cu keeps the shapes TMA cannot describe (K % 16 != 0).
//
// Computes, for xq int8 [M, K] (the activation, already quantized per
// tensor, its f32 scale xs on the device) and wk int8 [N, K] (the weight,
// K contiguous per output feature, the nn.Linear layout):
//   acc[m, n] = sum_k xq[m, k] * wk[n, k]                exact, in int32
//   out[m, n] = act(f32(acc) * (xs * ws[n]) + bias[n])    stored as bf16 or f32
// through csrc/epilogue.cuh and the same op order as int8_conv.cu (the
// int->f32 conversion and the two products each rounded on their own), so
// the two kernels and the plain version agree bit for bit.
//
// What bounds it on an H100: bytes. At the ViT-S/16 int8-compute path
// (bucket 64: M = 12 544, (K, N) = (384, 1152), (384, 384), (384, 1536),
// (1536, 384), 12 times each, and the 64 x 384 x 1000 logits) the 49 calls
// move 1.46 GB, about 1.2 GB of it the bf16 outputs, against 0.58 T int8
// operations: 0.44 ms over 3.35 TB/s, 0.29 ms over 1979 TOPS.
//
// Design: persistent blocks of 2 warpgroups and a warp, as many as fit
// (two per SM for bf16 out), striding over the 128 x 128 output tiles with
// N fastest, so that the blocks in flight share their A rows in L2. A
// 2-stage ring of 128-byte K slices (A 128 x 128 and B 128 x 128 bytes per
// stage) lives in shared memory; one thread of the last warp issues TMA
// tiled loads (128-byte swizzle, zero fill past M, N and K) that complete
// on a "full" mbarrier per stage, and waits on the stage's "empty" mbarrier
// before it refills it. The ring runs on across tiles, so the producer
// loads the next tile while the consumers store this one. The two consumer
// warpgroups each own 64 rows and run wgmma.m64n128k32.s32.s8.s8 (both
// operands K-major from shared memory, the only layout wgmma takes for
// 8-bit types) four times per stage, wait for them, and release the stage.
// The epilogue (one instantiation per activation, so no branch runs per
// element; each column's scale formed once for both of a thread's rows)
// writes the converted outputs to a padded shared tile of its own and then
// to device memory in 16-byte coalesced stores, because at these shapes the
// output bytes are most of the bound. The tensor maps are encoded on the
// host with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
// (no -lcuda), and passed as __grid_constant__ parameters; the barrier, TMA
// and wgmma helpers are csrc/hopper.cuh. TMA needs 16-byte aligned bases
// and row strides: the wrapper routes K % 16 != 0 to
// int8_conv.cu before it launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "epilogue.cuh"
#include "hopper.cuh"

#define TFDL_G_WGS 2  // consumer warpgroups, 64 tile rows each
#define TFDL_G_BM (64 * TFDL_G_WGS)
#define TFDL_G_CONSUMERS (128 * TFDL_G_WGS)
#define TFDL_G_BN 128
#define TFDL_G_BK 128  // bytes of K per stage: one 128-byte swizzle row
#define TFDL_G_STAGES 2
#define TFDL_G_THREADS (TFDL_G_CONSUMERS + 32)  // the consumers + 1 producer warp
#define TFDL_G_A_BYTES (TFDL_G_BM * TFDL_G_BK)  // A bytes per stage
#define TFDL_G_B_BYTES (TFDL_G_BN * TFDL_G_BK)  // B bytes per stage

// shared memory of one block: the 1024-byte alignment slack, the ring, the
// output staging tile (rows padded by 16 bytes) and the barriers
template <bool OUT_BF16>
struct TfdlGemmSmem {
  static constexpr int PITCH = TFDL_G_BN * (OUT_BF16 ? 2 : 4) + 16;
  static constexpr int RING = TFDL_G_STAGES * (TFDL_G_A_BYTES + TFDL_G_B_BYTES);
  static constexpr int BYTES = 1024 + RING + TFDL_G_BM * PITCH + 2 * TFDL_G_STAGES * 8;
};

template <bool OUT_BF16, int ACT>
__global__ void __launch_bounds__(TFDL_G_THREADS, 2)
    tfdl_int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const float* __restrict__ x_scale,
                          const float* __restrict__ w_scale,
                          const float* __restrict__ bias, void* __restrict__ out,
                          int M, int N, int K, int vec_out) {
  typedef typename std::conditional<OUT_BF16, __nv_bfloat16, float>::type OutT;
  typedef TfdlGemmSmem<OUT_BF16> L;
  constexpr int EPC = 16 / (int)sizeof(OutT);  // elements per 16 bytes
  constexpr int CPR = TFDL_G_BN / EPC;         // 16-byte chunks per tile row
  extern __shared__ uint8_t tfdl_g_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tfdl_g_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* As = smem;                                 // [S][BM][128]
  uint8_t* Bs = As + TFDL_G_STAGES * TFDL_G_A_BYTES;  // [S][BN][128]
  uint8_t* stage_out = smem + L::RING;                   // [128][PITCH]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + TFDL_G_BM * L::PITCH);
  uint64_t* empty = full + TFDL_G_STAGES;

  const int tiles_n = (N + TFDL_G_BN - 1) / TFDL_G_BN;
  const int tiles = tiles_n * ((M + TFDL_G_BM - 1) / TFDL_G_BM);
  const int nk = (K + TFDL_G_BK - 1) / TFDL_G_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TFDL_G_STAGES; ++s) {
      tfdl_mbar_init(&full[s], 1);
      tfdl_mbar_init(&empty[s], TFDL_G_CONSUMERS);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // Blocks stride over the output tiles, N fastest; the ring's slot and
  // phase run on across tiles, so the producer fills the next tile's first
  // stages while the consumers store the current one.
  if (wg == TFDL_G_WGS) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == TFDL_G_CONSUMERS) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * TFDL_G_BM, n0 = (tile % tiles_n) * TFDL_G_BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % TFDL_G_STAGES;
          tfdl_mbar_wait(&empty[s], ((it / TFDL_G_STAGES) & 1) ^ 1);  // a fresh slot passes
          tfdl_mbar_expect_tx(&full[s], TFDL_G_A_BYTES + TFDL_G_B_BYTES);
          tfdl_tma_load(As + s * TFDL_G_A_BYTES, &map_a, kt * TFDL_G_BK, m0, &full[s]);
          tfdl_tma_load(Bs + s * TFDL_G_B_BYTES, &map_b, kt * TFDL_G_BK, n0, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64); accumulator
  // 4j + e of a thread is tile row 64 wg + 16 warp + lane / 4 + 8 (e >= 2),
  // column 8j + 2 (lane % 4) + (e & 1)
  const int t = threadIdx.x;
  const int lane = t & 31, warp = (t >> 5) & 3;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const float xs = *x_scale;
  OutT* o = reinterpret_cast<OutT*>(out);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * TFDL_G_BM, n0 = (tile % tiles_n) * TFDL_G_BN;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % TFDL_G_STAGES;
      tfdl_mbar_wait(&full[s], (it / TFDL_G_STAGES) & 1);
      const uint8_t* a = As + s * TFDL_G_A_BYTES + wg * 64 * TFDL_G_BK;
      const uint8_t* b = Bs + s * TFDL_G_B_BYTES;
      tfdl_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TFDL_G_BK / 32; ++kk) {
        tfdl_wgmma_s8(acc, tfdl_desc_sw128(a + kk * 32), tfdl_desc_sw128(b + kk * 32));
      }
      tfdl_wgmma_commit_wait();
      tfdl_mbar_arrive(&empty[s]);
    }

    // epilogue: the previous tile's stores have read the staging tile
    asm volatile("bar.sync 1, %0;\n" ::"n"(TFDL_G_CONSUMERS) : "memory");
#pragma unroll
    for (int j = 0; j < TFDL_G_BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      // the two columns' scales, once for both rows
      float scale[2] = {0.0f, 0.0f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (n0 + c + u < N) scale[u] = __fmul_rn(xs, w_scale[n0 + c + u]);
      }
      float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + c + (e & 1);
        if (n < N) {
          // the activation is fixed at compile time: no branch per element
          y[e] = tfdl_bias_act(__fmul_rn(__int2float_rn(acc[4 * j + e]), scale[e & 1]), bias, n, ACT);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows r0 and r0 + 8: two neighbouring columns each
        uint8_t* dst = stage_out + (r0 + 8 * h) * L::PITCH + c * (int)sizeof(OutT);
        if (OUT_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y[2 * h], y[2 * h + 1]);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(y[2 * h], y[2 * h + 1]);
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(TFDL_G_CONSUMERS) : "memory");
    for (int i = t; i < TFDL_G_BM * CPR; i += TFDL_G_CONSUMERS) {
      const int r = i / CPR, n = n0 + (i % CPR) * EPC;
      const int64_t m = m0 + r;
      if (m >= M || n >= N) continue;
      const uint8_t* src = stage_out + r * L::PITCH + (i % CPR) * 16;
      OutT* dst = o + m * N + n;
      if (vec_out && n + EPC <= N) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < EPC && n + e < N; ++e) dst[e] = reinterpret_cast<const OutT*>(src)[e];
      }
    }
  }
}

template <bool OUT_BF16, int ACT>
static int tfdl_gemm_launch(const CUtensorMap& ma, const CUtensorMap& mb, const void* x_scale, const void* w_scale,
                            const void* bias, void* out, int M, int N, int K, int vec_out,
                            cudaStream_t stream) {
  const int smem = TfdlGemmSmem<OUT_BF16>::BYTES;
  // as many resident blocks as fit (two per SM for bf16 out), none idle;
  // the attribute, the SM count and the occupancy are looked up once per
  // device (they cost more host time than the launch)
  static int cached_device = -1, slots_per_device = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(tfdl_int8_gemm_kernel<OUT_BF16, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tfdl_int8_gemm_kernel<OUT_BF16, ACT>, TFDL_G_THREADS,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    slots_per_device = sms * (per_sm > 0 ? per_sm : 1);
    cached_device = device;
  }
  const int64_t tiles = (int64_t)((N + TFDL_G_BN - 1) / TFDL_G_BN) * ((M + TFDL_G_BM - 1) / TFDL_G_BM);
  const int64_t slots = slots_per_device;
  const unsigned int grid = (unsigned int)(tiles < slots ? tiles : slots);
  tfdl_int8_gemm_kernel<OUT_BF16, ACT><<<grid, TFDL_G_THREADS, smem, stream>>>(
      ma, mb, (const float*)x_scale, (const float*)w_scale, (const float*)bias, out, M, N, K, vec_out);
  return (int)cudaGetLastError();
}

// the instantiation for the epilogue's activation (the csrc/epilogue.cuh codes)
template <bool OUT_BF16>
static int tfdl_gemm_dispatch(const CUtensorMap& ma, const CUtensorMap& mb, const void* x_scale, const void* w_scale,
                              const void* bias, void* out, int M, int N, int K, int act, int vec_out,
                              cudaStream_t stream) {
  switch (act) {
    case 0:
      return tfdl_gemm_launch<OUT_BF16, 0>(ma, mb, x_scale, w_scale, bias, out, M, N, K, vec_out, stream);
    case 1:
      return tfdl_gemm_launch<OUT_BF16, 1>(ma, mb, x_scale, w_scale, bias, out, M, N, K, vec_out, stream);
    case 2:
      return tfdl_gemm_launch<OUT_BF16, 2>(ma, mb, x_scale, w_scale, bias, out, M, N, K, vec_out, stream);
    case 3:
      return tfdl_gemm_launch<OUT_BF16, 3>(ma, mb, x_scale, w_scale, bias, out, M, N, K, vec_out, stream);
    case 4:
      return tfdl_gemm_launch<OUT_BF16, 4>(ma, mb, x_scale, w_scale, bias, out, M, N, K, vec_out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// xq: int8 [M, K]; wk: int8 [N, K]; both 16-byte aligned with K % 16 == 0
// (TMA's stride rule); out: [M, N] bf16 (out_bf16) or f32; x_scale: f32
// scalar; w_scale, bias (may be null): f32 [N].
extern "C" int tfdl_int8_gemm(const void* xq, const void* wk, const void* x_scale, const void* w_scale,
                              const void* bias, void* out, int M, int N, int K, int act, int out_bf16,
                              void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaSuccess;
  if (K % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wk) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  TfdlEncodeTiled encode = tfdl_encode_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mb;
  if (!tfdl_map_kmajor(&ma, encode, xq, M, K, TFDL_G_BM) || !tfdl_map_kmajor(&mb, encode, wk, N, K, TFDL_G_BN)) {
    return (int)cudaErrorInvalidValue;
  }
  const int es = out_bf16 ? 2 : 4;
  const int vec_out = ((int64_t)N * es) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) return tfdl_gemm_dispatch<true>(ma, mb, x_scale, w_scale, bias, out, M, N, K, act, vec_out, st);
  return tfdl_gemm_dispatch<false>(ma, mb, x_scale, w_scale, bias, out, M, N, K, act, vec_out, st);
}
