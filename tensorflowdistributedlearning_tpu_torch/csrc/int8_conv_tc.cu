// int8 x int8 -> int32 stride-1 k x k convolution with the fused scale +
// bias + activation epilogue, as a Hopper implicit GEMM (TMA im2col loads,
// wgmma, warp roles).
//
// Replaces: tensorflowdistributedlearning_tpu/ops/quant_kernels.py
//   int8_conv2d (kernel body _qconv_kernel: one pre-padded image per grid
//   step in VMEM, shift-and-matmul over the kh*kw taps on the MXU) for the
//   convs with Cin a multiple of 32. The 1x1 convs without pads go to
//   int8_gemm.cu; int8_conv.cu keeps what neither takes.
//
// Computes, for x int8 NHWC [B, H, W, Cin] (already quantized per tensor,
// its f32 scale xs on the device), w int8 [Cout, kh, kw, Cin] and explicit
// pads (top, bottom, left, right):
//   acc[m, n] = sum_k A[m, k] * w[n, k]                 exact, in int32
//   out[m, n] = act(f32(acc) * (xs * ws[n]) + bias[n])   stored as bf16 or f32
// with M = B*Ho*Wo output pixels (NHW order, so out is NHWC), N = Cout,
// K = kh*kw*Cin in tap-major order (the filter's own layout, so B is
// K-major as wgmma needs for 8-bit operands), A the im2col view of x with
// the padding taps read as zero. The epilogue is csrc/epilogue.cuh's in the
// order of int8_conv.cu and int8_gemm.cu, so the three kernels and the plain
// version agree bit for bit.
//
// What bounds it on an H100: at the serve path's k x k shapes (bucket 64
// of the full-width segmenter: 3x3 over 51x51 with Cin 64, 26x26 with Cin
// 128 and 512, 13x13 with Cin 256) operations, 113.8 G int8 ops against
// 0.177 GB of input, filter and bf16 output: 0.058 ms at 1979 TOPS.
//
// Design: persistent blocks of 2 consumer warpgroups and a producer warp,
// one per SM, striding over the 128 x 128 output tiles (N fastest). The K
// loop walks (tap, channel slice) pairs; a slice is BK = 128, 64 or 32
// bytes of channels (the largest that divides Cin: one wgmma swizzle row,
// so a tap never straddles a slice). For each pair one thread of the
// producer warp issues
//   - A: one TMA im2col box of the input: 128 consecutive output pixels
//     (walked W, H, N inside a bounding box whose corners are the pads, so
//     the pixels wrap across rows and images exactly as M does), each read
//     at the tap's offset (i, j), BK channels from the slice; taps outside
//     the image are zero-filled by the TMA unit;
//   - B: one TMA tile of the [Cout, K] filter, 128 rows x BK bytes, zero
//     past Cout;
// both swizzled at BK bytes and completing on the stage's "full" mbarrier,
// into a ring of 128 KB (4, 8 or 16 stages). The consumer warpgroups own
// 64 rows each and run wgmma.m64n128k32.s32.s8.s8 BK/32 times per stage,
// keep one stage's group in flight, and release the stage before it on its
// "empty" mbarrier. The ring runs on across tiles, so the producer loads
// the next tile while the consumers store this one. The epilogue writes a
// padded shared tile and then device memory in 16-byte coalesced stores.
// The tensor maps are encoded on the host (cuTensorMapEncodeIm2col and
// cuTensorMapEncodeTiled, looked up through the runtime; helpers in
// csrc/hopper.cuh) and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "epilogue.cuh"
#include "hopper.cuh"

#define TFDL_C_WGS 2  // consumer warpgroups, 64 tile rows each
#define TFDL_C_BM (64 * TFDL_C_WGS)
#define TFDL_C_CONSUMERS (128 * TFDL_C_WGS)
#define TFDL_C_BN 128
#define TFDL_C_THREADS (TFDL_C_CONSUMERS + 32)  // the consumers + 1 producer warp
#define TFDL_C_RING (128 * 1024)                // bytes of the stage ring

struct TfdlConvTcShape {
  int M, N, Ho, Wo, kh, kw, Cin, pt, pl;
};

// shared memory of one block: the 1024-byte alignment slack, the ring, the
// output staging tile (rows padded by 16 bytes) and the barriers
template <bool OUT_BF16, int BK>
struct TfdlConvTcSmem {
  static constexpr int A_BYTES = TFDL_C_BM * BK;  // A bytes per stage
  static constexpr int B_BYTES = TFDL_C_BN * BK;  // B bytes per stage
  static constexpr int STAGES = TFDL_C_RING / (A_BYTES + B_BYTES);
  static constexpr int PITCH = TFDL_C_BN * (OUT_BF16 ? 2 : 4) + 16;
  static constexpr int BYTES = 1024 + TFDL_C_RING + TFDL_C_BM * PITCH + 2 * STAGES * 8;
};

template <bool OUT_BF16, int BK>
__global__ void __launch_bounds__(TFDL_C_THREADS, 1)
    tfdl_int8_conv_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b,
                             const float* __restrict__ x_scale,
                             const float* __restrict__ w_scale,
                             const float* __restrict__ bias, void* __restrict__ out,
                             TfdlConvTcShape s, int act, int vec_out) {
  typedef typename std::conditional<OUT_BF16, __nv_bfloat16, float>::type OutT;
  typedef TfdlConvTcSmem<OUT_BF16, BK> L;
  constexpr int EPC = 16 / (int)sizeof(OutT);  // elements per 16 bytes
  constexpr int CPR = TFDL_C_BN / EPC;         // 16-byte chunks per tile row
  extern __shared__ uint8_t tfdl_c_raw[];
  // a swizzle pattern repeats every 8 rows: align the ring to the widest
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tfdl_c_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* As = smem;                            // [S][BM][BK]
  uint8_t* Bs = As + L::STAGES * L::A_BYTES;     // [S][BN][BK]
  uint8_t* stage_out = smem + TFDL_C_RING;       // [BM][PITCH]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_out + TFDL_C_BM * L::PITCH);
  uint64_t* empty = full + L::STAGES;

  const int tiles_n = (s.N + TFDL_C_BN - 1) / TFDL_C_BN;
  const int tiles = tiles_n * ((s.M + TFDL_C_BM - 1) / TFDL_C_BM);
  const int slices = s.Cin / BK;
  const int nk = s.kh * s.kw * slices;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      tfdl_mbar_init(&full[i], 1);
      tfdl_mbar_init(&empty[i], TFDL_C_CONSUMERS);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == TFDL_C_WGS) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == TFDL_C_CONSUMERS) {
      const int hw = s.Ho * s.Wo;
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * TFDL_C_BM, n0 = (tile % tiles_n) * TFDL_C_BN;
        // the tile's first output pixel, as the box's start in the input
        const int img = m0 / hw, r = m0 - img * hw;
        const int oy = r / s.Wo, ox = r - oy * s.Wo;
        for (int i = 0; i < s.kh; ++i) {
          for (int j = 0; j < s.kw; ++j) {
            const int k_tap = (i * s.kw + j) * s.Cin;
            for (int c = 0; c < slices; ++c, ++it) {
              const int st = it % L::STAGES;
              tfdl_mbar_wait(&empty[st], ((it / L::STAGES) & 1) ^ 1);  // a fresh slot passes
              tfdl_mbar_expect_tx(&full[st], L::A_BYTES + L::B_BYTES);
              tfdl_tma_load_im2col(As + st * L::A_BYTES, &map_a, c * BK, ox - s.pl, oy - s.pt, img, (uint16_t)j,
                                   (uint16_t)i, &full[st]);
              tfdl_tma_load(Bs + st * L::B_BYTES, &map_b, k_tap + c * BK, n0, &full[st]);
            }
          }
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
    const int m0 = (tile / tiles_n) * TFDL_C_BM, n0 = (tile % tiles_n) * TFDL_C_BN;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % L::STAGES;
      tfdl_mbar_wait(&full[st], (it / L::STAGES) & 1);
      const uint8_t* a = As + st * L::A_BYTES + wg * 64 * BK;
      const uint8_t* b = Bs + st * L::B_BYTES;
      tfdl_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        tfdl_wgmma_s8(acc, tfdl_desc_sw<BK>(a + kk * 32), tfdl_desc_sw<BK>(b + kk * 32));
      }
      tfdl_wgmma_commit();
      // the stage before this one is done once at most this group runs
      tfdl_wgmma_wait<1>();
      if (kt > 0) tfdl_mbar_arrive(&empty[(it - 1) % L::STAGES]);
    }
    tfdl_wgmma_wait<0>();
    tfdl_mbar_arrive(&empty[(it - 1) % L::STAGES]);

    // epilogue: the previous tile's stores have read the staging tile
    asm volatile("bar.sync 1, %0;\n" ::"n"(TFDL_C_CONSUMERS) : "memory");
#pragma unroll
    for (int j = 0; j < TFDL_C_BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      // the two columns' scales, once for both rows
      float scale[2] = {0.0f, 0.0f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (n0 + c + u < s.N) scale[u] = __fmul_rn(xs, w_scale[n0 + c + u]);
      }
      float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + c + (e & 1);
        if (n < s.N) y[e] = tfdl_bias_act(__fmul_rn(__int2float_rn(acc[4 * j + e]), scale[e & 1]), bias, n, act);
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
    asm volatile("bar.sync 1, %0;\n" ::"n"(TFDL_C_CONSUMERS) : "memory");
    for (int i = t; i < TFDL_C_BM * CPR; i += TFDL_C_CONSUMERS) {
      const int r = i / CPR, n = n0 + (i % CPR) * EPC;
      const int64_t m = m0 + r;
      if (m >= s.M || n >= s.N) continue;
      const uint8_t* src = stage_out + r * L::PITCH + (i % CPR) * 16;
      OutT* dst = o + m * s.N + n;
      if (vec_out && n + EPC <= s.N) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < EPC && n + e < s.N; ++e) dst[e] = reinterpret_cast<const OutT*>(src)[e];
      }
    }
  }
}

template <bool OUT_BF16, int BK>
static int tfdl_conv_tc_launch(const CUtensorMap& ma, const CUtensorMap& mb, const void* x_scale,
                               const void* w_scale, const void* bias, void* out, const TfdlConvTcShape& s, int act,
                               int vec_out, cudaStream_t stream) {
  const int smem = TfdlConvTcSmem<OUT_BF16, BK>::BYTES;
  // one resident block per SM, none idle; the attribute and the SM count
  // are looked up once per device
  static int cached_device = -1, sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device) {
    err = cudaFuncSetAttribute(tfdl_int8_conv_tc_kernel<OUT_BF16, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    cached_device = device;
  }
  const int64_t tiles = (int64_t)((s.N + TFDL_C_BN - 1) / TFDL_C_BN) * ((s.M + TFDL_C_BM - 1) / TFDL_C_BM);
  const unsigned int grid = (unsigned int)(tiles < sms ? tiles : sms);
  tfdl_int8_conv_tc_kernel<OUT_BF16, BK><<<grid, TFDL_C_THREADS, smem, stream>>>(
      ma, mb, (const float*)x_scale, (const float*)w_scale, (const float*)bias, out, s, act, vec_out);
  return (int)cudaGetLastError();
}

template <int BK>
static int tfdl_conv_tc_dispatch(const void* x, const void* w, const void* x_scale, const void* w_scale,
                                 const void* bias, void* out, int B, int H, int W, const TfdlConvTcShape& s, int pb,
                                 int pr, int act, int out_bf16, cudaStream_t stream) {
  TfdlEncodeIm2col encode_im2col = tfdl_encode_im2col_fn();
  TfdlEncodeTiled encode = tfdl_encode_fn();
  if (encode_im2col == nullptr || encode == nullptr) return (int)cudaErrorNotSupported;
  // A: the NHWC input as a 4-D map {C, W, H, N}; the bounding box of the
  // taps' start pixels runs from (-left, -top) to (W - 1 + right - (kw - 1),
  // H - 1 + bottom - (kh - 1)), i.e. over the Wo x Ho output pixels
  const cuuint64_t dims[4] = {(cuuint64_t)s.Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.Cin, (cuuint64_t)W * s.Cin, (cuuint64_t)H * W * s.Cin};
  const int lower[2] = {-s.pl, -s.pt};
  const int upper[2] = {pr - (s.kw - 1), pb - (s.kh - 1)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUtensorMap ma, mb;
  if (encode_im2col(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, lower, upper,
                    (cuuint32_t)BK, (cuuint32_t)TFDL_C_BM, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, tfdl_swizzle(BK),
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorInvalidValue;
  }
  // B: the [Cout, kh*kw*Cin] filter
  if (!tfdl_map_kmajor(&mb, encode, w, s.N, s.kh * s.kw * s.Cin, TFDL_C_BN, BK)) return (int)cudaErrorInvalidValue;
  const int es = out_bf16 ? 2 : 4;
  const int vec_out = ((int64_t)s.N * es) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (out_bf16) return tfdl_conv_tc_launch<true, BK>(ma, mb, x_scale, w_scale, bias, out, s, act, vec_out, stream);
  return tfdl_conv_tc_launch<false, BK>(ma, mb, x_scale, w_scale, bias, out, s, act, vec_out, stream);
}

// x: int8 NHWC [B, H, W, Cin]; w: int8 [Cout, kh, kw, Cin]; both 16-byte
// aligned, Cin % 32 == 0, each pad and (kernel side - 1 - pad) within a
// signed byte (the im2col box corners); out: [B, Ho, Wo, Cout] bf16
// (out_bf16) or f32; x_scale: f32 scalar; w_scale, bias (may be null): f32
// [Cout]. The same arguments as tfdl_int8_conv2d without its vec flag.
extern "C" int tfdl_int8_conv2d_tc(const void* x, const void* w, const void* x_scale, const void* w_scale,
                                   const void* bias, void* out, int B, int H, int W, int Cin, int Cout, int kh,
                                   int kw, int pt, int pb, int pl, int pr, int act, int out_bf16, void* stream) {
  TfdlConvTcShape s;
  s.Ho = H + pt + pb - kh + 1;
  s.Wo = W + pl + pr - kw + 1;
  s.kh = kh;
  s.kw = kw;
  s.Cin = Cin;
  s.pt = pt;
  s.pl = pl;
  s.N = Cout;
  const int64_t M = (int64_t)B * s.Ho * s.Wo;
  if (B <= 0 || s.Ho <= 0 || s.Wo <= 0 || Cout <= 0 || Cin <= 0) return (int)cudaSuccess;
  if (M > (int64_t)0x7FFFFFFF || Cin % 32 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int corners[4] = {-pl, -pt, pr - (kw - 1), pb - (kh - 1)};
  for (int c : corners) {
    if (c < -128 || c > 127) return (int)cudaErrorInvalidValue;
  }
  s.M = (int)M;
  const cudaStream_t st = (cudaStream_t)stream;
  if (Cin % 128 == 0) return tfdl_conv_tc_dispatch<128>(x, w, x_scale, w_scale, bias, out, B, H, W, s, pb, pr, act, out_bf16, st);
  if (Cin % 64 == 0) return tfdl_conv_tc_dispatch<64>(x, w, x_scale, w_scale, bias, out, B, H, W, s, pb, pr, act, out_bf16, st);
  return tfdl_conv_tc_dispatch<32>(x, w, x_scale, w_scale, bias, out, B, H, W, s, pb, pr, act, out_bf16, st);
}
