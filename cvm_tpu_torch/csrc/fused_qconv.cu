// Fused W8A8 ConvBN for Hopper (sm_90a): quantize -> int8 x int8 tensor-core
// implicit GEMM with int32 accumulation -> f32 epilogue (acc*scale + bias,
// activation) -> bf16 / f32 out, or int8 out requantized into the consumer's
// lattice.
//
// Replaces the TPU kernel cvm_tpu/ops/pallas/fused_qconv.py::fused_qconv
// (bodies _kernel_1x1 / _kernel_3x3, helpers _quantize / _epilogue).
//
// What bounds it on this card. The serving convs of CenterNet config B are
// 3x3 stride-1 SAME convs over 8x(16..256)^2 maps with 12..768 input
// channels: about 160 G int8 MACs per batch-8 forward against a few hundred
// MB of activations, so the program sits above the int8 ridge of the H100
// and the limit is how fast the tensor cores are fed from shared memory,
// not device memory. What the TPU kernel kept out of HBM (the s32
// accumulator, the f32 dequant/BN/activation chain, the requant) stays out
// of device memory here too: it lives in registers.
//
// Design (simple and right first; wgmma/TMA pipelines are later work):
//   * A block owns an 8x16 tile of output pixels of one image and a 64-wide
//     slice of Cout. 4 warps; warp w computes output rows 2w, 2w+1 of the
//     tile (two m16 tiles: one m16 tile = 16 pixels of one output row) times
//     the 64 output channels (eight n8 tiles) with mma.sync m16n8k32 s8.
//   * Cin is walked in chunks of 32 (one mma k-step): a 3x3x768x128 int8
//     weight slice is 884 KB and cannot sit in shared memory whole. For each
//     chunk the block stages the input tile plus its 1-pixel halo, QUANTIZED
//     TO INT8 ONCE on the way in (zeros outside the image = SAME padding),
//     and the chunk's 3x3x32x64 weights, then runs the 9 taps as 9 k-steps
//     reading shifted windows of the same staged tile. No row-block/halo
//     BlockSpec tricks: the block computes its own offsets and masks the
//     ragged edge, so any H, any W (W = 1 included), any Cin (zero-padded
//     to the chunk) and any Cout (masked) work.
//   * Shared-memory rows are 48 bytes (32 data + 16 pad) so the fragment
//     loads of a warp (8 rows x 4 words) hit 32 distinct banks.
//   * The epilogue runs on the accumulator registers: int32 -> f32,
//     y = acc*scale[c] + bias[c], silu/relu, then the store (or requant).
//
// Known traps, handled where marked [T1]..[T4]:
//   [T1] jnp.round rounds half to even: use __float2int_rn / rintf, never
//        roundf (which rounds half away from zero).
//   [T2] clip to [-127, 127] BEFORE the int8 cast.
//   [T3] the int32 sum stays below 2^31: |acc| <= 3*3*768*127^2 ~ 1.1e8.
//   [T4] silu is y*sigmoid(y) in f32 with the accurate expf (no fast-math):
//        __expf could move an int8 requant by one lattice step at a
//        rounding boundary. The requant can still differ by one step from a
//        reference whose f32 epilogue rounds differently (FMA contraction),
//        which the comparison allows on a stated small fraction.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // output tile rows
constexpr int TW = 16;         // output tile cols (= mma M of one m16 tile)
constexpr int BN = 64;         // Cout slice per block
constexpr int CK = 32;         // Cin chunk = mma K (int8)
constexpr int ROW = 48;        // smem bytes per pixel / weight row (32 + pad)
constexpr int NTHREADS = 128;  // 4 warps

enum XKind { X_F32 = 0, X_BF16 = 1, X_I8 = 2 };
enum OutKind { OUT_F32 = 0, OUT_BF16 = 1, OUT_I8 = 2 };
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_RELU = 2 };

__device__ __forceinline__ int quantize(float v, float inv) {
  // [T2] clip first, [T1] then round half to even.
  return __float2int_rn(fminf(fmaxf(v * inv, -127.0f), 127.0f));
}

template <int XK>
__device__ __forceinline__ int load_q(const void* x, size_t i, float inv) {
  if constexpr (XK == X_I8) {
    return static_cast<const int8_t*>(x)[i];  // already lattice points
  } else if constexpr (XK == X_BF16) {
    return quantize(__bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]), inv);
  } else {
    return quantize(static_cast<const float*>(x)[i], inv);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int KS, int XK>
__global__ void __launch_bounds__(NTHREADS)
fused_qconv_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, void* __restrict__ out,
                   int H, int W, int Cin, int Cout, int tiles_h, int tiles_w,
                   float inv_sx, int act, int out_kind, float inv_s_out) {
  constexpr int HALO = KS / 2;
  constexpr int IH = TH + 2 * HALO;
  constexpr int IW = TW + 2 * HALO;
  constexpr int TAPS = KS * KS;
  __shared__ __align__(16) int8_t xs[IH * IW * ROW];
  __shared__ __align__(16) int8_t ws[TAPS * BN * ROW];

  int tile = blockIdx.x;
  const int tw = tile % tiles_w;
  tile /= tiles_w;
  const int th = tile % tiles_h;
  const int b = tile / tiles_h;
  const int h0 = th * TH;
  const int w0 = tw * TW;
  const int n0 = blockIdx.y * BN;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // Stage the input tile + halo, quantized once; 4 channels per word.
    for (int i = threadIdx.x; i < IH * IW * (CK / 4); i += NTHREADS) {
      const int k4 = i % (CK / 4);
      const int p = i / (CK / 4);
      const int hh = h0 + p / IW - HALO;
      const int ww = w0 + p % IW - HALO;
      uint32_t packed = 0;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const size_t base = ((static_cast<size_t>(b) * H + hh) * W + ww) * Cin;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = c0 + k4 * 4 + j;
          const int q = ci < Cin ? load_q<XK>(x, base + ci, inv_sx) : 0;
          packed |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q))) << (8 * j);
        }
      }
      *reinterpret_cast<uint32_t*>(xs + p * ROW + k4 * 4) = packed;
    }
    // Stage the weights (global layout kh,kw,Cin,Cout) as [tap][n][k].
    for (int i = threadIdx.x; i < TAPS * (CK / 4) * BN; i += NTHREADS) {
      const int n = i % BN;
      const int r = i / BN;
      const int k4 = r % (CK / 4);
      const int tap = r / (CK / 4);
      const int co = n0 + n;
      uint32_t packed = 0;
      if (co < Cout) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = c0 + k4 * 4 + j;
          if (ci < Cin) {
            const int8_t v = w[(static_cast<size_t>(tap) * Cin + ci) * Cout + co];
            packed |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * j);
          }
        }
      }
      *reinterpret_cast<uint32_t*>(ws + (tap * BN + n) * ROW + k4 * 4) = packed;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int dy = tap / KS;
      const int dx = tap % KS;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // Output row r = 2*warp+mi, pixel c reads input (r+dy, c+dx).
        const int8_t* base = xs + ((2 * warp + mi + dy) * IW + dx) * ROW;
        a[mi][0] = lds32(base + g * ROW + t * 4);
        a[mi][1] = lds32(base + (g + 8) * ROW + t * 4);
        a[mi][2] = lds32(base + g * ROW + 16 + t * 4);
        a[mi][3] = lds32(base + (g + 8) * ROW + 16 + t * 4);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* wb = ws + (tap * BN + ni * 8 + g) * ROW;
        const uint32_t b0 = lds32(wb + t * 4);
        const uint32_t b1 = lds32(wb + 16 + t * 4);
        mma_s8(acc[0][ni], a[0], b0, b1);  // [T3] int32 accumulation
        mma_s8(acc[1][ni], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  // Epilogue in registers. Accumulator element r of an m16n8 tile sits at
  // pixel column g (r < 2) or g + 8 (r >= 2), channel 2t + (r & 1).
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int hh = h0 + 2 * warp + mi;
    if (hh >= H) continue;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ww = w0 + g + (r >= 2 ? 8 : 0);
        const int co = n0 + ni * 8 + 2 * t + (r & 1);
        if (ww >= W || co >= Cout) continue;
        float y = static_cast<float>(acc[mi][ni][r]) * scale[co] + bias[co];
        if (act == ACT_SILU) {
          y = y * (1.0f / (1.0f + expf(-y)));  // [T4] accurate expf
        } else if (act == ACT_RELU) {
          y = fmaxf(y, 0.0f);
        }
        const size_t o = ((static_cast<size_t>(b) * H + hh) * W + ww) * Cout + co;
        if (out_kind == OUT_I8) {
          static_cast<int8_t*>(out)[o] = static_cast<int8_t>(quantize(y, inv_s_out));
        } else if (out_kind == OUT_BF16) {
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
        } else {
          static_cast<float*>(out)[o] = y;
        }
      }
    }
  }
}

template <int KS, int XK>
void launch(const void* x, const int8_t* w, const float* scale,
            const float* bias, void* out, int B, int H, int W, int Cin,
            int Cout, float inv_sx, int act, int out_kind, float inv_s_out,
            cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(static_cast<unsigned>(B * tiles_h * tiles_w),
                  static_cast<unsigned>((Cout + BN - 1) / BN));
  fused_qconv_kernel<KS, XK><<<grid, NTHREADS, 0, stream>>>(
      x, w, scale, bias, out, H, W, Cin, Cout, tiles_h, tiles_w, inv_sx, act,
      out_kind, inv_s_out);
}

}  // namespace

// Plain C interface (bound with ctypes). Shapes: x (B,H,W,Cin) NHWC of kind
// x_kind, w (ks,ks,Cin,Cout) int8, scale/bias (Cout,) f32, out (B,H,W,Cout)
// of kind out_kind; all contiguous. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int fused_qconv_launch(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int B, int H, int W, int Cin,
                                  int Cout, int ks, int x_kind, float inv_sx,
                                  int act, int out_kind, float inv_s_out,
                                  void* stream) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ks != 1 && ks != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (x_kind < 0 || x_kind > 2 || out_kind < 0 || out_kind > 2 || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define CVM_LAUNCH(KS, XK) \
  launch<KS, XK>(x, wq, sc, bi, out, B, H, W, Cin, Cout, inv_sx, act, out_kind, inv_s_out, s)
  if (ks == 3) {
    if (x_kind == X_F32) CVM_LAUNCH(3, X_F32);
    else if (x_kind == X_BF16) CVM_LAUNCH(3, X_BF16);
    else CVM_LAUNCH(3, X_I8);
  } else {
    if (x_kind == X_F32) CVM_LAUNCH(1, X_F32);
    else if (x_kind == X_BF16) CVM_LAUNCH(1, X_BF16);
    else CVM_LAUNCH(1, X_I8);
  }
#undef CVM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
