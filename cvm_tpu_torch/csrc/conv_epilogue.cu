// The BN-folded conv's epilogue for Hopper (sm_90a): one pass after cuDNN's
// bf16 conv that computes, for every element of the NHWC conv output y
// (rows x C, channels contiguous),
//     out = act( bf16( bf16(y + bias[c]) + residual ) )
// with the residual and the activation (none, silu, relu) optional and out
// bf16 or float32.
//
// Replaces no TPU kernel: XLA fuses the reference's bias add, residual add
// and silu into its conv, while PyTorch runs each as a pass of its own over
// the conv's output (infer/fold_bn.py::FoldedConv is its one caller).
//
// Numerics: PyTorch's eager sequence bit for bit. Each step is computed in
// float32 and rounded to bf16 where PyTorch rounds (after the bias add,
// after the residual add, after the activation), round to nearest even
// (__float2bfloat16_rn, as c10::BFloat16 on the card). silu is
// x / (1 + expf(-x)) with the accurate expf and IEEE division, as ATen's
// silu kernel (built without fast math, as this file is); relu is
// fmaxf(x, 0) with NaN passed through, as ATen's clamp_min.
//
// Bound: bytes. y and the residual are read once and out written once; the
// bias is a few hundred bytes. 2 + 2 + 2 bytes an element with a residual,
// 2 + 2 without, 2 + 4 for a float32 out. Nothing to compute is near the
// card's rate.
//
// Design: a thread owns one group of VEC channels of one row (VEC = 8: one
// 16-byte load of y, one of the residual, one of the group's bias, and one
// 16-byte store of a bf16 out, two of a float32 one). A block is groups x
// rows_per_block threads (groups = C / VEC, threadIdx.x the group, about
// 256 threads), so the threads of a warp cover consecutive addresses: whole
// rows, back to back. One thread per unit, with no loop: at config B's
// calls on an H100 this ran 7% faster per forward than a grid-stride loop
// over resident blocks with the bias held across rows, and than the same
// with two or four rows in flight per thread. Widths that are not a
// multiple of 8 (a 2-channel offset or size head, 5 segmentation classes)
// and tensors not aligned to 16 bytes take VEC = 1: the same kernel with
// 2-byte accesses, still coalesced.
//
// Traps: rows * C >= 2^31 is refused (the grid's block count must fit 32
// bits); groups > 1024 is refused (one row's threads would exceed a block),
// which is C > 8192 with VEC = 8 and C > 1024 with VEC = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Act { kNone = 0, kSilu = 1, kRelu = 2 };

__device__ __forceinline__ float rn_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int ACT, bool RES>
__device__ __forceinline__ float epilogue(float y, float bias, float res) {
  float v = rn_bf16(y + bias);
  if (RES) v = rn_bf16(v + res);
  if (ACT == kSilu) {
    v = rn_bf16(v / (1.0f + expf(-v)));
  } else if (ACT == kRelu) {
    v = isnan(v) ? v : fmaxf(v, 0.0f);
  }
  return v;
}

template <int VEC>
struct Vec;

template <>
struct Vec<8> {
  using T = uint4;  // 8 bf16
  __device__ static void unpack(const T& a, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static void store_bf16(void* out, long long i, const float* f) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    reinterpret_cast<uint4*>(out)[i] = a;
  }
  __device__ static void store_f32(void* out, long long i, const float* f) {
    float4* o = reinterpret_cast<float4*>(out) + 2 * i;
    o[0] = make_float4(f[0], f[1], f[2], f[3]);
    o[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <>
struct Vec<1> {
  using T = __nv_bfloat16;
  __device__ static void unpack(const T& a, float* f) { f[0] = __bfloat162float(a); }
  __device__ static void store_bf16(void* out, long long i, const float* f) {
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(f[0]);
  }
  __device__ static void store_f32(void* out, long long i, const float* f) {
    reinterpret_cast<float*>(out)[i] = f[0];
  }
};

// Thread (g, r) of block b handles channel group g of row b*rpb + r: the
// VEC-wide unit row*groups + g of y, residual and out.
template <int VEC, int ACT, bool RES, bool F32OUT>
__global__ void __launch_bounds__(1024)
conv_epilogue_kernel(const void* __restrict__ y, const void* __restrict__ res,
                     const __nv_bfloat16* __restrict__ bias, void* __restrict__ out,
                     long long rows, int groups) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int g = threadIdx.x;
  const long long i = row * groups + g;
  float b[VEC], f[VEC], r[VEC];
  V::unpack(reinterpret_cast<const T*>(y)[i], f);
  if (RES) V::unpack(reinterpret_cast<const T*>(res)[i], r);
  V::unpack(reinterpret_cast<const T*>(bias)[g], b);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = epilogue<ACT, RES>(f[j], b[j], RES ? r[j] : 0.0f);
  if (F32OUT) {
    V::store_f32(out, i, f);
  } else {
    V::store_bf16(out, i, f);
  }
}

template <int VEC, int ACT, bool RES, bool F32OUT>
cudaError_t launch(const void* y, const void* res, const void* bias, void* out, long long rows,
                   int groups, cudaStream_t stream) {
  const int rpb = groups >= 256 ? 1 : 256 / groups;
  const long long blocks = (rows + rpb - 1) / rpb;
  conv_epilogue_kernel<VEC, ACT, RES, F32OUT><<<(unsigned)blocks, dim3(groups, rpb), 0, stream>>>(
      y, res, (const __nv_bfloat16*)bias, out, rows, groups);
  return cudaGetLastError();
}

template <int VEC, int ACT>
cudaError_t by_mode(const void* y, const void* res, const void* bias, void* out, long long rows,
                    int groups, int f32_out, cudaStream_t s) {
  if (res != nullptr) {
    return f32_out ? launch<VEC, ACT, true, true>(y, res, bias, out, rows, groups, s)
                   : launch<VEC, ACT, true, false>(y, res, bias, out, rows, groups, s);
  }
  return f32_out ? launch<VEC, ACT, false, true>(y, res, bias, out, rows, groups, s)
                 : launch<VEC, ACT, false, false>(y, res, bias, out, rows, groups, s);
}

template <int VEC>
cudaError_t by_act(const void* y, const void* res, const void* bias, void* out, long long rows,
                   int groups, int act, int f32_out, cudaStream_t s) {
  switch (act) {
    case kNone: return by_mode<VEC, kNone>(y, res, bias, out, rows, groups, f32_out, s);
    case kSilu: return by_mode<VEC, kSilu>(y, res, bias, out, rows, groups, f32_out, s);
    case kRelu: return by_mode<VEC, kRelu>(y, res, bias, out, rows, groups, f32_out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y, res (or null): bf16 (rows, C), contiguous; bias: bf16 (C,); out: bf16
// or float32 (f32_out) (rows, C), contiguous. vec is 8 (C % 8 == 0 and
// every pointer 16-byte aligned) or 1. act: 0 none, 1 silu, 2 relu.
// Returns the cudaError_t of the launch.
extern "C" int conv_epilogue_launch(const void* y, const void* res, const void* bias, void* out,
                                    long long rows, int C, int vec, int act, int f32_out,
                                    void* stream) {
  if (rows <= 0 || C <= 0 || rows * (long long)C >= 0x7fffffffLL ||
      (vec != 1 && vec != 8) || C % vec != 0 || C / vec > 1024)
    return (int)cudaErrorInvalidValue;
  if (vec == 8) {
    const uintptr_t all = (uintptr_t)y | (uintptr_t)res | (uintptr_t)bias | (uintptr_t)out;
    if (all & 15) return (int)cudaErrorInvalidValue;
    return (int)by_act<8>(y, res, bias, out, rows, C / 8, act, f32_out, (cudaStream_t)stream);
  }
  return (int)by_act<1>(y, res, bias, out, rows, C, act, f32_out, (cudaStream_t)stream);
}
