// CenterNet Gaussian heatmap splat (kernel K1) for Hopper (sm_90a).
//
// Replaces cvm_tpu/ops/pallas/gaussian_splat.py (_render_bk / _splat_kernel).
// For every valid object k of image b whose class c lies in [0, C), it
// max-accumulates
//     g = exp(-(dy^2 + dx^2) / (2 sigma^2 + 1e-12)),  dy^2, dx^2 <= r^2 + 1e-6
// into channel c of a map that starts at zero, written NHWC (B, Hs, Ws, C).
//
// The TPU kernel keeps the whole (C, Hs, Ws) map in VMEM on a (B, K) grid and
// evaluates every pixel for every object. Here blocks run in parallel and in
// no order, so one block takes one (b, k) object and its threads cover only
// the object's (2R+1)^2 window, clipped to the map; R = ceil(r) + 1 bounds the
// truncation test, which is applied per pixel exactly as the reference does.
// Overlapping objects meet through an integer atomicMax on the float bits:
// every value is >= +0 and the map starts at +0, where the order of the bit
// patterns is the order of the floats, so the max is exact and the result
// does not depend on the order of the blocks.
//
// Bound: stores. The map (B*Hs*Ws*C*4 bytes, 10.5 MB at B16 128^2 C10) is
// zero-filled by the wrapper; the kernel touches only window pixels, one
// strided 4-byte atomic each. The arithmetic follows the reference's order
// with accurate expf and IEEE division (no fast math); __fmul_rn/__fadd_rn
// keep the denominator and the window bound from being contracted into FMAs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gaussian_splat_kernel(const int* __restrict__ iy, const int* __restrict__ ix,
                                      const float* __restrict__ sigma,
                                      const float* __restrict__ radius,
                                      const int* __restrict__ cls,
                                      const uint8_t* __restrict__ valid,
                                      float* __restrict__ out, int K, int Hs, int Ws, int C) {
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int o = b * K + k;
  const int c = cls[o];
  if (!valid[o] || c < 0 || c >= C) return;
  const int cy = iy[o];
  const int cx = ix[o];
  const float s = sigma[o];
  const float r = radius[o];
  const float den = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, s), s), 1e-12f);
  const float r2 = __fadd_rn(__fmul_rn(r, r), 1e-6f);
  // Window half-width: every pixel that passes the truncation test lies
  // within ceil(r) + 1 of the centre (r >= 0 from prepare_centers).
  const float rc = fminf(ceilf(fmaxf(r, 0.0f)) + 1.0f, (float)(Hs > Ws ? Hs : Ws));
  const int R = (int)rc;
  const int y0 = max(cy - R, 0), y1 = min(cy + R, Hs - 1);
  const int x0 = max(cx - R, 0), x1 = min(cx + R, Ws - 1);
  if (y0 > y1 || x0 > x1) return;
  const int wh = y1 - y0 + 1, ww = x1 - x0 + 1;
  const float fy = (float)cy, fx = (float)cx;
  int* base = reinterpret_cast<int*>(out) + (size_t)b * Hs * Ws * C + c;
  for (int i = threadIdx.x; i < wh * ww; i += blockDim.x) {
    const int y = y0 + i / ww;
    const int x = x0 + i % ww;
    const float dy = (float)y - fy;
    const float dx = (float)x - fx;
    const float dy2 = __fmul_rn(dy, dy);
    const float dx2 = __fmul_rn(dx, dx);
    if (dy2 <= r2 && dx2 <= r2) {
      const float g = expf(__fdiv_rn(-__fadd_rn(dy2, dx2), den));
      atomicMax(base + ((size_t)y * Ws + x) * C, __float_as_int(g));
    }
  }
}

}  // namespace

// All pointers are device pointers on the stream's device; iy, ix, cls are
// int32 (B, K), sigma and radius float32 (B, K), valid one byte per object
// (B, K), out float32 (B, Hs, Ws, C), zero-filled by the caller. Returns the
// launch's cudaError_t (0 on success).
extern "C" int gaussian_splat_launch(const void* iy, const void* ix, const void* sigma,
                                     const void* radius, const void* cls, const void* valid,
                                     void* out, int B, int K, int Hs, int Ws, int C,
                                     void* stream) {
  if (B <= 0 || K <= 0) return 0;
  dim3 grid(K, B);
  gaussian_splat_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)iy, (const int*)ix, (const float*)sigma, (const float*)radius,
      (const int*)cls, (const uint8_t*)valid, (float*)out, K, Hs, Ws, C);
  return (int)cudaGetLastError();
}
