// CenterNet Gaussian heatmap splat (kernel K1) for Hopper (sm_90a).
//
// Replaces cvm_tpu/ops/pallas/gaussian_splat.py (_render_bk, whose
// pallas_call runs _splat_kernel). For every valid object k of image b whose
// class c lies in [0, C), it max-accumulates
//     g = exp(-(dy^2 + dx^2) / (2 sigma^2 + 1e-12)),  dy^2, dx^2 <= r^2 + 1e-6
// into channel c of a map that starts at zero, written NHWC (B, Hs, Ws, C).
//
// Bound: the map's bytes, written once (B*Hs*Ws*C*4: 10.5 MB at the flagship
// B16 128^2 C10, 3.1 us at 3.35 TB/s; 42 MB at config B's C80). The inputs
// are a few KB and the arithmetic touches only the objects' windows.
//
// Design: one pass that writes every element of the map exactly once, with
// no fill by the caller and no global atomics. The map is cut into tiles,
// each a contiguous range of one image's NHWC map: a band of whole rows
// (rows * Ws * C floats), or, where one row is wider than a tile, a flat
// chunk (ops/cuda/gaussian_splat.py::splat_plan picks the cut, 4 rows of
// 20 KB at the flagship's C10 and 1 row of 40 KB at config B's C80, and the
// launch passes it in). One block owns one tile:
//   1. its first kObjs threads read one of image b's objects each, and,
//      while those reads are in flight, all threads zero the tile in shared
//      memory;
//   2. a thread keeps its object if it is valid, its class is in [0, C)
//      and its window [cy - R, cy + R] meets the tile's rows, R = ceil(r) +
//      1 (every pixel that passes the truncation test lies within R of the
//      centre), and appends it, clipped to the tile, to a list in shared
//      memory;
//   3. the kept windows are cut into units of 32 pixels, numbered across
//      the objects by a prefix sum in one warp, and the warps take the units
//      in turn: each lane computes g once for its pixel and max-accumulates
//      it into the shared tile with an integer atomicMax on the float bits.
//      Every value is >= +0 and the tile starts at +0, where the order of
//      the bit patterns is the order of the floats, so the max is exact and
//      does not depend on the order of warps or objects;
//   4. all threads store the tile with 16-byte vector stores, coalesced; a
//      tile that no object touched is stored as zeros from registers,
//      without a pass over shared memory.
// What is left above the bound is the read of the objects (their latency
// comes before any store) and what a plain write of the map costs: on an
// H100 SXM at 700 W a torch.zeros of the flagship map takes 4.5 us, this
// kernel 5.5 us (scripts/time_gaussian_splat.py --parts).
// The arithmetic follows the reference's order with accurate expf and IEEE
// division (no fast math); __fmul_rn/__fadd_rn keep the denominator and the
// window bound from being contracted into FMAs.
//
// Traps:
//   - K = 0, images without a valid object and tiles no object touches are
//     still written (zeros): the kernel runs a block per tile whatever the
//     objects, and the wrapper's output comes from torch.empty.
//   - Row lengths Ws*C that are not a multiple of 4 floats: a tile's start
//     is then not 16-B aligned. Element i of the tile lives at shared float
//     m + i, m = (start mod 4), so shared and global agree modulo 16 B; the
//     partial float4s at the head and tail are stored one float at a time.
//   - R is not capped at the map size (that is exact only for centres inside
//     the map, which prepare_centers guarantees but the kernel cannot see):
//     it is capped at 1e10 and the window is clipped in 64-bit integers, so
//     a radius of +inf or a centre far outside the map neither overflows nor
//     loses a pixel. Offsets within one image are 32-bit: the launch refuses
//     Hs*Ws*C >= 2^31.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kObjs = 128;     // objects culled per pass (one per thread)
constexpr unsigned kFull = 0xffffffffu;

struct Obj {                   // a kept object, its window clipped to the tile's rows
  int cy, cx, c, y0, y1, x0, x1;
  int npix;                    // pixels of the clipped window
  int u0;                      // its first 32-pixel unit in the pass
  float den, r2;
};

struct Raw {                   // one object as read from the inputs
  int cy, cx, c;
  float s, r;
  bool keep;
};

// Floats of shared memory a tile of `chunk` floats takes: room for the
// alignment offset m <= 3, rounded up to whole float4s.
__host__ __device__ constexpr long long tile_floats(long long chunk) { return (chunk + 6) / 4 * 4; }

__device__ __forceinline__ Raw load_object(const int* __restrict__ iy, const int* __restrict__ ix,
                                           const float* __restrict__ sigma,
                                           const float* __restrict__ radius,
                                           const int* __restrict__ cls,
                                           const uint8_t* __restrict__ valid, int b, int K, int k,
                                           int C) {
  Raw o;
  o.keep = false;
  if (threadIdx.x < kObjs && k < K) {
    const int i = b * K + k;
    o.c = cls[i];
    o.cy = iy[i];
    o.cx = ix[i];
    o.s = sigma[i];
    o.r = radius[i];
    o.keep = valid[i] && o.c >= 0 && o.c < C;
  }
  return o;
}

__global__ void __launch_bounds__(kThreads)
gaussian_splat_kernel(const int* __restrict__ iy, const int* __restrict__ ix,
                      const float* __restrict__ sigma, const float* __restrict__ radius,
                      const int* __restrict__ cls, const uint8_t* __restrict__ valid,
                      float* __restrict__ out, int K, int Hs, int Ws, int C, int chunk,
                      int tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_kept, n_units;
  const int t = blockIdx.x, b = blockIdx.y;
  const int row = Ws * C;                             // the launch checks Hs*Ws*C < 2^31
  const int hwc = row * Hs;
  const int p0 = t * chunk;                           // tile start within image b
  const int len = min(chunk, hwc - p0);
  const long long g0 = (long long)b * hwc + p0;       // tile start within the map
  const int m = (int)(g0 & 3);
  const int end = m + len;                            // shared floats [m, end) hold the tile
  const int nvec = (end + 3) >> 2;
  float4* tile4 = reinterpret_cast<float4*>(smem);
  int* bits = reinterpret_cast<int*>(smem) + m;       // element i of the tile, as int bits
  Obj* objs = reinterpret_cast<Obj*>(smem + tile_floats(chunk));

  // The first pass's objects are read before the zero fill, so that their
  // latency overlaps it.
  Raw raw = load_object(iy, ix, sigma, radius, cls, valid, b, K, threadIdx.x, C);
  if (threadIdx.x == 0) n_kept = 0;
  if (K > 0)
    for (int v = threadIdx.x; v < nvec; v += kThreads) tile4[v] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ty0 = p0 / row;                           // rows the tile touches
  const int ty1 = (p0 + len - 1) / row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool touched = false;                               // the same in every thread
  for (int k0 = 0; k0 < K; k0 += kObjs) {
    if (k0 > 0) raw = load_object(iy, ix, sigma, radius, cls, valid, b, K, k0 + threadIdx.x, C);
    __syncthreads();  // the zero fill, the reset of n_kept and the previous pass are done
    if (raw.keep) {
      const long long R = (long long)fminf(ceilf(fmaxf(raw.r, 0.0f)) + 1.0f, 1e10f);
      const long long y0 = max((long long)raw.cy - R, (long long)ty0);
      const long long y1 = min((long long)raw.cy + R, (long long)ty1);
      const long long x0 = max((long long)raw.cx - R, 0LL);
      const long long x1 = min((long long)raw.cx + R, (long long)Ws - 1);
      if (y0 <= y1 && x0 <= x1) {
        Obj ob;
        ob.cy = raw.cy;
        ob.cx = raw.cx;
        ob.c = raw.c;
        ob.y0 = (int)y0;
        ob.y1 = (int)y1;
        ob.x0 = (int)x0;
        ob.x1 = (int)x1;
        ob.npix = (int)((y1 - y0 + 1) * (x1 - x0 + 1));
        ob.den = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, raw.s), raw.s), 1e-12f);
        ob.r2 = __fadd_rn(__fmul_rn(raw.r, raw.r), 1e-6f);
        objs[atomicAdd(&n_kept, 1)] = ob;
      }
    }
    __syncthreads();
    const int n = n_kept;
    if (n > 0) {
      touched = true;
      // Cut every kept object's window into units of 32 pixels, numbered
      // across the objects (a prefix sum in warp 0), so that the warps
      // share the pixels evenly however few objects meet the tile.
      if (warp == 0) {
        int carry = 0;
        for (int base = 0; base < n; base += 32) {
          const int j = base + lane;
          const int u = j < n ? (objs[j].npix + 31) >> 5 : 0;
          int incl = u;
          for (int d = 1; d < 32; d <<= 1) {
            const int x = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += x;
          }
          if (j < n) objs[j].u0 = carry + incl - u;
          carry += __shfl_sync(kFull, incl, 31);
        }
        if (lane == 0) n_units = carry;
      }
      __syncthreads();
      const int nu = n_units;
      for (int u = warp; u < nu; u += kWarps) {
        int j = -1;  // the last object whose first unit is <= u (u0 ascends with j)
        for (int base = 0; base < n; base += 32) {
          const unsigned ball = __ballot_sync(kFull, base + lane < n && objs[base + lane].u0 <= u);
          j += __popc(ball);
          if (ball != kFull) break;
        }
        const Obj& ob = objs[j];
        const int i = (u - ob.u0) * 32 + lane;
        if (i < ob.npix) {
          const int ww = ob.x1 - ob.x0 + 1;
          const int y = ob.y0 + i / ww;
          const int x = ob.x0 + i % ww;
          const float dy = (float)y - (float)ob.cy;
          const float dx = (float)x - (float)ob.cx;
          const float dy2 = __fmul_rn(dy, dy);
          const float dx2 = __fmul_rn(dx, dx);
          const int e = (y * Ws + x) * C + ob.c - p0;
          if (dy2 <= ob.r2 && dx2 <= ob.r2 && e >= 0 && e < len) {
            const float g = expf(__fdiv_rn(-__fadd_rn(dy2, dx2), ob.den));
            atomicMax(bits + e, __float_as_int(g));
          }
        }
      }
    }
    __syncthreads();  // every warp is done with objs, n_kept and n_units
    if (threadIdx.x == 0) n_kept = 0;
  }

  // Global float (g0 - m + s) is shared float s: the whole float4s
  // [vh, vt) go out as 16-B stores, the head [m, 4 vh) and the tail
  // [4 max(vt, vh), end) (at most 3 floats each) one float at a time. A tile
  // no object touched is all zeros: it is stored from registers, without
  // reading the shared tile.
  float* dst = out + (g0 - m);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int vh = (m + 3) >> 2, vt = end >> 2;
  for (int v = vh + threadIdx.x; v < vt; v += kThreads) dst4[v] = touched ? tile4[v] : zero;
  if (threadIdx.x < 4) {
    const int sh = m + threadIdx.x, st = 4 * max(vt, vh) + threadIdx.x;
    if (sh < min(4 * vh, end)) dst[sh] = touched ? smem[sh] : 0.f;
    if (st < end) dst[st] = touched ? smem[st] : 0.f;
  }
}

}  // namespace

// All pointers are device pointers on the stream's device; iy, ix, cls are
// int32 (B, K), sigma and radius float32 (B, K), valid one byte per object
// (B, K), out float32 (B, Hs, Ws, C), 16-B aligned, uninitialised: every
// element is written. The tiling comes from the wrapper's splat_plan: tiles
// of `chunk` floats, `tiles` per image (the last may be shorter), one block
// each, `smem_bytes` of dynamic shared memory per block. Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for a plan that
// does not tile the map or does not fit its shared memory).
extern "C" int gaussian_splat_launch(const void* iy, const void* ix, const void* sigma,
                                     const void* radius, const void* cls, const void* valid,
                                     void* out, int B, int K, int Hs, int Ws, int C, int chunk,
                                     int tiles, int smem_bytes, void* stream) {
  const long long hwc = (long long)Hs * Ws * C;
  if (B <= 0 || B > 65535 || K < 0 || hwc <= 0 || hwc > 0x7fffffffLL || chunk <= 0 ||
      tiles <= 0 || (long long)tiles * chunk < hwc || (long long)(tiles - 1) * chunk >= hwc ||
      ((uintptr_t)out & 15) != 0 ||
      smem_bytes < tile_floats(chunk) * 4 + kObjs * (long long)sizeof(Obj))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gaussian_splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  gaussian_splat_kernel<<<dim3(tiles, B), kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const int*)iy, (const int*)ix, (const float*)sigma, (const float*)radius,
      (const int*)cls, (const uint8_t*)valid, (float*)out, K, Hs, Ws, C, chunk, tiles);
  return (int)cudaGetLastError();
}
