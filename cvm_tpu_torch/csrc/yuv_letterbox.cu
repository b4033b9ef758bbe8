// The eval preprocess of a planar YUV420 batch for Hopper (sm_90a): one pass
// from the uint8 planes to the letterboxed, normalised NHWC batch (bf16 or
// float32), with each image's letterbox ROI as a row of a (B, 8) float32
// table (src_y0, src_x0, src_h, src_w, dst_y0, dst_x0, dst_h, dst_w) and its
// flip_x, false, in a (B,) bool column.
//
// Replaces no TPU kernel: XLA fuses the reference's eval preprocess
// (cvm_tpu/pipeline/preprocess.py::preprocess_yuv420_batch) into a few
// fusions, while PyTorch runs the same eager ops (the letterbox ROI, three
// bilinear resamples with their gather plans, the colour convert, the
// normalisation and the cast) as ~222 kernels per call, each writing float32
// intermediates to device memory (pipeline/preprocess.py is its one caller,
// through ops/cuda/yuv_letterbox.py).
//
// Numerics: PyTorch's eager CUDA sequence (ops/image.py: letterbox_roi,
// _axis_coords, sample_bilinear, yuv_to_rgb, normalize_pm1, then the cast)
// bit for bit. Each of its ops rounds its float32 result, so each step here
// is one __f*_rn intrinsic, which nvcc never contracts into an FMA:
//  - out_h / h is h.reciprocal() * out_h (Tensor.__rdiv__): two roundings;
//  - torch.round is rint (half to even);
//  - a + (b - a) * f is three rounded ops;
//  - a Python scalar enters an op as its float32 value: (float)1.402, the
//    double rounded once;
//  - x / 127.5 is x * (1 / 127.5f): ATen's CUDA division by a CPU scalar
//    multiplies by the scalar's float32 reciprocal;
//  - the bf16 cast rounds to nearest even.
// Sample indices clamp to each plane's valid extent (luma h, w; chroma
// (h+1)/2, (w+1)/2), as the eager path's, and also to the plane's shape: a
// size larger than its buffer, on which the eager gather faults, reads the
// buffer's last row or column here.
//
// Bound: bytes. The output is written once (6 bytes a pixel in bf16, 12 in
// float32); the source rows an output row samples are read from device
// memory about once (neighbouring pixels share them through L1 and L2), at
// most the planes' valid extents, 1.5 bytes a source pixel. Config B's batch
// of 8 at 512x512 from 768x768 buffers: 12.6 MB out, <= 7.1 MB in, 5.9 us at
// 3.35 TB/s; semseg A's 874x1164 frame at 256x640: 1.0 MB out, 1.5 MB in,
// 0.75 us, below a launch's ~3.4 us.
//
// Design: block (blockIdx.x, blockIdx.y, blockIdx.z) covers a chunk of
// kCols output columns and a group of `rows` (1 to kMaxRows) output rows of
// image blockIdx.z. Each thread owns one column: it computes the image's ROI
// from image_hw as the kernel runs (a replayed CUDA graph reads the sizes of
// that replay; nothing is baked in) and keeps its column's luma and chroma
// plans (lo, hi, frac) in registers; the group's row plans are computed once
// into shared memory, as offsets into the planes. A thread then computes its
// column's pixel in each row of the group and stores its three values: the
// warp's stores cover consecutive bytes. The wrapper picks `rows` so that the
// grid holds about 4 blocks per SM: 8 rows for config B's batch (2,048
// blocks), 2 for semseg's frame (640), so the column plans are amortised
// where the work is large and the SMs are covered where it is small.
// Measured on an H100 80GB HBM3 at config B's batch (CUDA events): staging
// each row in shared memory for 16-byte stores ran 9% slower than these
// direct stores, 2 or 4 adjacent columns per thread 11-25% slower, 1, 2 or
// 16 rows a block slower than 4-8; the division 1 / 127.5 run per pixel and
// 64-bit offsets per load cost 16% together.
//
// Traps: the wrapper refuses a batch or an output height above 65,535 (grid
// limits) and planes of 2^31 bytes or more per image.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;   // output columns per block, one per thread
constexpr int kMaxRows = 8;  // output rows per block, at most

struct Plan {  // one output coordinate's bilinear plan on one plane axis
  int lo, hi;
  float frac;
};

struct Box {  // one image's letterbox: its source size and destination window
  float h, w, dst_y0, dst_x0, dst_h, dst_w;
};

struct RowPlan {  // one output row's plans: its source rows as offsets into the planes
  int luma_lo, luma_hi, chroma_lo, chroma_hi;
  float luma_frac, chroma_frac;
  bool inside;
};

// x / 127.5 on the card is x * (1 / 127.5f), the reciprocal rounded once.
constexpr float kInv127_5 = 1.0f / 127.5f;
static_assert(kInv127_5 == 0x1.010102p-7f, "1 / 127.5 rounded to float32");

// letterbox_roi: scale = min(out_h / h, out_w / w), the window rounded half
// to even and centred (floor of half the slack).
__device__ __forceinline__ Box letterbox(int h, int w, int out_h, int out_w) {
  Box r;
  r.h = __int2float_rn(h);
  r.w = __int2float_rn(w);
  const float fh = __int2float_rn(out_h), fw = __int2float_rn(out_w);
  const float scale = fminf(__fmul_rn(__fdiv_rn(1.0f, r.h), fh),
                            __fmul_rn(__fdiv_rn(1.0f, r.w), fw));
  r.dst_h = rintf(__fmul_rn(r.h, scale));
  r.dst_w = rintf(__fmul_rn(r.w, scale));
  r.dst_y0 = floorf(__fmul_rn(__fsub_rn(fh, r.dst_h), 0.5f));
  r.dst_x0 = floorf(__fmul_rn(__fsub_rn(fw, r.dst_w), 0.5f));
  return r;
}

// _axis_coords' position of output coordinate i across the window, 0..1.
__device__ __forceinline__ float across(float i, float dst0, float len) {
  return __fdiv_rn(__fadd_rn(__fsub_rn(i, dst0), 0.5f), len);
}

__device__ __forceinline__ bool inside(float i, float dst0, float len) {
  return i >= dst0 && i < __fadd_rn(dst0, len);
}

// _axis_coords' gather plan: src = t * src_len - 0.5, its floor and the next
// clamped to [0, last], and its fraction. Clamping the floor to [-1, last]
// first gives the eager path's indices and keeps lo + 1 from overflowing.
__device__ __forceinline__ Plan plan(float t, float src_len, int last) {
  const float src = __fsub_rn(__fmul_rn(t, src_len), 0.5f);
  const float lo = floorf(src);
  const int l = (int)fminf(fmaxf(lo, -1.0f), (float)last);
  return Plan{max(l, 0), min(l + 1, last), __fsub_rn(src, lo)};
}

// The last sample index of a plane axis: valid extent, clamped to the shape.
__device__ __forceinline__ int last_index(int valid, int extent) {
  return max(min(valid, extent) - 1, 0);
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

// sample_bilinear at one pixel: rows first (at the two columns), then
// columns. col_lo / col_hi point at the pixel's two source columns of row 0;
// row_lo / row_hi are its two source rows' offsets.
__device__ __forceinline__ float sample(const uint8_t* __restrict__ col_lo,
                                        const uint8_t* __restrict__ col_hi, int row_lo,
                                        int row_hi, float fy, float fx) {
  const float at_lo = lerp(__ldg(col_lo + row_lo), __ldg(col_lo + row_hi), fy);
  const float at_hi = lerp(__ldg(col_hi + row_lo), __ldg(col_hi + row_hi), fy);
  return lerp(at_lo, at_hi, fx);
}

// clamp to 0..255, then normalize_pm1.
__device__ __forceinline__ float pm1(float c) {
  return __fsub_rn(__fmul_rn(fminf(fmaxf(c, 0.0f), 255.0f), kInv127_5), 1.0f);
}

__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* o, float v) { *o = v; }

template <typename T>
__global__ void __launch_bounds__(kCols)
yuv_letterbox_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                     const uint8_t* __restrict__ v, const int* __restrict__ hw,
                     T* __restrict__ out, float* __restrict__ roi, bool* __restrict__ flip,
                     int Hm, int Wm, int Hc, int Wc, int out_h, int out_w, int rows) {
  __shared__ RowPlan row_plans[kMaxRows];

  const int b = blockIdx.z, t = threadIdx.x;
  const int h = hw[2 * b], w = hw[2 * b + 1];
  const Box box = letterbox(h, w, out_h, out_w);
  const int y0 = blockIdx.y * rows, nrows = min(rows, out_h - y0);

  if (t < nrows) {
    const float i = __int2float_rn(y0 + t);
    const float a = across(i, box.dst_y0, box.dst_h);
    const Plan luma = plan(a, box.h, last_index(h, Hm));
    const Plan chroma = plan(a, __fmul_rn(box.h, 0.5f), last_index((h + 1) >> 1, Hc));
    row_plans[t] = RowPlan{luma.lo * Wm, luma.hi * Wm, chroma.lo * Wc, chroma.hi * Wc,
                           luma.frac, chroma.frac, inside(i, box.dst_y0, box.dst_h)};
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && t == 0) {
    float* r = roi + 8 * b;
    r[0] = 0.0f;
    r[1] = 0.0f;
    r[2] = box.h;
    r[3] = box.w;
    r[4] = box.dst_y0;
    r[5] = box.dst_x0;
    r[6] = box.dst_h;
    r[7] = box.dst_w;
    flip[b] = false;
  }
  __syncthreads();

  const int x = blockIdx.x * kCols + t;
  if (x >= out_w) return;
  const float i = __int2float_rn(x);
  const float a = across(i, box.dst_x0, box.dst_w);
  const Plan lx = plan(a, box.w, last_index(w, Wm));
  const Plan cx = plan(a, __fmul_rn(box.w, 0.5f), last_index((w + 1) >> 1, Wc));
  const bool col_inside = inside(i, box.dst_x0, box.dst_w);
  const uint8_t* yb = y + (long long)b * Hm * Wm;
  const uint8_t* ub = u + (long long)b * Hc * Wc;
  const uint8_t* vb = v + (long long)b * Hc * Wc;
  T* o = out + (((long long)b * out_h + y0) * out_w + x) * 3;
  for (int r = 0; r < nrows; ++r, o += (long long)out_w * 3) {
    const RowPlan rp = row_plans[r];
    float Y = 0.0f, U = 128.0f, V = 128.0f;  // the pads outside the window
    if (col_inside && rp.inside) {
      Y = sample(yb + lx.lo, yb + lx.hi, rp.luma_lo, rp.luma_hi, rp.luma_frac, lx.frac);
      U = sample(ub + cx.lo, ub + cx.hi, rp.chroma_lo, rp.chroma_hi, rp.chroma_frac, cx.frac);
      V = sample(vb + cx.lo, vb + cx.hi, rp.chroma_lo, rp.chroma_hi, rp.chroma_frac, cx.frac);
    }
    // yuv_to_rgb: full-range JFIF, each product and sum rounded.
    const float cb = __fsub_rn(U, 128.0f), cr = __fsub_rn(V, 128.0f);
    store(o, pm1(__fadd_rn(Y, __fmul_rn(cr, (float)1.402))));
    store(o + 1, pm1(__fsub_rn(__fsub_rn(Y, __fmul_rn(cb, (float)0.344136)),
                               __fmul_rn(cr, (float)0.714136))));
    store(o + 2, pm1(__fadd_rn(Y, __fmul_rn(cb, (float)1.772))));
  }
}

}  // namespace

// y: uint8 (B, Hm, Wm); u, v: uint8 (B, Hc, Wc); hw: int32 (B, 2) [h, w];
// all contiguous on the device. out: bf16 or float32 (f32_out) (B, out_h,
// out_w, 3); roi: float32 (B, 8); flip: bool (B,), written false. rows:
// output rows per block, 1..8.
// Returns the cudaError_t of the launch.
extern "C" int yuv_letterbox_launch(const void* y, const void* u, const void* v, const void* hw,
                                    void* out, void* roi, void* flip, int B, int Hm, int Wm,
                                    int Hc, int Wc, int out_h, int out_w, int rows, int f32_out,
                                    void* stream) {
  if (B <= 0 || B > 65535 || Hm <= 0 || Wm <= 0 || Hc <= 0 || Wc <= 0 || out_h <= 0 ||
      out_w <= 0 || rows < 1 || rows > kMaxRows || (long long)Hm * Wm >= 0x7fffffffLL ||
      (long long)Hc * Wc >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((out_w + kCols - 1) / kCols, (out_h + rows - 1) / rows, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t *yp = (const uint8_t*)y, *up = (const uint8_t*)u, *vp = (const uint8_t*)v;
  if (f32_out) {
    yuv_letterbox_kernel<float><<<grid, kCols, 0, s>>>(
        yp, up, vp, (const int*)hw, (float*)out, (float*)roi, (bool*)flip, Hm, Wm, Hc, Wc,
        out_h, out_w, rows);
  } else {
    yuv_letterbox_kernel<__nv_bfloat16><<<grid, kCols, 0, s>>>(
        yp, up, vp, (const int*)hw, (__nv_bfloat16*)out, (float*)roi, (bool*)flip, Hm, Wm, Hc,
        Wc, out_h, out_w, rows);
  }
  return (int)cudaGetLastError();
}
