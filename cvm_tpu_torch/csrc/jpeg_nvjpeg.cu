// Batch JPEG decoder for the card's machine: nvJPEG, with libjpeg's output.
//
// The card's machine has no libjpeg, so the host decoder of
// csrc/jpeg_feeder.cc cannot be built there. This library keeps its C
// interface (cvm_decode_batch, cvm_decode_batch_yuv420: the same padded
// host buffers and hw, the same power-of-2 scale choice) and decodes with
// nvJPEG (CUDA toolkit) on the card. nvJPEG hands over the decoded
// component planes; what libjpeg does after its IDCT is done here, in the
// kernels below, with libjpeg's own integer arithmetic, so that the output
// differs from jpeg_feeder.cc's only where the two IDCTs round differently:
//   * RGB: each component as libjpeg decodes it (plan_plane, after
//     jdmaster.c and jdsample.c): its IDCT at the component's own DCT scale,
//     which is the output's scale num/8 doubled while both of the frame's
//     sampling ratios stay whole (4:2:0 chroma at twice the luma's scale at
//     1/2, 1/4 and 1/8, and so needing no upsampling there), then its
//     upsampler: "fancy" for 2:1 across (4:2:2), 1:2 down (4:4:0) and 2:2
//     (4:2:0 at full scale) while the scale is above 1/8, else each sample
//     replicated by the whole ratio (int_upsample: 4:1:1, 4:1:0, a 1x4
//     luma, and any other whole ratio); then libjpeg's YCbCr -> RGB tables
//     (jdsample.c, jdcolor.c). libjpeg's reduced-size IDCTs (jidctred.c)
//     equal, in exact arithmetic, the box average of the full IDCT's output
//     over 2x2, 4x4, 8x8 pixels (the average of adjacent 8-point IDCT
//     outputs drops the frequencies the reduced IDCT drops), so each plane
//     nvJPEG decodes at full scale is box-averaged by 8 / its DCT size;
//   * planar YUV420: the raw planes at full scale (jpeg_feeder.cc's raw
//     path, under the same condition), else RGB converted on the card with
//     jpeg_feeder.cc's integer formulas (Y per pixel, chroma from the 2x2
//     RGB average).
// Grayscale is its Y plane, replicated. A three-component JPEG that
// libjpeg reads as RGB (read_header below) takes the same upsampling and
// no color conversion. Refused as unreadable (1): four components (CMYK,
// YCCK), which libjpeg cannot convert to RGB either; sampling ratios that
// are not whole, which libjpeg refuses too; and what nvJPEG itself does not
// decode into planes of the sizes the frame header implies
// (cvm_decode_info reports nvJPEG's own verdict).
//
// Return codes per image: 0 decoded; the data faults of jpeg_feeder.cc, 1
// unreadable (nvJPEG's BAD_JPEG, JPEG_NOT_SUPPORTED or INCOMPLETE_BITSTREAM,
// or a refused layout) and 3 too large even at 1/8; and the decoder's own faults, which are not
// the image's: 4 a CUDA call failed, 5 the decoder could not start (device,
// handle or state), 6 nvJPEG failed otherwise. cvm_decode_last_error()
// names the last fault.
//
// Build: cvm_tpu_torch/ops/cuda/_build.py::load_library (nvcc, -lnvjpeg),
// at first use. Python binding: cvm_tpu_torch/data/jpeg.py.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <pthread.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

enum { kUnreadable = 1, kTooLarge = 3, kCuda = 4, kNoStart = 5, kNvjpeg = 6 };

int g_device = 0;
nvjpegHandle_t g_handle = nullptr;
pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;
char g_error[256] = "";

// Records a fault of the decoder (not of an image) and returns its code.
int fault(int code, const char* fmt, ...) {
  pthread_mutex_lock(&g_mu);
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(g_error, sizeof(g_error), fmt, ap);
  va_end(ap);
  pthread_mutex_unlock(&g_mu);
  return code;
}

// A failed CUDA call; its error is cleared from the calling thread (unless
// it is sticky), so that it does not surface in the caller's next check.
int cuda_fault(int code, const char* what, cudaError_t e) {
  cudaGetLastError();
  return fault(code, "%s: %s", what, cudaGetErrorString(e));
}

// nvJPEG's verdict on the bytes: BAD_JPEG, JPEG_NOT_SUPPORTED and
// INCOMPLETE_BITSTREAM (a stream cut short) are the image's fault, any other
// failure the decoder's.
int nvjpeg_rc(const char* what, nvjpegStatus_t s) {
  if (s == NVJPEG_STATUS_SUCCESS) return 0;
  if (s == NVJPEG_STATUS_BAD_JPEG || s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ||
      s == NVJPEG_STATUS_INCOMPLETE_BITSTREAM)
    return kUnreadable;
  return fault(kNvjpeg, "%s: nvjpegStatus_t %d", what, (int)s);
}

// One decoding thread's nvJPEG state, stream and device scratch; kept in a
// pool across calls (a state is not thread-safe, the handle is).
struct Worker {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* planes = nullptr;  // nvJPEG's output: the component planes
  size_t planes_cap = 0;
  uint8_t* rgb = nullptr;     // the (scaled) RGB frame, oh x ow x 3
  size_t rgb_cap = 0;
  uint8_t* yuv = nullptr;     // converted planes, oh x ow + 2 chroma planes
  size_t yuv_cap = 0;
};
std::vector<Worker*> g_pool;

// 0, or kCuda when the device buffer cannot grow to `need` bytes.
int grow(uint8_t** buf, size_t* cap, size_t need) {
  if (need <= *cap) return 0;
  if (*buf) cudaFree(*buf);
  *buf = nullptr;
  *cap = 0;
  const cudaError_t e = cudaMalloc(buf, need);
  if (e != cudaSuccess) return cuda_fault(kCuda, "cudaMalloc", e);
  *cap = need;
  return 0;
}

bool ensure_handle() {
  pthread_mutex_lock(&g_mu);
  const int device = g_device;
  cudaError_t e = cudaSuccess;
  nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
  if (g_handle == nullptr) {
    e = cudaSetDevice(device);
    if (e == cudaSuccess) s = nvjpegCreateSimple(&g_handle);
    if (e != cudaSuccess || s != NVJPEG_STATUS_SUCCESS) g_handle = nullptr;
  }
  pthread_mutex_unlock(&g_mu);
  if (e != cudaSuccess)
    cuda_fault(kNoStart, "cudaSetDevice", e);
  else if (s != NVJPEG_STATUS_SUCCESS)
    fault(kNoStart, "nvjpegCreateSimple: nvjpegStatus_t %d", (int)s);
  return e == cudaSuccess && s == NVJPEG_STATUS_SUCCESS;
}

Worker* acquire() {
  pthread_mutex_lock(&g_mu);
  Worker* w = nullptr;
  if (!g_pool.empty()) {
    w = g_pool.back();
    g_pool.pop_back();
  }
  pthread_mutex_unlock(&g_mu);
  if (w) return w;
  w = new Worker();
  const nvjpegStatus_t s = nvjpegJpegStateCreate(g_handle, &w->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    fault(kNoStart, "nvjpegJpegStateCreate: nvjpegStatus_t %d", (int)s);
    delete w;
    return nullptr;
  }
  const cudaError_t e = cudaStreamCreateWithFlags(&w->stream, cudaStreamNonBlocking);
  if (e != cudaSuccess) {
    cuda_fault(kNoStart, "cudaStreamCreateWithFlags", e);
    nvjpegJpegStateDestroy(w->state);
    delete w;
    return nullptr;
  }
  return w;
}

void release(Worker* w) {
  pthread_mutex_lock(&g_mu);
  g_pool.push_back(w);
  pthread_mutex_unlock(&g_mu);
}

// jpeg_feeder.cc::choose_scale, on the header's size (libjpeg's scaled
// extent is ceil(size * num / 8)). Returns num in {8, 4, 2, 1}, or -1 when
// even 1/8 exceeds the buffer.
int choose_num(int h, int w, int max_h, int max_w, int target_h, int target_w) {
  int best = -1;
  for (int num = 8; num >= 1; num /= 2) {
    const int oh = (h * num + 7) / 8, ow = (w * num + 7) / 8;
    if (oh > max_h || ow > max_w) continue;
    if (best < 0) best = num;
    if (target_h > 0 && 8 * oh >= 7 * target_h && 8 * ow >= 7 * target_w) best = num;
  }
  return best;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint8_t sat(int v) { return (uint8_t)clampi(v, 0, 255); }

// Rounded mean of the f x f block at (y*f, x*f) of a w x h plane, edges
// replicated; f is a power of 2 (1..8).
__device__ __forceinline__ int box(const uint8_t* p, int w, int h, int y, int x, int f,
                                   int shift) {
  int acc = 0;
  for (int i = 0; i < f; ++i) {
    const uint8_t* row = p + (size_t)clampi(y * f + i, 0, h - 1) * w;
    for (int j = 0; j < f; ++j) acc += row[clampi(x * f + j, 0, w - 1)];
  }
  return (acc + ((f * f) >> 1)) >> shift;
}

// libjpeg's YCbCr -> RGB (jdcolor.c build_ycc_rgb_table, SCALEBITS 16).
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, uint8_t* o) {
  const int x_cb = cb - 128, x_cr = cr - 128;
  const int one_half = 1 << 15;
  const int cr_r = (91881 * x_cr + one_half) >> 16;      // FIX(1.40200)
  const int cb_b = (116130 * x_cb + one_half) >> 16;     // FIX(1.77200)
  const int g = (-22554 * x_cb + one_half + -46802 * x_cr) >> 16;  // FIX(0.34414), FIX(0.71414)
  o[0] = sat(y + cr_r);
  o[1] = sat(y + g);
  o[2] = sat(y + cb_b);
}

// How one component's plane (w x h at full scale, as nvJPEG hands it over)
// gives the sample of output pixel (x, y), as libjpeg decodes and upsamples
// that component (plan_plane): box-averaged by g (libjpeg's IDCT at the
// component's own DCT scale 8/g), then upsampled by (rh, rv) output samples
// per sample: "fancy" when `fancy` (jdsample.c h2v1_fancy_upsample for
// (2, 1): 3/4 nearer + 1/4 further sample, bias 1 left and 2 right;
// h1v2_fancy_upsample for (1, 2): the same with rows, bias 1 above and 2
// below; h2v2_fancy_upsample for (2, 2): that vertical blend, then across,
// bias 8 left and 7 right; edges replicated), else each sample replicated
// (int_upsample; nothing to do at (1, 1)).
struct Plane {
  const uint8_t* p;
  int w, h;    // at full scale
  int g, gs;   // box factor, log2(g * g)
  int rh, rv;  // upsampling factors
  bool fancy;
};

__device__ __forceinline__ int sample_at(const Plane& c, int y, int x) {
  const int cy = y / c.rv, cx = x / c.rh;
  const int near = box(c.p, c.w, c.h, cy, cx, c.g, c.gs);
  if (!c.fancy) return near;
  const int rw = (c.w + c.g - 1) / c.g, rh = (c.h + c.g - 1) / c.g;
  const int nx = clampi((x & 1) ? cx + 1 : cx - 1, 0, rw - 1);
  const int ny = clampi((y & 1) ? cy + 1 : cy - 1, 0, rh - 1);
  if (c.rv == 1) return (3 * near + box(c.p, c.w, c.h, cy, nx, c.g, c.gs) + ((x & 1) ? 2 : 1)) >> 2;
  if (c.rh == 1) return (3 * near + box(c.p, c.w, c.h, ny, cx, c.g, c.gs) + ((y & 1) ? 2 : 1)) >> 2;
  const int s = 3 * near + box(c.p, c.w, c.h, ny, cx, c.g, c.gs);
  const int n = 3 * box(c.p, c.w, c.h, cy, nx, c.g, c.gs) + box(c.p, c.w, c.h, ny, nx, c.g, c.gs);
  return (3 * s + n + ((x & 1) ? 7 : 8)) >> 4;
}

// Component planes -> RGB (oh x ow x 3) with libjpeg's arithmetic after
// its IDCT: each component's sample (sample_at), then libjpeg's YCbCr
// tables, or, when `rgb`, the three samples as they are (libjpeg's null
// conversion). Grayscale (ncomp 1): Cb = Cr = 128, i.e. R = G = B = Y.
__global__ void k_rgb_from_planes(Plane c0, Plane c1, Plane c2, int ncomp, bool rgb,
                                  uint8_t* out, int ow, int oh) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  const int yy = sample_at(c0, y, x);
  const int cb = ncomp == 3 ? sample_at(c1, y, x) : 128;
  const int cr = ncomp == 3 ? sample_at(c2, y, x) : 128;
  uint8_t* o = out + ((size_t)y * ow + x) * 3;
  if (rgb) {
    o[0] = (uint8_t)yy;
    o[1] = (uint8_t)cb;
    o[2] = (uint8_t)cr;
  } else {
    ycc_rgb(yy, cb, cr, o);
  }
}
// jpeg_feeder.cc's RGB -> planar 4:2:0 (its path for scaled or non-4:2:0
// sources): fixed-point Y per pixel; chroma from the rounded 2x2 average of
// RGB, an odd last row or column paired with itself. One thread per chroma
// sample and its (up to) four luma samples.
__global__ void k_yuv_from_rgb(const uint8_t* rgb, int ow, int oh, uint8_t* Yo,
                               uint8_t* Uo, uint8_t* Vo) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y * blockDim.y + threadIdx.y;
  const int cow = (ow + 1) / 2, coh = (oh + 1) / 2;
  if (cx >= cow || cy >= coh) return;
  const int y0 = 2 * cy, y1 = y0 + 1 < oh ? y0 + 1 : y0;
  const int x0 = 2 * cx, x1 = x0 + 1 < ow ? x0 + 1 : x0;
  for (int yy = y0; yy <= y1; ++yy)
    for (int xx = x0; xx <= x1; ++xx) {
      const uint8_t* p = rgb + ((size_t)yy * ow + xx) * 3;
      Yo[(size_t)yy * ow + xx] = (uint8_t)((77 * p[0] + 150 * p[1] + 29 * p[2] + 128) >> 8);
    }
  const uint8_t *a = rgb + ((size_t)y0 * ow + x0) * 3, *b = rgb + ((size_t)y0 * ow + x1) * 3;
  const uint8_t *c = rgb + ((size_t)y1 * ow + x0) * 3, *d = rgb + ((size_t)y1 * ow + x1) * 3;
  const int r = (a[0] + b[0] + c[0] + d[0] + 2) >> 2;
  const int g = (a[1] + b[1] + c[1] + d[1] + 2) >> 2;
  const int bl = (a[2] + b[2] + c[2] + d[2] + 2) >> 2;
  Uo[(size_t)cy * cow + cx] = sat(((-43 * r - 85 * g + 128 * bl + 128) >> 8) + 128);
  Vo[(size_t)cy * cow + cx] = sat(((128 * r - 107 * g - 21 * bl + 128) >> 8) + 128);
}

int log2i(int f) { return f == 1 ? 0 : (f == 2 ? 1 : (f == 4 ? 2 : 3)); }

dim3 grid_of(int w, int h, dim3 blk) {
  return dim3((w + blk.x - 1) / blk.x, (h + blk.y - 1) / blk.y);
}

struct Decoded {
  int w, h, f, ow, oh;  // the frame (SOF), 8 / num, the output
  int ncomp;            // 1 or 3
  Plane planes[3];      // each component's plane (p set by to_rgb) and plan
  bool rgb;             // the three planes are R, G, B (libjpeg's JCS_RGB)
  bool is420;           // YCbCr, luma 2x2, chroma 1x1
};

// What decode_planes reads of the markers before the first scan.
struct Header {
  int w = 0, h = 0, ncomp = 0;
  int hs[4] = {0, 0, 0, 0}, vs[4] = {0, 0, 0, 0};  // sampling factors
  bool rgb = false;
};

// The frame header (SOFn) and libjpeg's guess of a three-component JPEG's
// color space (jdapimin.c default_decompress_parms, from the markers before
// the frame header): a JFIF marker means YCbCr; else an Adobe marker's
// transform, 0 RGB and any other YCbCr; else component ids 'R', 'G', 'B'
// mean RGB, any others YCbCr. False when there is no readable SOFn.
bool read_header(const uint8_t* p, unsigned long len, Header* hd) {
  bool jfif = false, adobe = false;
  int transform = 1;
  unsigned long i = 2;
  while (i + 4 <= len && p[i] == 0xFF) {
    const int m = p[i + 1];
    if (m == 0xFF) {  // fill byte
      ++i;
      continue;
    }
    const unsigned long seg = ((unsigned long)p[i + 2] << 8) | p[i + 3];
    if (seg < 2 || i + 2 + seg > len) return false;
    const uint8_t* d = p + i + 4;
    const unsigned long n = seg - 2;
    if (m == 0xE0 && n >= 14 && memcmp(d, "JFIF", 5) == 0) jfif = true;
    if (m == 0xEE && n >= 12 && memcmp(d, "Adobe", 5) == 0) {
      adobe = true;
      transform = d[11];
    }
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {  // SOFn
      if (n < 6) return false;
      hd->h = (d[1] << 8) | d[2];
      hd->w = (d[3] << 8) | d[4];
      hd->ncomp = d[5];
      if (hd->ncomp < 1 || hd->ncomp > 4 || n < 6 + 3ul * hd->ncomp) return false;
      for (int c = 0; c < hd->ncomp; ++c) {
        hd->hs[c] = d[7 + 3 * c] >> 4;
        hd->vs[c] = d[7 + 3 * c] & 15;
      }
      if (hd->ncomp == 3 && !jfif)
        hd->rgb = adobe ? transform == 0 : (d[6] == 'R' && d[9] == 'G' && d[12] == 'B');
      return true;
    }
    i += 2 + seg;
  }
  return false;
}

// libjpeg's plan for component c at scale num/8 (jdmaster.c
// jpeg_calc_output_dimensions, jdsample.c jinit_upsampler): the component's
// IDCT runs at DCT size ssize, which starts at num and doubles while it
// stays within 8 and both of the frame's sampling ratios stay whole ("scale
// up the chroma components via IDCT scaling rather than upsampling"); its
// (h * ssize / num, v * ssize / num) samples then upsample onto (max_h,
// max_v): fancy for 2:1, 1:2 and 2:2 while num > 1 (and, across, only when
// the plane is wider than 2 samples), else replicated (int_upsample). False
// for a ratio that is not whole, which libjpeg refuses ("Fractional sampling
// not implemented yet").
bool plan_plane(const Header& hd, int c, int num, int w, int h, Plane* pl) {
  int max_h = 0, max_v = 0;
  for (int k = 0; k < hd.ncomp; ++k) {
    max_h = hd.hs[k] > max_h ? hd.hs[k] : max_h;
    max_v = hd.vs[k] > max_v ? hd.vs[k] : max_v;
  }
  const int hc = hd.hs[c], vc = hd.vs[c];
  int ssize = num;
  while (ssize < 8 && (max_h * num) % (hc * ssize * 2) == 0 &&
         (max_v * num) % (vc * ssize * 2) == 0)
    ssize *= 2;
  const int h_in = hc * ssize / num, v_in = vc * ssize / num;
  if (max_h % h_in || max_v % v_in) return false;
  pl->p = nullptr;
  pl->w = w;
  pl->h = h;
  pl->g = 8 / ssize;
  pl->gs = 2 * log2i(pl->g);
  pl->rh = max_h / h_in;
  pl->rv = max_v / v_in;
  const bool wide = (w + pl->g - 1) / pl->g > 2;
  pl->fancy = num > 1 && ((pl->rh == 2 && pl->rv == 1 && wide) ||
                          (pl->rh == 1 && pl->rv == 2) || (pl->rh == 2 && pl->rv == 2 && wide));
  return true;
}

// Header, scale choice and nvJPEG decode into the worker's planes: one
// (grayscale) or three components with sampling factors 1-4 whose ratios
// libjpeg can upsample, each plane at its own size. Any other layout (four
// components, a fractional ratio, planes of another size than the frame
// header implies) is refused, as is what nvJPEG itself refuses. Returns 0
// or the image's code (see the top of the file).
int decode_planes(Worker* wk, const uint8_t* jpeg, unsigned long len, int max_h, int max_w,
                  int target_h, int target_w, Decoded* d) {
  // libjpeg's "Not a JPEG file": no start-of-image marker.
  if (len < 2 || jpeg[0] != 0xFF || jpeg[1] != 0xD8) return kUnreadable;
  int ncomp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  int rc = nvjpeg_rc("nvjpegGetImageInfo",
                     nvjpegGetImageInfo(g_handle, jpeg, len, &ncomp, &css, widths, heights));
  if (rc != 0) return rc;
  Header hd;
  if (!read_header(jpeg, len, &hd) || hd.w <= 0 || hd.h <= 0 || hd.ncomp != ncomp ||
      (ncomp != 1 && ncomp != 3))
    return kUnreadable;
  int smax_h = 0, smax_v = 0;  // the largest sampling factors
  for (int c = 0; c < ncomp; ++c) {
    if (hd.hs[c] < 1 || hd.hs[c] > 4 || hd.vs[c] < 1 || hd.vs[c] > 4) return kUnreadable;
    smax_h = hd.hs[c] > smax_h ? hd.hs[c] : smax_h;
    smax_v = hd.vs[c] > smax_v ? hd.vs[c] : smax_v;
  }
  d->w = hd.w;
  d->h = hd.h;
  const int num = choose_num(d->h, d->w, max_h, max_w, target_h, target_w);
  if (num < 0) return kTooLarge;
  d->f = 8 / num;
  d->ow = (d->w * num + 7) / 8;
  d->oh = (d->h * num + 7) / 8;
  d->ncomp = ncomp;
  size_t total = 0;
  for (int c = 0; c < ncomp; ++c) {
    // libjpeg's component size (jdinput.c): ceil(w * h_c / max_h) by
    // ceil(h * v_c / max_v).
    const int cw = (d->w * hd.hs[c] + smax_h - 1) / smax_h;
    const int ch = (d->h * hd.vs[c] + smax_v - 1) / smax_v;
    if (widths[c] != cw || heights[c] != ch) return kUnreadable;
    if (!plan_plane(hd, c, num, cw, ch, &d->planes[c])) return kUnreadable;
    total += (size_t)cw * ch;
  }
  d->rgb = ncomp == 3 && hd.rgb;
  d->is420 = ncomp == 3 && !d->rgb && hd.hs[0] == 2 && hd.vs[0] == 2 && hd.hs[1] == 1 &&
             hd.vs[1] == 1 && hd.hs[2] == 1 && hd.vs[2] == 1;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  if ((rc = grow(&wk->planes, &wk->planes_cap, total)) != 0) return rc;
  size_t at = 0;
  for (int c = 0; c < ncomp; ++c) {
    img.channel[c] = wk->planes + at;
    img.pitch[c] = d->planes[c].w;
    at += (size_t)d->planes[c].w * d->planes[c].h;
  }
  return nvjpeg_rc("nvjpegDecode",
                   nvjpegDecode(g_handle, wk->state, jpeg, len,
                                ncomp == 3 ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &img,
                                wk->stream));
}

// The decoded frame as RGB (oh x ow x 3) in the worker's rgb buffer.
int to_rgb(Worker* wk, Decoded& d) {
  if (const int rc = grow(&wk->rgb, &wk->rgb_cap, (size_t)d.ow * d.oh * 3)) return rc;
  size_t at = 0;
  for (int c = 0; c < d.ncomp; ++c) {
    d.planes[c].p = wk->planes + at;
    at += (size_t)d.planes[c].w * d.planes[c].h;
  }
  const dim3 blk(32, 8);
  k_rgb_from_planes<<<grid_of(d.ow, d.oh, blk), blk, 0, wk->stream>>>(
      d.planes[0], d.planes[d.ncomp == 3 ? 1 : 0], d.planes[d.ncomp == 3 ? 2 : 0], d.ncomp,
      d.rgb, wk->rgb, d.ow, d.oh);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : cuda_fault(kCuda, "kernel launch", e);
}
int copy_rect(uint8_t* dst, size_t dpitch, const uint8_t* src, size_t spitch, size_t width,
              size_t height, cudaStream_t s) {
  const cudaError_t e = cudaMemcpy2DAsync(dst, dpitch, src, spitch, width, height,
                                          cudaMemcpyDeviceToHost, s);
  return e == cudaSuccess ? 0 : cuda_fault(kCuda, "cudaMemcpy2DAsync", e);
}

int finish(Worker* wk, int rc) {
  const cudaError_t e = cudaStreamSynchronize(wk->stream);
  if (e == cudaSuccess) return rc;
  const int f = cuda_fault(kCuda, "cudaStreamSynchronize", e);
  return rc < kCuda ? f : rc;  // a fault of the decoder outranks the image's
}

int decode_rgb_into(Worker* wk, const uint8_t* jpeg, unsigned long len, uint8_t* out,
                    int max_h, int max_w, int target_h, int target_w, int* out_h, int* out_w) {
  Decoded d;
  int rc = decode_planes(wk, jpeg, len, max_h, max_w, target_h, target_w, &d);
  if (rc == 0) rc = to_rgb(wk, d);
  if (rc == 0)
    rc = copy_rect(out, (size_t)max_w * 3, wk->rgb, (size_t)d.ow * 3, (size_t)d.ow * 3, d.oh,
                   wk->stream);
  rc = finish(wk, rc);
  if (rc == 0) {
    *out_h = d.oh;
    *out_w = d.ow;
  }
  return rc;
}

int decode_yuv420_into(Worker* wk, const uint8_t* jpeg, unsigned long len, uint8_t* out_y,
                       uint8_t* out_u, uint8_t* out_v, int max_h, int max_w, int target_h,
                       int target_w, int* out_h, int* out_w) {
  Decoded d;
  int rc = decode_planes(wk, jpeg, len, max_h, max_w, target_h, target_w, &d);
  const size_t cp = (size_t)max_w / 2;
  // jpeg_feeder.cc's raw-plane condition: full scale, YCbCr 4:2:0, and the
  // MCU-padded width within the buffer.
  const bool raw = rc == 0 && d.is420 && d.f == 1 && ((d.w + 15) / 16) * 16 <= max_w;
  if (raw) {
    const int cw = d.planes[1].w, ch = d.planes[1].h;
    const uint8_t* Y = wk->planes;
    const uint8_t* U = Y + (size_t)d.w * d.h;
    const uint8_t* V = U + (size_t)cw * ch;
    rc = copy_rect(out_y, max_w, Y, d.w, d.w, d.h, wk->stream);
    if (rc == 0) rc = copy_rect(out_u, cp, U, cw, cw, ch, wk->stream);
    if (rc == 0) rc = copy_rect(out_v, cp, V, cw, cw, ch, wk->stream);
  } else if (rc == 0) {
    rc = to_rgb(wk, d);
    const int cow = (d.ow + 1) / 2, coh = (d.oh + 1) / 2;
    const size_t ysz = (size_t)d.ow * d.oh, csz = (size_t)cow * coh;
    if (rc == 0) rc = grow(&wk->yuv, &wk->yuv_cap, ysz + 2 * csz);
    if (rc == 0) {
      const dim3 blk(32, 8);
      k_yuv_from_rgb<<<grid_of(cow, coh, blk), blk, 0, wk->stream>>>(
          wk->rgb, d.ow, d.oh, wk->yuv, wk->yuv + ysz, wk->yuv + ysz + csz);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) rc = cuda_fault(kCuda, "kernel launch", e);
    }
    if (rc == 0) rc = copy_rect(out_y, max_w, wk->yuv, d.ow, d.ow, d.oh, wk->stream);
    if (rc == 0) rc = copy_rect(out_u, cp, wk->yuv + ysz, cow, cow, coh, wk->stream);
    if (rc == 0) rc = copy_rect(out_v, cp, wk->yuv + ysz + csz, cow, cow, coh, wk->stream);
  }
  rc = finish(wk, rc);
  if (rc == 0) {
    *out_h = d.oh;
    *out_w = d.ow;
  }
  return rc;
}

struct BatchTask {
  int n;
  const uint8_t* const* jpegs;
  const unsigned long* lens;
  uint8_t *out, *out_y, *out_u, *out_v;  // out (RGB) or the three planes
  int max_h, max_w;
  int target_h, target_w;
  int* out_hw;
  int* rc;
  int next;
  pthread_mutex_t mu;
};

void* batch_worker(void* arg) {
  BatchTask* t = static_cast<BatchTask*>(arg);
  const cudaError_t e = cudaSetDevice(g_device);
  if (e != cudaSuccess) {
    cuda_fault(kNoStart, "cudaSetDevice", e);
    return nullptr;
  }
  Worker* wk = acquire();
  if (wk == nullptr) return nullptr;
  const size_t frame = (size_t)t->max_h * t->max_w;
  for (;;) {
    pthread_mutex_lock(&t->mu);
    int i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->n) break;
    if (t->out != nullptr)
      t->rc[i] = decode_rgb_into(wk, t->jpegs[i], t->lens[i], t->out + 3 * frame * i,
                                 t->max_h, t->max_w, t->target_h, t->target_w,
                                 &t->out_hw[2 * i], &t->out_hw[2 * i + 1]);
    else
      t->rc[i] = decode_yuv420_into(wk, t->jpegs[i], t->lens[i], t->out_y + frame * i,
                                    t->out_u + frame / 4 * i, t->out_v + frame / 4 * i,
                                    t->max_h, t->max_w, t->target_h, t->target_w,
                                    &t->out_hw[2 * i], &t->out_hw[2 * i + 1]);
  }
  release(wk);
  return nullptr;
}

// jpeg_feeder.cc's transient thread pool. rc[] starts at kNoStart, so an
// image no thread reached is the decoder's fault, not the image's.
int run_batch(BatchTask* t, int num_threads) {
  for (int i = 0; i < t->n; ++i) t->rc[i] = kNoStart;
  if (!ensure_handle()) return t->n;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > t->n) num_threads = t->n;
  if (num_threads > 64) num_threads = 64;
  pthread_t threads[64];
  int created = 0;  // join only successfully created threads (EAGAIN-safe)
  for (int i = 0; i < num_threads; ++i)
    if (pthread_create(&threads[created], nullptr, batch_worker, t) == 0) ++created;
  if (created == 0) batch_worker(t);  // degrade to inline execution
  for (int i = 0; i < created; ++i) pthread_join(threads[i], nullptr);
  int failures = 0;
  for (int i = 0; i < t->n; ++i) failures += (t->rc[i] != 0);
  return failures;
}

}  // namespace

extern "C" {

// The card the decoder runs on (default 0); set before the first batch.
int cvm_decode_set_device(int device) {
  pthread_mutex_lock(&g_mu);
  const int ok = g_handle == nullptr || device == g_device;
  if (ok) g_device = device;
  pthread_mutex_unlock(&g_mu);
  return ok ? 0 : 1;
}

// The last fault of the decoder (codes 4-6), or "".
const char* cvm_decode_last_error() { return g_error; }

// One JPEG's component planes as nvJPEG decodes them, before any
// upsampling: Y, then Cb and Cr, packed into `out` (cap bytes); dims =
// {components, h, w of each}. nvJPEG decodes at full scale only, so num
// must be 8. Returns 0, an image's code (1; 3 when `out` is too small) or
// a fault of the decoder (4-6). The tests hold k_rgb_from_planes to a
// model of libjpeg's arithmetic applied to these planes.
int cvm_decode_planes(const uint8_t* jpeg, unsigned long len, int num, uint8_t* out,
                      unsigned long cap, int* dims) {
  if (num != 8) return kUnreadable;
  if (!ensure_handle()) return kNoStart;
  const cudaError_t e = cudaSetDevice(g_device);
  if (e != cudaSuccess) return cuda_fault(kNoStart, "cudaSetDevice", e);
  Worker* wk = acquire();
  if (wk == nullptr) return kNoStart;
  Decoded d;
  int rc = decode_planes(wk, jpeg, len, 1 << 20, 1 << 20, 0, 0, &d);
  size_t total = 0;
  for (int c = 0; rc == 0 && c < d.ncomp; ++c) total += (size_t)d.planes[c].w * d.planes[c].h;
  if (rc == 0 && total > cap) rc = kTooLarge;
  if (rc == 0) rc = copy_rect(out, total, wk->planes, total, total, 1, wk->stream);
  rc = finish(wk, rc);
  release(wk);
  if (rc == 0) {
    dims[0] = d.ncomp;
    for (int c = 0; c < d.ncomp; ++c) {
      dims[1 + 2 * c] = d.planes[c].h;
      dims[2 + 2 * c] = d.planes[c].w;
    }
  }
  return rc;
}

// What nvJPEG itself makes of one JPEG, for a layout the decoder refuses:
// info = {nvjpegGetImageInfo's status, its component count and chroma
// subsampling (nvjpegChromaSubsampling_t), the width and height of
// components 0-2, and nvjpegDecode's status with NVJPEG_OUTPUT_YUV (or
// _Y for one component) into planes of those sizes (-1 when not tried)}.
// Returns 0, or a fault of the decoder (4-6).
int cvm_decode_info(const uint8_t* jpeg, unsigned long len, int* info) {
  for (int k = 0; k < 10; ++k) info[k] = -1;
  if (!ensure_handle()) return kNoStart;
  const cudaError_t e = cudaSetDevice(g_device);
  if (e != cudaSuccess) return cuda_fault(kNoStart, "cudaSetDevice", e);
  int ncomp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  info[0] = (int)nvjpegGetImageInfo(g_handle, jpeg, len, &ncomp, &css, widths, heights);
  if (info[0] != NVJPEG_STATUS_SUCCESS) return 0;
  info[1] = ncomp;
  info[2] = (int)css;
  for (int c = 0; c < 3 && c < ncomp; ++c) {
    info[3 + 2 * c] = widths[c];
    info[4 + 2 * c] = heights[c];
  }
  if (ncomp != 1 && ncomp != 3) return 0;
  Worker* wk = acquire();
  if (wk == nullptr) return kNoStart;
  size_t total = 0;
  for (int c = 0; c < ncomp; ++c) total += (size_t)widths[c] * heights[c];
  int rc = grow(&wk->planes, &wk->planes_cap, total);
  if (rc == 0) {
    nvjpegImage_t img;
    memset(&img, 0, sizeof(img));
    size_t at = 0;
    for (int c = 0; c < ncomp; ++c) {
      img.channel[c] = wk->planes + at;
      img.pitch[c] = widths[c];
      at += (size_t)widths[c] * heights[c];
    }
    info[9] = (int)nvjpegDecode(g_handle, wk->state, jpeg, len,
                                ncomp == 3 ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &img,
                                wk->stream);
  }
  rc = finish(wk, rc);
  release(wk);
  return rc;
}

int cvm_decode_batch(int n, const uint8_t* const* jpegs, const unsigned long* lens,
                     uint8_t* out, int max_h, int max_w, int target_h, int target_w,
                     int* out_hw, int* rc, int num_threads) {
  BatchTask t{n, jpegs, lens, out, nullptr, nullptr, nullptr, max_h, max_w,
              target_h, target_w, out_hw, rc, 0, PTHREAD_MUTEX_INITIALIZER};
  return run_batch(&t, num_threads);
}

int cvm_decode_batch_yuv420(int n, const uint8_t* const* jpegs, const unsigned long* lens,
                            uint8_t* out_y, uint8_t* out_u, uint8_t* out_v, int max_h,
                            int max_w, int target_h, int target_w, int* out_hw, int* rc,
                            int num_threads) {
  BatchTask t{n, jpegs, lens, nullptr, out_y, out_u, out_v, max_h, max_w,
              target_h, target_w, out_hw, rc, 0, PTHREAD_MUTEX_INITIALIZER};
  return run_batch(&t, num_threads);
}

}  // extern "C"
