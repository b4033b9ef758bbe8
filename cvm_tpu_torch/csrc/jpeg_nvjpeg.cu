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
//   * RGB at full scale: libjpeg's "fancy" chroma upsampling (3/4 nearer +
//     1/4 further sample, edges replicated; h2v2 for 4:2:0, h2v1 for 4:2:2)
//     and its YCbCr -> RGB tables (jdsample.c, jdcolor.c);
//   * the reduced scales 1/2, 1/4, 1/8: libjpeg's reduced-size IDCTs
//     (jidctred.c) equal, in exact arithmetic, the box average of the full
//     IDCT's output over 2x2, 4x4, 8x8 pixels (the average of adjacent
//     8-point IDCT outputs drops the frequencies the reduced IDCT drops),
//     so the luma plane is box-averaged by 8/num. libjpeg decodes 4:2:0
//     chroma at twice the luma's DCT scale (jdmaster.c), at the output
//     resolution, and converts without upsampling: its planes are averaged
//     by 4/num. 4:2:2 and 4:4:4 chroma it decodes at the luma's scale (the
//     vertical factor does not allow more), averaged by 8/num, and 4:2:2's
//     is then h2v1-upsampled;
//   * planar YUV420: the raw planes at full scale (jpeg_feeder.cc's raw
//     path, under the same condition), else RGB converted on the card with
//     jpeg_feeder.cc's integer formulas (Y per pixel, chroma from the 2x2
//     RGB average).
// 4:4:0 and 4:1:1 chroma libjpeg decodes at the luma's DCT scale (the
// sampling factors never allow more), so their planes are box-averaged by
// 8/num, then upsampled as libjpeg upsamples them: 4:4:0 with its vertical
// "fancy" blend (h1v2_fancy_upsample: 3/4 nearer + 1/4 further row, bias 1
// above and 2 below, edges replicated) while the scale is above 1/8, rows
// replicated at 1/8; 4:1:1 by replicating each sample 4 times across
// (int_upsample: libjpeg has no fancy h4v1).
// Grayscale is its Y plane, replicated. A three-component JPEG that
// libjpeg reads as RGB (is_rgb_jpeg below) takes the same upsampling and
// no color conversion. Other layouts are refused as unreadable (1): four
// components (CMYK, YCCK), which libjpeg cannot convert to RGB either, and
// sampling factors other than the five above (4:1:0, 1x4 luma), which
// libjpeg decodes and nvJPEG's own upsampling does not decode as it does.
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

// A 4:2:2 chroma sample at output (x, y): the chroma plane (cw x ch, as
// many rows as the luma) box-averaged by g, as libjpeg decodes it at the
// luma's DCT scale, then libjpeg's h2v1 upsampling: "fancy" (3/4 nearer +
// 1/4 further sample, edges replicated; jdsample.c h2v1_fancy_upsample)
// when `fancy` and the reduced plane is wider than 2 samples, else
// replication.
__device__ __forceinline__ int h2v1(const uint8_t* C, int cw, int ch, int y, int x, int g,
                                    int gs, bool fancy) {
  const int rcw = (cw + g - 1) / g, cx = x >> 1;
  const int near = box(C, cw, ch, y, cx, g, gs);
  if (!fancy || rcw <= 2) return near;
  const int nb = (x & 1) ? min(cx + 1, rcw - 1) : max(cx - 1, 0);
  return (3 * near + box(C, cw, ch, y, nb, g, gs) + ((x & 1) ? 2 : 1)) >> 2;
}

// A 4:4:0 chroma sample at output (x, y): the chroma plane (cw x ch, as
// many columns as the luma) box-averaged by g, then libjpeg's vertical
// upsampling: "fancy" (3/4 nearer + 1/4 further row, bias 1 for the upper
// and 2 for the lower output row, edges replicated; jdsample.c
// h1v2_fancy_upsample) when `fancy`, else the row replicated (int_upsample).
__device__ __forceinline__ int h1v2(const uint8_t* C, int cw, int ch, int y, int x, int g,
                                    int gs, bool fancy) {
  const int rch = (ch + g - 1) / g, cy = y >> 1;
  const int near = box(C, cw, ch, cy, x, g, gs);
  if (!fancy) return near;
  const int nb = (y & 1) ? min(cy + 1, rch - 1) : max(cy - 1, 0);
  return (3 * near + box(C, cw, ch, nb, x, g, gs) + ((y & 1) ? 2 : 1)) >> 2;
}

// Component planes -> RGB at scale 8/f, with libjpeg's arithmetic after its
// IDCT; the luma (or R) is box-averaged by f. Chroma by its horizontal and
// vertical subsampling (sh, sv):
//   * (2, 2), 4:2:0: at f == 1 libjpeg's h2v2 fancy upsampling (plain
//     replication when the chroma plane is 2 samples wide or less, as
//     jdsample.c does); at f > 1 box-averaged by f/2, without upsampling;
//   * (2, 1), 4:2:2: h2v1 as above, fancy while f < 8 (libjpeg upsamples
//     plainly at 1/8);
//   * (1, 2), 4:4:0: h1v2 as above, fancy while f < 8;
//   * (4, 1), 4:1:1: box-averaged by f, each sample replicated 4 times
//     across;
//   * (1, 1), 4:4:4: box-averaged by f;
//   * no chroma planes (U null), grayscale: Cb = Cr = 128, i.e. R = G = B.
// Then libjpeg's YCbCr tables, or, when `rgb`, the three samples as they
// are (libjpeg's null conversion).
__global__ void k_rgb_from_planes(const uint8_t* Y, const uint8_t* U, const uint8_t* V,
                                  int w, int h, int cw, int ch, int sh, int sv, int f,
                                  int shift, bool rgb, uint8_t* out, int ow, int oh) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= ow || y >= oh) return;
  const int yy = f == 1 ? Y[(size_t)y * w + x] : box(Y, w, h, y, x, f, shift);
  int cb = 128, cr = 128;
  if (U == nullptr) {
  } else if (sh == 2 && sv == 2 && f == 1) {
    const int cy = y >> 1, cx = x >> 1;
    if (cw > 2) {
      const int other = clampi((y & 1) ? cy + 1 : cy - 1, 0, ch - 1);
      const int nb = clampi((x & 1) ? cx + 1 : cx - 1, 0, cw - 1);
      const int bias = (x & 1) ? 7 : 8;
      const uint8_t *u0 = U + (size_t)cy * cw, *u1 = U + (size_t)other * cw;
      const uint8_t *v0 = V + (size_t)cy * cw, *v1 = V + (size_t)other * cw;
      const int us = 3 * u0[cx] + u1[cx], un = 3 * u0[nb] + u1[nb];
      const int vs = 3 * v0[cx] + v1[cx], vn = 3 * v0[nb] + v1[nb];
      cb = (3 * us + un + bias) >> 4;
      cr = (3 * vs + vn + bias) >> 4;
    } else {
      cb = U[(size_t)cy * cw + cx];
      cr = V[(size_t)cy * cw + cx];
    }
  } else if (sh == 2 && sv == 2) {
    const int g = f >> 1, gs = shift - 2;
    cb = box(U, cw, ch, y, x, g, gs);
    cr = box(V, cw, ch, y, x, g, gs);
  } else if (sh == 2) {
    cb = h2v1(U, cw, ch, y, x, f, shift, f < 8);
    cr = h2v1(V, cw, ch, y, x, f, shift, f < 8);
  } else if (sv == 2) {
    cb = h1v2(U, cw, ch, y, x, f, shift, f < 8);
    cr = h1v2(V, cw, ch, y, x, f, shift, f < 8);
  } else if (sh == 4) {
    cb = box(U, cw, ch, y, x >> 2, f, shift);
    cr = box(V, cw, ch, y, x >> 2, f, shift);
  } else {
    cb = box(U, cw, ch, y, x, f, shift);
    cr = box(V, cw, ch, y, x, f, shift);
  }
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
  int w, h, cw, ch, f, ow, oh;
  int sh, sv;    // chroma subsampling of the planes; 0 when gray
  bool rgb;      // the three planes are R, G, B (libjpeg's JCS_RGB)
  bool is420;    // YCbCr 4:2:0
};

// libjpeg's guess of a three-component JPEG's color space (jdapimin.c
// default_decompress_parms, from the markers before the frame header): a
// JFIF marker means YCbCr; else an Adobe marker's transform, 0 RGB and any
// other YCbCr; else component ids 'R', 'G', 'B' mean RGB, any others YCbCr.
// True for RGB.
bool is_rgb_jpeg(const uint8_t* p, unsigned long len) {
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
      if (jfif) return false;
      if (adobe) return transform == 0;
      return n >= 15 && d[5] == 3 && d[6] == 'R' && d[9] == 'G' && d[12] == 'B';
    }
    i += 2 + seg;
  }
  return false;
}

// Header, scale choice and nvJPEG decode into the worker's planes: 4:2:0,
// 4:2:2, 4:4:4, 4:4:0 and 4:1:1 as three planes, grayscale as the Y plane;
// any other layout is refused. Returns 0 or the image's code (see the top
// of the file).
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
  if (widths[0] <= 0 || heights[0] <= 0) return kUnreadable;
  d->w = widths[0];
  d->h = heights[0];
  const int num = choose_num(d->h, d->w, max_h, max_w, target_h, target_w);
  if (num < 0) return kTooLarge;
  d->f = 8 / num;
  d->ow = (d->w * num + 7) / 8;
  d->oh = (d->h * num + 7) / 8;
  const bool three = ncomp == 3 &&
      (css == NVJPEG_CSS_420 || css == NVJPEG_CSS_422 || css == NVJPEG_CSS_444 ||
       css == NVJPEG_CSS_440 || css == NVJPEG_CSS_411);
  if (!three && !(ncomp == 1 && css == NVJPEG_CSS_GRAY)) return kUnreadable;
  d->rgb = three && is_rgb_jpeg(jpeg, len);
  d->is420 = three && !d->rgb && css == NVJPEG_CSS_420;
  d->sh = !three ? 0 : css == NVJPEG_CSS_411 ? 4
        : (css == NVJPEG_CSS_420 || css == NVJPEG_CSS_422) ? 2 : 1;
  d->sv = !three ? 0 : (css == NVJPEG_CSS_420 || css == NVJPEG_CSS_440) ? 2 : 1;
  d->cw = three ? widths[1] : 0;
  d->ch = three ? heights[1] : 0;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  const size_t ysz = (size_t)d->w * d->h, csz = (size_t)d->cw * d->ch;
  if ((rc = grow(&wk->planes, &wk->planes_cap, ysz + 2 * csz)) != 0) return rc;
  img.channel[0] = wk->planes;
  img.pitch[0] = d->w;
  if (three) {
    img.channel[1] = wk->planes + ysz;
    img.channel[2] = wk->planes + ysz + csz;
    img.pitch[1] = img.pitch[2] = d->cw;
  }
  return nvjpeg_rc("nvjpegDecode",
                   nvjpegDecode(g_handle, wk->state, jpeg, len,
                                three ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &img, wk->stream));
}

// The decoded frame as RGB (oh x ow x 3) in the worker's rgb buffer.
int to_rgb(Worker* wk, const Decoded& d) {
  if (const int rc = grow(&wk->rgb, &wk->rgb_cap, (size_t)d.ow * d.oh * 3)) return rc;
  const dim3 blk(32, 8);
  const int shift = 2 * log2i(d.f);
  const uint8_t* Y = wk->planes;
  const uint8_t* U = d.sh ? Y + (size_t)d.w * d.h : nullptr;
  const uint8_t* V = d.sh ? U + (size_t)d.cw * d.ch : nullptr;
  k_rgb_from_planes<<<grid_of(d.ow, d.oh, blk), blk, 0, wk->stream>>>(
      Y, U, V, d.w, d.h, d.cw, d.ch, d.sh, d.sv, d.f, shift, d.rgb, wk->rgb, d.ow, d.oh);
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
    const uint8_t* Y = wk->planes;
    const uint8_t* U = Y + (size_t)d.w * d.h;
    const uint8_t* V = U + (size_t)d.cw * d.ch;
    rc = copy_rect(out_y, max_w, Y, d.w, d.w, d.h, wk->stream);
    if (rc == 0) rc = copy_rect(out_u, cp, U, d.cw, d.cw, d.ch, wk->stream);
    if (rc == 0) rc = copy_rect(out_v, cp, V, d.cw, d.cw, d.ch, wk->stream);
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
  const size_t ysz = (size_t)d.w * d.h, csz = d.sh ? (size_t)d.cw * d.ch : 0;
  if (rc == 0 && ysz + 2 * csz > cap) rc = kTooLarge;
  if (rc == 0) rc = copy_rect(out, ysz + 2 * csz, wk->planes, ysz + 2 * csz, ysz + 2 * csz, 1,
                              wk->stream);
  rc = finish(wk, rc);
  release(wk);
  if (rc == 0) {
    dims[0] = d.sh ? 3 : 1;
    dims[1] = d.h;
    dims[2] = d.w;
    dims[3] = dims[5] = d.ch;
    dims[4] = dims[6] = d.cw;
  }
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
