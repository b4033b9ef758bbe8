// Host batch JPEG decoder (libjpeg) of the port's input pipeline.
//
// The port's copy of cvm_tpu/native/jpeg_feeder.cc, unchanged in what it
// computes: decode straight into the loader's padded static buffer (stride
// = max_w * 3, top-left aligned); JPEGs larger than the buffer, or larger
// than the model needs (target_h/target_w), are decoded at libjpeg's
// power-of-2 DCT scales (1/2, 1/4, 1/8); cvm_decode_batch_yuv420 hands
// 4:2:0 sources' raw planes straight out of the entropy decoder.
//
// Build: cvm_tpu_torch/ops/cuda/_build.py::load_host_library (the host
// C++ compiler, -O3 -shared -fPIC, links -ljpeg -lpthread), at first use.
// Python binding: cvm_tpu_torch/data/jpeg.py, which raises when this
// library cannot be built (there is no other decoder to fall back to).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <pthread.h>

#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Pick the DCT scale. Only the power-of-2 scales (1/1, 1/2, 1/4, 1/8) are
// considered: libjpeg-turbo's fractional M/8 scales fall off the SIMD IDCT
// path and measured SLOWER than full decode on this host (44 vs 19 ms for
// an 8x700px batch), and any scaling disables the raw-4:2:0 fast path.
// target_h/w > 0: the SMALLEST power-of-2 output still covering the target
// (so the device letterbox never upsamples) — a 3000px frame feeding a
// 512px model decodes at 1/4, 16x fewer IDCT pixels.
// target 0: the largest output that fits the pad buffer (legacy behavior).
// Returns false if even 1/8 exceeds the buffer.
bool choose_scale(jpeg_decompress_struct* cinfo, int max_h, int max_w,
                  int target_h, int target_w) {
  int best = -1;
  for (int num = 8; num >= 1; num /= 2) {
    cinfo->scale_num = num;
    cinfo->scale_denom = 8;
    jpeg_calc_output_dimensions(cinfo);
    const int oh = (int)cinfo->output_height, ow = (int)cinfo->output_width;
    if (oh > max_h || ow > max_w) continue;  // too big at this scale
    if (best < 0) best = num;                // largest fitting scale
    // "Covers" with 1/8 slack: letterboxing 500->512 (a 2.4% upsample) is
    // visually free and buys a whole power-of-2 of IDCT work.
    if (target_h > 0 && 8 * oh >= 7 * target_h && 8 * ow >= 7 * target_w)
      best = num;                            // smallest still covering target
  }
  if (best < 0) return false;
  cinfo->scale_num = best;
  cinfo->scale_denom = 8;
  jpeg_calc_output_dimensions(cinfo);
  return true;
}

}  // namespace

extern "C" {

// Decode one JPEG into out[max_h][max_w][3] (RGB, row stride max_w*3).
// Returns 0 on success; fills out_h/out_w with the decoded (possibly
// DCT-downscaled) size. target_h/target_w > 0 selects the smallest M/8
// DCT scale still covering the model input (scale-aware decode); 0 keeps
// the fit-to-buffer behavior. Non-fatal failure returns nonzero and
// leaves the buffer untouched.
int cvm_decode_into(const uint8_t* jpeg, unsigned long len, uint8_t* out,
                    int max_h, int max_w, int target_h, int target_w,
                    int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  if (!choose_scale(&cinfo, max_h, max_w, target_h, target_w)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;  // still too large at 1/8 — caller should raise max buffer
  }
  jpeg_start_decompress(&cinfo);
  const int stride = max_w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (size_t)cinfo.output_scanline * stride;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  *out_h = (int)cinfo.output_height;
  *out_w = (int)cinfo.output_width;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// YUV420 planar decode: JPEGs store 4:2:0 chroma natively, so shipping raw
// planes to the device (1.5 B/px instead of 3 B/px RGB) halves host->device
// bandwidth; chroma upsampling + YCbCr->RGB then fuse into the device-side
// preprocess. Non-4:2:0 sources fall back to RGB decode + host subsample.
// ---------------------------------------------------------------------------

// Fixed-point JFIF RGB->Y (full range, BT.601): integer math so the
// compiler vectorizes; coefficients sum to 256 exactly.
static void rgb_row_to_yuv(const uint8_t* rgb, uint8_t* yrow, int w) {
  for (int x = 0; x < w; ++x) {
    const int r = rgb[3 * x], g = rgb[3 * x + 1], b = rgb[3 * x + 2];
    yrow[x] = (uint8_t)((77 * r + 150 * g + 29 * b + 128) >> 8);
  }
}

// Decode one JPEG into planar YUV420: Y in out_y[max_h][max_w], U/V in
// out_u/out_v[max_h/2][max_w/2] (strides max_w and max_w/2). Returns 0 on ok.
int cvm_decode_yuv420_into(const uint8_t* jpeg, unsigned long len,
                           uint8_t* out_y, uint8_t* out_u, uint8_t* out_v,
                           int max_h, int max_w, int target_h, int target_w,
                           int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }

  const bool native420 =
      cinfo.jpeg_color_space == JCS_YCbCr && cinfo.num_components == 3 &&
      cinfo.comp_info[0].h_samp_factor == 2 && cinfo.comp_info[0].v_samp_factor == 2 &&
      cinfo.comp_info[1].h_samp_factor == 1 && cinfo.comp_info[1].v_samp_factor == 1 &&
      cinfo.comp_info[2].h_samp_factor == 1 && cinfo.comp_info[2].v_samp_factor == 1;

  if (!choose_scale(&cinfo, max_h, max_w, target_h, target_w)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }

  // jpeg_read_raw_data writes whole MCU-padded rows (multiples of 16 px for
  // 4:2:0 luma); taking the raw path with an unaligned buffer would overflow
  // each row into the next. Fall back to the convert path in that case.
  const int mcu_padded_w = (((int)cinfo.output_width + 15) / 16) * 16;
  if (native420 && cinfo.scale_num == 8 && cinfo.scale_denom == 8 &&
      mcu_padded_w <= max_w) {
    // Fast path: raw 4:2:0 planes straight out of the entropy decoder —
    // no host color conversion or chroma upsampling at all.
    cinfo.raw_data_out = TRUE;
    cinfo.do_fancy_upsampling = FALSE;
    jpeg_start_decompress(&cinfo);
    const int H = cinfo.output_height, W = cinfo.output_width;
    const int cw = (W + 1) / 2;
    const int y_stride = max_w, c_stride = max_w / 2;
    // raw_data requires reading in units of max_v_samp_factor*DCTSIZE rows.
    const int mcu_rows = cinfo.max_v_samp_factor * DCTSIZE;  // 16
    JSAMPROW yrows[16], urows[8], vrows[8];
    JSAMPARRAY planes[3] = {yrows, urows, vrows};
    // Scratch for rows past the buffer edge (H not multiple of 16);
    // libjpeg-pool-allocated so error longjmp cannot leak it.
    JSAMPARRAY scrap_arr = (*cinfo.mem->alloc_sarray)(
        (j_common_ptr)&cinfo, JPOOL_IMAGE, max_w, 1);
    uint8_t* scrap = scrap_arr[0];
    while ((int)cinfo.output_scanline < H) {
      const int base = cinfo.output_scanline;
      for (int r = 0; r < mcu_rows; ++r) {
        const int yy = base + r;
        yrows[r] = (yy < H) ? out_y + (size_t)yy * y_stride : scrap;
      }
      for (int r = 0; r < mcu_rows / 2; ++r) {
        const int cy = base / 2 + r;
        const int ch = (H + 1) / 2;
        urows[r] = (cy < ch) ? out_u + (size_t)cy * c_stride : scrap;
        vrows[r] = (cy < ch) ? out_v + (size_t)cy * c_stride : scrap;
      }
      jpeg_read_raw_data(&cinfo, planes, mcu_rows);
    }
    // jpeg_read_raw_data emits MCU-padded rows (edge-replicated pixels in
    // columns W..mcu_w); restore the loader's zero-padding invariant.
    if (mcu_padded_w > W) {
      for (int yy = 0; yy < H; ++yy)
        memset(out_y + (size_t)yy * y_stride + W, 0, mcu_padded_w - W);
      const int cW = (W + 1) / 2, c_mcu = mcu_padded_w / 2;
      for (int cy = 0; cy < (H + 1) / 2; ++cy) {
        memset(out_u + (size_t)cy * c_stride + cW, 128, c_mcu - cW);
        memset(out_v + (size_t)cy * c_stride + cW, 128, c_mcu - cW);
      }
    }
    *out_h = H;
    *out_w = W;
    (void)cw;
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }

  // Fallback: decode to RGB rows, convert + 2x2 box-subsample on host.
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int H = cinfo.output_height, W = cinfo.output_width;
  JSAMPARRAY rgb_rows = (*cinfo.mem->alloc_sarray)(
      (j_common_ptr)&cinfo, JPOOL_IMAGE, (JDIMENSION)(W * 3), 2);
  const int y_stride = max_w, c_stride = max_w / 2;
  while ((int)cinfo.output_scanline < H) {
    const int y0 = cinfo.output_scanline;
    // jpeg_read_scanlines may return FEWER rows than requested; the chroma
    // 2x2 averaging below assumes y0 is even, so insist on the full pair
    // (except at an odd-H tail) rather than trusting one call.
    const int want = (y0 + 1 < H) ? 2 : 1;
    int got = 0;
    while (got < want && (int)cinfo.output_scanline < H)
      got += jpeg_read_scanlines(&cinfo, rgb_rows + got, want - got);
    for (int r = 0; r < got; ++r)
      rgb_row_to_yuv(rgb_rows[r], out_y + (size_t)(y0 + r) * y_stride, W);
    // Chroma: average the 2x2 block (JFIF centered siting — matches the
    // raw-4:2:0 path and the device upsampler's centered assumption; a
    // top-left pick would co-site chroma 0.25 chroma px off).
    const uint8_t* s0 = rgb_rows[0];
    const uint8_t* s1 = (got > 1) ? rgb_rows[1] : rgb_rows[0];
    uint8_t* urow = out_u + (size_t)(y0 / 2) * c_stride;
    uint8_t* vrow = out_v + (size_t)(y0 / 2) * c_stride;
    for (int x = 0; x < W; x += 2) {
      const int x1 = (x + 1 < W) ? x + 1 : x;
      const int r = (s0[3 * x] + s0[3 * x1] + s1[3 * x] + s1[3 * x1] + 2) >> 2;
      const int g = (s0[3 * x + 1] + s0[3 * x1 + 1] + s1[3 * x + 1] + s1[3 * x1 + 1] + 2) >> 2;
      const int b = (s0[3 * x + 2] + s0[3 * x1 + 2] + s1[3 * x + 2] + s1[3 * x1 + 2] + 2) >> 2;
      int u = ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128;
      int v = ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128;
      urow[x / 2] = (uint8_t)(u < 0 ? 0 : (u > 255 ? 255 : u));
      vrow[x / 2] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  *out_h = H;
  *out_w = W;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

struct YuvBatchTask {
  int n;
  const uint8_t* const* jpegs;
  const unsigned long* lens;
  uint8_t *out_y, *out_u, *out_v;
  int max_h, max_w;
  int target_h, target_w;
  int* out_hw;
  int* rc;
  int next;
  pthread_mutex_t mu;
};

void* yuv_batch_worker(void* arg) {
  YuvBatchTask* t = static_cast<YuvBatchTask*>(arg);
  const size_t yf = (size_t)t->max_h * t->max_w;
  const size_t cf = yf / 4;
  for (;;) {
    pthread_mutex_lock(&t->mu);
    int i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->n) break;
    t->rc[i] = cvm_decode_yuv420_into(
        t->jpegs[i], t->lens[i], t->out_y + yf * i, t->out_u + cf * i,
        t->out_v + cf * i, t->max_h, t->max_w, t->target_h, t->target_w,
        &t->out_hw[2 * i], &t->out_hw[2 * i + 1]);
  }
  return nullptr;
}

int cvm_decode_batch_yuv420(int n, const uint8_t* const* jpegs,
                            const unsigned long* lens, uint8_t* out_y,
                            uint8_t* out_u, uint8_t* out_v, int max_h,
                            int max_w, int target_h, int target_w,
                            int* out_hw, int* rc, int num_threads) {
  YuvBatchTask t{n, jpegs, lens, out_y, out_u, out_v, max_h, max_w,
                 target_h, target_w, out_hw, rc, 0, PTHREAD_MUTEX_INITIALIZER};
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  pthread_t threads[64];
  if (num_threads > 64) num_threads = 64;
  int created = 0;  // join only successfully created threads (EAGAIN-safe)
  for (int i = 0; i < num_threads; ++i) {
    if (pthread_create(&threads[created], nullptr, yuv_batch_worker, &t) == 0) ++created;
  }
  if (created == 0) yuv_batch_worker(&t);  // degrade to inline execution
  for (int i = 0; i < created; ++i) pthread_join(threads[i], nullptr);
  int failures = 0;
  for (int i = 0; i < n; ++i) failures += (rc[i] != 0);
  return failures;
}

struct BatchTask {
  int n;
  const uint8_t* const* jpegs;
  const unsigned long* lens;
  uint8_t* out;        // n * max_h * max_w * 3
  int max_h, max_w;
  int target_h, target_w;
  int* out_hw;         // n * 2 (h, w)
  int* rc;             // n return codes
  int next;            // work index (guarded by mu)
  pthread_mutex_t mu;
};

void* batch_worker(void* arg) {
  BatchTask* t = static_cast<BatchTask*>(arg);
  const size_t frame = (size_t)t->max_h * t->max_w * 3;
  for (;;) {
    pthread_mutex_lock(&t->mu);
    int i = t->next++;
    pthread_mutex_unlock(&t->mu);
    if (i >= t->n) break;
    t->rc[i] = cvm_decode_into(t->jpegs[i], t->lens[i], t->out + frame * i,
                               t->max_h, t->max_w, t->target_h, t->target_w,
                               &t->out_hw[2 * i], &t->out_hw[2 * i + 1]);
  }
  return nullptr;
}

// One JPEG's component planes at scale num/8 as libjpeg's IDCT hands them
// to its upsampler (raw_data_out): Y, then Cb and Cr, packed into `out`
// (cap bytes); dims = {components, h, w of each}. Returns 0, 1 unreadable,
// 2 bad header, 3 `out` too small. The tests hold a model of libjpeg's
// upsampling and color conversion, applied to these planes, to
// cvm_decode_into's RGB.
int cvm_decode_planes(const uint8_t* jpeg, unsigned long len, int num, uint8_t* out,
                      unsigned long cap, int* dims) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK ||
      (cinfo.num_components != 1 && cinfo.num_components != 3)) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.raw_data_out = TRUE;
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  const int nc = cinfo.num_components;
#if JPEG_LIB_VERSION >= 70
  const int min_size = cinfo.min_DCT_v_scaled_size;
#else
  const int min_size = cinfo.min_DCT_scaled_size;
#endif
  size_t need = 0;
  for (int c = 0; c < nc; ++c)
    need += (size_t)cinfo.comp_info[c].downsampled_width * cinfo.comp_info[c].downsampled_height;
  if (need > cap) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  // One iMCU row of each component, MCU-padded, per jpeg_read_raw_data;
  // libjpeg's image pool owns the rows (freed by jpeg_destroy, also after
  // an error's longjmp).
  JSAMPARRAY planes[3];
  int nrows[3], done[3] = {0, 0, 0};
  size_t at[3];
  size_t off = 0;
  for (int c = 0; c < nc; ++c) {
    const jpeg_component_info* comp = &cinfo.comp_info[c];
#if JPEG_LIB_VERSION >= 70
    const int size = comp->DCT_h_scaled_size;
#else
    const int size = comp->DCT_scaled_size;
#endif
    const int bw = (int)comp->width_in_blocks * size;
    nrows[c] = comp->v_samp_factor * size;
    planes[c] = (*cinfo.mem->alloc_sarray)(reinterpret_cast<j_common_ptr>(&cinfo), JPOOL_IMAGE,
                                           (JDIMENSION)bw, (JDIMENSION)nrows[c]);
    at[c] = off;
    off += (size_t)comp->downsampled_width * comp->downsampled_height;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    if (jpeg_read_raw_data(&cinfo, planes, cinfo.max_v_samp_factor * min_size) == 0) break;
    for (int c = 0; c < nc; ++c) {
      const jpeg_component_info* comp = &cinfo.comp_info[c];
      for (int r = 0; r < nrows[c] && done[c] < (int)comp->downsampled_height; ++r, ++done[c])
        memcpy(out + at[c] + (size_t)done[c] * comp->downsampled_width, planes[c][r],
               comp->downsampled_width);
    }
  }
  dims[0] = nc;
  for (int c = 0; c < nc; ++c) {
    dims[1 + 2 * c] = (int)cinfo.comp_info[c].downsampled_height;
    dims[2 + 2 * c] = (int)cinfo.comp_info[c].downsampled_width;
  }
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode a batch with a transient thread pool. Returns count of failures.
int cvm_decode_batch(int n, const uint8_t* const* jpegs,
                     const unsigned long* lens, uint8_t* out, int max_h,
                     int max_w, int target_h, int target_w, int* out_hw,
                     int* rc, int num_threads) {
  BatchTask t{n, jpegs, lens, out, max_h, max_w, target_h, target_w,
              out_hw, rc, 0, PTHREAD_MUTEX_INITIALIZER};
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  pthread_t threads[64];
  if (num_threads > 64) num_threads = 64;
  int created = 0;  // join only successfully created threads (EAGAIN-safe)
  for (int i = 0; i < num_threads; ++i) {
    if (pthread_create(&threads[created], nullptr, batch_worker, &t) == 0) ++created;
  }
  if (created == 0) batch_worker(&t);  // degrade to inline execution
  for (int i = 0; i < created; ++i) pthread_join(threads[i], nullptr);
  int failures = 0;
  for (int i = 0; i < n; ++i) failures += (rc[i] != 0);
  return failures;
}

}  // extern "C"
