// Native image-decode core: JPEG bytes -> HWC RGB via the system
// libjpeg (libjpeg-turbo where installed), exposed over a plain C ABI for
// ctypes — the sibling of recordio.cc for the image data plane.
//
// Three layers, cheapest-sufficient wins:
//
//   img_info           header geometry, no IDCT
//   img_decode[_scaled] full frame -> HWC uint8 RGB, optional DCT-domain
//                      scaling (decode at scale_num/8 — a 2048px source
//                      bound for a 224px crop decodes at 1/8 IDCT cost)
//   img_decode_rrc     the training hot path, fused: scaled decode ->
//                      crop -> bilinear resize to target -> optional
//                      hflip -> per-channel affine (normalize) written
//                      STRAIGHT into the caller's float32 batch slot —
//                      no intermediate PIL object, no per-image array,
//                      no stack copy (the tf.data/DALI fused-decode
//                      shape)
//
// The crop box arrives in FULL-RESOLUTION coordinates (the Python side
// draws it from header-stamped geometry, so crop parameters — and the
// seeded rng stream — stay backend-independent) and is mapped onto the
// scaled frame here. scale_num is chosen by the caller; the pipeline
// restricts itself to {1, 2, 4, 8} because libjpeg-turbo has SIMD IDCT
// only at those scales — a 6/8 "cheaper" decode measures SLOWER than a
// full-scale SIMD decode.
//
// The Python binder (tfk8s_tpu_torch/data/images/_native_decode.py)
// lazy-builds this with `g++ ... -ljpeg` and falls back to PIL when the
// toolchain or jpeglib.h is absent; every capability keeps both paths
// and the tests assert they agree (exact pixels for PNG-through-PIL,
// bounded tolerance for JPEG — IDCT implementations legitimately
// differ).
//
// Error discipline: libjpeg's default error handler calls exit(); a
// corrupt record must instead surface as a negative return the binder
// can turn into a per-image PIL retry or a typed decode error.

#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <cstdio>  // jpeglib.h needs FILE declared before inclusion
extern "C" {
#include <jpeglib.h>
}

namespace {

struct ErrorTrap {
  jpeg_error_mgr mgr;
  jmp_buf env;
};

void on_error(j_common_ptr cinfo) {
  // longjmp out instead of the library's exit(); the message is not
  // propagated — the binder retries the image through PIL, whose error
  // text names the corruption for the operator
  longjmp(reinterpret_cast<ErrorTrap*>(cinfo->err)->env, 1);
}

void on_message(j_common_ptr, int) {}  // swallow warnings (stderr spam)

constexpr int64_t kBadArgs = -1;      // null/empty input or bad scale/box
constexpr int64_t kBadImage = -2;     // libjpeg rejected the bytes
constexpr int64_t kShortBuffer = -3;  // out smaller than the decoded frame

// Shared decode body: header read + DCT scaling + RGB rows into `out`.
// Writes the SCALED frame dims to out_h/out_w and (when non-null) the
// full-resolution dims to full_h/full_w. `max_rows >= 0` stops after
// that many scanlines (the fused crop path never IDCTs rows below its
// crop bottom); the frame is aborted, not finished, when cut short.
int64_t decode_impl(const uint8_t* data, int64_t n, int64_t scale_num,
                    uint8_t* out, int64_t cap, int64_t* out_h,
                    int64_t* out_w, int64_t* full_h = nullptr,
                    int64_t* full_w = nullptr, int64_t max_rows = -1) {
  if (!data || n <= 0 || !out || scale_num < 1 || scale_num > 8)
    return kBadArgs;
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = jpeg_std_error(&trap.mgr);
  trap.mgr.error_exit = on_error;
  trap.mgr.emit_message = on_message;
  if (setjmp(trap.env)) {
    jpeg_destroy_decompress(&cinfo);
    return kBadImage;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               (unsigned long)n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return kBadImage;
  }
  cinfo.scale_num = (unsigned)scale_num;
  cinfo.scale_denom = 8;
  // RGB out regardless of source space (grayscale/YCbCr convert in the
  // library; CMYK errors out -> the binder's PIL retry handles it)
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  const int64_t h = cinfo.output_height, w = cinfo.output_width;
  if (h * w * 3 > cap) {
    jpeg_destroy_decompress(&cinfo);
    return kShortBuffer;
  }
  jpeg_start_decompress(&cinfo);
  const int64_t stride = (int64_t)cinfo.output_width *
                         cinfo.output_components;  // 3 after JCS_RGB
  const int64_t stop =
      (max_rows >= 0 && max_rows < h) ? max_rows : h;
  while ((int64_t)cinfo.output_scanline < stop) {
    JSAMPROW row = out + (int64_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  if (out_h) *out_h = h;
  if (out_w) *out_w = w;
  if (full_h) *full_h = cinfo.image_height;
  if (full_w) *full_w = cinfo.image_width;
  if (stop < h)
    jpeg_abort_decompress(&cinfo);  // cut short: abort, don't finish
  else
    jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

double clampd(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Grow-on-demand per-thread workspace: the fused path's resample taps
// and row strip live here, so a steady-state decode worker allocates
// NOTHING per image (matching the Python side's thread-local scratch
// frame). Freed at thread exit by the destructor.
struct ThreadBuf {
  void* p = nullptr;
  size_t cap = 0;
  ~ThreadBuf() { free(p); }
  void* get(size_t n) {
    if (cap < n) {
      free(p);
      p = malloc(n);
      cap = p ? n : 0;
    }
    return p;
  }
};

thread_local ThreadBuf tl_taps;   // x0/x1 indices + wx weights
thread_local ThreadBuf tl_strip;  // one vertically-blended source row

}  // namespace

extern "C" {

// Header-only geometry (no IDCT): 0 on success, writes (h, w, comps) of
// the FULL-SCALE image. comps is the source component count (1 gray,
// 3 color) — the decode functions always emit 3-channel RGB.
int64_t img_info(const uint8_t* data, int64_t n, int64_t* h, int64_t* w,
                 int64_t* comps) {
  if (!data || n <= 0) return kBadArgs;
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = jpeg_std_error(&trap.mgr);
  trap.mgr.error_exit = on_error;
  trap.mgr.emit_message = on_message;
  if (setjmp(trap.env)) {
    jpeg_destroy_decompress(&cinfo);
    return kBadImage;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               (unsigned long)n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return kBadImage;
  }
  if (h) *h = cinfo.image_height;
  if (w) *w = cinfo.image_width;
  if (comps) *comps = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Full-scale decode: JPEG bytes -> HWC uint8 RGB into `out` (`cap`
// bytes, >= h*w*3). Writes the decoded (h, w). Returns 0, or -1 bad
// args / -2 undecodable / -3 short buffer.
int64_t img_decode(const uint8_t* data, int64_t n, uint8_t* out,
                   int64_t cap, int64_t* out_h, int64_t* out_w) {
  return decode_impl(data, n, 8, out, cap, out_h, out_w);
}

// DCT-scaled decode at scale_num/8 (scale_num in 1..8): the output
// frame is ceil(dim * scale_num / 8) per side — the caller picks the
// largest downscale whose frame still covers its crop/resize target
// and skips the rest of the IDCT work. Same contract as img_decode.
int64_t img_decode_scaled(const uint8_t* data, int64_t n,
                          int64_t scale_num, uint8_t* out, int64_t cap,
                          int64_t* out_h, int64_t* out_w) {
  return decode_impl(data, n, scale_num, out, cap, out_h, out_w);
}

// The fused training path: decode at scale_num/8 into `scratch`
// (caller-owned, reused across calls; sized >= the scaled frame or -3
// comes back), map the full-resolution crop box (top, left, crop_h,
// crop_w) onto the scaled frame, bilinear-resize it to target x target,
// optionally mirror horizontally, and write float32
// `pix * chan_scale[c] + chan_bias[c]` into `out` (target*target*3
// floats, HWC) — one call per image, zero intermediate buffers beyond
// the scratch frame. Identity scale/bias (1, 0) yields raw 0..255
// float pixels (the do_normalize=False contract).
//
// (full_h, full_w) is the caller's full-resolution geometry (the
// record's header stamp — already in hand, so the hot path does not
// pay a second header parse); the decode verifies it against the real
// frame and returns kBadImage on a lying stamp.
int64_t img_decode_rrc(const uint8_t* data, int64_t n, int64_t top,
                       int64_t left, int64_t crop_h, int64_t crop_w,
                       int64_t full_h, int64_t full_w,
                       int64_t target, int32_t flip, int64_t scale_num,
                       const float* chan_scale, const float* chan_bias,
                       uint8_t* scratch, int64_t scratch_cap,
                       float* out) {
  if (!out || !chan_scale || !chan_bias || target < 1 || crop_h < 1 ||
      crop_w < 1 || top < 0 || left < 0 || full_h < 1 || full_w < 1)
    return kBadArgs;
  // scaled-frame geometry from the caller's stamp: dims are
  // jdiv_round_up(dim * scale_num / 8), so the crop bottom row — the
  // last scanline the decode has to produce — is known up front
  const int64_t fh = full_h, fw = full_w;
  if (top + crop_h > fh || left + crop_w > fw) return kBadArgs;
  const int64_t sh = (fh * scale_num + 7) / 8;
  const int64_t sw = (fw * scale_num + 7) / 8;
  if (sh * sw * 3 > scratch_cap) return kShortBuffer;
  // map the box onto the scaled frame by the ACTUAL ratio (ceil'd dims,
  // so sh/fh is not exactly scale_num/8)
  const double ry = (double)sh / (double)fh;
  const double rx = (double)sw / (double)fw;
  const double ctop = (double)top * ry, cleft = (double)left * rx;
  // >= 1 px even for degenerate boxes on tiny scaled frames
  const double ch = clampd((double)crop_h * ry, 1.0, (double)sh);
  const double cw = clampd((double)crop_w * rx, 1.0, (double)sw);
  // decode through the crop bottom PLUS the resample filter's support
  // (ch/target rows when downscaling) — the support-scaled taps below
  // the box must see real pixels
  const int64_t last_row = (int64_t)clampd(
      ctop + ch + ch / (double)target + 1.0, 1.0, (double)sh);

  int64_t dh = 0, dw = 0;
  int64_t rc = decode_impl(data, n, scale_num, scratch, scratch_cap, &dh,
                           &dw, nullptr, nullptr, /*max_rows=*/last_row);
  if (rc != 0) return rc;
  if (dh != sh || dw != sw) return kBadImage;  // the stamp lied

  // separable, SUPPORT-SCALED bilinear (PIL's BILINEAR): on downscale
  // the triangle filter widens by the scale factor, so every source
  // pixel in the footprint contributes — a plain 2-tap bilinear
  // point-samples and ALIASES at factors > ~1.5x (measured mean
  // |native-PIL| 0.23 normalized units on a 1.56x downscale; with
  // support scaling both backends agree to IDCT tolerance). Upscale
  // keeps support 1 — identical to classic bilinear. Per output row
  // the row taps blend VERTICALLY into a contiguous float strip
  // (sequential uint8 loads — the loop the compiler vectorizes), then
  // the column taps sample that strip.
  const float s0 = chan_scale[0], s1 = chan_scale[1], s2 = chan_scale[2];
  const float b0 = chan_bias[0], b1 = chan_bias[1], b2 = chan_bias[2];
  const double xscale = cw / (double)target > 1.0 ? cw / (double)target : 1.0;
  const double yscale = ch / (double)target > 1.0 ? ch / (double)target : 1.0;
  // max taps per output pixel on each axis (PIL: ceil(support*2) + 1)
  const int64_t xk = (int64_t)(xscale * 2.0) + 2;
  const int64_t yk = (int64_t)(yscale * 2.0) + 2;
  // workspace: per-column (start, count) + weights, plus per-row
  // weights (computed per output row, reused across the strip)
  uint8_t* taps = (uint8_t*)tl_taps.get(
      2 * target * sizeof(int64_t) + target * xk * sizeof(float) +
      yk * sizeof(float));
  if (!taps) return kBadArgs;
  int64_t* xmin = (int64_t*)taps;
  int64_t* xcnt = xmin + target;
  float* xw = (float*)(xcnt + target);
  float* yw = xw + target * xk;

  // triangle-filter coefficients for one output position (PIL's
  // precompute_coeffs, filter support 1.0 scaled by `scale`): source
  // taps [lo, lo+cnt) with normalized weights into w[]
  auto coeffs = [](double center, double scale, int64_t limit, float* w,
                   int64_t kmax, int64_t* lo_out) -> int64_t {
    const double support = scale;  // bilinear support = 1.0, scaled
    int64_t lo = (int64_t)(center - support + 0.5);
    if (lo < 0) lo = 0;
    int64_t hi = (int64_t)(center + support + 0.5);
    if (hi > limit) hi = limit;
    int64_t cnt = hi - lo;
    if (cnt < 1) {  // degenerate: nearest source pixel
      lo = (int64_t)clampd(center, 0.0, (double)(limit - 1));
      cnt = 1;
    }
    if (cnt > kmax) cnt = kmax;
    double total = 0.0;
    for (int64_t i = 0; i < cnt; ++i) {
      double t = ((double)(lo + i) + 0.5 - center) / scale;
      double v = t < 0 ? 1.0 + t : 1.0 - t;  // triangle(t), |t| <= 1
      if (v < 0) v = 0;
      w[i] = (float)v;
      total += v;
    }
    if (total > 0)
      for (int64_t i = 0; i < cnt; ++i) w[i] = (float)(w[i] / total);
    *lo_out = lo;
    return cnt;
  };

  for (int64_t x = 0; x < target; ++x) {
    const double center = cleft + ((double)x + 0.5) * cw / (double)target;
    xcnt[x] = coeffs(center, xscale, sw, xw + x * xk, xk, &xmin[x]);
  }
  const int64_t xlo = xmin[0];
  const int64_t xhi = xmin[target - 1] + xcnt[target - 1];  // exclusive
  const int64_t span = (xhi - xlo) * 3;
  float* strip = (float*)tl_strip.get(span * sizeof(float));
  if (!strip) return kBadArgs;

  for (int64_t y = 0; y < target; ++y) {
    const double center = ctop + ((double)y + 0.5) * ch / (double)target;
    int64_t ylo = 0;
    int64_t ycnt = coeffs(center, yscale, last_row, yw, yk, &ylo);
    // vertical pass: weighted blend of the row taps into the strip
    {
      const uint8_t* r = scratch + (ylo * sw + xlo) * 3;
      const float w = yw[0];
      for (int64_t i = 0; i < span; ++i) strip[i] = w * (float)r[i];
    }
    for (int64_t t = 1; t < ycnt; ++t) {
      const uint8_t* r = scratch + ((ylo + t) * sw + xlo) * 3;
      const float w = yw[t];
      for (int64_t i = 0; i < span; ++i) strip[i] += w * (float)r[i];
    }
    // horizontal pass: per-column taps over the blended strip
    float* orow = out + y * target * 3;
    for (int64_t x = 0; x < target; ++x) {
      const float* w = xw + x * xk;
      const float* src = strip + (xmin[x] - xlo) * 3;
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int64_t t = 0; t < xcnt[x]; ++t) {
        acc0 += w[t] * src[t * 3];
        acc1 += w[t] * src[t * 3 + 1];
        acc2 += w[t] * src[t * 3 + 2];
      }
      float* o = orow + (flip ? (target - 1 - x) : x) * 3;
      o[0] = acc0 * s0 + b0;
      o[1] = acc1 * s1 + b1;
      o[2] = acc2 * s2 + b2;
    }
  }
  return 0;
}

}  // extern "C"
