// Native image-decode pipeline: fused PNG/JPEG decode + bilinear resize,
// with a threaded batch API.
//
// TPU-native replacement for the reference's host input machinery
// (SURVEY.md §2 native inventory): PIL(-SIMD)'s C JPEG/PNG decode
// (datasets/mono_dataset.py:14-19) and cv2's C++ bilinear resize
// (datasets/mono_dataset.py:103), plus the torch DataLoader's native worker
// loop (trainer.py:69-71) — here a std::thread pool over the batch. The
// decode and the resize are fused in one pass over one scratch buffer per
// thread (no PIL Image object, no numpy round-trip between decode and
// resize).
//
// Resize semantics: separable bilinear with half-pixel centers
// (src = (dst + 0.5) * scale − 0.5), the same sampling grid as
// cv2.resize(INTER_LINEAR); cv2 runs it in 11-bit fixed point so outputs
// may differ by ±1 LSB, which the Python tests bound.
//
// Build: g++ -O3 -shared -fPIC imgio.cpp -o libimgio.so -ljpeg -lpng
// (see __init__.py; gated — falls back to PIL/cv2 if libs are absent).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- errors
enum ErrCode {
  OK = 0,
  ERR_OPEN = 1,     // file missing/unreadable
  ERR_FORMAT = 2,   // not a PNG/JPEG
  ERR_DECODE = 3,   // codec error mid-stream
  ERR_ARGS = 4,     // bad output shape
};

// ------------------------------------------------------------- JPEG decode
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to RGB u8. Returns OK and fills rgb/(w,h), or an error.
int decode_jpeg(FILE* f, std::vector<uint8_t>* rgb, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr → RGB
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return OK;
}

// -------------------------------------------------------------- PNG decode
int decode_png(FILE* f, std::vector<uint8_t>* rgb, int* w, int* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return ERR_DECODE;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return ERR_DECODE;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  // Normalize every PNG flavor to 8-bit RGB (PIL convert("RGB") analog).
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  std::vector<png_bytep> rows(*h);
  const size_t stride = static_cast<size_t>(*w) * 3;
  for (int y = 0; y < *h; ++y) rows[y] = rgb->data() + y * stride;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return OK;
}

// ------------------------------------------------------ bilinear resize u8
// Separable, half-pixel centers, f32 accumulation, round-half-up — the
// cv2.resize(INTER_LINEAR) sampling grid (cv2 itself uses 11-bit fixed
// point; agreement is within ±1 LSB).
struct Tap {
  int i0;
  float w1;  // weight of i0+1 (weight of i0 is 1-w1)
};

void make_taps(int src, int dst, std::vector<Tap>* taps) {
  taps->resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int x = 0; x < dst; ++x) {
    double fx = (x + 0.5) * scale - 0.5;
    int ix = static_cast<int>(fx >= 0 ? fx : fx - 1);  // floor
    float w1 = static_cast<float>(fx - ix);
    if (ix < 0) { ix = 0; w1 = 0.f; }
    if (ix >= src - 1) { ix = src - 2 >= 0 ? src - 2 : 0; w1 = src > 1 ? 1.f : 0.f; }
    (*taps)[x] = {ix, w1};
  }
}

void resize_bilinear_u8(const uint8_t* src, int sh, int sw,
                        uint8_t* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  std::vector<Tap> tx, ty;
  make_taps(sw, dw, &tx);
  make_taps(sh, dh, &ty);
  // Horizontal pass: (sh, sw, 3) → (sh, dw, 3) f32.
  std::vector<float> mid(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    float* mrow = mid.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const Tap t = tx[x];
      const uint8_t* p0 = srow + t.i0 * 3;
      const uint8_t* p1 = srow + (t.i0 + (sw > 1 ? 1 : 0)) * 3;
      const float w1 = t.w1, w0 = 1.f - t.w1;
      mrow[x * 3 + 0] = w0 * p0[0] + w1 * p1[0];
      mrow[x * 3 + 1] = w0 * p0[1] + w1 * p1[1];
      mrow[x * 3 + 2] = w0 * p0[2] + w1 * p1[2];
    }
  }
  // Vertical pass: (sh, dw, 3) → (dh, dw, 3) u8.
  for (int y = 0; y < dh; ++y) {
    const Tap t = ty[y];
    const float* r0 = mid.data() + static_cast<size_t>(t.i0) * dw * 3;
    const float* r1 = mid.data() + static_cast<size_t>(t.i0 + (sh > 1 ? 1 : 0)) * dw * 3;
    const float w1 = t.w1, w0 = 1.f - t.w1;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw * 3; ++x) {
      const float v = w0 * r0[x] + w1 * r1[x];
      int iv = static_cast<int>(v + 0.5f);
      if (iv < 0) iv = 0;
      if (iv > 255) iv = 255;
      drow[x] = static_cast<uint8_t>(iv);
    }
  }
}

// ----------------------------------------------------------- single decode
int decode_resize_one(const char* path, uint8_t* out, int64_t out_h,
                      int64_t out_w, int32_t* src_w, int32_t* src_h) {
  if (out_h <= 0 || out_w <= 0) return ERR_ARGS;
  FILE* f = std::fopen(path, "rb");
  if (!f) return ERR_OPEN;
  uint8_t magic[8] = {0};
  const size_t got = std::fread(magic, 1, 8, f);
  std::rewind(f);
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  int rc;
  if (got >= 8 && std::memcmp(magic, "\x89PNG\r\n\x1a\n", 8) == 0) {
    rc = decode_png(f, &rgb, &w, &h);
  } else if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = decode_jpeg(f, &rgb, &w, &h);
  } else {
    rc = ERR_FORMAT;
  }
  std::fclose(f);
  if (rc != OK) return rc;
  if (src_w) *src_w = w;
  if (src_h) *src_h = h;
  resize_bilinear_u8(rgb.data(), h, w, out,
                     static_cast<int>(out_h), static_cast<int>(out_w));
  return OK;
}

}  // namespace

extern "C" {

// Decode one PNG/JPEG file and bilinear-resize it to (out_h, out_w) RGB u8
// written to `out` (capacity out_h*out_w*3). Original dimensions are
// returned via src_w/src_h (needed for intrinsics rescale,
// kitti_dataset.py:53-57). Returns an ErrCode.
int32_t img_decode_resize(const char* path, uint8_t* out, int64_t out_h,
                          int64_t out_w, int32_t* src_w, int32_t* src_h) {
  return decode_resize_one(path, out, out_h, out_w, src_w, src_h);
}

// Threaded batch: decode+resize `n` files into `out` (n, out_h, out_w, 3).
// `src_dims` receives n (w, h) pairs; `errs` the per-file ErrCode. Returns
// the number of failures. Threads each own a contiguous chunk — the pool
// is the native analog of the reference's 12 DataLoader workers.
int32_t img_decode_resize_batch(const char** paths, int64_t n, uint8_t* out,
                                int64_t out_h, int64_t out_w,
                                int32_t* src_dims, int64_t n_threads,
                                int32_t* errs) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  const int64_t item = out_h * out_w * 3;
  auto run = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      errs[i] = decode_resize_one(paths[i], out + i * item, out_h, out_w,
                                  &src_dims[2 * i], &src_dims[2 * i + 1]);
    }
  };
  if (n_threads == 1) {
    run(0, n);
  } else {
    std::vector<std::thread> pool;
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
      const int64_t lo = t * chunk;
      const int64_t hi = lo + chunk < n ? lo + chunk : n;
      if (lo >= hi) break;
      pool.emplace_back(run, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  int32_t fails = 0;
  for (int64_t i = 0; i < n; ++i) fails += errs[i] != OK;
  return fails;
}

// Standalone resize (u8 HWC, any channel count folded into w by the caller
// is NOT supported — c is explicit) for tests and the GT tooling.
void img_resize_bilinear(const uint8_t* src, int64_t sh, int64_t sw,
                         uint8_t* dst, int64_t dh, int64_t dw) {
  resize_bilinear_u8(src, static_cast<int>(sh), static_cast<int>(sw), dst,
                     static_cast<int>(dh), static_cast<int>(dw));
}

}  // extern "C"
