// Native host-side IO: multithreaded image decode into a caller-provided
// float32 arena.
//
// The reference's input pipeline leaned on TensorFlow's C++ tf.data runtime for
// its decode/shuffle/batch/prefetch hot path (reference: model.py:296-322; SURVEY
// §2.2 "tf.data C++ pipeline"). This is the TPU-native framework's equivalent:
// the host-side decode runs in native threads (off the GIL), the device-side
// augmentation stays in XLA (data/augment.py).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image):
//   tfdl_decode_png_batch(paths, n, out, h, w, channels, n_threads) -> int
//     Decodes n PNG files (which must already be h x w) into
//     out[n, h, w, channels] float32 in [0, 1]. Grayscale files fill every
//     requested channel; RGB(A) files must match channels (or be gray-converted
//     when channels == 1). Returns 0 on success, else 1 + the index of the
//     first failing file.
//   tfdl_decode_image_batch(paths, n, out, h, w, channels, n_threads) -> int
//     General form for ImageNet-class datasets: accepts PNG and JPEG (sniffed
//     by magic bytes) at ANY source size and bilinearly resizes to h x w.
//   tfdl_version() -> const char*

#include <cstddef>
#include <cstdio>

// jpeglib.h requires size_t/FILE to be declared before inclusion.
// TFDL_NO_JPEG builds (hosts without libjpeg) keep the PNG fast path; the
// Python side refuses JPEG files on such a build (native/loader.py).
#ifndef TFDL_NO_JPEG
#include <jpeglib.h>
#endif
#include <png.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Decode one 8/16-bit PNG to float32 [h, w, channels] in [0, 1].
// Returns true on success (file exists, is a PNG, and matches h x w).
bool DecodeOne(const char* path, float* out, int h, int w, int channels) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;

  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  // Declared BEFORE setjmp so a libpng longjmp unwinds through objects that are
  // already fully constructed — their destructors run on the error-path return.
  std::vector<png_byte> pixels;
  std::vector<png_bytep> rows;
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(fp);
    return false;
  }

  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const int img_w = png_get_image_width(png, info);
  const int img_h = png_get_image_height(png, info);
  if (img_w != w || img_h != h) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }

  // Normalize every input to 8-bit gray or RGB.
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_interlace_handling(png);  // de-interlace Adam7 files
  png_read_update_info(png, info);
  const int img_channels = png_get_channels(png, info);

  // Read the whole image through row pointers: png_read_image runs every
  // interlace pass, which per-row png_read_row would not.
  const size_t rowbytes = png_get_rowbytes(png, info);
  pixels.resize(rowbytes * h);
  rows.resize(h);
  for (int y = 0; y < h; ++y) rows[y] = pixels.data() + rowbytes * y;
  png_read_image(png, rows.data());

  for (int y = 0; y < h; ++y) {
    const png_byte* row = rows[y];
    float* dst = out + static_cast<int64_t>(y) * w * channels;
    if (img_channels == 1) {
      // gray: broadcast into every requested channel
      for (int x = 0; x < w; ++x) {
        const float v = row[x] / 255.0f;
        for (int c = 0; c < channels; ++c) dst[x * channels + c] = v;
      }
    } else if (img_channels == 3 && channels == 3) {
      for (int x = 0; x < w * 3; ++x) dst[x] = row[x] / 255.0f;
    } else if (img_channels == 3 && channels == 1) {
      // ITU-R BT.601 luma, what PIL's convert("L") computes
      for (int x = 0; x < w; ++x) {
        dst[x] = (0.299f * row[3 * x] + 0.587f * row[3 * x + 1] +
                  0.114f * row[3 * x + 2]) /
                 255.0f;
      }
    } else {
      png_destroy_read_struct(&png, &info, nullptr);
      std::fclose(fp);
      return false;
    }
  }

  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

// ---------------------------------------------------------------------------
// General path: PNG or JPEG at any source size, bilinear-resized to h x w.
// ---------------------------------------------------------------------------

// Decode a PNG at its native size into an 8-bit gray or RGB buffer.
bool DecodePngNative(FILE* fp, std::vector<unsigned char>* pixels, int* img_h,
                     int* img_w, int* img_c) {
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  std::vector<png_bytep> rows;
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  *img_h = png_get_image_height(png, info);
  *img_w = png_get_image_width(png, info);
  *img_c = png_get_channels(png, info);
  if (*img_c == 2) {  // gray+alpha survived strip_alpha ordering quirks
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  const size_t rowbytes = png_get_rowbytes(png, info);
  pixels->resize(rowbytes * *img_h);
  rows.resize(*img_h);
  for (int y = 0; y < *img_h; ++y) rows[y] = pixels->data() + rowbytes * y;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

#ifndef TFDL_NO_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void JpegErrorExit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG at its native size into an 8-bit gray or RGB buffer. CMYK/YCCK
// files (a handful exist in real ImageNet) are decoded as CMYK and converted —
// libjpeg cannot convert those to RGB itself and would abort the batch.
bool DecodeJpegNative(FILE* fp, int want_channels,
                      std::vector<unsigned char>* pixels, int* img_h,
                      int* img_w, int* img_c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrorExit;
  std::vector<unsigned char> cmyk;  // constructed before setjmp
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  const bool is_cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
                       cinfo.jpeg_color_space == JCS_YCCK;
  if (is_cmyk) {
    cinfo.out_color_space = JCS_CMYK;
  } else {
    cinfo.out_color_space = want_channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  }
  jpeg_start_decompress(&cinfo);
  *img_h = cinfo.output_height;
  *img_w = cinfo.output_width;
  const int out_c = cinfo.output_components;
  const size_t rowbytes = static_cast<size_t>(*img_w) * out_c;
  std::vector<unsigned char>* target = is_cmyk ? &cmyk : pixels;
  target->resize(rowbytes * *img_h);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = target->data() + rowbytes * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (!is_cmyk) {
    *img_c = out_c;
    return true;
  }
  // Adobe CMYK JPEGs store inverted values; libjpeg hands them through as-is,
  // so r = c*k/255 with the stored (inverted) samples — what PIL produces for
  // the same files via its CMYK path.
  const size_t npx = static_cast<size_t>(*img_h) * *img_w;
  pixels->resize(npx * 3);
  for (size_t i = 0; i < npx; ++i) {
    const unsigned char* p = cmyk.data() + i * 4;
    unsigned char* q = pixels->data() + i * 3;
    q[0] = static_cast<unsigned char>(p[0] * p[3] / 255);
    q[1] = static_cast<unsigned char>(p[1] * p[3] / 255);
    q[2] = static_cast<unsigned char>(p[2] * p[3] / 255);
  }
  *img_c = 3;
  return true;
}
#endif  // TFDL_NO_JPEG

// Precomputed 1-D triangle-filter resampling weights for one output axis
// (PIL-style antialiased bilinear: filter support scales with the downscale
// ratio, so minification averages instead of aliasing; half-pixel centers).
struct Taps {
  std::vector<int> start;     // first source index per output index
  std::vector<int> count;     // tap count per output index
  std::vector<int> offset;    // prefix index of each output's weights
  std::vector<float> weight;  // concatenated normalized weights
};

Taps BuildTaps(int src_n, int dst_n) {
  Taps t;
  const double scale = static_cast<double>(src_n) / dst_n;
  const double support = scale > 1.0 ? scale : 1.0;  // triangle radius
  t.start.resize(dst_n);
  t.count.resize(dst_n);
  t.offset.resize(dst_n);
  for (int i = 0; i < dst_n; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support + 0.5));
    int hi = static_cast<int>(std::floor(center + support + 0.5));
    if (lo < 0) lo = 0;
    if (hi > src_n) hi = src_n;
    t.start[i] = lo;
    t.count[i] = hi - lo;
    t.offset[i] = static_cast<int>(t.weight.size());
    double total = 0.0;
    std::vector<double> ws(hi - lo);
    for (int j = lo; j < hi; ++j) {
      const double d = (j + 0.5 - center) / support;
      const double wgt = d < 0 ? 1.0 + d : 1.0 - d;  // triangle
      ws[j - lo] = wgt > 0 ? wgt : 0.0;
      total += ws[j - lo];
    }
    for (double& wgt : ws) t.weight.push_back(static_cast<float>(wgt / total));
  }
  return t;
}

// Antialiased bilinear resize of an 8-bit [src_h, src_w, src_c] buffer into
// float32 [h, w, channels] in [0, 1] (separable triangle filter, the PIL
// BILINEAR convention), with the same channel adaptation rules as the
// fixed-size path.
bool ResizeToFloat(const unsigned char* src, int src_h, int src_w, int src_c,
                   float* out, int h, int w, int channels) {
  if (!(src_c == 1 || src_c == 3)) return false;
  if (!(channels == src_c || src_c == 1 || channels == 1)) return false;
  const Taps tx = BuildTaps(src_w, w);
  const Taps ty = BuildTaps(src_h, h);

  // pass 1: horizontal, uint8 -> float32 [src_h, w, src_c]. y-outer/x-inner so
  // both the source row and the tmp row stream contiguously through cache.
  std::vector<float> tmp(static_cast<size_t>(src_h) * w * src_c);
  for (int y = 0; y < src_h; ++y) {
    const unsigned char* row = src + static_cast<size_t>(y) * src_w * src_c;
    float* trow = tmp.data() + static_cast<size_t>(y) * w * src_c;
    for (int x = 0; x < w; ++x) {
      const int lo = tx.start[x], cnt = tx.count[x];
      const float* wp = tx.weight.data() + tx.offset[x];
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < cnt; ++k) {
        const unsigned char* px = row + (lo + k) * src_c;
        for (int c = 0; c < src_c; ++c) acc[c] += wp[k] * px[c];
      }
      for (int c = 0; c < src_c; ++c) trow[x * src_c + c] = acc[c];
    }
  }

  // pass 2: vertical + [0,1] scaling + channel adaptation
  for (int y = 0; y < h; ++y) {
    const int lo = ty.start[y], cnt = ty.count[y];
    const float* wp = ty.weight.data() + ty.offset[y];
    for (int x = 0; x < w; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < cnt; ++k) {
        const float* px =
            tmp.data() + (static_cast<size_t>(lo + k) * w + x) * src_c;
        for (int c = 0; c < src_c; ++c) acc[c] += wp[k] * px[c];
      }
      for (int c = 0; c < src_c; ++c) acc[c] /= 255.0f;
      float* dst = out + (static_cast<int64_t>(y) * w + x) * channels;
      if (src_c == channels) {
        for (int c = 0; c < channels; ++c) dst[c] = acc[c];
      } else if (src_c == 1) {
        for (int c = 0; c < channels; ++c) dst[c] = acc[0];
      } else {  // RGB -> gray, BT.601 luma (PIL convert("L"))
        dst[0] = 0.299f * acc[0] + 0.587f * acc[1] + 0.114f * acc[2];
      }
    }
  }
  return true;
}

// PNG or JPEG (magic-byte sniff) at any size -> float32 [h, w, channels].
// Decode an already-open PNG/JPEG stream (file or fmemopen'd record blob).
bool DecodeImageStream(FILE* fp, float* out, int h, int w, int channels) {
  unsigned char magic[2];
  if (std::fread(magic, 1, 2, fp) != 2) return false;
  std::rewind(fp);
  std::vector<unsigned char> pixels;
  int img_h = 0, img_w = 0, img_c = 0;
  bool ok;
  if (magic[0] == 0xFF && magic[1] == 0xD8) {
#ifdef TFDL_NO_JPEG
    ok = false;  // no libjpeg on this host; the Python side refuses JPEGs
#else
    ok = DecodeJpegNative(fp, channels, &pixels, &img_h, &img_w, &img_c);
#endif
  } else {
    ok = DecodePngNative(fp, &pixels, &img_h, &img_w, &img_c);
  }
  if (!ok) return false;
  return ResizeToFloat(pixels.data(), img_h, img_w, img_c, out, h, w, channels);
}

bool DecodeImageOne(const char* path, float* out, int h, int w, int channels) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  bool ok = DecodeImageStream(fp, out, h, w, channels);
  std::fclose(fp);
  return ok;
}

// Shared work-stealing thread harness for both batch entry points: decode each
// file with `decode_one` and report the MINIMAL failing index.
//
// Contract relied on by the Python side (loader.py names the failing index):
// every index below the returned failure index HAS been decoded. Workers
// therefore process every index they claim (no early bail-out — a worker that
// returned after another thread's failure would leave its just-claimed row as
// uninitialized memory that the fallback would then trust), and failures fold
// into an atomic minimum rather than first-to-CAS.
// Generalized over any per-index decode callable (file paths, memory blobs).
template <typename DecodeIndexFn>
int DecodeBatchIndexed(DecodeIndexFn decode_index, int n, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::atomic<int> min_error(n);  // n = "no failure yet"

  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      // Skip only indices ABOVE the current minimal failure: they are beyond
      // the contract's guarantee and will be revisited by the fallback loop.
      if (i > min_error.load(std::memory_order_relaxed)) continue;
      if (!decode_index(i)) {
        int cur = min_error.load();
        while (i < cur && !min_error.compare_exchange_weak(cur, i)) {
        }
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();

  const int err = min_error.load();
  return err >= n ? 0 : 1 + err;
}

using DecodeFn = bool (*)(const char*, float*, int, int, int);

int DecodeBatch(DecodeFn decode_one, const char** paths, int n, float* out,
                int h, int w, int channels, int n_threads) {
  const int64_t stride = static_cast<int64_t>(h) * w * channels;
  return DecodeBatchIndexed(
      [&](int i) { return decode_one(paths[i], out + i * stride, h, w, channels); },
      n, n_threads);
}

}  // namespace

extern "C" {

int tfdl_decode_png_batch(const char** paths, int n, float* out, int h, int w,
                          int channels, int n_threads) {
  return DecodeBatch(DecodeOne, paths, n, out, h, w, channels, n_threads);
}

int tfdl_decode_image_batch(const char** paths, int n, float* out, int h, int w,
                            int channels, int n_threads) {
  return DecodeBatch(DecodeImageOne, paths, n, out, h, w, channels, n_threads);
}

// In-memory twin of tfdl_decode_image_batch for record payloads: each blob is
// wrapped with fmemopen so the stream decoders run unchanged. Same minimal-
// failing-index contract as DecodeBatch.
int tfdl_decode_image_blob_batch(const unsigned char** blobs,
                                 const unsigned long long* sizes, int n,
                                 float* out, int h, int w, int channels,
                                 int n_threads) {
  const int64_t stride = static_cast<int64_t>(h) * w * channels;
  return DecodeBatchIndexed(
      [&](int i) {
        FILE* fp = fmemopen(const_cast<unsigned char*>(blobs[i]),
                            static_cast<size_t>(sizes[i]), "rb");
        bool ok = fp != nullptr &&
                  DecodeImageStream(fp, out + i * stride, h, w, channels);
        if (fp) std::fclose(fp);
        return ok;
      },
      n, n_threads);
}

const char* tfdl_version() { return "tfdl-io 0.2.0"; }

}  // extern "C"
