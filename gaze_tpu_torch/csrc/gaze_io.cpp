// gaze_io — host-side JPEG decode of gaze_tpu_torch: a threaded libjpeg
// batch decoder behind a plain C ABI, bound with ctypes by
// gaze_tpu_torch/data/native_io.py.
//
// The port's own copy of the JAX package's decoder (native/gaze_io.cpp):
// one call decodes N frames into a caller-owned contiguous uint8
// [N, H, W, 3] buffer, bilinear-resizing each to the target grid, on
// `threads` std::threads. The card has no part in it; it keeps the card
// fed from a host with few cores.
//
// Built at first use with g++ into gaze_tpu_torch/_build/ (native_io.py).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* mgr = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(mgr->jump, 1);
}

// Decode one JPEG file to RGB. Returns true on success; fills w/h and
// the pixel vector.
bool decode_file(const char* path, std::vector<unsigned char>& pixels,
                 int* width, int* height) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  pixels.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  *width = w;
  *height = h;
  return true;
}

// Bilinear resize RGB uint8 (sh, sw) -> (th, tw), writing into dst.
void resize_bilinear(const unsigned char* src, int sh, int sw,
                     unsigned char* dst, int th, int tw) {
  if (sh == th && sw == tw) {
    std::memcpy(dst, src, static_cast<size_t>(th) * tw * 3);
    return;
  }
  // Align corners=false convention (matches jax.image.resize / PIL).
  const float sy = static_cast<float>(sh) / th;
  const float sx = static_cast<float>(sw) / tw;
  for (int y = 0; y < th; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 > sh - 1 ? sh - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 > sh - 1 ? sh - 1 : y0 + 1);
    for (int x = 0; x < tw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 > sw - 1 ? sw - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 > sw - 1 ? sw - 1 : x0 + 1);
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(static_cast<size_t>(y0c) * sw + x0c) * 3 + c];
        float v01 = src[(static_cast<size_t>(y0c) * sw + x1c) * 3 + c];
        float v10 = src[(static_cast<size_t>(y1c) * sw + x0c) * 3 + c];
        float v11 = src[(static_cast<size_t>(y1c) * sw + x1c) * 3 + c];
        float v = v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
                  v10 * (1 - wx) * wy + v11 * wx * wy;
        dst[(static_cast<size_t>(y) * tw + x) * 3 + c] =
            static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Read JPEG dimensions without a full decode. Returns 0 on success.
int gaze_jpeg_dims(const char* path, int* width, int* height) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *width = cinfo.image_width;
  *height = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// Decode n JPEGs into out[n, th, tw, 3] (uint8, caller-allocated),
// bilinear-resizing each to (th, tw). Spreads work over `threads`
// std::threads. Returns the number of files that FAILED to decode
// (their slots are zero-filled), i.e. 0 means full success.
int gaze_decode_batch(const char** paths, int n, int th, int tw,
                      int threads, unsigned char* out) {
  if (n <= 0) return 0;
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;

  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t frame_bytes = static_cast<size_t>(th) * tw * 3;

  auto worker = [&]() {
    std::vector<unsigned char> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int w = 0, h = 0;
      unsigned char* dst = out + static_cast<size_t>(i) * frame_bytes;
      if (decode_file(paths[i], pixels, &w, &h)) {
        resize_bilinear(pixels.data(), h, w, dst, th, tw);
      } else {
        std::memset(dst, 0, frame_bytes);
        failures.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
