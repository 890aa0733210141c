// Native JPEG decode + bilinear resize batch feeder.
//
// The reference's DataLoader workers decode JPEGs with PIL in Python
// (stylenet/data_loader.py:57-66); this is the native host feeder:
// libjpeg decompression and resize in C++ threads, one call per batch, no
// GIL.  Python falls back to the PIL path when the toolchain or libjpeg is
// unavailable (icee_tpu_torch/native/imagedec.py; outputs tested against PIL).
//
// Exact-parity note: JPEG IDCT rounding may differ by +-1 LSB across
// libjpeg builds, and the resize here is classic half-pixel-center bilinear
// (PIL's resize() applies an antialias triangle filter when downscaling),
// so this feeder is for high-throughput training input, not bit-parity
// paths.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* mgr = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(mgr->jb, 1);
}

// decode one JPEG buffer to tightly-packed RGB; returns false on failure
bool decode_rgb(const uint8_t* buf, int64_t n, std::vector<uint8_t>* pix,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(n));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  pix->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pix->data() + static_cast<size_t>(cinfo.output_scanline) *
                                     (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// half-pixel-center bilinear resize, RGB uint8
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  if (sw == dw && sh == dh) {
    std::memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float p00 = src[(static_cast<size_t>(y0) * sw + x0) * 3 + c];
        const float p01 = src[(static_cast<size_t>(y0) * sw + x1) * 3 + c];
        const float p10 = src[(static_cast<size_t>(y1) * sw + x0) * 3 + c];
        const float p11 = src[(static_cast<size_t>(y1) * sw + x1) * 3 + c];
        const float v = p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx +
                        p10 * wy * (1 - wx) + p11 * wy * wx;
        dst[(static_cast<size_t>(y) * dw + x) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// bufs: n pointers to JPEG byte buffers of length sizes[i]; out:
// (n, out_h, out_w, 3) uint8, zero-filled on per-image decode failure.
// Returns the number of failed decodes.
int decode_resize_batch(const uint8_t** bufs, const int64_t* sizes,
                        int64_t n, int out_h, int out_w, uint8_t* out,
                        int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> failures(n_threads, 0);
  const size_t out_stride = static_cast<size_t>(out_h) * out_w * 3;
  auto worker = [&](int tid) {
    std::vector<uint8_t> pix;
    for (int64_t i = tid; i < n; i += n_threads) {
      int w = 0, h = 0;
      uint8_t* dst = out + static_cast<size_t>(i) * out_stride;
      if (decode_rgb(bufs[i], sizes[i], &pix, &w, &h)) {
        resize_bilinear(pix.data(), w, h, dst, out_w, out_h);
      } else {
        std::memset(dst, 0, out_stride);
        ++failures[tid];
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
  int total = 0;
  for (int f : failures) total += f;
  return total;
}

}  // extern "C"
