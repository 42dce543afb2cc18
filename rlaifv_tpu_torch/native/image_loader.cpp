// Threaded JPEG decode + mean-pad-to-square — the host half of the image
// hot path (the device kernel in ops/image_kernels.py does resize+normalize).
//
// TPU-native replacement for the PIL/cv2 dependency of the reference's
// data loading (ref: llava/mm_utils.py expand2square + PIL decode inside 16
// torch DataLoader workers, script/train/llava15_train.sh:44). One process,
// a std::thread pool, no Python in the decode loop.
//
// C ABI (ctypes):
//   rlaifv_jpeg_dims(data, size, &w, &h)          -> 0 ok
//   rlaifv_decode_pad(data, size, out, side, bg)  -> 0 ok; out: side*side*3
//   rlaifv_decode_pad_batch(...)                  -> #failures
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
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

// Decode into RGB; returns nullptr on failure. Caller frees with delete[].
uint8_t* decode_rgb(const uint8_t* data, size_t size, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  uint8_t* pixels = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    delete[] pixels;
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  pixels = new uint8_t[size_t(*w) * (*h) * 3];
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels + size_t(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return pixels;
}

}  // namespace

extern "C" {

int rlaifv_jpeg_dims(const uint8_t* data, size_t size, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode + center pad to side*side*3 with background color (expand2square,
// ref llava/mm_utils.py:152-163). side must be >= max(w, h).
int rlaifv_decode_pad(const uint8_t* data, size_t size, uint8_t* out,
                      int side, const uint8_t* bg) {
  int w = 0, h = 0;
  uint8_t* pixels = decode_rgb(data, size, &w, &h);
  if (!pixels) return 1;
  if (w > side || h > side) {
    delete[] pixels;
    return 2;
  }
  // fill background
  for (size_t i = 0; i < size_t(side) * side; ++i) {
    out[i * 3 + 0] = bg[0];
    out[i * 3 + 1] = bg[1];
    out[i * 3 + 2] = bg[2];
  }
  const int top = (side - h) / 2;
  const int left = (side - w) / 2;
  for (int row = 0; row < h; ++row) {
    std::memcpy(out + (size_t(top + row) * side + left) * 3,
                pixels + size_t(row) * w * 3, size_t(w) * 3);
  }
  delete[] pixels;
  return 0;
}

// Parallel batch: each image decodes on the pool and pads to its own
// out_sides[i] square buffer outs[i]. Returns the number of failures.
int rlaifv_decode_pad_batch(const uint8_t* const* datas, const size_t* sizes,
                            int n, uint8_t* const* outs, const int* out_sides,
                            const uint8_t* bg, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (rlaifv_decode_pad(datas[i], sizes[i], outs[i], out_sides[i], bg)) {
        failures.fetch_add(1);
      }
    }
  };
  int t = num_threads > 0 ? num_threads : 1;
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
