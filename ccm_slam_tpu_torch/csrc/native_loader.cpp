// Prefetching grayscale PNG loader for ccm_slam_tpu_torch (ctypes, plain C
// ABI): worker threads decode ahead into a bounded queue and the consumer
// takes frames strictly in sequence order, so image IO does not stall the
// per-frame step.  A copy of the loader half of the repository's
// native/ccm_native.cpp; it needs libpng, so it is built apart from the TCP
// channel (native_channel.cpp), which needs nothing but the C library.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// PNG decode (grayscale 8-bit)
// ---------------------------------------------------------------------------

namespace {

struct Image {
  int64_t index = -1;
  int width = 0;
  int height = 0;
  std::vector<uint8_t> pixels;
  bool ok = false;
};

bool decode_png_gray(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  // normalize everything to 8-bit grayscale
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  out->width = static_cast<int>(w);
  out->height = static_cast<int>(h);
  out->pixels.resize(static_cast<size_t>(w) * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->pixels.data() + y * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  out->ok = true;
  return true;
}

// ---------------------------------------------------------------------------
// Prefetching loader: worker threads decode ahead into a bounded, ordered
// queue; the consumer takes frames strictly in sequence order.
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  int queue_depth;
  std::atomic<int64_t> next_to_fetch{0};
  int64_t next_to_emit = 0;

  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::deque<Image> done;  // unordered completions
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      if (stop.load()) return;
      int64_t idx = next_to_fetch.fetch_add(1);
      if (idx >= static_cast<int64_t>(paths.size())) return;
      Image img;
      img.index = idx;
      decode_png_gray(paths[idx].c_str(), &img);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() ||
               static_cast<int>(done.size()) < queue_depth + 8;
      });
      if (stop.load()) return;
      done.push_back(std::move(img));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ccm_loader_create(const char** paths, int64_t n_paths, int n_threads,
                        int queue_depth) {
  auto* ld = new Loader();
  ld->paths.reserve(n_paths);
  for (int64_t i = 0; i < n_paths; ++i) ld->paths.emplace_back(paths[i]);
  ld->queue_depth = queue_depth;
  for (int i = 0; i < n_threads; ++i)
    ld->workers.emplace_back([ld] { ld->worker(); });
  return ld;
}

// Blocks until the next in-order frame is decoded.  Returns 1 on success,
// 0 at end of stream, -1 on decode failure.  Buffer must hold max_h*max_w.
int ccm_loader_next(void* handle, uint8_t* buffer, int* out_h, int* out_w,
                    int max_h, int max_w) {
  auto* ld = static_cast<Loader*>(handle);
  if (ld->next_to_emit >= static_cast<int64_t>(ld->paths.size())) return 0;
  std::unique_lock<std::mutex> lk(ld->mu);
  for (;;) {
    for (auto it = ld->done.begin(); it != ld->done.end(); ++it) {
      if (it->index == ld->next_to_emit) {
        Image img = std::move(*it);
        ld->done.erase(it);
        ld->cv_space.notify_all();
        ld->next_to_emit++;
        lk.unlock();
        if (!img.ok || img.height > max_h || img.width > max_w) return -1;
        *out_h = img.height;
        *out_w = img.width;
        // the caller's buffer is a [max_h, max_w] array: honor its row stride
        for (int y = 0; y < img.height; ++y)
          memcpy(buffer + static_cast<size_t>(y) * max_w,
                 img.pixels.data() + static_cast<size_t>(y) * img.width,
                 img.width);
        return 1;
      }
    }
    ld->cv_ready.wait(lk);
  }
}

void ccm_loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  ld->stop.store(true);
  ld->cv_space.notify_all();
  ld->cv_ready.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
