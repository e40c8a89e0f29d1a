// Threaded prefetching image loader + C API (ctypes boundary).
//
// The native runtime piece of the framework's ingest path: the reference
// does sequential single-threaded imread of 25 views per run
// (/root/reference/src/CameraStereoVision.cpp:14-19); here a worker pool
// decodes ahead of the consumer into a bounded in-order queue so host decode
// overlaps device compute (the classic input-pipeline overlap device step
// time depends on). Python binds via ctypes
// (stereovisionarray_tpu/datasets/native_loader.py) and copies each frame
// straight into a numpy array that jax.device_put ships to HBM.
//
// Concurrency design: one mutex + two condvars around a slot ring.
// Completion order is ENFORCED to be submission order (slot = index %
// capacity) so results are deterministic regardless of decode-thread timing
// — the determinism the reference's unsorted directory iteration lacks
// (/root/reference/src/functions.cpp:241-251; sorting happens Python-side).

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "image_codec.h"

namespace {

struct Slot {
  svt::Image image;
  std::string error;
  bool ready = false;
  bool failed = false;
};

struct Loader {
  std::vector<std::string> paths;
  int gray = 1;
  int half_res = 0;

  std::vector<Slot> slots;          // ring, capacity entries
  size_t capacity = 0;
  std::atomic<size_t> next_fetch{0};  // next path index a worker takes
  size_t next_consume = 0;            // next index the consumer pops
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slot ready
  std::condition_variable cv_free;    // workers wait for slot freed
  std::vector<std::thread> workers;
  bool stop = false;

  void work() {
    for (;;) {
      size_t idx = next_fetch.fetch_add(1);
      if (idx >= paths.size()) return;
      Slot local;
      svt::Image img;
      // decode_image can throw (bad_alloc/length_error on corrupt headers
      // with huge dims); an escaped exception in a worker thread would call
      // std::terminate — convert to a per-frame decode failure instead
      try {
        if (!svt::decode_image(paths[idx], &img)) {
          local.failed = true;
          local.error = svt::g_last_error;
        } else {
          if (gray && img.channels != 1) {
            std::vector<float> g;
            svt::to_gray(img, &g);
            img.pixels = std::move(g);
            img.channels = 1;
          }
          if (half_res) svt::decimate2(&img.pixels, &img.width, &img.height, img.channels);
          local.image = std::move(img);
        }
      } catch (const std::exception& e) {
        local.failed = true;
        local.error = std::string("decode exception: ") + e.what();
        local.image = svt::Image();
      }
      size_t s = idx % capacity;
      std::unique_lock<std::mutex> lk(mu);
      // wait until the consumer has drained the previous occupant of slot s
      cv_free.wait(lk, [&] { return stop || idx < next_consume + capacity; });
      if (stop) return;
      local.ready = true;
      slots[s] = std::move(local);
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

const char* svt_last_error() { return svt::g_last_error.c_str(); }

// One-shot synchronous decode. Returns 0 on failure. On success fills
// *width/*height/*channels; call svt_image_copy to fetch pixels then
// svt_image_free.
void* svt_decode(const char* path, int gray, int half_res, int* width,
                 int* height, int* channels) {
  auto* img = new svt::Image();
  // exceptions must not cross the extern "C"/ctypes boundary: convert to
  // the documented null-return + svt_last_error contract
  try {
    if (!svt::decode_image(path, img)) {
      delete img;
      return nullptr;
    }
    if (gray && img->channels != 1) {
      std::vector<float> g;
      svt::to_gray(*img, &g);
      img->pixels = std::move(g);
      img->channels = 1;
    }
    if (half_res) svt::decimate2(&img->pixels, &img->width, &img->height, img->channels);
  } catch (const std::exception& e) {
    svt::g_last_error = std::string("decode exception: ") + e.what();
    delete img;
    return nullptr;
  }
  *width = img->width;
  *height = img->height;
  *channels = img->channels;
  return img;
}

void svt_image_copy(void* handle, float* dst) {
  auto* img = static_cast<svt::Image*>(handle);
  std::memcpy(dst, img->pixels.data(), img->pixels.size() * sizeof(float));
}

void svt_image_free(void* handle) { delete static_cast<svt::Image*>(handle); }

// Prefetching loader over a fixed path list.
void* svt_loader_create(const char** paths, int n_paths, int n_threads,
                        int capacity, int gray, int half_res) {
  auto* ld = new Loader();
  ld->paths.assign(paths, paths + n_paths);
  ld->gray = gray;
  ld->half_res = half_res;
  ld->capacity = capacity < 1 ? 1 : static_cast<size_t>(capacity);
  ld->slots.resize(ld->capacity);
  int nt = n_threads < 1 ? 1 : n_threads;
  for (int i = 0; i < nt; ++i) ld->workers.emplace_back([ld] { ld->work(); });
  return ld;
}

// Pop the next frame in submission order. Returns 1 on success (handle
// out-params like svt_decode), 0 on decode failure (svt_last_error set),
// -1 when the list is exhausted.
int svt_loader_next(void* handle, int* width, int* height, int* channels,
                    void** image_out) {
  auto* ld = static_cast<Loader*>(handle);
  if (ld->next_consume >= ld->paths.size()) return -1;
  size_t idx = ld->next_consume;
  size_t s = idx % ld->capacity;
  std::unique_lock<std::mutex> lk(ld->mu);
  ld->cv_ready.wait(lk, [&] { return ld->slots[s].ready; });
  Slot slot = std::move(ld->slots[s]);
  ld->slots[s] = Slot{};
  ld->next_consume = idx + 1;
  ld->cv_free.notify_all();
  lk.unlock();
  if (slot.failed) {
    svt::g_last_error = slot.error;
    return 0;
  }
  auto* img = new svt::Image(std::move(slot.image));
  *width = img->width;
  *height = img->height;
  *channels = img->channels;
  *image_out = img;
  return 1;
}

void svt_loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop = true;
    ld->cv_free.notify_all();
  }
  ld->next_fetch.store(ld->paths.size());
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"

extern "C" {
// 8-bit grayscale PNG writer. Returns 1 on success, 0 on failure
// (svt_last_error set).
int svt_encode_png_gray(const char* path, const unsigned char* data,
                        int width, int height) {
  return svt::encode_png_gray(path, data, width, height) ? 1 : 0;
}
}
