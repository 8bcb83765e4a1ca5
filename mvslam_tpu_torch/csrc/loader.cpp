// Native data loader: JPEG decode + multi-threaded prefetch pipeline.
//
// The native equivalent of the reference's C++ IO/runtime layer:
// image decode (reference: cv::imread behind base/image.cpp:9-15) done with
// libjpeg, and the host-side concurrency primitives (reference os/mutex.
// {hpp,cpp} pthread mutex + os/event.{hpp,cpp} condvar) realized as a
// bounded producer/consumer prefetch queue feeding the device step loop —
// decode of frame t+1 overlaps compute of frame t.
//
// C ABI (consumed via ctypes from mvslam_tpu_torch.io.native_loader; a copy
// of native/loader.cpp, equal to it below this header):
//   mvslam_decode_jpeg_gray(path, out_buf, cap, &h, &w)   -> 0 on success
//   mvslam_loader_create(paths, n, queue_depth, threads)  -> handle
//   mvslam_loader_next(handle, out_buf, cap, &h, &w, &idx)-> 0/eof=1/err<0
//   mvslam_loader_destroy(handle)
//
// Build: g++ -O2 -shared -fPIC -o libmvslam_loader.so loader.cpp -ljpeg -lpthread

#include <cstddef>
#include <cstdio>
#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to grayscale float32 in [0, 1]. Returns 0 on
// success, negative on error. *h/*w receive the dimensions; fails if the
// image exceeds `cap` floats.
int decode_gray(const char* path, float* out, int64_t cap, int* h, int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  const int width = cinfo.output_width;
  const int height = cinfo.output_height;
  if (static_cast<int64_t>(width) * height > cap) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -3;
  }
  std::vector<JSAMPLE> row(width);
  JSAMPROW rowp = row.data();
  constexpr float kScale = 1.0f / 255.0f;
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out + static_cast<int64_t>(y) * width;
    for (int x = 0; x < width; ++x) dst[x] = row[x] * kScale;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  *h = height;
  *w = width;
  return 0;
}

struct DecodedFrame {
  int index = -1;
  int h = 0, w = 0;
  int status = 0;
  std::vector<float> pixels;
};

// Bounded multi-producer prefetch queue. Workers claim source indices with
// an atomic ticket; frames are delivered to the consumer in order.
class PrefetchLoader {
 public:
  PrefetchLoader(std::vector<std::string> paths, int queue_depth, int threads)
      : paths_(std::move(paths)),
        queue_depth_(queue_depth < 1 ? 1 : queue_depth) {
    const int n = threads < 1 ? 1 : threads;
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~PrefetchLoader() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // 0 = frame written, 1 = end of stream, <0 = decode error for that frame.
  int Next(float* out, int64_t cap, int* h, int* w, int* index) {
    std::unique_lock<std::mutex> lock(mu_);
    const int want = next_deliver_;
    if (want >= static_cast<int>(paths_.size())) return 1;
    cv_ready_.wait(lock, [&] {
      return stop_ || Find(want) != nullptr;
    });
    if (stop_) return 1;
    DecodedFrame* fr = Find(want);
    int status = fr->status;
    if (status == 0) {
      if (static_cast<int64_t>(fr->h) * fr->w > cap) {
        status = -3;
      } else {
        std::memcpy(out, fr->pixels.data(),
                    sizeof(float) * fr->pixels.size());
        *h = fr->h;
        *w = fr->w;
      }
    }
    *index = fr->index;
    Erase(want);
    ++next_deliver_;
    cv_space_.notify_all();
    return status;
  }

 private:
  DecodedFrame* Find(int index) {
    for (auto& fr : ready_)
      if (fr.index == index) return &fr;
    return nullptr;
  }

  void Erase(int index) {
    for (auto it = ready_.begin(); it != ready_.end(); ++it) {
      if (it->index == index) {
        ready_.erase(it);
        return;
      }
    }
  }

  void WorkerLoop() {
    while (true) {
      const int idx = next_claim_.fetch_add(1);
      if (idx >= static_cast<int>(paths_.size())) return;
      DecodedFrame fr;
      fr.index = idx;
      fr.pixels.resize(kMaxPixels);
      fr.status = decode_gray(paths_[idx].c_str(), fr.pixels.data(),
                              kMaxPixels, &fr.h, &fr.w);
      if (fr.status == 0)
        fr.pixels.resize(static_cast<size_t>(fr.h) * fr.w);
      else
        fr.pixels.clear();
      std::unique_lock<std::mutex> lock(mu_);
      // bound the lookahead relative to the delivery cursor
      cv_space_.wait(lock, [&] {
        return stop_ || idx < next_deliver_ + queue_depth_;
      });
      if (stop_) return;
      ready_.push_back(std::move(fr));
      cv_ready_.notify_all();
    }
  }

  static constexpr int64_t kMaxPixels = 64LL * 1024 * 1024;

  std::vector<std::string> paths_;
  const int queue_depth_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::deque<DecodedFrame> ready_;
  std::atomic<int> next_claim_{0};
  int next_deliver_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

int mvslam_decode_jpeg_gray(const char* path, float* out, int64_t cap,
                            int* h, int* w) {
  return decode_gray(path, out, cap, h, w);
}

void* mvslam_loader_create(const char** paths, int n, int queue_depth,
                           int threads) {
  std::vector<std::string> v;
  v.reserve(n);
  for (int i = 0; i < n; ++i) v.emplace_back(paths[i]);
  return new PrefetchLoader(std::move(v), queue_depth, threads);
}

int mvslam_loader_next(void* handle, float* out, int64_t cap, int* h, int* w,
                       int* index) {
  return static_cast<PrefetchLoader*>(handle)->Next(out, cap, h, w, index);
}

void mvslam_loader_destroy(void* handle) {
  delete static_cast<PrefetchLoader*>(handle);
}

}  // extern "C"
