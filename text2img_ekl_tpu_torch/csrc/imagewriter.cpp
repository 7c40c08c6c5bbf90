// Native async PNG writer of the PyTorch port (host code, g++).
//
// The port's own copy of the JAX package's native/imagewriter.cpp. The
// reference's evaluate loop writes one PNG per (image, caption, noise)
// triple, 30k files for the offline IS/FID protocol
// (cub_trainer_splitz_cap_ca.py:758-774, TEST.SAMPLE_NUM), through PIL,
// serialized with the sampling loop. Here a C++ thread pool encodes
// libpng images off the GIL while the host thread keeps dispatching device
// work, so the write tax overlaps the sampling instead of adding to it.
//
// API (ctypes, see text2img_ekl_tpu_torch/io_utils/native_writer.py):
//   t2i_writer_create(threads, compress_level) -> handle
//   t2i_write_png_batch(h, n, paths[], data, height, width, channels)
//       enqueue n HWC uint8 images (data copied; returns immediately)
//   t2i_writer_flush(h) -> number of failed writes since last flush
//   t2i_writer_destroy(h)

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

namespace {

struct Job {
  std::string path;
  std::vector<uint8_t> pixels;  // HWC uint8
  int h, w, c;
};

class Writer {
 public:
  Writer(int threads, int level) : level_(level) {
    if (threads < 1) threads = 1;
    for (int i = 0; i < threads; ++i)
      workers_.emplace_back([this] { Run(); });
  }

  ~Writer() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void Enqueue(Job&& job) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      // Bound queued memory: past ~256 jobs the producer helps drain.
      full_cv_.wait(lk, [this] { return queue_.size() < 256 || stop_; });
      queue_.emplace_back(std::move(job));
      ++pending_;
    }
    cv_.notify_one();
  }

  int Flush() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
    return errors_.exchange(0);
  }

 private:
  void Run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      full_cv_.notify_one();
      if (!WritePng(job)) errors_.fetch_add(1);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  bool WritePng(const Job& job) {
    FILE* fp = std::fopen(job.path.c_str(), "wb");
    if (!fp) return false;
    png_structp png =
        png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                                nullptr);
    if (!png) {
      std::fclose(fp);
      return false;
    }
    png_infop info = png_create_info_struct(png);
    if (!info || setjmp(png_jmpbuf(png))) {
      png_destroy_write_struct(&png, info ? &info : nullptr);
      std::fclose(fp);
      return false;
    }
    png_init_io(png, fp);
    png_set_compression_level(png, level_);
    const int color =
        job.c == 1 ? PNG_COLOR_TYPE_GRAY : PNG_COLOR_TYPE_RGB;
    png_set_IHDR(png, info, job.w, job.h, 8, color, PNG_INTERLACE_NONE,
                 PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
    png_write_info(png, info);
    std::vector<png_bytep> rows(job.h);
    const size_t stride = static_cast<size_t>(job.w) * job.c;
    for (int y = 0; y < job.h; ++y)
      rows[y] = const_cast<png_bytep>(job.pixels.data() + y * stride);
    png_write_image(png, rows.data());
    png_write_end(png, nullptr);
    png_destroy_write_struct(&png, &info);
    return std::fclose(fp) == 0;
  }

  const int level_;
  std::vector<std::thread> workers_;
  std::deque<Job> queue_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_, full_cv_;
  int pending_ = 0;
  bool stop_ = false;
  std::atomic<int> errors_{0};
};

}  // namespace

extern "C" {

void* t2i_writer_create(int threads, int compress_level) {
  return new Writer(threads, compress_level);
}

void t2i_writer_destroy(void* h) { delete static_cast<Writer*>(h); }

int t2i_write_png_batch(void* h, int n, const char** paths,
                        const uint8_t* data, int height, int width,
                        int channels) {
  if (!h || n <= 0 || !paths || !data) return -1;
  if (channels != 1 && channels != 3) return -1;
  Writer* w = static_cast<Writer*>(h);
  const size_t img_bytes =
      static_cast<size_t>(height) * width * channels;
  for (int i = 0; i < n; ++i) {
    Job job;
    job.path = paths[i];
    job.pixels.assign(data + i * img_bytes, data + (i + 1) * img_bytes);
    job.h = height;
    job.w = width;
    job.c = channels;
    w->Enqueue(std::move(job));
  }
  return 0;
}

int t2i_writer_flush(void* h) {
  return h ? static_cast<Writer*>(h)->Flush() : -1;
}

}  // extern "C"
