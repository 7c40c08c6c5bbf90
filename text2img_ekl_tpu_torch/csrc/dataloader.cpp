// Native batch decode pipeline of the PyTorch port (host code, g++).
//
// The port's own copy of the JAX package's native/dataloader.cpp, the same
// in behaviour to the bit: JPEG decode (libjpeg, DCT-scaled), CUB bbox
// square crop, shorter-side scale, random crop + horizontal flip,
// multi-scale pyramid, and [-1,1] float32 or raw uint8 output, all in C++
// with an internal thread pool behind a C ABI for ctypes
// (text2img_ekl_tpu_torch/data/native_loader.py). It stands in for the
// reference's torch DataLoader workers + PIL (reference: main.py:133-135,
// datasets.py:43-68).
//
// Per-image RNG is a SplitMix64 stream seeded from (epoch_seed, index) so
// results are reproducible regardless of thread scheduling.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// ----------------------------------------------------------------------
// SplitMix64: tiny deterministic per-item RNG.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return n ? next() % n : 0; }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// ----------------------------------------------------------------------
// Minimal image container (interleaved RGB, uint8).
struct ImageU8 {
  int w = 0, h = 0;
  std::vector<uint8_t> data;  // h * w * 3
  uint8_t* row(int y) { return data.data() + static_cast<size_t>(y) * w * 3; }
  const uint8_t* row(int y) const {
    return data.data() + static_cast<size_t>(y) * w * 3;
  }
};

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode, optionally at a reduced DCT scale (libjpeg scale_num/8).
//
// roi_full_side: the full-resolution pixel size of the region the pipeline
// will crop out (the CUB bbox square's side, or 0 = the whole image);
// target_px: the oversize the pipeline scales that region to. The decoder
// picks the smallest scale_num such that the region still maps to at least
// 1.25 * target_px decoded pixels — everything past that is IDCT work the
// downstream bilinear resize would immediately throw away. scale_out
// receives the applied scale factor (output_width / image_width).
bool decode_jpeg(const char* path, ImageU8* out, int roi_full_side,
                 int target_px, double* scale_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (target_px > 0) {
    int roi = roi_full_side > 0
                  ? roi_full_side
                  : static_cast<int>(std::min(cinfo.image_width,
                                              cinfo.image_height));
    roi = std::max(roi, 1);
    int s = static_cast<int>(
        std::ceil(8.0 * target_px * 1.25 / roi));
    cinfo.scale_num = std::min(8, std::max(1, s));
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  if (scale_out) {
    *scale_out = static_cast<double>(cinfo.output_width) / cinfo.image_width;
  }
  out->data.resize(static_cast<size_t>(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = out->row(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// ----------------------------------------------------------------------
// Bilinear resize (uint8 -> uint8), PIL-style half-pixel centers.
// Horizontal taps/weights are precomputed once per destination row sweep;
// all arithmetic is single-precision.
void resize_bilinear(const ImageU8& src, int dw, int dh, ImageU8* dst) {
  dst->w = dw;
  dst->h = dh;
  dst->data.resize(static_cast<size_t>(dw) * dh * 3);
  const float sx = static_cast<float>(src.w) / dw;
  const float sy = static_cast<float>(src.h) / dh;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> wxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = static_cast<int>(std::floor(fx));
    wxs[x] = fx - x0;
    x1s[x] = std::min(x0 + 1, src.w - 1) * 3;
    x0s[x] = std::max(x0, 0) * 3;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, src.h - 1);
    y0 = std::max(y0, 0);
    uint8_t* drow = dst->row(y);
    const uint8_t* r0 = src.row(y0);
    const uint8_t* r1 = src.row(y1);
    for (int x = 0; x < dw; ++x) {
      const int a = x0s[x], b = x1s[x];
      const float wx = wxs[x];
      for (int c = 0; c < 3; ++c) {
        float top = r0[a + c] * (1 - wx) + r0[b + c] * wx;
        float bot = r1[a + c] * (1 - wx) + r1[b + c] * wx;
        drow[x * 3 + c] =
            static_cast<uint8_t>(std::lround(top * (1 - wy) + bot * wy));
      }
    }
  }
}

void crop(const ImageU8& src, int x1, int y1, int x2, int y2, ImageU8* dst) {
  x1 = std::max(0, x1);
  y1 = std::max(0, y1);
  x2 = std::min(src.w, x2);
  y2 = std::min(src.h, y2);
  dst->w = x2 - x1;
  dst->h = y2 - y1;
  dst->data.resize(static_cast<size_t>(dst->w) * dst->h * 3);
  for (int y = 0; y < dst->h; ++y) {
    std::memcpy(dst->row(y), src.row(y + y1) + x1 * 3,
                static_cast<size_t>(dst->w) * 3);
  }
}

void hflip(ImageU8* img) {
  for (int y = 0; y < img->h; ++y) {
    uint8_t* row = img->row(y);
    for (int x = 0; x < img->w / 2; ++x) {
      for (int c = 0; c < 3; ++c) {
        std::swap(row[x * 3 + c], row[(img->w - 1 - x) * 3 + c]);
      }
    }
  }
}

// shorter side -> size (torchvision Scale semantics)
void scale_shorter(const ImageU8& src, int size, ImageU8* dst) {
  if ((src.w <= src.h && src.w == size) ||
      (src.h <= src.w && src.h == size)) {
    *dst = src;
    return;
  }
  if (src.w < src.h) {
    resize_bilinear(src, size, static_cast<int>(
        std::lround(static_cast<double>(size) * src.h / src.w)), dst);
  } else {
    resize_bilinear(src, static_cast<int>(std::lround(
        static_cast<double>(size) * src.w / src.h)), size, dst);
  }
}

// CUB square crop (reference: datasets.py:47-55)
void bbox_crop(const ImageU8& src, const float* bbox, ImageU8* dst) {
  int r = static_cast<int>(std::max(bbox[2], bbox[3]) * 0.75f);
  int cx = static_cast<int>((2 * bbox[0] + bbox[2]) / 2);
  int cy = static_cast<int>((2 * bbox[1] + bbox[3]) / 2);
  crop(src, cx - r, cy - r, cx + r, cy + r, dst);
}

void normalize_into(const ImageU8& img, float* out) {
  const size_t n = static_cast<size_t>(img.w) * img.h * 3;
  const float scale = 2.0f / 255.0f;
  for (size_t i = 0; i < n; ++i) {
    out[i] = img.data[i] * scale - 1.0f;
  }
}

// uint8 output mode: raw pixels; the train step normalizes on-device
// (x/127.5 - 1, exactly ToTensor+Normalize(0.5,0.5)) — 4x less host
// memory bandwidth and host->device transfer than float32 slabs.
void copy_into(const ImageU8& img, uint8_t* out) {
  std::memcpy(out, img.data.data(),
              static_cast<size_t>(img.w) * img.h * 3);
}

struct Loader {
  int num_threads;
  std::vector<int> sizes;  // branch sizes, ascending
  int oversize;            // imsize * 76 / 64
  uint64_t epoch_seed;
};

// Process one image into the per-branch output slabs (float32 [-1,1]
// or raw uint8 when out_uint8). Returns 0 on success.
int process_one(const Loader& L, const char* path, const float* bbox,
                bool train, uint64_t item_seed, int item_index,
                void** out_bufs, bool out_uint8) {
  ImageU8 img;
  // The bbox square's full-res side is 2R (reference: datasets.py:47-50) —
  // the decoder only needs enough DCT scale for that region to cover the
  // oversize target.
  int roi = 0;
  if (bbox) {
    roi = 2 * static_cast<int>(std::max(bbox[2], bbox[3]) * 0.75f);
  }
  double f = 1.0;
  if (!decode_jpeg(path, &img, roi, L.oversize, &f)) return 1;
  ImageU8 tmp;
  if (bbox) {
    float scaled[4] = {static_cast<float>(bbox[0] * f),
                       static_cast<float>(bbox[1] * f),
                       static_cast<float>(bbox[2] * f),
                       static_cast<float>(bbox[3] * f)};
    bbox_crop(img, scaled, &tmp);
    img.data.swap(tmp.data);
    std::swap(img.w, tmp.w);
    std::swap(img.h, tmp.h);
  }
  const int top = L.sizes.back();
  Rng rng(item_seed);
  // Scale(oversize) + crop(imsize) + flip (reference: main.py:111-114)
  scale_shorter(img, L.oversize, &tmp);
  int max_x = tmp.w - top, max_y = tmp.h - top;
  ImageU8 crop_img;
  if (max_x < 0 || max_y < 0) {
    resize_bilinear(tmp, std::max(tmp.w, top), std::max(tmp.h, top),
                    &crop_img);
    tmp.data.swap(crop_img.data);
    std::swap(tmp.w, crop_img.w);
    std::swap(tmp.h, crop_img.h);
    max_x = tmp.w - top;
    max_y = tmp.h - top;
  }
  int x = train ? static_cast<int>(rng.below(max_x + 1)) : max_x / 2;
  int y = train ? static_cast<int>(rng.below(max_y + 1)) : max_y / 2;
  crop(tmp, x, y, x + top, y + top, &crop_img);
  if (train && rng.uniform() < 0.5) hflip(&crop_img);

  // branch pyramid (reference: datasets.py:61-67)
  for (size_t b = 0; b < L.sizes.size(); ++b) {
    const int s = L.sizes[b];
    const size_t off = static_cast<size_t>(item_index) * s * s * 3;
    const ImageU8* src = &crop_img;
    ImageU8 small;
    if (s != top) {
      resize_bilinear(crop_img, s, s, &small);
      src = &small;
    }
    if (out_uint8) {
      copy_into(*src, static_cast<uint8_t*>(out_bufs[b]) + off);
    } else {
      normalize_into(*src, static_cast<float*>(out_bufs[b]) + off);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

void* t2i_loader_create(int num_threads, int branch_num, const int* sizes,
                        int oversize, uint64_t seed) {
  Loader* L = new Loader();
  L->num_threads = std::max(1, num_threads);
  L->sizes.assign(sizes, sizes + branch_num);
  L->oversize = oversize;
  L->epoch_seed = seed;
  return L;
}

void t2i_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

// Decode n images in parallel into per-branch slabs out_bufs[b] of shape
// [n, sizes[b], sizes[b], 3] — float32 [-1,1], or raw uint8 when
// out_uint8 (the train step then normalizes on-device: 4x less host
// bandwidth and H2D transfer). bboxes: n*4 floats, has_bbox: n bytes.
// Returns the number of failed images (their slots are zero-filled).
int t2i_decode_batch(void* handle, int n, const char** paths,
                     const float* bboxes, const unsigned char* has_bbox,
                     int train, uint64_t seed, void** out_bufs,
                     int out_uint8) {
  Loader* L = static_cast<Loader*>(handle);
  std::atomic<int> next(0), failures(0);
  const size_t elt = out_uint8 ? sizeof(uint8_t) : sizeof(float);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const float* bb =
          (has_bbox && has_bbox[i]) ? bboxes + static_cast<size_t>(i) * 4
                                    : nullptr;
      uint64_t item_seed = seed * 0x9E3779B97F4A7C15ull + i;
      int rc = process_one(*L, paths[i], bb, train != 0, item_seed, i,
                           out_bufs, out_uint8 != 0);
      if (rc != 0) {
        failures.fetch_add(1);
        // failed slots fill as mid-gray in BOTH modes: f32 0.0, uint8
        // 128 (-> 0.004 after the on-device x/127.5-1), keeping the
        // two output modes' failure behavior equivalent
        const int fill = out_uint8 ? 128 : 0;
        for (size_t b = 0; b < L->sizes.size(); ++b) {
          const int s = L->sizes[b];
          std::memset(static_cast<char*>(out_bufs[b]) +
                          static_cast<size_t>(i) * s * s * 3 * elt,
                      fill, static_cast<size_t>(s) * s * 3 * elt);
        }
      }
    }
  };
  int threads = std::min(L->num_threads, n);
  if (threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return failures.load();
}

}  // extern "C"
