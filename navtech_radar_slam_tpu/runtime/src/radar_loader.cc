// Native radar scan loader: PNG decode + metadata strip + threaded prefetch.
//
// The reference's front-end is a C++ node that reads MulRan polar PNGs
// directly from disk in its scan loop (README.md:27 "file-based input").
// Here the native runtime owns the host-side data path so the device never
// waits on image decode: a worker pool decodes scans ahead of the consumer
// into a bounded ring of pre-allocated float32 buffers (power image already
// normalized and padded to the configured range-bin width), while the Python side
// only moves ready buffers to the device.
//
// Exposed as a plain C API consumed via ctypes (no pybind11 in this image).
//
// Format (oxford-radar-robotcar polar form, README.md:70-71):
//   row = azimuth (400 rows), cols 0-7 int64 LE timestamp, cols 8-9 uint16
//   azimuth encoder tick (of 5600), col 10 validity, cols 11+ uint8 power.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kEncoderSize = 5600;

struct LoaderConfig {
  int num_azimuths;
  int num_range_bins;
  int padded_range_bins;
  int meta_columns;
  int num_workers;
  int queue_capacity;
  // raw_u8: emit power as the raw PNG bytes (normalize-on-device path —
  // the consumer ships uint8 to the accelerator and divides by 255 there,
  // cutting host->device traffic 4x vs float32)
  bool raw_u8 = false;
};

struct DecodedScan {
  int64_t index = -1;
  bool ok = false;
  std::vector<float> power;        // num_azimuths * padded_range_bins (float mode)
  std::vector<uint8_t> power_u8;   // same shape (raw_u8 mode)
  std::vector<double> timestamps;  // num_azimuths
  std::vector<float> azimuths;     // num_azimuths
  std::vector<uint8_t> valid;      // num_azimuths
};

struct PngImage {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> data;  // grayscale, row-major
};

bool ReadGrayPng(const char* path, PngImage* out) {
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
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  // normalize to 8-bit grayscale
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  out->width = static_cast<int>(png_get_image_width(png, info));
  out->height = static_cast<int>(png_get_image_height(png, info));
  out->data.resize(static_cast<size_t>(out->width) * out->height);
  std::vector<png_bytep> rows(out->height);
  for (int y = 0; y < out->height; ++y)
    rows[y] = out->data.data() + static_cast<size_t>(y) * out->width;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

void DecodeScan(const PngImage& img, const LoaderConfig& cfg, DecodedScan* out) {
  const int na = cfg.num_azimuths;
  const int nb = cfg.num_range_bins;
  const int pb = cfg.padded_range_bins;
  if (cfg.raw_u8)
    out->power_u8.assign(static_cast<size_t>(na) * pb, 0);
  else
    out->power.assign(static_cast<size_t>(na) * pb, 0.0f);
  out->timestamps.assign(na, 0.0);
  out->azimuths.assign(na, 0.0f);
  out->valid.assign(na, 1);

  const bool has_meta = img.width > nb;
  const int data_off = has_meta ? cfg.meta_columns : 0;
  const int w = img.width - data_off < nb ? img.width - data_off : nb;
  const int rows = img.height < na ? img.height : na;
  for (int a = 0; a < rows; ++a) {
    const uint8_t* row = img.data.data() + static_cast<size_t>(a) * img.width;
    if (has_meta) {
      int64_t stamp;
      std::memcpy(&stamp, row, 8);  // little-endian host assumed (x86/ARM)
      // MulRan stamps ns if huge, else us (oxford)
      out->timestamps[a] =
          stamp > 100000000000000000LL ? stamp * 1e-9 : stamp * 1e-6;
      uint16_t enc;
      std::memcpy(&enc, row + 8, 2);
      out->azimuths[a] =
          static_cast<float>(enc) / kEncoderSize * 6.283185307179586f;
      out->valid[a] = row[10] != 0;
    } else {
      out->azimuths[a] = (a + 0.5f) / na * 6.283185307179586f;
    }
    const uint8_t* src = row + data_off;
    if (cfg.raw_u8) {
      std::memcpy(out->power_u8.data() + static_cast<size_t>(a) * pb, src, w);
    } else {
      float* dst = out->power.data() + static_cast<size_t>(a) * pb;
      for (int r = 0; r < w; ++r) dst[r] = src[r] * (1.0f / 255.0f);
    }
  }
  out->ok = true;
}

class Prefetcher {
 public:
  Prefetcher(std::vector<std::string> paths, const LoaderConfig& cfg)
      : paths_(std::move(paths)), cfg_(cfg) {
    const int workers = cfg.num_workers > 0 ? cfg.num_workers : 2;
    for (int i = 0; i < workers; ++i)
      threads_.emplace_back([this] { Work(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_ready_.notify_all();
    cv_space_.notify_all();
    for (auto& t : threads_) t.join();
  }

  // Blocks until scan `index` (strictly increasing consumption) is ready and
  // copies it into caller buffers. Returns 0 on success, -1 on failure/EOF.
  // `power` is float* in float mode, uint8_t* in raw_u8 mode.
  int Next(void* power, double* timestamps, float* azimuths, uint8_t* valid,
           int64_t* index_out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (next_consume_ >= static_cast<int64_t>(paths_.size())) return -1;
    cv_ready_.wait(lk, [this] {
      return stop_ || ready_.count(next_consume_) > 0;
    });
    if (stop_) return -1;
    DecodedScan scan = std::move(ready_[next_consume_]);
    ready_.erase(next_consume_);
    ++next_consume_;
    lk.unlock();
    cv_space_.notify_all();

    if (!scan.ok) return -1;
    if (cfg_.raw_u8)
      std::memcpy(power, scan.power_u8.data(), scan.power_u8.size());
    else
      std::memcpy(power, scan.power.data(), scan.power.size() * sizeof(float));
    std::memcpy(timestamps, scan.timestamps.data(),
                scan.timestamps.size() * sizeof(double));
    std::memcpy(azimuths, scan.azimuths.data(),
                scan.azimuths.size() * sizeof(float));
    std::memcpy(valid, scan.valid.data(), scan.valid.size());
    *index_out = scan.index;
    return 0;
  }

 private:
  void Work() {
    for (;;) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] {
          return stop_ ||
                 (next_fetch_ < static_cast<int64_t>(paths_.size()) &&
                  next_fetch_ - next_consume_ <
                      static_cast<int64_t>(cfg_.queue_capacity));
        });
        if (stop_) return;
        idx = next_fetch_++;
      }
      DecodedScan scan;
      scan.index = idx;
      PngImage img;
      if (ReadGrayPng(paths_[idx].c_str(), &img)) DecodeScan(img, cfg_, &scan);
      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_[idx] = std::move(scan);
      }
      cv_ready_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  LoaderConfig cfg_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_ready_;
  std::condition_variable cv_space_;
  std::map<int64_t, DecodedScan> ready_;
  int64_t next_fetch_ = 0;
  int64_t next_consume_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* radar_loader_create(const char** paths, int num_paths, int num_azimuths,
                          int num_range_bins, int padded_range_bins,
                          int meta_columns, int num_workers,
                          int queue_capacity) {
  LoaderConfig cfg{num_azimuths, num_range_bins, padded_range_bins,
                   meta_columns, num_workers, queue_capacity, false};
  std::vector<std::string> p;
  p.reserve(num_paths);
  for (int i = 0; i < num_paths; ++i) p.emplace_back(paths[i]);
  return new Prefetcher(std::move(p), cfg);
}

// raw_u8 variant: power buffers are the raw PNG bytes (uint8), normalized
// on the accelerator by the consumer.
void* radar_loader_create_u8(const char** paths, int num_paths,
                             int num_azimuths, int num_range_bins,
                             int padded_range_bins, int meta_columns,
                             int num_workers, int queue_capacity) {
  LoaderConfig cfg{num_azimuths, num_range_bins, padded_range_bins,
                   meta_columns, num_workers, queue_capacity, true};
  std::vector<std::string> p;
  p.reserve(num_paths);
  for (int i = 0; i < num_paths; ++i) p.emplace_back(paths[i]);
  return new Prefetcher(std::move(p), cfg);
}

int radar_loader_next(void* handle, float* power, double* timestamps,
                      float* azimuths, uint8_t* valid, int64_t* index_out) {
  return static_cast<Prefetcher*>(handle)->Next(power, timestamps, azimuths,
                                                valid, index_out);
}

int radar_loader_next_u8(void* handle, uint8_t* power, double* timestamps,
                         float* azimuths, uint8_t* valid, int64_t* index_out) {
  return static_cast<Prefetcher*>(handle)->Next(power, timestamps, azimuths,
                                                valid, index_out);
}

void radar_loader_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

// one-shot decode (no prefetcher) for random access / tests
int radar_decode_png(const char* path, int num_azimuths, int num_range_bins,
                     int padded_range_bins, int meta_columns, float* power,
                     double* timestamps, float* azimuths, uint8_t* valid) {
  LoaderConfig cfg{num_azimuths, num_range_bins, padded_range_bins,
                   meta_columns, 0, 0, false};
  PngImage img;
  if (!ReadGrayPng(path, &img)) return -1;
  if (img.height < num_azimuths) return -2;
  DecodedScan scan;
  DecodeScan(img, cfg, &scan);
  std::memcpy(power, scan.power.data(), scan.power.size() * sizeof(float));
  std::memcpy(timestamps, scan.timestamps.data(),
              scan.timestamps.size() * sizeof(double));
  std::memcpy(azimuths, scan.azimuths.data(),
              scan.azimuths.size() * sizeof(float));
  std::memcpy(valid, scan.valid.data(), scan.valid.size());
  return 0;
}

int radar_decode_png_u8(const char* path, int num_azimuths, int num_range_bins,
                        int padded_range_bins, int meta_columns,
                        uint8_t* power, double* timestamps, float* azimuths,
                        uint8_t* valid) {
  LoaderConfig cfg{num_azimuths, num_range_bins, padded_range_bins,
                   meta_columns, 0, 0, true};
  PngImage img;
  if (!ReadGrayPng(path, &img)) return -1;
  if (img.height < num_azimuths) return -2;
  DecodedScan scan;
  DecodeScan(img, cfg, &scan);
  std::memcpy(power, scan.power_u8.data(), scan.power_u8.size());
  std::memcpy(timestamps, scan.timestamps.data(),
              scan.timestamps.size() * sizeof(double));
  std::memcpy(azimuths, scan.azimuths.data(),
              scan.azimuths.size() * sizeof(float));
  std::memcpy(valid, scan.valid.data(), scan.valid.size());
  return 0;
}

}  // extern "C"
