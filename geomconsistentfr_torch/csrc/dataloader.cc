// Native streaming data loader and libjpeg codec of geomconsistentfr_torch.
//
// The port's own copy of the JAX package's native/dataloader.cc, with the
// same plain C interface (gcfr_loader_*, gcfr_has_jpeg, gcfr_decode_jpeg(s),
// gcfr_encode_jpeg, gcfr_free); data/native_loader.py builds it with g++
// into build/native/ and binds it with ctypes. It is host code: nothing
// here runs on the GPU.
//
// The reference loads the whole 29,890-sample dataset into float64 numpy in
// RAM (~110 GB, train_raytracing_relighting_CelebAHQ_DSSIM_8x.py:527-558).
// This loader instead mmaps the packed memmap cache (data/celebahq.py
// build_cache) and assembles training batches on background threads into a
// bounded queue, overlapping host IO with device compute.
//
// Batch schema (must match data/celebahq.py FIELDS):
//   image     uint8  (N, 256, 256, 3) -> float32 /255
//   depth_gt  float32(N, 256, 256)
//   depth_mask uint8 (N, 256, 256)    -> float32 /255
//   albedo_gt uint8  (N, 256, 256)    -> float32 /255
//   face_mask uint8  (N, 256, 256)    -> float32 /255
//   light_gt  float32(N, 3)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int kH = 256;
constexpr int kW = 256;
constexpr int kImg = kH * kW * 3;
constexpr int kMap = kH * kW;

struct Mapped {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t header = 0;  // .npy header bytes to skip

  const uint8_t* payload() const { return data + header; }
};

bool MapNpy(const std::string& path, Mapped* out) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return false;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return false;
  out->data = static_cast<const uint8_t*>(p);
  out->size = st.st_size;
  // .npy v1: magic(6) ver(2) hlen(2 LE) header(hlen)
  if (out->size < 10 || std::memcmp(out->data, "\x93NUMPY", 6) != 0) return false;
  uint16_t hlen;
  std::memcpy(&hlen, out->data + 8, 2);
  out->header = 10 + hlen;
  return true;
}

struct Batch {
  // f32 mode (raw=0): the expanded training schema.
  std::vector<float> image;       // B*kImg
  std::vector<float> depth_gt;    // B*kMap
  std::vector<float> depth_mask;  // B*kMap
  std::vector<float> albedo_gt;   // B*kMap
  std::vector<float> face_mask;   // B*kMap
  std::vector<float> light_gt;    // B*3
  // raw mode (raw=1): stored dtypes, no /255 expansion — 2.8x fewer bytes
  // for the host->device handoff (the /255 runs on the device; see
  // train.py decode_batch).
  std::vector<uint8_t> image_u8;       // B*kImg
  std::vector<uint8_t> depth_mask_u8;  // B*kMap
  std::vector<uint8_t> albedo_gt_u8;   // B*kMap
  std::vector<uint8_t> face_mask_u8;   // B*kMap
};

class Loader {
 public:
  Loader(const std::string& dir, int num_samples, int batch, uint64_t seed,
         int workers, int queue_capacity, bool raw)
      : num_samples_(num_samples),
        batch_(batch),
        capacity_(queue_capacity),
        raw_(raw),
        rng_(seed) {
    ok_ = MapNpy(dir + "/image.npy", &image_) &&
          MapNpy(dir + "/depth_gt.npy", &depth_) &&
          MapNpy(dir + "/depth_mask.npy", &dmask_) &&
          MapNpy(dir + "/albedo_gt.npy", &albedo_) &&
          MapNpy(dir + "/face_mask.npy", &fmask_) &&
          MapNpy(dir + "/light_gt.npy", &light_);
    if (!ok_) return;
    for (int i = 0; i < workers; ++i) {
      threads_.emplace_back([this] { Work(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_full_.notify_all();
    cv_empty_.notify_all();
    for (auto& t : threads_) t.join();
  }

  bool ok() const { return ok_; }

  // Blocks until a batch is ready, copies it into caller-owned buffers.
  void Next(float* image, float* depth_gt, float* depth_mask, float* albedo_gt,
            float* face_mask, float* light_gt) {
    Batch b;
    {
      std::unique_lock<std::mutex> lock(mu_);
      cv_empty_.wait(lock, [this] { return !queue_.empty() || stop_; });
      if (stop_ && queue_.empty()) return;
      b = std::move(queue_.front());
      queue_.pop_front();
    }
    cv_full_.notify_one();
    std::memcpy(image, b.image.data(), b.image.size() * 4);
    std::memcpy(depth_gt, b.depth_gt.data(), b.depth_gt.size() * 4);
    std::memcpy(depth_mask, b.depth_mask.data(), b.depth_mask.size() * 4);
    std::memcpy(albedo_gt, b.albedo_gt.data(), b.albedo_gt.size() * 4);
    std::memcpy(face_mask, b.face_mask.data(), b.face_mask.size() * 4);
    std::memcpy(light_gt, b.light_gt.data(), b.light_gt.size() * 4);
  }

  // Raw-mode twin of Next: uint8 fields stay uint8 (loader must have been
  // created with raw=1).
  void NextRaw(uint8_t* image, float* depth_gt, uint8_t* depth_mask,
               uint8_t* albedo_gt, uint8_t* face_mask, float* light_gt) {
    Batch b;
    {
      std::unique_lock<std::mutex> lock(mu_);
      cv_empty_.wait(lock, [this] { return !queue_.empty() || stop_; });
      if (stop_ && queue_.empty()) return;
      b = std::move(queue_.front());
      queue_.pop_front();
    }
    cv_full_.notify_one();
    std::memcpy(image, b.image_u8.data(), b.image_u8.size());
    std::memcpy(depth_gt, b.depth_gt.data(), b.depth_gt.size() * 4);
    std::memcpy(depth_mask, b.depth_mask_u8.data(), b.depth_mask_u8.size());
    std::memcpy(albedo_gt, b.albedo_gt_u8.data(), b.albedo_gt_u8.size());
    std::memcpy(face_mask, b.face_mask_u8.data(), b.face_mask_u8.size());
    std::memcpy(light_gt, b.light_gt.data(), b.light_gt.size() * 4);
  }

 private:
  void Fill(Batch* b, const std::vector<int>& idx) {
    const int n = static_cast<int>(idx.size());
    b->depth_gt.resize(size_t(n) * kMap);
    b->light_gt.resize(size_t(n) * 3);
    if (raw_) {
      b->image_u8.resize(size_t(n) * kImg);
      b->depth_mask_u8.resize(size_t(n) * kMap);
      b->albedo_gt_u8.resize(size_t(n) * kMap);
      b->face_mask_u8.resize(size_t(n) * kMap);
    } else {
      b->image.resize(size_t(n) * kImg);
      b->depth_mask.resize(size_t(n) * kMap);
      b->albedo_gt.resize(size_t(n) * kMap);
      b->face_mask.resize(size_t(n) * kMap);
    }
    for (int i = 0; i < n; ++i) {
      const size_t s = idx[i];
      const uint8_t* img = image_.payload() + s * size_t(kImg);
      const uint8_t* dm = dmask_.payload() + s * size_t(kMap);
      const uint8_t* al = albedo_.payload() + s * size_t(kMap);
      const uint8_t* fm = fmask_.payload() + s * size_t(kMap);
      if (raw_) {
        std::memcpy(&b->image_u8[size_t(i) * kImg], img, kImg);
        std::memcpy(&b->depth_mask_u8[size_t(i) * kMap], dm, kMap);
        std::memcpy(&b->albedo_gt_u8[size_t(i) * kMap], al, kMap);
        std::memcpy(&b->face_mask_u8[size_t(i) * kMap], fm, kMap);
      } else {
        for (int j = 0; j < kImg; ++j)
          b->image[size_t(i) * kImg + j] = img[j] * (1.0f / 255.0f);
        for (int j = 0; j < kMap; ++j) {
          b->depth_mask[size_t(i) * kMap + j] = dm[j] * (1.0f / 255.0f);
          b->albedo_gt[size_t(i) * kMap + j] = al[j] * (1.0f / 255.0f);
          b->face_mask[size_t(i) * kMap + j] = fm[j] * (1.0f / 255.0f);
        }
      }
      std::memcpy(&b->depth_gt[size_t(i) * kMap],
                  depth_.payload() + s * size_t(kMap) * 4, size_t(kMap) * 4);
      std::memcpy(&b->light_gt[size_t(i) * 3],
                  light_.payload() + s * 12, 12);
    }
  }

  std::vector<int> SampleIndices() {
    // Reference epoch structure: contiguous batch slots in shuffled order
    // (train_*.py:578,593,606). Slot stream regenerates per epoch.
    std::lock_guard<std::mutex> lock(idx_mu_);
    if (slots_.empty()) {
      int n_slots = num_samples_ / batch_;
      slots_.resize(n_slots);
      for (int i = 0; i < n_slots; ++i) slots_[i] = i;
      std::shuffle(slots_.begin(), slots_.end(), rng_);
      cursor_ = 0;
    }
    int slot = slots_[cursor_++];
    if (cursor_ >= static_cast<int>(slots_.size())) slots_.clear();
    std::vector<int> idx(batch_);
    for (int i = 0; i < batch_; ++i) idx[i] = slot * batch_ + i;
    return idx;
  }

  void Work() {
    while (true) {
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_full_.wait(lock, [this] {
          return static_cast<int>(queue_.size()) < capacity_ || stop_;
        });
        if (stop_) return;
      }
      Batch b;
      Fill(&b, SampleIndices());
      {
        std::unique_lock<std::mutex> lock(mu_);
        if (stop_) return;
        queue_.push_back(std::move(b));
      }
      cv_empty_.notify_one();
    }
  }

  Mapped image_, depth_, dmask_, albedo_, fmask_, light_;
  int num_samples_;
  int batch_;
  int capacity_;
  bool raw_ = false;
  bool ok_ = false;

  std::mutex mu_;
  std::condition_variable cv_empty_, cv_full_;
  std::deque<Batch> queue_;
  bool stop_ = false;
  std::vector<std::thread> threads_;

  std::mutex idx_mu_;
  std::mt19937_64 rng_;
  std::vector<int> slots_;
  int cursor_ = 0;
};

}  // namespace

extern "C" {

void* gcfr_loader_create(const char* cache_dir, int num_samples, int batch,
                         uint64_t seed, int workers, int queue_capacity,
                         int raw) {
  auto* loader = new Loader(cache_dir, num_samples, batch, seed, workers,
                            queue_capacity, raw != 0);
  if (!loader->ok()) {
    delete loader;
    return nullptr;
  }
  return loader;
}

void gcfr_loader_next(void* handle, float* image, float* depth_gt,
                      float* depth_mask, float* albedo_gt, float* face_mask,
                      float* light_gt) {
  static_cast<Loader*>(handle)->Next(image, depth_gt, depth_mask, albedo_gt,
                                     face_mask, light_gt);
}

void gcfr_loader_next_raw(void* handle, uint8_t* image, float* depth_gt,
                          uint8_t* depth_mask, uint8_t* albedo_gt,
                          uint8_t* face_mask, float* light_gt) {
  static_cast<Loader*>(handle)->NextRaw(image, depth_gt, depth_mask, albedo_gt,
                                        face_mask, light_gt);
}

void gcfr_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Direct JPEG decode (libjpeg): removes the Python imageio step from the
// cache-packing path (build_cache decodes the CelebA-HQ jpgs here, threaded).
// Compiled in when <jpeglib.h> is available; gcfr_has_jpeg() reports it so
// the Python binding can fall back to imageio.
// ---------------------------------------------------------------------------

#if defined(__has_include) && !defined(GCFR_NO_JPEG)
#if __has_include(<jpeglib.h>)
#define GCFR_HAVE_JPEG 1
#endif
#endif

#ifdef GCFR_HAVE_JPEG

#include <csetjmp>
#include <cstdio>
#include <cstdlib>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jmp;
};

void JpegErrorExit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jmp, 1);
}

// Decode one JPEG file into caller-owned HWC uint8. Requires the decoded
// dimensions to match (h, w) exactly — the CelebA-HQ pipeline is fixed
// 256x256 and silent rescaling would hide dataset corruption. channels must
// be 1 (libjpeg converts to grayscale) or 3 (RGB).
int DecodeJpegFile(const char* path, uint8_t* out, int h, int w,
                   int channels) {
  if (channels != 1 && channels != 3) return 1;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 2;

  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = JpegErrorExit;
  if (setjmp(err.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 3;  // corrupt / not a JPEG
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != w ||
      static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_components) != channels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 4;  // dimension mismatch
  }
  const size_t stride = size_t(w) * channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// Encode caller-owned HWC uint8 into an in-memory JPEG (jpeg_mem_dest).
// The server answers "format": "jpeg" requests with it. channels must be
// 1 (grayscale) or 3 (RGB). *out is malloc'd by libjpeg and must be
// released with gcfr_free().
unsigned long EncodeJpegMem(const uint8_t* img, int h, int w, int channels,
                            int quality, uint8_t** out) {
  if (channels != 1 && channels != 3) return 0;
  jpeg_compress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = JpegErrorExit;
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  if (setjmp(err.jmp)) {
    jpeg_destroy_compress(&cinfo);
    if (buf) std::free(buf);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = size_t(w) * channels;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(img) +
                   size_t(cinfo.next_scanline) * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = buf;
  return size;
}

}  // namespace

extern "C" {

int gcfr_has_jpeg() { return 1; }

unsigned long gcfr_encode_jpeg(const uint8_t* img, int h, int w,
                               int channels, int quality, uint8_t** out) {
  return EncodeJpegMem(img, h, w, channels, quality, out);
}

void gcfr_free(uint8_t* p) { std::free(p); }

int gcfr_decode_jpeg(const char* path, uint8_t* out, int h, int w,
                     int channels) {
  return DecodeJpegFile(path, out, h, w, channels);
}

// Threaded batch decode into a contiguous (n, h, w, channels) buffer.
// Returns the number of failed files (their slots are zero-filled).
int gcfr_decode_jpegs(const char** paths, int n, uint8_t* out, int h, int w,
                      int channels, int workers) {
  if (workers < 1) workers = 1;
  const size_t frame = size_t(h) * w * channels;
  std::atomic<int> next(0), failures(0);
  auto work = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + size_t(i) * frame;
      if (DecodeJpegFile(paths[i], dst, h, w, channels) != 0) {
        std::memset(dst, 0, frame);
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 0; i < workers - 1; ++i) threads.emplace_back(work);
  work();
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"

#else  // !GCFR_HAVE_JPEG

extern "C" {
int gcfr_has_jpeg() { return 0; }
int gcfr_decode_jpeg(const char*, uint8_t*, int, int, int) { return -1; }
int gcfr_decode_jpegs(const char**, int, uint8_t*, int, int, int, int) {
  return -1;
}
unsigned long gcfr_encode_jpeg(const uint8_t*, int, int, int, int,
                               uint8_t**) {
  return 0;
}
void gcfr_free(uint8_t*) {}
}

#endif  // GCFR_HAVE_JPEG
