// Threaded image-recordio pipeline: decode -> augment -> batch -> prefetch.
//
// Native analog of the reference's ImageRecordIter stack
// (src/io/iter_image_recordio_2.cc decode/augment threads,
// iter_batchloader.h batching, iter_prefetcher.h double buffering,
// image_aug_default.cc augmenters). Decode uses OpenCV (the reference's
// decoder too); batches are produced into caller-provided float buffers by a
// background thread pool so host IO overlaps device steps.
//
// Record payload layout follows the reference's im2rec IRHeader:
//   u32 flag | f32 label | u64 id | u64 id2 | (flag>1: f32 label[flag]) | jpeg
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include <algorithm>

extern "C" {
void* mxtpu_recio_reader_open(const char* path);
int64_t mxtpu_recio_read(void* vr, const char** out);
void mxtpu_recio_seek(void* vr, int64_t offset);
int64_t mxtpu_recio_tell(void* vr);
void mxtpu_recio_reader_close(void* vr);
}

namespace {

struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id, id2;
};

struct Config {
  int batch = 0, c = 3, h = 224, w = 224;
  int shuffle = 0, num_threads = 4, rand_mirror = 0, rand_crop = 0;
  int label_width = 1;
  int seed = 0;
  int prefetch = 4;
  float mean[3] = {0, 0, 0};
  float std[3] = {1, 1, 1};
};

struct Batch {
  std::vector<float> data, label;
  int n = 0;
};

class Pipeline {
 public:
  Pipeline(const char* rec_path, const Config& cfg)
      : cfg_(cfg), rng_(cfg.seed),
        queue_depth_(static_cast<size_t>(std::max(1, cfg.prefetch))) {
    // index pass: record offsets for shuffling/epoch resets
    void* r = mxtpu_recio_reader_open(rec_path);
    if (!r) { failed_ = true; return; }
    path_ = rec_path;
    const char* p;
    for (;;) {
      int64_t off_candidate = mxtpu_recio_tell(r);
      int64_t len = mxtpu_recio_read(r, &p);
      if (len < 0) break;
      offsets_.push_back(off_candidate);
    }
    mxtpu_recio_reader_close(r);
    Reset();
  }

  ~Pipeline() { StopWorkers(); }

  void Reset() {
    StopWorkers();
    order_.resize(offsets_.size());
    for (size_t i = 0; i < order_.size(); ++i) order_[i] = i;
    if (cfg_.shuffle) {
      std::shuffle(order_.begin(), order_.end(), rng_);
    }
    cursor_ = 0;
    next_out_ = 0;
    epoch_done_ = false;
    StartWorkers();
  }

  // fill caller buffers; returns #valid samples, 0 when epoch exhausted.
  // Batches are delivered in record order (keyed by batch index) so that
  // shuffle=false iteration is deterministic and matches the .lst/.idx order
  // like the reference iterator.
  int Next(float* data_out, float* label_out) {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      out_cv_.wait(lk, [&] {
        return batches_.count(next_out_) ||
               (workers_done_ == static_cast<int>(threads_.size()) &&
                batches_.empty());
      });
      auto it = batches_.find(next_out_);
      if (it == batches_.end()) return 0;
      Batch b = std::move(it->second);
      batches_.erase(it);
      ++next_out_;
      in_cv_.notify_all();
      if (b.n == 0) continue;  // whole batch failed to decode: skip
      lk.unlock();
      std::memcpy(data_out, b.data.data(), b.data.size() * sizeof(float));
      std::memcpy(label_out, b.label.data(), b.label.size() * sizeof(float));
      return b.n;
    }
  }

  bool failed() const { return failed_; }

 private:

  void StartWorkers() {
    stop_ = false;
    workers_done_ = 0;
    int n = std::max(1, cfg_.num_threads);
    for (int i = 0; i < n; ++i)
      threads_.emplace_back([this] { WorkerLoop(); });
  }

  void StopWorkers() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      in_cv_.notify_all();
      out_cv_.notify_all();
    }
    for (auto& t : threads_) t.join();
    threads_.clear();
    batches_.clear();
  }

  // each worker claims a contiguous range of `batch` records, opens its own
  // reader, decodes+augments, enqueues the finished batch (bounded queue)
  void WorkerLoop() {
    void* r = mxtpu_recio_reader_open(path_.c_str());
    std::mt19937 rng(cfg_.seed ^ std::hash<std::thread::id>()(
        std::this_thread::get_id()));
    for (;;) {
      size_t start, batch_idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (stop_ || cursor_ >= order_.size()) break;
        start = cursor_;
        batch_idx = cursor_ / cfg_.batch;
        cursor_ += cfg_.batch;
      }
      size_t end = std::min(start + cfg_.batch, order_.size());
      Batch b;
      b.data.assign(static_cast<size_t>(cfg_.batch) * cfg_.c * cfg_.h * cfg_.w,
                    0.f);
      b.label.assign(static_cast<size_t>(cfg_.batch) * cfg_.label_width, 0.f);
      b.n = 0;
      const char* payload;
      for (size_t i = start; i < end; ++i) {
        mxtpu_recio_seek(r, offsets_[order_[i]]);
        int64_t len = mxtpu_recio_read(r, &payload);
        if (len < static_cast<int64_t>(sizeof(IRHeader))) continue;
        IRHeader hdr;
        std::memcpy(&hdr, payload, sizeof(hdr));
        const char* img = payload + sizeof(hdr);
        int64_t img_len = len - sizeof(hdr);
        float* lab = b.label.data() +
                     static_cast<size_t>(b.n) * cfg_.label_width;
        if (hdr.flag > 1) {
          int64_t lab_bytes = static_cast<int64_t>(hdr.flag) * 4;
          if (img_len < lab_bytes) continue;  // truncated multi-label record
          int nl = std::min<int>(hdr.flag, cfg_.label_width);
          std::memcpy(lab, img, nl * 4);
          img += lab_bytes;
          img_len -= lab_bytes;
        } else {
          lab[0] = hdr.label;
        }
        if (!Decode(img, img_len, rng,
                    b.data.data() +
                        static_cast<size_t>(b.n) * cfg_.c * cfg_.h * cfg_.w))
          continue;
        ++b.n;
      }
      {
        std::unique_lock<std::mutex> lk(mu_);
        // Admission by delivery order, not raw queue size: a size-based bound
        // deadlocks when out-of-order batches fill the queue while the
        // consumer waits for next_out_ and the worker holding it blocks here.
        // The window guarantees the in-order batch is always admissible.
        in_cv_.wait(lk, [&] {
          return stop_ || batch_idx < next_out_ + queue_depth_;
        });
        if (stop_) break;
        // Emplace even when every record failed to decode (b.n == 0): Next()
        // skips empty batches but must still see this index to advance
        // next_out_, otherwise it waits forever on the gap.
        batches_.emplace(batch_idx, std::move(b));
        out_cv_.notify_all();
      }
    }
    mxtpu_recio_reader_close(r);
    std::unique_lock<std::mutex> lk(mu_);
    ++workers_done_;
    out_cv_.notify_all();
  }

  // decode + resize/crop + mirror + normalize into CHW float
  bool Decode(const char* bytes, int64_t len, std::mt19937& rng, float* out) {
    if (len <= 0) return false;
    cv::Mat raw(1, static_cast<int>(len), CV_8UC1,
                const_cast<char*>(bytes));
    cv::Mat img = cv::imdecode(raw, cfg_.c == 1 ? cv::IMREAD_GRAYSCALE
                                                : cv::IMREAD_COLOR);
    if (img.empty()) return false;
    if (cfg_.c == 3) cv::cvtColor(img, img, cv::COLOR_BGR2RGB);
    // resize shorter side then center/random crop (image_aug_default.cc)
    float scale = std::max(cfg_.w / static_cast<float>(img.cols),
                           cfg_.h / static_cast<float>(img.rows));
    cv::resize(img, img, cv::Size(std::max(cfg_.w, static_cast<int>(
                                               img.cols * scale + 0.5f)),
                                  std::max(cfg_.h, static_cast<int>(
                                               img.rows * scale + 0.5f))));
    int max_x = img.cols - cfg_.w, max_y = img.rows - cfg_.h;
    int x0 = max_x / 2, y0 = max_y / 2;
    if (cfg_.rand_crop && max_x >= 0 && max_y >= 0) {
      x0 = max_x ? static_cast<int>(rng() % (max_x + 1)) : 0;
      y0 = max_y ? static_cast<int>(rng() % (max_y + 1)) : 0;
    }
    cv::Mat crop = img(cv::Rect(x0, y0, cfg_.w, cfg_.h));
    if (cfg_.rand_mirror && (rng() & 1)) cv::flip(crop, crop, 1);
    // HWC u8 -> CHW float with mean/std
    for (int ch = 0; ch < cfg_.c; ++ch) {
      float m = cfg_.mean[ch % 3], s = cfg_.std[ch % 3];
      float* dst = out + static_cast<size_t>(ch) * cfg_.h * cfg_.w;
      for (int y = 0; y < cfg_.h; ++y) {
        const uint8_t* row = crop.ptr<uint8_t>(y);
        for (int x = 0; x < cfg_.w; ++x)
          dst[y * cfg_.w + x] = (row[x * cfg_.c + ch] - m) / s;
      }
    }
    return true;
  }

  Config cfg_;
  std::string path_;
  std::vector<int64_t> offsets_;
  std::vector<size_t> order_;
  size_t cursor_ = 0;
  std::mt19937 rng_;
  std::mutex mu_;
  std::condition_variable in_cv_, out_cv_;
  std::map<size_t, Batch> batches_;  // batch index -> batch, delivered in order
  size_t next_out_ = 0;
  size_t queue_depth_;
  std::vector<std::thread> threads_;
  bool stop_ = false, epoch_done_ = false, failed_ = false;
  int workers_done_ = 0;
};

}  // namespace

extern "C" {

void* mxtpu_impipe_create(const char* rec_path, int batch, int c, int h, int w,
                          int shuffle, int num_threads, int rand_mirror,
                          int rand_crop, const float* mean, const float* stdv,
                          int label_width, int seed, int prefetch) {
  Config cfg;
  cfg.batch = batch;
  cfg.c = c;
  cfg.h = h;
  cfg.w = w;
  cfg.shuffle = shuffle;
  cfg.num_threads = num_threads;
  cfg.rand_mirror = rand_mirror;
  cfg.rand_crop = rand_crop;
  cfg.label_width = label_width;
  cfg.seed = seed;
  cfg.prefetch = prefetch;
  if (mean) std::memcpy(cfg.mean, mean, 3 * sizeof(float));
  if (stdv) std::memcpy(cfg.std, stdv, 3 * sizeof(float));
  auto* p = new Pipeline(rec_path, cfg);
  if (p->failed()) {
    delete p;
    return nullptr;
  }
  return p;
}

int mxtpu_impipe_next(void* p, float* data_out, float* label_out) {
  return static_cast<Pipeline*>(p)->Next(data_out, label_out);
}

void mxtpu_impipe_reset(void* p) { static_cast<Pipeline*>(p)->Reset(); }

void mxtpu_impipe_destroy(void* p) { delete static_cast<Pipeline*>(p); }

}  // extern "C"
