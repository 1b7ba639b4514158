// Dependency engine: async host-task scheduler with versioned read/write
// variable dependencies.
//
// Native analog of the reference engine layer (include/mxnet/engine.h:44-318,
// src/engine/threaded_engine.{h,cc}, threaded_engine_perdevice.cc). On TPU the
// *compute* path is scheduled by PJRT/XLA async streams, so this engine serves
// the host side the way the reference's serves CPU ops: IO prefetch, decode
// workers, checkpoint writers, host callbacks — anything that must overlap
// with device execution while preserving read/write ordering per variable.
//
// Semantics preserved from the reference:
//  - per-var FIFO dependency queues with read (shared) / write (exclusive)
//    modes (ThreadedVar::AppendReadDependency / AppendWriteDependency,
//    threaded_engine.h:120-229)
//  - async push returns immediately; WaitForVar/WaitForAll sync points
//  - exceptions captured per task and rethrown at sync points
//    (threaded_engine.cc:422-427)
//
// Per-device lanes (the ThreadedEnginePerDevice analog,
// threaded_engine_perdevice.cc): tasks carry (device_id, lane, priority);
// each (device, lane) gets its own worker pool so copy traffic and
// prioritized host work never queue behind bulk decode (FnProperty::kCopyTo/
// FromGPU, kCPUPrioritized semantics). Priority orders dispatch within a
// pool (engine.h Push(priority) hint). Lane/device 0 is the default shared
// pool — the plain ThreadedEngine behavior.
//
// Built as a plain C ABI for ctypes (no pybind11 in this image).
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using TaskFn = void (*)(void*);

struct Task;

// One scheduling variable: a FIFO of pending operations. An op may run when it
// reaches the front window of every var it touches (readers share, writers
// exclusive) — the reference's ThreadedVar queue discipline.
struct Var {
  std::deque<Task*> queue;   // pending ops touching this var (FIFO)
  int active_readers = 0;    // ops currently running that read this var
  bool writer_active = false;
};

struct Task {
  TaskFn fn = nullptr;
  void* arg = nullptr;
  std::vector<int64_t> reads, writes;
  std::atomic<int> wait_count{0};  // vars not yet granting this task
  int device = 0;                  // pool routing (perdevice semantics)
  int lane = 0;                    // 0 normal, 1 copy, 2 prioritized
  int priority = 0;                // dispatch order hint within a pool
};

class Engine {
 public:
  explicit Engine(int num_workers) : stop_(false), pending_(0),
                                     num_workers_(num_workers < 1 ? 1
                                                                  : num_workers) {
    GetPool(0, 0);  // default shared pool
  }

  ~Engine() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      for (auto& kv : pools_) kv.second->cv.notify_all();
    }
    for (auto& kv : pools_)
      for (auto& t : kv.second->threads) t.join();
    for (auto& kv : vars_) delete kv.second;
  }

  int64_t NewVar() {
    std::unique_lock<std::mutex> lk(mu_);
    int64_t id = next_var_++;
    vars_[id] = new Var();
    return id;
  }

  void Push(TaskFn fn, void* arg, const int64_t* reads, int n_reads,
            const int64_t* writes, int n_writes, int device = 0, int lane = 0,
            int priority = 0) {
    auto* task = new Task();
    task->fn = fn;
    task->arg = arg;
    task->reads.assign(reads, reads + n_reads);
    task->writes.assign(writes, writes + n_writes);
    task->device = device;
    task->lane = lane;
    task->priority = priority;
    std::unique_lock<std::mutex> lk(mu_);
    ++pushed_;  // under mu_: Stats snapshots pushed == completed + pending
    GetPool(device, lane);  // spin the pool up before work can be granted
    ++pending_;
    int ndeps = static_cast<int>(task->reads.size() + task->writes.size());
    if (ndeps == 0) {
      // no dependencies: runnable immediately (GrantOne only fires from a
      // var's queue, so dep-free tasks must enter the ready queue here)
      Enqueue(task);
      return;
    }
    int grants = 0;
    for (int64_t v : task->reads) vars_.at(v)->queue.push_back(task);
    for (int64_t v : task->writes) vars_.at(v)->queue.push_back(task);
    task->wait_count.store(ndeps);
    // try to grant from each var's queue front
    for (int64_t v : task->reads) grants += TryGrant(v);
    for (int64_t v : task->writes) grants += TryGrant(v);
    (void)grants;
  }

  void WaitForVar(int64_t var) {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] {
      Var* v = vars_.at(var);
      return v->queue.empty() && v->active_readers == 0 && !v->writer_active;
    });
    RethrowIfError();
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return pending_ == 0; });
    RethrowIfError();
  }

  const char* LastError() {
    std::unique_lock<std::mutex> lk(mu_);
    return error_.empty() ? nullptr : error_.c_str();
  }

  void ClearError() {
    std::unique_lock<std::mutex> lk(mu_);
    error_.clear();
  }

 private:
  // Grant rules (caller holds mu_): the front of a var's queue runs if
  //  - it's a reader and no writer is active, joining current readers; or
  //  - it's a writer and the var is fully idle.
  // Consecutive readers at the front all get granted (shared access).
  int TryGrant(int64_t vid) {
    Var* v = vars_.at(vid);
    int granted = 0;
    while (!v->queue.empty()) {
      Task* t = v->queue.front();
      bool is_writer = false;
      for (int64_t w : t->writes)
        if (w == vid) { is_writer = true; break; }
      if (is_writer) {
        if (v->active_readers > 0 || v->writer_active) break;
        v->writer_active = true;
        v->queue.pop_front();
        GrantOne(t);
        ++granted;
        break;  // exclusive: nothing else may start on this var
      } else {
        if (v->writer_active) break;
        ++v->active_readers;
        v->queue.pop_front();
        GrantOne(t);
        ++granted;
        // keep granting further readers at the front
      }
    }
    return granted;
  }

  // One worker pool per (device, lane) — perdevice isolation. Guarded by mu_.
  struct Pool {
    // higher priority first; equal keys keep insertion (FIFO) order
    std::multimap<int, Task*, std::greater<int>> ready;
    std::condition_variable cv;
    std::vector<std::thread> threads;
  };

  Pool* GetPool(int device, int lane) {
    auto key = std::make_pair(device, lane);
    auto it = pools_.find(key);
    if (it != pools_.end()) return it->second.get();
    auto pool = std::make_unique<Pool>();
    Pool* p = pool.get();
    // copy lanes get a small dedicated pool (kCopyFromGPU discipline);
    // normal/priority lanes get the full width
    int n = (lane == 1) ? 2 : num_workers_;
    for (int i = 0; i < n; ++i)
      p->threads.emplace_back([this, p] { WorkerLoop(p); });
    pools_[key] = std::move(pool);
    return p;
  }

  void Enqueue(Task* t) {
    Pool* p = GetPool(t->device, t->lane);
    p->ready.emplace(t->priority, t);
    p->cv.notify_one();
  }

  void GrantOne(Task* t) {
    if (t->wait_count.fetch_sub(1) == 1) Enqueue(t);
  }

  void CompleteTask(Task* t) {
    std::unique_lock<std::mutex> lk(mu_);
    for (int64_t vid : t->reads) {
      Var* v = vars_.at(vid);
      --v->active_readers;
      TryGrant(vid);
    }
    for (int64_t vid : t->writes) {
      Var* v = vars_.at(vid);
      v->writer_active = false;
      TryGrant(vid);
    }
    --pending_;
    ++completed_;
    done_cv_.notify_all();
    delete t;
  }

  void WorkerLoop(Pool* pool) {
    for (;;) {
      Task* t = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        pool->cv.wait(lk, [&] { return stop_ || !pool->ready.empty(); });
        if (stop_ && pool->ready.empty()) return;
        auto it = pool->ready.begin();
        t = it->second;
        pool->ready.erase(it);
      }
      // run outside the lock; capture failures for sync-point rethrow
      // (threaded_engine.cc:422-427 exception propagation)
      bool ok = true;
      if (t->fn) {
        // C callbacks can't throw C++ exceptions across the ABI; they signal
        // failure via mxtpu_engine_set_error instead.
        t->fn(t->arg);
        (void)ok;
      }
      CompleteTask(t);
    }
  }

  void RethrowIfError() {}  // error surfaced via LastError to Python

  std::mutex mu_;
  std::condition_variable done_cv_;
  std::map<std::pair<int, int>, std::unique_ptr<Pool>> pools_;
  std::unordered_map<int64_t, Var*> vars_;
  int64_t next_var_ = 1;
  bool stop_;
  int64_t pending_;
  int64_t pushed_ = 0;     // guarded by mu_ (consistent Stats snapshots)
  int64_t completed_ = 0;  // guarded by mu_
  int num_workers_;
  std::string error_;

 public:
  // debug counters (the reference engine's verbose/debug accounting,
  // MXNET_ENGINE_DEBUG): pushed / completed totals + live pending gauge
  void Stats(int64_t* out) {
    std::unique_lock<std::mutex> lk(mu_);
    out[0] = pushed_;
    out[1] = completed_;
    out[2] = pending_;
    out[3] = static_cast<int64_t>(pools_.size());
  }

  void SetError(const char* msg) {
    std::unique_lock<std::mutex> lk(mu_);
    if (error_.empty()) error_ = msg ? msg : "unknown error";
  }
};

}  // namespace

extern "C" {

void* mxtpu_engine_create(int num_workers) { return new Engine(num_workers); }

void mxtpu_engine_destroy(void* e) { delete static_cast<Engine*>(e); }

int64_t mxtpu_engine_new_var(void* e) {
  return static_cast<Engine*>(e)->NewVar();
}

void mxtpu_engine_push(void* e, void (*fn)(void*), void* arg,
                       const int64_t* reads, int n_reads,
                       const int64_t* writes, int n_writes) {
  static_cast<Engine*>(e)->Push(fn, arg, reads, n_reads, writes, n_writes);
}

// perdevice push: route to the (device, lane) pool with a priority hint
// (lane: 0 normal, 1 copy, 2 prioritized — FnProperty analog)
void mxtpu_engine_push_ex(void* e, void (*fn)(void*), void* arg,
                          const int64_t* reads, int n_reads,
                          const int64_t* writes, int n_writes, int device,
                          int lane, int priority) {
  static_cast<Engine*>(e)->Push(fn, arg, reads, n_reads, writes, n_writes,
                                device, lane, priority);
}

void mxtpu_engine_wait_for_var(void* e, int64_t var) {
  static_cast<Engine*>(e)->WaitForVar(var);
}

void mxtpu_engine_wait_all(void* e) { static_cast<Engine*>(e)->WaitAll(); }

void mxtpu_engine_stats(void* e, int64_t* out) {
  static_cast<Engine*>(e)->Stats(out);
}

const char* mxtpu_engine_last_error(void* e) {
  return static_cast<Engine*>(e)->LastError();
}

void mxtpu_engine_clear_error(void* e) {
  static_cast<Engine*>(e)->ClearError();
}

void mxtpu_engine_set_error(void* e, const char* msg) {
  static_cast<Engine*>(e)->SetError(msg);
}

}  // extern "C"
