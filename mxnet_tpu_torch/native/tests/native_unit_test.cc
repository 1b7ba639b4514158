// Native C++ unit tests for the runtime components (parity:
// tests/cpp/engine/threaded_engine_test.cc + the recordio round-trip
// checks). Plain asserts, no gtest dependency; built and executed by
// tests/test_native.py so the invariants are exercised from a clean build
// in CI just like the reference's C++ test tier.
//
// Covers, against the public C ABI of libmxtpu_native.so:
//  - write-after-write ordering on one var (serialization discipline)
//  - read concurrency + read/write exclusion (var grant discipline)
//  - diamond dependency graphs resolve in topological order
//  - WaitForVar vs WaitAll semantics under load
//  - exception capture: an op error surfaces at the sync point, then clears
//  - per-device lanes: work pushed to distinct (device, lane) pools all runs
//  - recordio writer/reader round-trip incl. seek/tell
#include <atomic>
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void* mxtpu_engine_create(int num_workers);
void mxtpu_engine_destroy(void* e);
int64_t mxtpu_engine_new_var(void* e);
void mxtpu_engine_push(void* e, void (*fn)(void*), void* arg,
                       const int64_t* reads, int n_reads,
                       const int64_t* writes, int n_writes);
void mxtpu_engine_push_ex(void* e, void (*fn)(void*), void* arg,
                          const int64_t* reads, int n_reads,
                          const int64_t* writes, int n_writes, int device,
                          int lane, int priority);
void mxtpu_engine_wait_for_var(void* e, int64_t var);
void mxtpu_engine_wait_all(void* e);
const char* mxtpu_engine_last_error(void* e);
void mxtpu_engine_clear_error(void* e);
void mxtpu_engine_set_error(void* e, const char* msg);

void* mxtpu_recio_writer_open(const char* path);
int64_t mxtpu_recio_write(void* w, const char* data, int64_t len);
void mxtpu_recio_writer_close(void* w);
void* mxtpu_recio_reader_open(const char* path);
int64_t mxtpu_recio_read(void* r, const char** out);
void mxtpu_recio_seek(void* r, int64_t offset);
int64_t mxtpu_recio_tell(void* r);
void mxtpu_recio_reader_close(void* r);
}

#define CHECK_MSG(cond, msg)                                        \
  do {                                                              \
    if (!(cond)) {                                                  \
      std::fprintf(stderr, "FAILED: %s (%s:%d)\n", msg, __FILE__,   \
                   __LINE__);                                       \
      return 1;                                                     \
    }                                                               \
  } while (0)

namespace {

struct AppendCtx {
  std::vector<int>* log;
  std::atomic<int>* running;
  std::atomic<int>* max_running;
  int id;
  int spin_us;
};

void append_op(void* arg) {
  AppendCtx* c = static_cast<AppendCtx*>(arg);
  int cur = ++*c->running;
  int prev = c->max_running->load();
  while (cur > prev && !c->max_running->compare_exchange_weak(prev, cur)) {
  }
  // busy wait to widen race windows
  for (volatile int i = 0; i < c->spin_us * 100; ++i) {
  }
  c->log->push_back(c->id);  // safe only if the engine serializes writers
  --*c->running;
}

int test_waw_ordering(void* e) {
  // 200 ops writing the same var must execute strictly in push order
  std::vector<int> log;
  std::atomic<int> running{0}, max_running{0};
  int64_t var = mxtpu_engine_new_var(e);
  std::vector<AppendCtx> ctxs(200);
  for (int i = 0; i < 200; ++i) {
    ctxs[i] = {&log, &running, &max_running, i, 2};
    mxtpu_engine_push(e, append_op, &ctxs[i], nullptr, 0, &var, 1);
  }
  mxtpu_engine_wait_for_var(e, var);
  CHECK_MSG(log.size() == 200, "all writers ran");
  for (int i = 0; i < 200; ++i) {
    CHECK_MSG(log[i] == i, "writers executed in push order");
  }
  CHECK_MSG(max_running.load() == 1, "writers never overlapped");
  return 0;
}

struct ReadCtx {
  std::atomic<int>* concurrent_reads;
  std::atomic<int>* max_concurrent;
  std::atomic<int>* done;
};

void read_op(void* arg) {
  ReadCtx* c = static_cast<ReadCtx*>(arg);
  ++*c->concurrent_reads;
  // rendezvous: hold the read slot until a peer reader overlaps (or a
  // bounded deadline passes), so observed overlap is deterministic on a
  // multi-worker engine instead of a scheduling coin-flip
  for (int spin = 0; spin < 2000000; ++spin) {
    int cur = c->concurrent_reads->load();
    int prev = c->max_concurrent->load();
    while (cur > prev &&
           !c->max_concurrent->compare_exchange_weak(prev, cur)) {
    }
    if (c->max_concurrent->load() >= 2) break;
  }
  --*c->concurrent_reads;
  ++*c->done;
}

int test_read_concurrency(void* e) {
  // many readers of one var may overlap (and with >1 worker, should)
  std::atomic<int> concurrent{0}, max_concurrent{0}, done{0};
  int64_t var = mxtpu_engine_new_var(e);
  ReadCtx ctx{&concurrent, &max_concurrent, &done};
  for (int i = 0; i < 64; ++i) {
    mxtpu_engine_push(e, read_op, &ctx, &var, 1, nullptr, 0);
  }
  mxtpu_engine_wait_all(e);
  CHECK_MSG(done.load() == 64, "all readers ran");
  CHECK_MSG(max_concurrent.load() >= 2,
            "readers overlapped on a multi-worker engine");
  return 0;
}

struct StampCtx {
  std::atomic<int>* clock;
  std::atomic<int>* stamp;  // this op's completion order
};

void stamp_op(void* arg) {
  StampCtx* c = static_cast<StampCtx*>(arg);
  c->stamp->store(++*c->clock);
}

int test_diamond_dependencies(void* e) {
  //    a
  //   / \       b,c read a's var (may run CONCURRENTLY); d reads b's and
  //  b   c      c's vars. Order must be a < b, a < c, b < d, c < d —
  //   \ /       each op gets its own atomic stamp slot, since b and c are
  //    d        legitimately unordered relative to each other.
  std::atomic<int> clock{0};
  std::atomic<int> sa{0}, sb{0}, sc{0}, sd{0};
  int64_t va = mxtpu_engine_new_var(e);
  int64_t vb = mxtpu_engine_new_var(e);
  int64_t vc = mxtpu_engine_new_var(e);
  int64_t vd = mxtpu_engine_new_var(e);
  StampCtx a{&clock, &sa}, b{&clock, &sb}, c{&clock, &sc}, d{&clock, &sd};
  mxtpu_engine_push(e, stamp_op, &a, nullptr, 0, &va, 1);
  mxtpu_engine_push(e, stamp_op, &b, &va, 1, &vb, 1);
  mxtpu_engine_push(e, stamp_op, &c, &va, 1, &vc, 1);
  int64_t bc[2] = {vb, vc};
  mxtpu_engine_push(e, stamp_op, &d, bc, 2, &vd, 1);
  mxtpu_engine_wait_for_var(e, vd);
  CHECK_MSG(sa.load() && sb.load() && sc.load() && sd.load(),
            "diamond: all four ops ran");
  CHECK_MSG(sa.load() < sb.load() && sa.load() < sc.load(),
            "diamond: a before b and c");
  CHECK_MSG(sd.load() > sb.load() && sd.load() > sc.load(),
            "diamond: d after b and c");
  return 0;
}

void failing_op(void* arg) {
  void* e = arg;
  mxtpu_engine_set_error(e, "injected failure");
}

int test_exception_at_sync(void* e) {
  int64_t var = mxtpu_engine_new_var(e);
  mxtpu_engine_push(e, failing_op, e, nullptr, 0, &var, 1);
  mxtpu_engine_wait_for_var(e, var);
  const char* err = mxtpu_engine_last_error(e);
  CHECK_MSG(err && std::strstr(err, "injected failure"),
            "error captured and visible at sync point");
  mxtpu_engine_clear_error(e);
  err = mxtpu_engine_last_error(e);
  CHECK_MSG(!err || err[0] == '\0', "error cleared");
  return 0;
}

void count_op(void* arg) {
  ++*static_cast<std::atomic<int>*>(arg);
}

int test_perdevice_lanes(void* e) {
  // push across 3 devices x 3 lanes with priorities; everything must run
  std::atomic<int> count{0};
  std::vector<int64_t> vars;
  for (int device = 0; device < 3; ++device) {
    for (int lane = 0; lane < 3; ++lane) {
      for (int i = 0; i < 10; ++i) {
        int64_t v = mxtpu_engine_new_var(e);
        vars.push_back(v);
        mxtpu_engine_push_ex(e, count_op, &count, nullptr, 0, &v, 1, device,
                             lane, i % 3 - 1);
      }
    }
  }
  mxtpu_engine_wait_all(e);
  CHECK_MSG(count.load() == 90, "all per-device-lane ops ran");
  return 0;
}

int test_recordio_roundtrip(const char* dir) {
  std::string path = std::string(dir) + "/unit.rec";
  void* w = mxtpu_recio_writer_open(path.c_str());
  CHECK_MSG(w != nullptr, "writer opened");
  std::vector<std::string> records = {"first", std::string(1000, 'x'), "",
                                      std::string("last\0with\0nuls", 14)};
  std::vector<int64_t> offsets;
  for (const auto& r : records) {
    offsets.push_back(mxtpu_recio_write(w, r.data(),
                                        static_cast<int64_t>(r.size())));
  }
  mxtpu_recio_writer_close(w);

  void* r = mxtpu_recio_reader_open(path.c_str());
  CHECK_MSG(r != nullptr, "reader opened");
  for (const auto& want : records) {
    const char* data = nullptr;
    int64_t len = mxtpu_recio_read(r, &data);
    CHECK_MSG(len == static_cast<int64_t>(want.size()), "record length");
    CHECK_MSG(std::memcmp(data, want.data(), want.size()) == 0,
              "record payload");
  }
  const char* data = nullptr;
  CHECK_MSG(mxtpu_recio_read(r, &data) < 0, "EOF after last record");
  // seek back to the second record (indexed access)
  mxtpu_recio_seek(r, offsets[1]);
  int64_t len = mxtpu_recio_read(r, &data);
  CHECK_MSG(len == 1000 && data[0] == 'x', "seek to indexed record");
  mxtpu_recio_reader_close(r);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const char* tmpdir = argc > 1 ? argv[1] : "/tmp";
  void* e = mxtpu_engine_create(4);
  int rc = 0;
  rc |= test_waw_ordering(e);
  rc |= test_read_concurrency(e);
  rc |= test_diamond_dependencies(e);
  rc |= test_exception_at_sync(e);
  rc |= test_perdevice_lanes(e);
  mxtpu_engine_destroy(e);
  rc |= test_recordio_roundtrip(tmpdir);
  if (rc == 0) std::printf("ALL NATIVE UNIT TESTS PASSED\n");
  return rc;
}
