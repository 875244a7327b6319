// paddle_tpu_torch's own copy of paddle_tpu/csrc/data_feed.cc. It calls the
// port's copy of slot_parser.cc (slotp_*), which is in the same host library,
// so both packages parse the same file text into the same chunk columns.
// With one reader thread the chunks come out in file order; with more they
// come out in the order the threads finish (in both packages).
//
// Native data feed: multithreaded file -> parse -> bounded channel.
//
// TPU-build counterpart of the reference's C++ data pipeline
// (framework/data_feed.{h,cc}: DataFeed readers on worker threads
// filling paddle::framework::Channel; data_set.cc spawning one reader
// per file chunk). Reader threads pull file paths from a work queue,
// parse MultiSlot text with the slot_parser engine, and push columnar
// chunks into a capacity-bounded channel the trainer drains — IO and
// parse overlap with consumption exactly like the reference's
// channel-based feed.
//
// C ABI: dfd_create(files...) spawns the readers; dfd_next() blocks for
// the next chunk (-1 = all files done); dfd_fetch copies the current
// chunk's per-slot CSR arrays into caller buffers; dfd_release frees it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// slot_parser.cc C API (same shared library)
extern "C" {
void* slotp_create(int num_slots, const uint8_t* is_float, const uint8_t* used);
void slotp_destroy(void* p);
int64_t slotp_parse(void* p, const char* data, int64_t len);
int64_t slotp_lines(void* p);
int64_t slotp_errors(void* p);
int64_t slotp_slot_value_count(void* p, int slot);
void slotp_slot_fetch(void* p, int slot, void* values, int32_t* lengths);
void slotp_reset(void* p);
}

namespace {

struct SlotColumn {
  std::vector<uint8_t> values;  // raw bytes (f32 or u64)
  std::vector<int32_t> lengths;
  int64_t value_count = 0;
};

struct Chunk {
  int64_t lines = 0;
  std::vector<SlotColumn> cols;  // per slot (unused slots stay empty)
};

struct DataFeed {
  int num_slots = 0;
  std::vector<uint8_t> is_float, used;
  std::vector<std::string> files;
  size_t next_file = 0;
  std::mutex file_mu;

  // channel
  std::deque<std::unique_ptr<Chunk>> chan;
  size_t capacity = 8;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  int active_readers = 0;
  std::atomic<int64_t> errors{0};
  std::atomic<bool> stopping{false};
  std::vector<std::thread> threads;

  std::unique_ptr<Chunk> current;

  ~DataFeed() {
    stopping.store(true);
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : threads)
      if (t.joinable()) t.join();
  }

  bool pop_file(std::string* out) {
    std::lock_guard<std::mutex> g(file_mu);
    if (next_file >= files.size()) return false;
    *out = files[next_file++];
    return true;
  }

  void push_chunk(std::unique_ptr<Chunk> c) {
    std::unique_lock<std::mutex> lk(mu);
    cv_push.wait(lk, [&] { return chan.size() < capacity || stopping.load(); });
    if (stopping.load()) return;
    chan.push_back(std::move(c));
    cv_pop.notify_one();
  }

  void reader_main() {
    void* parser = slotp_create(num_slots, is_float.data(), used.data());
    std::string path;
    std::vector<char> buf;
    while (!stopping.load() && pop_file(&path)) {
      FILE* f = std::fopen(path.c_str(), "rb");
      if (!f) {
        errors.fetch_add(1);
        continue;
      }
      std::fseek(f, 0, SEEK_END);
      long sz = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      buf.resize(sz > 0 ? static_cast<size_t>(sz) : 0);
      if (sz > 0 && std::fread(buf.data(), 1, sz, f) != static_cast<size_t>(sz)) {
        errors.fetch_add(1);
        std::fclose(f);
        continue;
      }
      std::fclose(f);
      slotp_parse(parser, buf.data(), static_cast<int64_t>(buf.size()));
      errors.fetch_add(slotp_errors(parser));
      auto chunk = std::make_unique<Chunk>();
      chunk->lines = slotp_lines(parser);
      chunk->cols.resize(num_slots);
      for (int s = 0; s < num_slots; ++s) {
        if (!used[s]) continue;
        SlotColumn& col = chunk->cols[s];
        col.value_count = slotp_slot_value_count(parser, s);
        size_t elem = is_float[s] ? 4 : 8;
        col.values.resize(col.value_count * elem);
        col.lengths.resize(chunk->lines);
        slotp_slot_fetch(parser, s, col.values.data(), col.lengths.data());
      }
      slotp_reset(parser);
      if (chunk->lines) push_chunk(std::move(chunk));
    }
    slotp_destroy(parser);
    std::lock_guard<std::mutex> g(mu);
    if (--active_readers == 0) cv_pop.notify_all();
  }

  // blocks until a chunk is available or all readers finished.
  // returns lines, or -1 when the feed is exhausted.
  int64_t next() {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] {
      return !chan.empty() || active_readers == 0 || stopping.load();
    });
    if (chan.empty()) return -1;
    current = std::move(chan.front());
    chan.pop_front();
    cv_push.notify_one();
    return current->lines;
  }
};

}  // namespace

extern "C" {

// files: newline-joined paths. Spawns num_threads readers immediately.
void* dfd_create(int num_slots, const uint8_t* is_float, const uint8_t* used,
                 const char* files_joined, int num_threads, int capacity) {
  DataFeed* d = new DataFeed();
  d->num_slots = num_slots;
  d->is_float.assign(is_float, is_float + num_slots);
  d->used.assign(used, used + num_slots);
  d->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 8;
  const char* p = files_joined;
  while (p && *p) {
    const char* nl = std::strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
    if (len) d->files.emplace_back(p, len);
    p = nl ? nl + 1 : nullptr;
  }
  if (d->files.empty()) {
    d->active_readers = 0;  // immediately drained
    return d;
  }
  int nt = num_threads > 0 ? num_threads : 1;
  if (static_cast<size_t>(nt) > d->files.size())
    nt = static_cast<int>(d->files.size());
  d->active_readers = nt;
  for (int i = 0; i < nt; ++i)
    d->threads.emplace_back([d]() { d->reader_main(); });
  return d;
}

void dfd_destroy(void* h) { delete static_cast<DataFeed*>(h); }

int64_t dfd_next(void* h) { return static_cast<DataFeed*>(h)->next(); }

int64_t dfd_value_count(void* h, int slot) {
  DataFeed* d = static_cast<DataFeed*>(h);
  return d->current ? d->current->cols[slot].value_count : 0;
}

void dfd_fetch(void* h, int slot, void* values, int32_t* lengths) {
  DataFeed* d = static_cast<DataFeed*>(h);
  if (!d->current) return;
  SlotColumn& col = d->current->cols[slot];
  if (!col.values.empty())
    std::memcpy(values, col.values.data(), col.values.size());
  if (!col.lengths.empty())
    std::memcpy(lengths, col.lengths.data(), col.lengths.size() * 4);
}

void dfd_release(void* h) { static_cast<DataFeed*>(h)->current.reset(); }

int64_t dfd_errors(void* h) {
  return static_cast<DataFeed*>(h)->errors.load();
}

}  // extern "C"
