// Feasign index: batched open-addressing hash map uint64 key -> int32 row.
//
// paddle_tpu_torch's own copy of paddle_tpu/csrc/sparse_index.cc. The
// dedup order of ps_dedup_u64 fixes the cache row ids of a pass, so the
// two copies must stay identical in behaviour.
//
// Native core of the host-side sparse tables — the TPU-build counterpart
// of the reference's SparseTableShard hash maps
// (paddle/fluid/distributed/ps/table/depends/feature_value.h:30) and the
// GPUPS dedup/build path (ps_gpu_wrapper.cc PreBuildTask). Row ids are
// stable handles into columnar value arrays owned by Python/numpy; rows
// freed by shrink are recycled via a free list.
//
// Batched API only (amortizes the FFI): lookup, lookup_or_insert, erase,
// plus iteration support for save/shrink. Thread-safety is the caller's
// concern — the table layer shards keys so each shard is touched by one
// thread at a time (the reference serializes per-shard via 1-thread pools).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int32_t kEmpty = -1;
constexpr int32_t kTombstone = -2;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct PsIndex {
  std::vector<uint64_t> keys;   // slot -> key (valid when state >= 0)
  std::vector<int32_t> state;   // slot -> row id | kEmpty | kTombstone
  std::vector<uint64_t> row_keys;  // row -> key
  std::vector<uint8_t> row_alive;  // row -> liveness
  std::vector<int32_t> free_rows;  // recycled rows
  uint64_t mask = 0;
  int64_t used = 0;       // live entries
  int64_t occupied = 0;   // live + tombstones

  explicit PsIndex(uint64_t capacity_hint) {
    uint64_t cap = 64;
    while (cap < capacity_hint * 2) cap <<= 1;
    keys.assign(cap, 0);
    state.assign(cap, kEmpty);
    mask = cap - 1;
  }

  void grow() {
    std::vector<uint64_t> old_keys(std::move(keys));
    std::vector<int32_t> old_state(std::move(state));
    uint64_t cap = (mask + 1) << 1;
    keys.assign(cap, 0);
    state.assign(cap, kEmpty);
    mask = cap - 1;
    occupied = 0;
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_state[i] >= 0) {
        uint64_t h = splitmix64(old_keys[i]) & mask;
        while (state[h] != kEmpty) h = (h + 1) & mask;
        keys[h] = old_keys[i];
        state[h] = old_state[i];
        ++occupied;
      }
    }
  }

  inline int32_t find(uint64_t key) const {
    uint64_t h = splitmix64(key) & mask;
    while (true) {
      int32_t s = state[h];
      if (s == kEmpty) return kEmpty;
      if (s != kTombstone && keys[h] == key) return s;
      h = (h + 1) & mask;
    }
  }

  inline int32_t insert(uint64_t key) {
    if ((occupied + 1) * 10 >= static_cast<int64_t>(mask + 1) * 7) grow();
    uint64_t h = splitmix64(key) & mask;
    int64_t first_tomb = -1;
    while (true) {
      int32_t s = state[h];
      if (s == kEmpty) break;
      if (s == kTombstone) {
        if (first_tomb < 0) first_tomb = static_cast<int64_t>(h);
      } else if (keys[h] == key) {
        return s;  // already present
      }
      h = (h + 1) & mask;
    }
    int32_t row;
    if (!free_rows.empty()) {
      row = free_rows.back();
      free_rows.pop_back();
      row_keys[row] = key;
      row_alive[row] = 1;
    } else {
      row = static_cast<int32_t>(row_keys.size());
      row_keys.push_back(key);
      row_alive.push_back(1);
    }
    uint64_t slot = first_tomb >= 0 ? static_cast<uint64_t>(first_tomb) : h;
    if (first_tomb < 0) ++occupied;  // tombstone reuse doesn't add occupancy
    keys[slot] = key;
    state[slot] = row;
    ++used;
    return row;
  }

  inline bool erase(uint64_t key) {
    uint64_t h = splitmix64(key) & mask;
    while (true) {
      int32_t s = state[h];
      if (s == kEmpty) return false;
      if (s != kTombstone && keys[h] == key) {
        state[h] = kTombstone;
        row_alive[s] = 0;
        free_rows.push_back(s);
        --used;
        return true;
      }
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

void* psidx_create(uint64_t capacity_hint) { return new PsIndex(capacity_hint); }

void psidx_destroy(void* p) { delete static_cast<PsIndex*>(p); }

int64_t psidx_size(void* p) { return static_cast<PsIndex*>(p)->used; }

int64_t psidx_row_capacity(void* p) {
  return static_cast<int64_t>(static_cast<PsIndex*>(p)->row_keys.size());
}

void psidx_lookup(void* p, const uint64_t* keys, int64_t n, int32_t* rows) {
  PsIndex* idx = static_cast<PsIndex*>(p);
  for (int64_t i = 0; i < n; ++i) rows[i] = idx->find(keys[i]);
}

// Parallel read-only lookup (find() never mutates): the serving-path hot
// call — one batch of B*S feasigns per train step. Thread count is the
// caller's choice; chunks are contiguous so writes to rows[] never share
// cache lines across threads beyond the two boundary lines.
void psidx_lookup_mt(void* p, const uint64_t* keys, int64_t n, int32_t* rows,
                     int32_t n_threads) {
  PsIndex* idx = static_cast<PsIndex*>(p);
  if (n_threads <= 1 || n < (int64_t)1 << 14) {
    for (int64_t i = 0; i < n; ++i) rows[i] = idx->find(keys[i]);
    return;
  }
  int64_t nt = std::min<int64_t>(n_threads, 64);
  int64_t chunk = (n + nt - 1) / nt;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int64_t t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([idx, keys, rows, lo, hi] {
      for (int64_t i = lo; i < hi; ++i) rows[i] = idx->find(keys[i]);
    });
  }
  for (auto& th : threads) th.join();
}

// Returns the number of newly created rows; rows[] receives one row id per
// key (insert-on-miss — memory_sparse_table.cc:443 pull semantics).
int64_t psidx_lookup_or_insert(void* p, const uint64_t* keys, int64_t n,
                               int32_t* rows) {
  PsIndex* idx = static_cast<PsIndex*>(p);
  int64_t before = idx->used;
  for (int64_t i = 0; i < n; ++i) rows[i] = idx->insert(keys[i]);
  return idx->used - before;
}

void psidx_erase(void* p, const uint64_t* keys, int64_t n) {
  PsIndex* idx = static_cast<PsIndex*>(p);
  for (int64_t i = 0; i < n; ++i) idx->erase(keys[i]);
}

// Parallel feasign dedup — the reference's 16-thread PreBuildTask shard
// dedup (ps_gpu_wrapper.cc:92): hash-partition the input into buckets,
// dedup each bucket with a local open-addressing set, concatenate.
// Output order is deterministic (bucket-major, first-seen within each
// bucket) but NOT sorted; callers that need sorted order sort the
// (much smaller) unique set afterwards. Returns the unique count;
// `out` must hold up to n entries.
int64_t ps_dedup_u64(const uint64_t* keys, int64_t n, uint64_t* out,
                     int32_t n_threads) {
  if (n <= 0) return 0;
  int64_t nt = std::max<int64_t>(1, std::min<int64_t>(n_threads, 64));
  if (n < (int64_t)1 << 15) nt = 1;
  // Buckets: sized so each bucket's dedup set stays cache-resident
  // (~64k keys/bucket), independent of thread count; threads just pick
  // buckets off a shared counter.
  uint64_t nb = 1;
  while (nb < static_cast<uint64_t>(n >> 16) && nb < 4096) nb <<= 1;
  while (nb < static_cast<uint64_t>(nt) * 4) nb <<= 1;
  int shift = 64 - __builtin_ctzll(nb);

  // Pass 1: per-(thread, bucket) counts over contiguous input chunks.
  int64_t chunk = (n + nt - 1) / nt;
  std::vector<std::vector<int64_t>> counts(nt, std::vector<int64_t>(nb, 0));
  {
    std::vector<std::thread> ths;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      ths.emplace_back([&, t, lo, hi] {
        auto& c = counts[t];
        for (int64_t i = lo; i < hi; ++i)
          ++c[splitmix64(keys[i]) >> shift];
      });
    }
    for (auto& th : ths) th.join();
  }

  // Offsets: bucket-major, thread order within a bucket (keeps first-seen
  // order deterministic and equal to sequential order within a bucket).
  std::vector<int64_t> bucket_start(nb + 1, 0);
  for (uint64_t b = 0; b < nb; ++b) {
    int64_t s = 0;
    for (int64_t t = 0; t < nt; ++t) s += counts[t][b];
    bucket_start[b + 1] = bucket_start[b] + s;
  }
  std::vector<std::vector<int64_t>> cursor(nt, std::vector<int64_t>(nb));
  for (uint64_t b = 0; b < nb; ++b) {
    int64_t pos = bucket_start[b];
    for (int64_t t = 0; t < nt; ++t) {
      cursor[t][b] = pos;
      pos += counts[t][b];
    }
  }

  // Pass 2: scatter into bucket-contiguous scratch.
  std::vector<uint64_t> part(n);
  {
    std::vector<std::thread> ths;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      ths.emplace_back([&, t, lo, hi] {
        auto& cur = cursor[t];
        for (int64_t i = lo; i < hi; ++i) {
          uint64_t b = splitmix64(keys[i]) >> shift;
          part[cur[b]++] = keys[i];
        }
      });
    }
    for (auto& th : ths) th.join();
  }

  // Pass 3: per-bucket dedup (parallel over buckets) into thread-local
  // vectors, then compact into `out`.
  std::vector<std::vector<uint64_t>> uniq(nb);
  {
    std::vector<std::thread> ths;
    std::atomic<uint64_t> next{0};
    for (int64_t t = 0; t < nt; ++t) {
      ths.emplace_back([&] {
        for (uint64_t b; (b = next.fetch_add(1)) < nb;) {
          int64_t lo = bucket_start[b], hi = bucket_start[b + 1];
          int64_t m = hi - lo;
          if (m == 0) continue;
          uint64_t cap = 64;
          while (static_cast<int64_t>(cap) < m * 2) cap <<= 1;
          std::vector<uint64_t> set_keys(cap, 0);
          std::vector<uint8_t> set_used(cap, 0);
          uint64_t mask = cap - 1;
          auto& u = uniq[b];
          u.reserve(m);
          for (int64_t i = lo; i < hi; ++i) {
            uint64_t k = part[i];
            uint64_t h = splitmix64(k * 0x9e3779b97f4a7c15ULL + 1) & mask;
            bool seen = false;
            while (set_used[h]) {
              if (set_keys[h] == k) { seen = true; break; }
              h = (h + 1) & mask;
            }
            if (!seen) {
              set_used[h] = 1;
              set_keys[h] = k;
              u.push_back(k);
            }
          }
        }
      });
    }
    for (auto& th : ths) th.join();
  }
  std::vector<int64_t> out_start(nb + 1, 0);
  for (uint64_t b = 0; b < nb; ++b)
    out_start[b + 1] = out_start[b] + static_cast<int64_t>(uniq[b].size());
  {
    std::vector<std::thread> ths;
    std::atomic<uint64_t> next{0};
    for (int64_t t = 0; t < nt; ++t) {
      ths.emplace_back([&] {
        for (uint64_t b; (b = next.fetch_add(1)) < nb;) {
          if (!uniq[b].empty())
            std::memcpy(out + out_start[b], uniq[b].data(),
                        uniq[b].size() * sizeof(uint64_t));
        }
      });
    }
    for (auto& th : ths) th.join();
  }
  return out_start[nb];
}

// Dump all live (key, row) pairs; buffers must hold psidx_size entries.
void psidx_items(void* p, uint64_t* out_keys, int32_t* out_rows) {
  PsIndex* idx = static_cast<PsIndex*>(p);
  int64_t j = 0;
  for (size_t r = 0; r < idx->row_keys.size(); ++r) {
    if (idx->row_alive[r]) {
      out_keys[j] = idx->row_keys[r];
      out_rows[j] = static_cast<int32_t>(r);
      ++j;
    }
  }
}

}  // extern "C"
