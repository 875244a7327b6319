// Host memory allocator: auto-growth best-fit arena.
//
// The counterpart of the reference's host-side allocator stack
// (`paddle/fluid/memory/allocation/allocator_facade.h` strategy
// selection, `auto_growth_best_fit_allocator.cc`): device memory is owned
// by PyTorch's caching allocator, but the host side still wants
// malloc-free reuse for the hot per-batch buffers (data-feed batch
// assembly, channel frames, staging for host-to-device copies). Same
// shape as the reference's auto-growth strategy: grab big chunks from the
// system, carve best-fit blocks, coalesce on free, never return chunks
// until destruction.
//
// 64-byte aligned blocks (cache line / numpy-friendly). Thread-safe via
// one mutex — the consumers are per-batch allocations, not per-element.
//
// This is paddle_tpu_torch's own copy of paddle_tpu/csrc/allocator.cc; it
// builds at first use into a library of its own (core/allocator.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <new>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kAlign = 64;

inline size_t align_up(size_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

struct Arena {
  struct Block {
    char* ptr;
    size_t size;
  };

  size_t chunk_size;
  std::mutex mu;
  std::vector<char*> chunks;
  // free blocks by size (best fit = lower_bound), and by address for
  // coalescing neighbours
  std::multimap<size_t, char*> free_by_size;
  std::map<char*, size_t> free_by_addr;
  std::unordered_map<char*, size_t> live;  // ptr -> size
  size_t reserved = 0, in_use = 0, peak = 0;

  explicit Arena(size_t chunk) : chunk_size(align_up(std::max(chunk, kAlign))) {}

  ~Arena() {
    for (char* c : chunks) std::free(c);
  }

  void add_free(char* p, size_t n) {
    // coalesce with the right neighbour
    auto right = free_by_addr.find(p + n);
    if (right != free_by_addr.end()) {
      erase_size_entry(right->second, right->first);
      n += right->second;
      free_by_addr.erase(right);
    }
    // coalesce with the left neighbour
    if (!free_by_addr.empty()) {
      auto left = free_by_addr.lower_bound(p);
      if (left != free_by_addr.begin()) {
        --left;
        if (left->first + left->second == p) {
          erase_size_entry(left->second, left->first);
          p = left->first;
          n += left->second;
          free_by_addr.erase(left);
        }
      }
    }
    free_by_addr.emplace(p, n);
    free_by_size.emplace(n, p);
  }

  void erase_size_entry(size_t n, char* p) {
    auto range = free_by_size.equal_range(n);
    for (auto it = range.first; it != range.second; ++it)
      if (it->second == p) {
        free_by_size.erase(it);
        return;
      }
  }

  void* alloc(size_t want) {
    size_t n = align_up(std::max(want, size_t(1)));
    std::lock_guard<std::mutex> lk(mu);
    auto it = free_by_size.lower_bound(n);  // best fit
    if (it == free_by_size.end()) {
      size_t grow = std::max(n, chunk_size);
      char* c = static_cast<char*>(std::aligned_alloc(kAlign, grow));
      if (!c) return nullptr;
      chunks.push_back(c);
      reserved += grow;
      add_free(c, grow);
      it = free_by_size.lower_bound(n);
    }
    char* p = it->second;
    size_t bsize = it->first;
    free_by_size.erase(it);
    free_by_addr.erase(p);
    if (bsize > n + kAlign) {  // split the tail back onto the free list
      add_free(p + n, bsize - n);
      bsize = n;
    }
    live.emplace(p, bsize);
    in_use += bsize;
    peak = std::max(peak, in_use);
    return p;
  }

  // returns false on double-free / foreign pointer
  bool dealloc(void* vp) {
    char* p = static_cast<char*>(vp);
    std::lock_guard<std::mutex> lk(mu);
    auto it = live.find(p);
    if (it == live.end()) return false;
    size_t n = it->second;
    live.erase(it);
    in_use -= n;
    add_free(p, n);
    return true;
  }
};

}  // namespace

extern "C" {

void* arena_create(int64_t chunk_size) {
  return new (std::nothrow) Arena(static_cast<size_t>(chunk_size));
}

void arena_destroy(void* h) { delete static_cast<Arena*>(h); }

void* arena_alloc(void* h, int64_t size) {
  return static_cast<Arena*>(h)->alloc(static_cast<size_t>(size));
}

int arena_free(void* h, void* p) {
  return static_cast<Arena*>(h)->dealloc(p) ? 0 : -1;
}

// stats out[4]: reserved bytes, in-use bytes, peak in-use, chunk count
void arena_stats(void* h, int64_t* out) {
  Arena* a = static_cast<Arena*>(h);
  std::lock_guard<std::mutex> lk(a->mu);
  out[0] = static_cast<int64_t>(a->reserved);
  out[1] = static_cast<int64_t>(a->in_use);
  out[2] = static_cast<int64_t>(a->peak);
  out[3] = static_cast<int64_t>(a->chunks.size());
}

}  // extern "C"
