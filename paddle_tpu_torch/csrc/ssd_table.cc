// paddle_tpu_torch's own copy of paddle_tpu/csrc/ssd_table.cc. New rows are a
// pure function of (key, table seed) and the row rules round every f32
// operation on its own (-ffp-contract=off), so both copies must stay
// identical in behaviour: the port's SSD table is held bit for bit
// against the JAX package's.
//
// SSD sparse table: two-tier feasign store = RAM hot tier (NativeTable,
// sparse_table.h) + per-shard append-only log files for the cold tier.
//
// TPU-build counterpart of the reference's SSD table direction — the
// vintage ships only rocksdb scaffolding
// (paddle/fluid/distributed/ps/table/depends/rocksdb_warpper.h, no table
// class wired in), but the capability it targets is the trillion-feature
// scale claim (README.md:31-34): the full feature population lives on
// disk, the active working set in RAM, the per-pass working set in HBM
// (ps/embedding_cache.py). Design here is log-structured rather than
// rocksdb: each shard owns one data file of fixed-width records
// [u64 key, u32 flag, full_dim floats]; an in-memory open-addressing
// index maps key -> latest record ordinal; updates append (latest wins
// on replay), deletes append a tombstone record, compaction rewrites
// live records. Crash recovery = sequential replay at open.
//
// Tier protocol (invariant: a key is live in at most ONE tier):
//   pull/push/export: RAM hit -> serve; else disk hit -> PROMOTE the row
//     into RAM (erasing the disk index entry) and serve; else
//     insert-on-miss into RAM when `create` (gated by the admission
//     sketch when an admission threshold is configured).
//   spill(budget): move the coldest RAM rows (highest unseen_days, then
//     lowest show/click score) to disk until RAM fits the budget.
//   shrink: RAM shrink (decay + delete) plus a disk sweep applying the
//     same decay/delete lifecycle (ctr_accessor.cc:55-135 semantics);
//     also decays the admission sketch so stale mass cannot admit.
//   save: RAM keep-set snapshot + disk rows passing the same mode
//     filter; update_stat_after_save rewrites affected disk rows.
//
// Cold-tier cost model at 1e9+ keys/host (this file's perf contract):
//   - INDEX: open-addressing array of 6-byte slots (12-bit fingerprint +
//     36-bit record ordinal), load factor kept in (0.375, 0.75] =>
//     8..16 bytes/row measured, no per-key heap node. Keys are NOT
//     stored — a fingerprint match verifies against the log record.
//   - ADMISSION: per-shard counting sketch (2-hash conservative update,
//     saturating u8 counters); a key earns a durable row only after k
//     observations, so one-shot hash-collision keys never materialize.
//   - STORAGE: optional block compression (sst_create2 flag bit 1):
//     records are grouped kSstBlockRecs per block, deflated with a
//     shared dictionary; combined with fp16 value columns (flag bit 0)
//     for the smallest on-disk rows.
//   - IO ISOLATION: compaction/shrink sweeps can run on a background
//     thread (sst_bg_start), metered by a token-bucket disk budget
//     shared with serve-class reads (serve has priority and never
//     blocks; background acquisition does), so compaction cannot
//     starve pull p99.
//
// C ABI (sst_*) mirrors sparse_table.cc's pst_* so the Python layer
// swaps engines; extra entry points: spill, compact, stats, load_cold,
// stats2, admission_config, io_budget, bg_start/bg_stop/bg_step,
// compact_async.
//
// Lock hierarchy (checked statically by tools/lint/lock_order.py —
// nested acquisitions carry a `// LOCK: name` tag and must follow the
// declared order; see docs/STATIC_ANALYSIS.md). bg_mu guards the
// background-compactor dirty flags and is taken UNDER disk_mu on the
// request side (maybe_compact) and alone by the worker; io_mu is the
// token-bucket leaf — nothing is ever acquired under it.
// LOCK ORDER: ssd_save_mu < mem_save_mu < shard_mu < disk_mu < bg_mu
// LOCK LEAF: io_mu

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <zlib.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <string>

#include "sparse_table.h"

namespace {

using pstpu::NativeTable;
using pstpu::Shard;
using pstpu::TableNativeConfig;
using pstpu::table_full_dim;

// sentinel returned by key_at callbacks when the record is unreadable —
// treated as "does not match" by every index probe
constexpr uint64_t kBadKey = ~0ULL;

// 48-bit index entry: [12-bit fingerprint | 36-bit (ordinal + 2)].
// ordinal+2 keeps the low 36 bits >= 2, so the packed entry can never
// collide with the sentinels regardless of fingerprint.
constexpr uint64_t kSlotEmpty = 0;
constexpr uint64_t kSlotTomb = 1;
constexpr int64_t kMaxOrd = (int64_t(1) << 36) - 3;

// Compact open-addressing key -> record ordinal index. 6 bytes per
// slot; the key itself lives only in the log record, so every
// fingerprint hit is verified through a `key_at(ord)` callback (false
// positive rate 2^-12 per probe). Load factor is bounded to (0.375,
// 0.75] by cap_for(), which is the ≤16-bytes/row contract: 6 B/slot /
// 0.375 = 16 B/row worst case right after a growth doubling.
struct DiskIndex {
  std::vector<uint8_t> slots;  // 6-byte little-endian entries
  uint64_t mask = 0;           // slot count - 1 (power of two)
  // per-instance salt (pstpu::next_hash_salt rationale): restores feed
  // this index keys in the SAVER index's hash order — unsalted, that
  // insertion order is home-slot-sorted and linear probing goes
  // quadratic (the 0.66e9-row restore "hang")
  uint64_t salt = pstpu::next_hash_salt();
  int64_t used = 0, occupied = 0;

  DiskIndex() { init_cap(1024); }

  void init_cap(uint64_t cap) {
    slots.assign(cap * 6, 0);
    mask = cap - 1;
    used = 0;
    occupied = 0;
  }

  static uint64_t cap_for(int64_t rows) {
    uint64_t cap = 1024;
    while (static_cast<uint64_t>(rows) * 4 > cap * 3) cap <<= 1;
    return cap;
  }

  uint64_t get(uint64_t h) const {
    uint64_t e = 0;
    std::memcpy(&e, slots.data() + h * 6, 6);
    return e;
  }
  void set(uint64_t h, uint64_t e) {
    std::memcpy(slots.data() + h * 6, &e, 6);
  }

  uint64_t home_of(uint64_t hash) const { return hash & mask; }
  static uint64_t fp_of(uint64_t hash) { return (hash >> 48) & 0xFFF; }
  uint64_t hash_key(uint64_t key) const {
    return pstpu::splitmix64(key ^ salt);
  }
  static uint64_t pack(uint64_t fp, int64_t ord) {
    return (fp << 36) | (static_cast<uint64_t>(ord) + 2);
  }
  static int64_t ord_of(uint64_t e) {
    return static_cast<int64_t>(e & ((uint64_t(1) << 36) - 1)) - 2;
  }
  static uint64_t efp_of(uint64_t e) { return e >> 36; }

  int64_t bytes() const { return static_cast<int64_t>(slots.size()); }

  template <typename KeyAt>
  int64_t find(uint64_t key, KeyAt key_at) const {
    uint64_t hs = hash_key(key), fp = fp_of(hs);
    uint64_t h = home_of(hs), probes = 0;
    while (true) {
      uint64_t e = get(h);
      if (e == kSlotEmpty) return -1;
      if (e != kSlotTomb && efp_of(e) == fp) {
        int64_t ord = ord_of(e);
        if (key_at(ord) == key) return ord;
      }
      h = (h + 1) & mask;
      if (++probes > mask + 1) {
        std::fprintf(stderr,
                     "DiskIndex.find: full-table probe (cap=%llu used=%lld "
                     "occupied=%lld) — invariant broken\n",
                     (unsigned long long)(mask + 1), (long long)used,
                     (long long)occupied);
        std::abort();
      }
    }
  }

  // insert without duplicate check into a pre-sized table (rebuild /
  // compaction refill paths — the caller guarantees unique keys and
  // capacity, so no key_at reads and no growth are needed)
  void insert_fresh(uint64_t key, int64_t ord) {
    uint64_t hs = hash_key(key);
    uint64_t h = home_of(hs);
    while (get(h) != kSlotEmpty) h = (h + 1) & mask;
    set(h, pack(fp_of(hs), ord));
    ++used;
    ++occupied;
  }

  // re-key the whole table into a capacity sized for `want_rows`,
  // clearing tombstones. Ordinals are visited in sorted order so the
  // key_at reads are sequential in the log (block-cache friendly).
  template <typename KeyAt>
  void rebuild(int64_t want_rows, KeyAt key_at) {
    std::vector<int64_t> ords;
    ords.reserve(static_cast<size_t>(used));
    for_each([&](int64_t o) { ords.push_back(o); });
    std::sort(ords.begin(), ords.end());
    init_cap(cap_for(std::max<int64_t>(
        want_rows, static_cast<int64_t>(ords.size()))));
    for (int64_t o : ords) {
      uint64_t k = key_at(o);
      if (k == kBadKey) continue;  // unreadable record: drop the entry
      insert_fresh(k, o);
    }
  }

  // bulk pre-size so a load wave doesn't pay per-insert growth
  template <typename KeyAt>
  void reserve_rows(int64_t rows, KeyAt key_at) {
    if (cap_for(rows) > mask + 1) rebuild(rows, key_at);
  }

  template <typename KeyAt>
  void upsert(uint64_t key, int64_t ord, KeyAt key_at) {
    uint64_t hs = hash_key(key), fp = fp_of(hs);
    uint64_t h = home_of(hs), probes = 0;
    int64_t first_tomb = -1;
    while (true) {
      uint64_t e = get(h);
      if (e == kSlotEmpty) {
        uint64_t t = first_tomb >= 0 ? static_cast<uint64_t>(first_tomb) : h;
        set(t, pack(fp, ord));
        ++used;
        if (first_tomb < 0) ++occupied;
        if (occupied * 4 >= static_cast<int64_t>(mask + 1) * 3)
          rebuild(used * 2, key_at);
        return;
      }
      if (e == kSlotTomb) {
        if (first_tomb < 0) first_tomb = static_cast<int64_t>(h);
      } else if (efp_of(e) == fp && key_at(ord_of(e)) == key) {
        set(h, pack(fp, ord));  // overwrite (newer record)
        return;
      }
      h = (h + 1) & mask;
      if (++probes > mask + 1) {
        std::fprintf(stderr,
                     "DiskIndex.upsert: full-table probe (cap=%llu used=%lld "
                     "occupied=%lld) — invariant broken\n",
                     (unsigned long long)(mask + 1), (long long)used,
                     (long long)occupied);
        std::abort();
      }
    }
  }

  template <typename KeyAt>
  bool erase(uint64_t key, KeyAt key_at) {
    uint64_t hs = hash_key(key), fp = fp_of(hs);
    uint64_t h = home_of(hs), probes = 0;
    while (true) {
      uint64_t e = get(h);
      if (e == kSlotEmpty) return false;
      if (e != kSlotTomb && efp_of(e) == fp && key_at(ord_of(e)) == key) {
        set(h, kSlotTomb);
        --used;
        return true;
      }
      h = (h + 1) & mask;
      if (++probes > mask + 1) return false;  // key not present
    }
  }

  template <typename Fn>
  void for_each(Fn fn) const {
    for (uint64_t h = 0; h <= mask; ++h) {
      uint64_t e = get(h);
      if (e != kSlotEmpty && e != kSlotTomb) fn(ord_of(e));
    }
  }
};

// Per-shard counting sketch for row admission (counting-Bloom in spirit:
// two derived positions per key, conservative update, saturating u8
// counters). A key is admitted once its estimated count reaches the
// configured threshold; sst_shrink halves every counter so stale mass
// ages out with the same lifecycle cadence as the rows themselves.
struct AdmitSketch {
  std::vector<uint8_t> cnt;
  uint64_t mask = 0;
  uint64_t salt = pstpu::next_hash_salt();

  bool enabled() const { return !cnt.empty(); }
  int64_t bytes() const { return static_cast<int64_t>(cnt.size()); }

  void init(int64_t want_bytes) {
    uint64_t cap = 1024;
    while (static_cast<int64_t>(cap) * 2 <= want_bytes) cap <<= 1;
    cnt.assign(cap, 0);
    mask = cap - 1;
  }

  void positions(uint64_t key, uint64_t* i1, uint64_t* i2) const {
    uint64_t h = pstpu::splitmix64(key ^ salt);
    *i1 = h & mask;
    *i2 = (h >> 24) & mask;
  }

  int32_t estimate(uint64_t key) const {
    uint64_t i1, i2;
    positions(key, &i1, &i2);
    return std::min(cnt[i1], cnt[i2]);
  }

  // conservative update: only counters at the current minimum advance,
  // so unrelated keys sharing one position don't inflate each other
  int32_t bump(uint64_t key) {
    uint64_t i1, i2;
    positions(key, &i1, &i2);
    uint8_t m = std::min(cnt[i1], cnt[i2]);
    if (m == 255) return 255;
    uint8_t nm = static_cast<uint8_t>(m + 1);
    if (cnt[i1] < nm) cnt[i1] = nm;
    if (cnt[i2] < nm) cnt[i2] = nm;
    return nm;
  }

  void decay() {
    for (uint8_t& c : cnt) c >>= 1;
  }
};

// Token-bucket disk budget shared between serve-class IO (pull/push
// promote reads, foreground appends) and background compaction. Serve
// traffic has absolute priority: it only debits the bucket (possibly
// driving it negative) and never blocks; background acquisition blocks
// until the bucket refills past its debt, so compaction bandwidth is
// exactly what serve traffic leaves behind.
struct IoBudget {
  std::mutex mu;
  std::atomic<int64_t> rate_bps{0};  // 0 = unmetered
  std::atomic<int64_t> cap_bytes{0};
  double tokens = 0.0;
  std::chrono::steady_clock::time_point last{};
  std::atomic<int64_t> serve_bytes{0}, bg_bytes{0}, bg_wait_ms{0};

  void refill_locked() {
    auto now = std::chrono::steady_clock::now();
    double dt = std::chrono::duration<double>(now - last).count();
    last = now;
    double cap = static_cast<double>(cap_bytes.load(std::memory_order_relaxed));
    tokens = std::min(
        cap, tokens + dt * static_cast<double>(
                          rate_bps.load(std::memory_order_relaxed)));
  }

  void configure(int64_t bps, int64_t cap) {
    std::lock_guard<std::mutex> g(mu);  // LOCK: io_mu
    rate_bps.store(bps, std::memory_order_relaxed);
    if (cap <= 0) cap = std::max<int64_t>(bps / 4, int64_t(4) << 20);
    cap_bytes.store(cap, std::memory_order_relaxed);
    tokens = static_cast<double>(cap);
    last = std::chrono::steady_clock::now();
  }

  void charge_serve(int64_t nb) {
    serve_bytes.fetch_add(nb, std::memory_order_relaxed);
    if (rate_bps.load(std::memory_order_relaxed) <= 0) return;
    std::lock_guard<std::mutex> g(mu);  // LOCK: io_mu
    refill_locked();
    tokens -= static_cast<double>(nb);  // may go negative: serve priority
  }

  bool acquire_bg(int64_t nb, const std::atomic<bool>& stop) {
    bg_bytes.fetch_add(nb, std::memory_order_relaxed);
    if (rate_bps.load(std::memory_order_relaxed) <= 0) return true;
    int64_t waited = 0;
    // a request larger than the bucket can never be satisfied whole —
    // clamp so it drains the full bucket instead of deadlocking
    while (true) {
      {
        std::lock_guard<std::mutex> g(mu);  // LOCK: io_mu
        refill_locked();
        double want = std::min<double>(
            static_cast<double>(nb),
            static_cast<double>(cap_bytes.load(std::memory_order_relaxed)));
        if (tokens >= want) {
          tokens -= static_cast<double>(nb);
          break;
        }
      }
      if (stop.load(std::memory_order_relaxed)) return false;
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
      waited += 2;
    }
    if (waited) bg_wait_ms.fetch_add(waited, std::memory_order_relaxed);
    return true;
  }
};

// -- block-compressed log -----------------------------------------------------

// sealed block on disk: [u32 magic, u32 comp_len, u32 n_recs,
// u32 crc32(raw)] then `comp_len` bytes of deflate data (shared-dict).
constexpr uint32_t kSstBlkMagic = 0x4B4C4253u;  // 'SBLK' little-endian
constexpr int32_t kSstBlockRecs = 128;
constexpr int64_t kSstBlockHdrBytes = 16;

struct BlockRef {
  int64_t first_ord;  // ordinal of the block's first record
  int64_t off;        // file offset of the block header
  int32_t n;          // records in the block
  int32_t comp_len;   // deflate payload bytes
};

// Unified per-shard log. Raw mode (comp=false) is the original
// fixed-width format: record `ord` lives at byte ord*rec_bytes. Comp
// mode appends records to an in-memory open block (volatile until
// sealed — sst_flush seals) and seals kSstBlockRecs at a time to disk.
// Ordinals stay dense and monotonic across both modes, which is what
// the 36-bit index packing and the replay contract rely on.
struct LogState {
  int fd = -1;
  bool comp = false;
  bool bg_class = false;  // io accounting class (background vs serve)
  int64_t n = 0;          // appended records incl. garbage + tombstones
  // comp mode state:
  std::vector<BlockRef> blocks;
  std::vector<uint8_t> open_raw;  // unsealed tail records
  int64_t open_first = 0;         // ordinal of open_raw's first record
  int64_t file_end = 0;           // bytes of sealed blocks on disk
  int64_t cache_first = -1;       // one-block decode cache
  int32_t cache_n = 0;
  std::vector<uint8_t> cache_raw;
  std::vector<uint8_t> scratch;  // raw-mode read buf / comp blob buf
};

struct DiskShard {
  std::string path;
  int32_t sid = 0;
  LogState log;
  DiskIndex index;
  AdmitSketch sketch;
  std::mutex mu;
  // IO scratch reused across records (guarded by mu) — promote/sweep
  // paths must not pay a heap allocation per record
  std::vector<float> row_buf;
};

struct SsdTable {
  NativeTable* mem;
  std::vector<DiskShard*> disk;
  std::string dir;
  int32_t fdim;       // full row width (floats)
  int64_t rec_bytes;  // 8 (key) + 4 (flag) + row_bytes
  // fp16-values record format (sst_create2 flag bit 0): the VALUE
  // columns — embed_w (col 5) and embedx_w (cols [v16_lo, v16_hi)) —
  // are stored as IEEE fp16 on disk and widened on every read, while
  // the optimizer state (g2sum / adam moments) and lifecycle stats
  // stay fp32. The canonical row everyone else sees (pull/export/
  // digest/snapshot/save) is the WIDENED form, so digests and
  // checkpoints of an fp16 table stay self-consistent: re-narrowing a
  // widened-from-fp16 value is the identity.
  bool val_f16 = false;
  bool block_comp = false;  // sst_create2 flag bit 1
  int32_t v16_lo = 0, v16_hi = 0;  // embedx_w column range
  int64_t row_bytes;
  std::vector<uint8_t> zdict;  // shared deflate dictionary
  // save snapshot buffers (begin/fetch protocol, same as NativeTable)
  std::mutex save_mu;

  // admission (sketch state lives per shard under disk_mu)
  std::atomic<int32_t> admit_threshold{0};  // 0/1 = admission off
  std::atomic<int64_t> admit_checks{0}, admit_admitted{0}, admit_rejects{0};

  IoBudget io;

  // background compactor: bg_mu guards the dirty flags + busy bit; the
  // worker drains dirty shards, compacting each with a two-phase copy
  // that holds disk_mu only for the snapshot and the final swap.
  std::thread bg_thread;
  std::mutex bg_mu;
  std::condition_variable bg_cv;
  std::atomic<bool> bg_on{false}, bg_stop{false};
  bool bg_busy = false;            // guarded by bg_mu
  std::vector<uint8_t> bg_dirty;   // guarded by bg_mu; 0 clean/1 policy/2 forced
  int32_t bg_interval_ms = 200;
  std::atomic<int64_t> bg_compactions{0};

  explicit SsdTable(const TableNativeConfig& c, const std::string& d,
                    int32_t flags)
      : mem(new NativeTable(c)),
        dir(d),
        val_f16((flags & 1) != 0),
        block_comp((flags & 2) != 0) {
    fdim = table_full_dim(mem);
    int32_t es = pstpu::rule_state_dim(c.embed_rule, 1);
    v16_lo = 7 + es;
    v16_hi = v16_lo + c.embedx_dim;
    int32_t n16 = 1 + c.embedx_dim;  // embed_w + embedx_w
    row_bytes = val_f16 ? 4 * static_cast<int64_t>(fdim - n16) + 2 * n16
                        : 4 * static_cast<int64_t>(fdim);
    rec_bytes = 8 + 4 + row_bytes;
    zdict.assign(static_cast<size_t>(
                     std::min<int64_t>(rec_bytes * 16, 4096)),
                 0);
  }
  ~SsdTable();  // defined after bg helpers (must join the worker)
};

// -- record IO (shard lock held) --------------------------------------------

// row <-> disk bytes. fp32 mode is a straight memcpy; fp16 mode packs
// the value columns (embed_w + embedx_w) as u16 halves in place,
// everything else fp32 — column order is unchanged, only widths.
void pack_row(const SsdTable* t, uint8_t* dst, const float* v) {
  if (!t->val_f16) {
    std::memcpy(dst, v, 4 * static_cast<size_t>(t->fdim));
    return;
  }
  for (int32_t j = 0; j < t->fdim; ++j) {
    if (j == 5 || (j >= t->v16_lo && j < t->v16_hi)) {
      uint16_t h = pstpu::f32_to_f16(v[j]);
      std::memcpy(dst, &h, 2);
      dst += 2;
    } else {
      std::memcpy(dst, &v[j], 4);
      dst += 4;
    }
  }
}

void unpack_row(const SsdTable* t, const uint8_t* src, float* v) {
  if (!t->val_f16) {
    std::memcpy(v, src, 4 * static_cast<size_t>(t->fdim));
    return;
  }
  for (int32_t j = 0; j < t->fdim; ++j) {
    if (j == 5 || (j >= t->v16_lo && j < t->v16_hi)) {
      uint16_t h;
      std::memcpy(&h, src, 2);
      v[j] = pstpu::f16_to_f32(h);
      src += 2;
    } else {
      std::memcpy(&v[j], src, 4);
      src += 4;
    }
  }
}

// one-shot deflate with the shared dictionary (level 3: the blocks are
// low-entropy fixed-width rows; fast levels are within ~20% of default)
bool zdeflate(const uint8_t* raw, size_t rawlen,
              const std::vector<uint8_t>& dict, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit(&zs, 3) != Z_OK) return false;
  if (!dict.empty())
    deflateSetDictionary(&zs, dict.data(),
                         static_cast<uInt>(dict.size()));
  out.resize(deflateBound(&zs, static_cast<uLong>(rawlen)));
  zs.next_in = const_cast<Bytef*>(raw);
  zs.avail_in = static_cast<uInt>(rawlen);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = deflate(&zs, Z_FINISH);
  bool ok = rc == Z_STREAM_END;
  out.resize(ok ? zs.total_out : 0);
  deflateEnd(&zs);
  return ok;
}

bool zinflate(const uint8_t* comp, size_t clen,
              const std::vector<uint8_t>& dict, uint8_t* out,
              size_t rawlen) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(comp);
  zs.avail_in = static_cast<uInt>(clen);
  zs.next_out = out;
  zs.avail_out = static_cast<uInt>(rawlen);
  int rc = inflate(&zs, Z_FINISH);
  if (rc == Z_NEED_DICT && !dict.empty()) {
    if (inflateSetDictionary(&zs, dict.data(),
                             static_cast<uInt>(dict.size())) != Z_OK) {
      inflateEnd(&zs);
      return false;
    }
    rc = inflate(&zs, Z_FINISH);
  }
  bool ok = rc == Z_STREAM_END && zs.total_out == rawlen;
  inflateEnd(&zs);
  return ok;
}

// io accounting funnel: serve-class traffic debits the token bucket
// inline (never blocks); background-class just counts — the bg copy
// loop acquires budget in coarse chunks before issuing its IO.
void io_account(SsdTable* t, const LogState& lg, int64_t nb) {
  if (lg.bg_class)
    t->io.bg_bytes.fetch_add(nb, std::memory_order_relaxed);
  else
    t->io.charge_serve(nb);
}

// seal the open block: deflate + header + pwrite at file_end. On a
// short write the file is truncated back and the block STAYS OPEN (the
// next append retries), so ordinals never skip.
bool log_seal(SsdTable* t, LogState& lg) {
  if (!lg.comp || lg.open_raw.empty()) return true;
  std::vector<uint8_t> blob;
  if (!zdeflate(lg.open_raw.data(), lg.open_raw.size(), t->zdict, blob))
    return false;
  uint32_t n_recs =
      static_cast<uint32_t>(lg.open_raw.size() / t->rec_bytes);
  uint32_t crc = static_cast<uint32_t>(
      crc32(0L, lg.open_raw.data(),
            static_cast<uInt>(lg.open_raw.size())));
  uint8_t hdr[kSstBlockHdrBytes];
  uint32_t clen = static_cast<uint32_t>(blob.size());
  std::memcpy(hdr, &kSstBlkMagic, 4);
  std::memcpy(hdr + 4, &clen, 4);
  std::memcpy(hdr + 8, &n_recs, 4);
  std::memcpy(hdr + 12, &crc, 4);
  if (pwrite(lg.fd, hdr, sizeof(hdr), lg.file_end) !=
          static_cast<ssize_t>(sizeof(hdr)) ||
      pwrite(lg.fd, blob.data(), blob.size(),
             lg.file_end + kSstBlockHdrBytes) !=
          static_cast<ssize_t>(blob.size())) {
    (void)ftruncate(lg.fd, lg.file_end);
    return false;
  }
  io_account(t, lg, kSstBlockHdrBytes + static_cast<int64_t>(blob.size()));
  lg.blocks.push_back({lg.open_first, lg.file_end,
                       static_cast<int32_t>(n_recs),
                       static_cast<int32_t>(clen)});
  lg.file_end += kSstBlockHdrBytes + static_cast<int64_t>(blob.size());
  // NOT lg.n: the eager seal inside log_append_raw fires before lg.n is
  // bumped for the record that filled the block — count what we sealed
  lg.open_first += n_recs;
  lg.open_raw.clear();
  return true;
}

// append one packed record; returns its ordinal or -1 (raw-mode short
// write / ordinal space exhausted). Comp mode appends to the open block
// in memory — a full block seals eagerly; a seal failure (disk full)
// keeps the block open and surfaces at the next seal/flush.
int64_t log_append_raw(SsdTable* t, LogState& lg, const uint8_t* rec) {
  int64_t ord = lg.n;
  if (ord > kMaxOrd) return -1;
  if (!lg.comp) {
    if (pwrite(lg.fd, rec, t->rec_bytes, ord * t->rec_bytes) !=
        static_cast<ssize_t>(t->rec_bytes))
      return -1;
    io_account(t, lg, t->rec_bytes);
  } else {
    lg.open_raw.insert(lg.open_raw.end(), rec, rec + t->rec_bytes);
    if (lg.open_raw.size() >=
        static_cast<size_t>(kSstBlockRecs) * t->rec_bytes)
      log_seal(t, lg);
  }
  lg.n = ord + 1;
  return ord;
}

int64_t log_append_row(SsdTable* t, LogState& lg, uint64_t key,
                       uint32_t flag, const float* vals) {
  lg.scratch.resize(t->rec_bytes);
  uint8_t* buf = lg.scratch.data();
  std::memcpy(buf, &key, 8);
  std::memcpy(buf + 8, &flag, 4);
  if (vals)
    pack_row(t, buf + 12, vals);
  else
    std::memset(buf + 12, 0, static_cast<size_t>(t->row_bytes));
  return log_append_raw(t, lg, buf);
}

// pointer to record `ord`'s packed bytes, valid until the next log call
// on this LogState. Raw mode preads into scratch; comp mode serves from
// the open block or a one-block decode cache (sequential sweeps over
// sorted ordinals decode each block exactly once).
const uint8_t* log_record(SsdTable* t, LogState& lg, int64_t ord) {
  if (ord < 0 || ord >= lg.n) return nullptr;
  if (!lg.comp) {
    lg.scratch.resize(t->rec_bytes);
    if (pread(lg.fd, lg.scratch.data(), t->rec_bytes,
              ord * t->rec_bytes) != static_cast<ssize_t>(t->rec_bytes))
      return nullptr;
    io_account(t, lg, t->rec_bytes);
    return lg.scratch.data();
  }
  if (ord >= lg.open_first) {
    size_t off = static_cast<size_t>(ord - lg.open_first) * t->rec_bytes;
    if (off + t->rec_bytes > lg.open_raw.size()) return nullptr;
    return lg.open_raw.data() + off;
  }
  if (lg.cache_first >= 0 && ord >= lg.cache_first &&
      ord < lg.cache_first + lg.cache_n)
    return lg.cache_raw.data() +
           static_cast<size_t>(ord - lg.cache_first) * t->rec_bytes;
  // binary search the sealed block containing `ord`
  size_t lo = 0, hi = lg.blocks.size();
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (lg.blocks[mid].first_ord <= ord)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo == 0) return nullptr;
  const BlockRef& b = lg.blocks[lo - 1];
  if (ord >= b.first_ord + b.n) return nullptr;
  lg.scratch.resize(static_cast<size_t>(b.comp_len));
  if (pread(lg.fd, lg.scratch.data(), b.comp_len,
            b.off + kSstBlockHdrBytes) != static_cast<ssize_t>(b.comp_len))
    return nullptr;
  io_account(t, lg, b.comp_len);
  size_t rawlen = static_cast<size_t>(b.n) * t->rec_bytes;
  lg.cache_raw.resize(rawlen);
  if (!zinflate(lg.scratch.data(), static_cast<size_t>(b.comp_len),
                t->zdict, lg.cache_raw.data(), rawlen)) {
    lg.cache_first = -1;
    return nullptr;
  }
  lg.cache_first = b.first_ord;
  lg.cache_n = b.n;
  return lg.cache_raw.data() +
         static_cast<size_t>(ord - b.first_ord) * t->rec_bytes;
}

uint64_t log_key_at(SsdTable* t, LogState& lg, int64_t ord) {
  const uint8_t* rec = log_record(t, lg, ord);
  if (!rec) return kBadKey;
  uint64_t k;
  std::memcpy(&k, rec, 8);
  return k;
}

int64_t log_bytes(const SsdTable* t, const LogState& lg) {
  if (!lg.comp) return lg.n * t->rec_bytes;
  return lg.file_end + static_cast<int64_t>(lg.open_raw.size());
}

bool read_record(SsdTable* t, DiskShard* d, int64_t ord, uint64_t* key,
                 uint32_t* flag, float* vals) {
  const uint8_t* rec = log_record(t, d->log, ord);
  if (!rec) return false;
  std::memcpy(key, rec, 8);
  std::memcpy(flag, rec + 8, 4);
  unpack_row(t, rec + 12, vals);
  return true;
}

// open-time replay: rebuild index + (comp mode) block directory from
// the shard file. Comp mode validates magic/bounds/crc per block and
// truncates a torn tail — a crash mid-seal loses at most the unsealed
// open block, never a sealed one.
void replay_shard(SsdTable* t, DiskShard* d) {
  LogState& lg = d->log;
  auto key_at = [&](int64_t o) { return log_key_at(t, lg, o); };
  off_t sz = lseek(lg.fd, 0, SEEK_END);
  if (!lg.comp) {
    int64_t n = sz / t->rec_bytes;  // trailing partial record ignored
    lg.n = n;
    std::vector<uint8_t> buf(t->rec_bytes);
    d->index.reserve_rows(std::max<int64_t>(n / 2, 1), key_at);
    for (int64_t ord = 0; ord < n; ++ord) {
      if (pread(lg.fd, buf.data(), t->rec_bytes, ord * t->rec_bytes) !=
          static_cast<ssize_t>(t->rec_bytes))
        break;
      uint64_t key;
      uint32_t flag;
      std::memcpy(&key, buf.data(), 8);
      std::memcpy(&flag, buf.data() + 8, 4);
      if (flag)
        d->index.upsert(key, ord, key_at);
      else
        d->index.erase(key, key_at);
    }
  } else {
    int64_t off = 0;
    lg.n = 0;
    std::vector<uint8_t> blob, raw;
    while (off + kSstBlockHdrBytes <= sz) {
      uint8_t hdr[kSstBlockHdrBytes];
      if (pread(lg.fd, hdr, sizeof(hdr), off) !=
          static_cast<ssize_t>(sizeof(hdr)))
        break;
      uint32_t magic, clen, n_recs, crc;
      std::memcpy(&magic, hdr, 4);
      std::memcpy(&clen, hdr + 4, 4);
      std::memcpy(&n_recs, hdr + 8, 4);
      std::memcpy(&crc, hdr + 12, 4);
      if (magic != kSstBlkMagic || n_recs == 0 ||
          n_recs > (1u << 20) ||
          off + kSstBlockHdrBytes + static_cast<int64_t>(clen) > sz)
        break;  // torn tail
      blob.resize(clen);
      if (pread(lg.fd, blob.data(), clen, off + kSstBlockHdrBytes) !=
          static_cast<ssize_t>(clen))
        break;
      size_t rawlen = static_cast<size_t>(n_recs) * t->rec_bytes;
      raw.resize(rawlen);
      if (!zinflate(blob.data(), clen, t->zdict, raw.data(), rawlen) ||
          static_cast<uint32_t>(crc32(
              0L, raw.data(), static_cast<uInt>(rawlen))) != crc)
        break;  // corrupt block: everything after it is suspect
      int64_t first = lg.n;
      lg.blocks.push_back({first, off, static_cast<int32_t>(n_recs),
                           static_cast<int32_t>(clen)});
      lg.n = first + n_recs;
      // keep open_first == n while replaying: index probes (key_at)
      // fire DURING the block loop, and a stale open_first of 0 would
      // route every sealed-ordinal read into the empty open block
      lg.open_first = lg.n;
      lg.file_end = off + kSstBlockHdrBytes + clen;
      // seed the decode cache with this block so the index probes
      // below (and their key_at verifications) stay in memory
      lg.cache_raw = raw;
      lg.cache_first = first;
      lg.cache_n = static_cast<int32_t>(n_recs);
      for (uint32_t j = 0; j < n_recs; ++j) {
        const uint8_t* rec = raw.data() + static_cast<size_t>(j) * t->rec_bytes;
        uint64_t key;
        uint32_t flag;
        std::memcpy(&key, rec, 8);
        std::memcpy(&flag, rec + 8, 4);
        if (flag)
          d->index.upsert(key, first + j, key_at);
        else
          d->index.erase(key, key_at);
      }
      off = lg.file_end;
    }
    if (off < sz) (void)ftruncate(lg.fd, off);  // drop the torn tail
    lg.open_first = lg.n;
  }
  // churn-heavy logs leave the index grown past its live set — rightsize
  if (DiskIndex::cap_for(d->index.used) * 2 <= d->index.mask + 1)
    d->index.rebuild(d->index.used, key_at);
}

// -- compaction --------------------------------------------------------------

bool needs_compact(const DiskShard* d) {
  return d->log.n > 4096 &&
         d->log.n > 4 * std::max<int64_t>(d->index.used, 1);
}

// open a fresh writer log on `path` (O_TRUNC) in the table's format
bool open_writer(SsdTable* t, const std::string& path, LogState& w,
                 bool bg_class) {
  w = LogState();
  w.comp = t->block_comp;
  w.bg_class = bg_class;
  w.fd = open(path.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  return w.fd >= 0;
}

void drop_writer(LogState& w, const std::string& path) {
  if (w.fd >= 0) close(w.fd);
  w.fd = -1;
  unlink(path.c_str());
}

// durability tail shared by both compaction flavors: the new log must be
// on stable storage BEFORE it replaces the old one, and the rename must
// reach the directory — a crash mid-compaction must never lose rows
// that were already durable (the old file stays intact until rename).
bool publish_writer(SsdTable* t, DiskShard* d, LogState& w,
                    const std::string& tmp, DiskIndex& fresh) {
  if (!log_seal(t, w) || fsync(w.fd) != 0 ||
      rename(tmp.c_str(), d->path.c_str()) != 0) {
    drop_writer(w, tmp);
    return false;
  }
  std::string dir = d->path.substr(0, d->path.find_last_of('/'));
  int dfd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd >= 0) {
    fsync(dfd);
    close(dfd);
  }
  close(d->log.fd);
  w.bg_class = false;  // the live log serves foreground traffic
  d->log = std::move(w);
  d->index = std::move(fresh);
  t->bg_compactions.fetch_add(1, std::memory_order_relaxed);
  return true;
}

// inline compaction, disk_mu held throughout (the bg-off path and the
// save/shrink call sites that already hold the lock)
bool compact_shard_locked(SsdTable* t, DiskShard* d) {
  std::string tmp = d->path + ".compact";
  LogState w;
  if (!open_writer(t, tmp, w, false)) return false;
  // sequential read order: sort live ordinals
  std::vector<int64_t> live;
  live.reserve(static_cast<size_t>(d->index.used));
  d->index.for_each([&](int64_t ord) { live.push_back(ord); });
  std::sort(live.begin(), live.end());
  DiskIndex fresh;
  fresh.init_cap(DiskIndex::cap_for(static_cast<int64_t>(live.size())));
  for (int64_t ord : live) {
    const uint8_t* rec = log_record(t, d->log, ord);
    if (!rec) continue;
    uint64_t key;
    std::memcpy(&key, rec, 8);
    int64_t nord = log_append_raw(t, w, rec);
    if (nord < 0) {
      drop_writer(w, tmp);
      return false;
    }
    fresh.insert_fresh(key, nord);
  }
  return publish_writer(t, d, w, tmp, fresh);
}

// Two-phase background compaction: phase A snapshots the log under
// disk_mu, then copies the live records to `.compact` WITHOUT the lock
// (foreground pulls keep serving), metered by the io budget in coarse
// chunks; phase B re-takes the lock, patches in whatever changed during
// the copy (appends, promotes, rewrites), and atomically swaps. Records
// erased during phase A stay in the new file as unindexed garbage — the
// next compaction reclaims them.
bool compact_shard_bg(SsdTable* t, DiskShard* d, bool force) {
  std::string tmp = d->path + ".compact";
  LogState snap;
  std::vector<int64_t> ords;
  {
    std::lock_guard<std::mutex> g(d->mu);  // LOCK: disk_mu
    if (!force && !needs_compact(d)) return false;
    log_seal(t, d->log);  // comp mode: snapshot reads need sealed blocks
    snap = d->log;        // shares fd (never closed via the snapshot)
    snap.bg_class = true;
    snap.cache_first = -1;  // private decode cache
    snap.cache_raw.clear();
    snap.scratch.clear();
    ords.reserve(static_cast<size_t>(d->index.used));
    d->index.for_each([&](int64_t ord) { ords.push_back(ord); });
  }
  std::sort(ords.begin(), ords.end());
  LogState w;
  if (!open_writer(t, tmp, w, true)) return false;
  // old-ordinal -> (key, new ordinal) map, parallel to sorted `ords`
  std::vector<uint64_t> key_of(ords.size());
  std::vector<int64_t> new_of(ords.size(), -1);
  size_t chunk_recs = std::max<size_t>(
      1, (size_t(4) << 20) / static_cast<size_t>(t->rec_bytes));
  for (size_t lo = 0; lo < ords.size(); lo += chunk_recs) {
    size_t nhi = std::min(lo + chunk_recs, ords.size());
    // budget the chunk's read+write before issuing it; an aborted stop
    // (table teardown) abandons the pass — the old log is untouched
    if (!t->io.acquire_bg(
            2 * static_cast<int64_t>(nhi - lo) * t->rec_bytes,
            t->bg_stop)) {
      drop_writer(w, tmp);
      return false;
    }
    for (size_t i = lo; i < nhi; ++i) {
      const uint8_t* rec = log_record(t, snap, ords[i]);
      if (!rec) continue;  // phase B re-reads from the live log
      uint32_t flag;
      std::memcpy(&flag, rec + 8, 4);
      if (!flag) continue;
      std::memcpy(&key_of[i], rec, 8);
      int64_t nord = log_append_raw(t, w, rec);
      if (nord < 0) {
        drop_writer(w, tmp);
        return false;
      }
      new_of[i] = nord;
    }
  }
  // phase B: reconcile + swap under the lock
  std::lock_guard<std::mutex> g(d->mu);  // LOCK: disk_mu
  std::vector<int64_t> cur;
  cur.reserve(static_cast<size_t>(d->index.used));
  d->index.for_each([&](int64_t ord) { cur.push_back(ord); });
  std::sort(cur.begin(), cur.end());
  DiskIndex fresh;
  fresh.init_cap(DiskIndex::cap_for(static_cast<int64_t>(cur.size())));
  for (int64_t ord : cur) {
    size_t lo = std::lower_bound(ords.begin(), ords.end(), ord) -
                ords.begin();
    if (lo < ords.size() && ords[lo] == ord && new_of[lo] >= 0) {
      fresh.insert_fresh(key_of[lo], new_of[lo]);
      continue;
    }
    // appended/rewritten during phase A (or a phase-A read miss):
    // copy from the live log now, under the lock
    const uint8_t* rec = log_record(t, d->log, ord);
    if (!rec) continue;
    uint32_t flag;
    std::memcpy(&flag, rec + 8, 4);
    if (!flag) continue;
    uint64_t key;
    std::memcpy(&key, rec, 8);
    int64_t nord = log_append_raw(t, w, rec);
    if (nord < 0) {
      drop_writer(w, tmp);
      return false;
    }
    fresh.insert_fresh(key, nord);
  }
  return publish_writer(t, d, w, tmp, fresh);
}

// request-side dispatch, called with shard_mu+disk_mu held: with the
// background worker running this is just a dirty-flag set (the push
// path sheds the whole compaction cost); without it, compact inline as
// the original engine did.
void request_bg_compact(SsdTable* t, int32_t sid, uint8_t level) {
  std::lock_guard<std::mutex> g(t->bg_mu);  // LOCK: bg_mu
  if (t->bg_dirty[sid] < level) t->bg_dirty[sid] = level;
  t->bg_cv.notify_all();
}

void maybe_compact(SsdTable* t, DiskShard* d) {
  if (!needs_compact(d)) return;
  if (t->bg_on.load(std::memory_order_relaxed))
    request_bg_compact(t, d->sid, 1);
  else
    compact_shard_locked(t, d);
}

void bg_main(SsdTable* t) {
  std::unique_lock<std::mutex> g(t->bg_mu);  // LOCK: bg_mu
  while (!t->bg_stop.load(std::memory_order_relaxed)) {
    int32_t pick = -1;
    for (size_t i = 0; i < t->bg_dirty.size(); ++i)
      if (t->bg_dirty[i]) {
        pick = static_cast<int32_t>(i);
        break;
      }
    if (pick < 0) {
      t->bg_cv.wait_for(
          g, std::chrono::milliseconds(t->bg_interval_ms));
      if (t->bg_stop.load(std::memory_order_relaxed)) break;
      // idle policy sweep: catch shards that crossed the garbage
      // threshold without a maybe_compact call landing (pure-read
      // workloads after heavy churn). compact_shard_bg re-checks the
      // policy under the lock, so a clean shard costs one lock hop.
      g.unlock();
      for (DiskShard* d : t->disk) {
        if (t->bg_stop.load(std::memory_order_relaxed)) break;
        compact_shard_bg(t, d, false);
      }
      g.lock();
      continue;
    }
    bool force = t->bg_dirty[pick] >= 2;
    t->bg_dirty[pick] = 0;
    t->bg_busy = true;
    g.unlock();
    compact_shard_bg(t, t->disk[pick], force);
    g.lock();
    t->bg_busy = false;
    t->bg_cv.notify_all();
  }
}

void bg_stop_join(SsdTable* t) {
  if (!t->bg_on.load(std::memory_order_relaxed)) return;
  {
    std::lock_guard<std::mutex> g(t->bg_mu);  // LOCK: bg_mu
    t->bg_stop.store(true, std::memory_order_relaxed);
    t->bg_cv.notify_all();
  }
  if (t->bg_thread.joinable()) t->bg_thread.join();
  t->bg_on.store(false, std::memory_order_relaxed);
  t->bg_stop.store(false, std::memory_order_relaxed);
}

SsdTable::~SsdTable() {
  bg_stop_join(this);
  for (DiskShard* s : disk) {
    if (s->log.fd >= 0) close(s->log.fd);
    delete s;
  }
  delete mem;
}

// -- admission ---------------------------------------------------------------

// both tier locks held. `bump` distinguishes observations (pushes —
// they advance the sketch) from probes (pulls/exports — they only ask).
bool admit_check(SsdTable* t, DiskShard* d, uint64_t key, bool bump) {
  int32_t thr = t->admit_threshold.load(std::memory_order_relaxed);
  if (thr <= 1 || !d->sketch.enabled()) return true;
  t->admit_checks.fetch_add(1, std::memory_order_relaxed);
  int32_t est = bump ? d->sketch.bump(key) : d->sketch.estimate(key);
  if (est >= thr) {
    t->admit_admitted.fetch_add(1, std::memory_order_relaxed);
    return true;
  }
  t->admit_rejects.fetch_add(1, std::memory_order_relaxed);
  return false;
}

// Deterministic pull row for an UNADMITTED key: exactly what
// select_into would return for a freshly created row (create_row inits
// embed_w from the per-key rng; stats zero; embedx not yet extended) —
// so the moment the key IS admitted and materializes, trainers see the
// same values they were already being served.
void synth_pull_row(Shard* sh, uint64_t key, float* out) {
  int32_t pd = sh->pull_dim();
  std::fill_n(out, pd, 0.0f);
  float w = 0.0f;
  float st[16];
  std::mt19937_64 g = sh->init_rng(key, 0xA0761D6478BD642FULL);
  sh->embed_rule.init(&w, sh->es() ? st : nullptr, g);
  if (sh->cfg->accessor == pstpu::kAccessorCtr)
    out[2] = w;
  else
    out[0] = w;
}

// full-row twin of synth_pull_row (export layout: [slot, unseen,
// delta_score, show, click, embed_w, embed_state[es], has_embedx, ...])
void synth_full_row(Shard* sh, uint64_t key, int32_t slot, float* out,
                    int32_t fdim) {
  std::fill_n(out, fdim, 0.0f);
  out[0] = static_cast<float>(slot);
  std::mt19937_64 g = sh->init_rng(key, 0xA0761D6478BD642FULL);
  sh->embed_rule.init(&out[5], sh->es() ? &out[6] : nullptr, g);
}

// -- tier logic (both shard locks held) -------------------------------------

// disk -> RAM promotion; returns the RAM row or -1 if not on disk
int32_t promote(SsdTable* t, Shard* sh, DiskShard* d, uint64_t key) {
  auto key_at = [&](int64_t o) { return log_key_at(t, d->log, o); };
  int64_t ord = d->index.find(key, key_at);
  if (ord < 0) return -1;
  uint64_t k;
  uint32_t flag;
  d->row_buf.resize(t->fdim);
  if (!read_record(t, d, ord, &k, &flag, d->row_buf.data()) || !flag ||
      k != key)
    return -1;
  int32_t r = sh->lookup_or_insert(key, static_cast<int32_t>(d->row_buf[0]));
  sh->import_row(r, d->row_buf.data());
  d->index.erase(key, key_at);  // index-only: the record becomes garbage
  return r;
}

// fan a batch over shards, holding BOTH tier locks per shard (mem first,
// disk second — consistent order across all entry points). The batched
// variant hands each shard its whole index list in one callback.
template <typename Fn>
void fan_out_batched(SsdTable* t, const uint64_t* keys, int64_t n, Fn fn) {
  int32_t ns = t->mem->cfg.shard_num;
  std::vector<std::vector<int64_t>> per(ns);
  for (int64_t i = 0; i < n; ++i)
    per[static_cast<int32_t>(keys[i] % static_cast<uint64_t>(ns))].push_back(i);
  std::vector<std::thread> ts;
  for (int32_t s = 0; s < ns; ++s) {
    if (per[s].empty()) continue;
    ts.emplace_back([&, s]() {
      Shard* sh = t->mem->shards[s];
      DiskShard* d = t->disk[s];
      std::lock_guard<std::mutex> g1(sh->mu);  // LOCK: shard_mu
      std::lock_guard<std::mutex> g2(d->mu);   // LOCK: disk_mu
      fn(sh, d, per[s]);
    });
  }
  for (auto& th : ts) th.join();
}

template <typename Fn>
void fan_out(SsdTable* t, const uint64_t* keys, int64_t n, Fn fn) {
  fan_out_batched(t, keys, n,
                  [&](Shard* sh, DiskShard* d, const std::vector<int64_t>& idx) {
                    for (int64_t i : idx) fn(sh, d, i);
                  });
}

template <typename Fn>
void per_shard(SsdTable* t, Fn fn) {
  std::vector<std::thread> ts;
  for (size_t s = 0; s < t->mem->shards.size(); ++s) {
    ts.emplace_back([&, s]() {
      Shard* sh = t->mem->shards[s];
      DiskShard* d = t->disk[s];
      std::lock_guard<std::mutex> g1(sh->mu);  // LOCK: shard_mu
      std::lock_guard<std::mutex> g2(d->mu);   // LOCK: disk_mu
      fn(sh, d, static_cast<int32_t>(s));
    });
  }
  for (auto& th : ts) th.join();
}

// full-row layout: v[1]=unseen, v[2]=delta_score, v[3]=show, v[4]=click
bool save_keep_values(const TableNativeConfig& c, const float* v,
                      int32_t mode) {
  return pstpu::save_keep(c, pstpu::show_click_score(c, v[3], v[4]), v[2],
                          v[1], mode);
}

}  // namespace

extern "C" {

// sst_stats2 field layout — keep in lockstep with ps/native.py's
// SST_STAT_FIELDS mirror (graftlint wire_contract cross-checks the two)
enum SstStatField {
  kSstHotRows = 0,
  kSstColdRows = 1,
  kSstDiskBytes = 2,
  kSstIndexBytes = 3,
  kSstSketchBytes = 4,
  kSstAdmitChecks = 5,
  kSstAdmitRejects = 6,
  kSstAdmitAdmitted = 7,
  kSstBgCompactions = 8,
  kSstBgBacklog = 9,
  kSstIoServeBytes = 10,
  kSstIoBgBytes = 11,
  kSstIoBgWaitMs = 12,
  kSstOpenBlockBytes = 13,
  kSstStatCount = 14
};

// flags bit 0: store value columns (embed_w + embedx_w) as fp16 on
// disk, optimizer state fp32 (TableConfig.ssd_value_dtype="fp16") —
// ~35-45% smaller cold-tier records at CTR shapes; reads widen.
// flags bit 1: block-compress the log (TableConfig.ssd_block_compress)
// — records grouped kSstBlockRecs per block, deflate + shared dict.
void* sst_create2(const int32_t* iparams, const float* fparams,
                  const char* dir, int32_t flags) {
  TableNativeConfig c = pstpu::parse_table_config(iparams, fparams);
  // mkdir -p: the table directory is often nested (e.g. a per-server
  // subdirectory under a job path)
  {
    std::string path(dir);
    for (size_t pos = 1; pos <= path.size(); ++pos) {
      if (pos == path.size() || path[pos] == '/') {
        std::string prefix = path.substr(0, pos);
        if (!prefix.empty() && mkdir(prefix.c_str(), 0755) != 0 &&
            errno != EEXIST)
          return nullptr;
      }
    }
  }
  SsdTable* t = new SsdTable(c, dir, flags);
  for (int32_t s = 0; s < c.shard_num; ++s) {
    DiskShard* d = new DiskShard();
    d->sid = s;
    d->path = std::string(dir) + "/ssd_shard_" + std::to_string(s) + ".dat";
    // a crash mid-compaction can leave a stale tmp behind; it is never
    // authoritative (the rename is the commit point), so drop it
    unlink((d->path + ".compact").c_str());
    d->log.comp = t->block_comp;
    d->log.fd = open(d->path.c_str(), O_RDWR | O_CREAT, 0644);
    if (d->log.fd < 0) {
      delete d;
      delete t;
      return nullptr;
    }
    replay_shard(t, d);
    t->disk.push_back(d);
  }
  return t;
}

void* sst_create(const int32_t* iparams, const float* fparams,
                 const char* dir) {
  return sst_create2(iparams, fparams, dir, 0);
}

void sst_destroy(void* h) { delete static_cast<SsdTable*>(h); }

int32_t sst_pull_dim(void* h) {
  return static_cast<SsdTable*>(h)->mem->shards[0]->pull_dim();
}
int32_t sst_push_dim(void* h) {
  return static_cast<SsdTable*>(h)->mem->shards[0]->push_dim();
}
int32_t sst_full_dim(void* h) { return static_cast<SsdTable*>(h)->fdim; }

// extended stats: fills min(n, kSstStatCount) fields of `out`, returns
// kSstStatCount so callers can size-check their mirror of the enum
int32_t sst_stats2(void* h, int64_t* out, int32_t n) {
  SsdTable* t = static_cast<SsdTable*>(h);
  int64_t f[kSstStatCount] = {0};
  for (Shard* s : t->mem->shards) {
    std::lock_guard<std::mutex> g(s->mu);  // `used` mutates under this
    f[kSstHotRows] += s->used;
  }
  for (DiskShard* d : t->disk) {
    std::lock_guard<std::mutex> g(d->mu);
    f[kSstColdRows] += d->index.used;
    f[kSstDiskBytes] += log_bytes(t, d->log);
    f[kSstIndexBytes] += d->index.bytes();
    f[kSstSketchBytes] += d->sketch.bytes();
    f[kSstOpenBlockBytes] += static_cast<int64_t>(d->log.open_raw.size());
  }
  f[kSstAdmitChecks] = t->admit_checks.load(std::memory_order_relaxed);
  f[kSstAdmitRejects] = t->admit_rejects.load(std::memory_order_relaxed);
  f[kSstAdmitAdmitted] = t->admit_admitted.load(std::memory_order_relaxed);
  f[kSstBgCompactions] = t->bg_compactions.load(std::memory_order_relaxed);
  {
    std::lock_guard<std::mutex> g(t->bg_mu);  // LOCK: bg_mu
    for (uint8_t v : t->bg_dirty)
      if (v) ++f[kSstBgBacklog];
  }
  f[kSstIoServeBytes] = t->io.serve_bytes.load(std::memory_order_relaxed);
  f[kSstIoBgBytes] = t->io.bg_bytes.load(std::memory_order_relaxed);
  f[kSstIoBgWaitMs] = t->io.bg_wait_ms.load(std::memory_order_relaxed);
  int32_t m = std::min<int32_t>(n, kSstStatCount);
  for (int32_t i = 0; i < m; ++i) out[i] = f[i];
  return kSstStatCount;
}

// rows live in RAM / rows live on disk / disk file bytes (incl. garbage)
void sst_stats(void* h, int64_t* out3) {
  int64_t f[kSstStatCount];
  sst_stats2(h, f, kSstStatCount);
  out3[0] = f[kSstHotRows];
  out3[1] = f[kSstColdRows];
  out3[2] = f[kSstDiskBytes];
}

// admission configuration: threshold <= 1 disables gating (every key
// materializes on first touch — the default, and what the parity tests
// rely on); sketch_kb is the per-shard counter budget.
void sst_admission_config(void* h, int32_t threshold, int32_t sketch_kb) {
  SsdTable* t = static_cast<SsdTable*>(h);
  for (DiskShard* d : t->disk) {
    std::lock_guard<std::mutex> g(d->mu);
    if (threshold > 1 && sketch_kb > 0 &&
        d->sketch.bytes() != static_cast<int64_t>(sketch_kb) * 1024)
      d->sketch.init(static_cast<int64_t>(sketch_kb) * 1024);
  }
  t->admit_threshold.store(threshold, std::memory_order_relaxed);
}

// token-bucket disk budget: rate_bps = 0 removes metering. cap_bytes
// <= 0 picks a burst of max(rate/4, 4 MiB).
void sst_io_budget(void* h, int64_t rate_bps, int64_t cap_bytes) {
  static_cast<SsdTable*>(h)->io.configure(rate_bps, cap_bytes);
}

// start/stop the background compactor. While running, every compaction
// trigger (push-path policy, shrink's eager pass, explicit compact)
// becomes a dirty-flag handoff to the worker.
void sst_bg_start(void* h, int32_t interval_ms) {
  SsdTable* t = static_cast<SsdTable*>(h);
  if (t->bg_on.load(std::memory_order_relaxed)) return;
  if (interval_ms > 0) t->bg_interval_ms = interval_ms;
  t->bg_stop.store(false, std::memory_order_relaxed);
  {
    std::lock_guard<std::mutex> g(t->bg_mu);  // LOCK: bg_mu
    t->bg_dirty.assign(t->disk.size(), 0);
    t->bg_busy = false;
  }
  t->bg_on.store(true, std::memory_order_relaxed);
  t->bg_thread = std::thread(bg_main, t);
}

void sst_bg_stop(void* h) { bg_stop_join(static_cast<SsdTable*>(h)); }

// single deterministic compactor iteration (tests / sched harness):
// runs the two-phase pass inline on one shard. Refused (-1) while the
// background thread owns the shard set.
int32_t sst_bg_step(void* h, int32_t shard, int32_t force) {
  SsdTable* t = static_cast<SsdTable*>(h);
  if (t->bg_on.load(std::memory_order_relaxed)) return -1;
  if (shard < 0 || shard >= static_cast<int32_t>(t->disk.size()))
    return -1;
  return compact_shard_bg(t, t->disk[shard], force != 0) ? 1 : 0;
}

// mark every shard force-dirty and return without waiting (the crash-
// injection test wants compaction IN FLIGHT, not finished)
void sst_compact_async(void* h) {
  SsdTable* t = static_cast<SsdTable*>(h);
  if (!t->bg_on.load(std::memory_order_relaxed)) return;
  std::lock_guard<std::mutex> g(t->bg_mu);  // LOCK: bg_mu
  for (auto& v : t->bg_dirty) v = 2;
  t->bg_cv.notify_all();
}

// per-shard live rows across both tiers (PrintTableStat support)
void sst_shard_sizes(void* h, int64_t* out) {
  SsdTable* t = static_cast<SsdTable*>(h);
  for (size_t s = 0; s < t->mem->shards.size(); ++s) {
    int64_t mem;
    {
      std::lock_guard<std::mutex> g(t->mem->shards[s]->mu);
      mem = t->mem->shards[s]->used;
    }
    std::lock_guard<std::mutex> g(t->disk[s]->mu);
    out[s] = mem + t->disk[s]->index.used;
  }
}

int64_t sst_size(void* h) {
  int64_t s3[3];
  sst_stats(h, s3);
  return s3[0] + s3[1];
}

// Order-independent content digest over BOTH tiers (pstpu::row_hash,
// wrapping-add combine) — the tier invariant (a key is live in at most
// one tier) makes the sum well-defined, and the per-row bytes match the
// RAM engine's export layout, so a RAM replica and an SSD replica of
// the same logical table digest identically.
uint64_t sst_digest(void* h) {
  SsdTable* t = static_cast<SsdTable*>(h);
  uint64_t dg = pstpu::table_digest(t->mem);  // hot tier (takes shard_mu)
  int32_t fd = t->fdim;
  for (DiskShard* d : t->disk) {
    std::lock_guard<std::mutex> g(d->mu);  // LOCK: disk_mu
    std::vector<int64_t> entries;
    entries.reserve(static_cast<size_t>(d->index.used));
    d->index.for_each([&](int64_t ord) { entries.push_back(ord); });
    std::sort(entries.begin(), entries.end());  // sequential block reads
    std::vector<float> v(fd);
    for (int64_t ord : entries) {
      uint64_t k;
      uint32_t flag;
      if (!read_record(t, d, ord, &k, &flag, v.data()) || !flag) continue;
      dg += pstpu::row_hash(k, v.data(), fd);
    }
  }
  return dg;
}

// Pull (select layout) with disk fallback + promotion; insert-on-miss
// into RAM when create != 0 — gated by the admission sketch: an
// unadmitted key is served its deterministic init row without
// materializing anything.
void sst_pull(void* h, const uint64_t* keys, const int32_t* slots, int64_t n,
              int32_t create, float* out) {
  SsdTable* t = static_cast<SsdTable*>(h);
  int32_t pd = t->mem->shards[0]->pull_dim();
  fan_out(t, keys, n, [&](Shard* sh, DiskShard* d, int64_t i) {
    int32_t r = sh->find(keys[i]);
    if (r < 0) r = promote(t, sh, d, keys[i]);
    float* o = out + i * pd;
    if (r < 0 && create) {
      if (admit_check(t, d, keys[i], /*bump=*/false)) {
        r = sh->lookup_or_insert(keys[i], slots ? slots[i] : 0);
      } else {
        synth_pull_row(sh, keys[i], o);
        return;
      }
    }
    if (r >= 0)
      sh->select_into(r, o);
    else
      std::fill_n(o, pd, 0.0f);
  });
}

// Push merged records (promotes cold rows first; creates on miss). A
// miss is an OBSERVATION: it bumps the admission sketch, and the
// gradient of a still-unadmitted key is dropped — the key has not
// earned a row yet, exactly Parallax's treatment of rare features.
void sst_push(void* h, const uint64_t* keys, const float* push, int64_t n) {
  SsdTable* t = static_cast<SsdTable*>(h);
  int32_t pd = t->mem->shards[0]->push_dim();
  fan_out(t, keys, n, [&](Shard* sh, DiskShard* d, int64_t i) {
    const float* pv = push + i * pd;
    int32_t r = sh->find(keys[i]);
    if (r < 0) r = promote(t, sh, d, keys[i]);
    if (r < 0) {
      if (!admit_check(t, d, keys[i], /*bump=*/true)) return;
      r = sh->lookup_or_insert(keys[i], static_cast<int32_t>(pv[0]));
    }
    sh->push_one(r, pv);
  });
}

// Full-row export with disk fallback; create promotes/creates so the
// pass-build gets one traversal exactly like pst_export_create. An
// unadmitted key reports found=1 with its deterministic init row (the
// pass cache must be able to serve it) without materializing.
void sst_export(void* h, const uint64_t* keys, const int32_t* slots,
                int64_t n, int32_t create, float* values_out, uint8_t* found) {
  SsdTable* t = static_cast<SsdTable*>(h);
  int32_t fd = t->fdim;
  fan_out(t, keys, n, [&](Shard* sh, DiskShard* d, int64_t i) {
    int32_t r = sh->find(keys[i]);
    if (r < 0) r = promote(t, sh, d, keys[i]);
    float* o = values_out + i * fd;
    if (r < 0 && create) {
      if (admit_check(t, d, keys[i], /*bump=*/false)) {
        r = sh->lookup_or_insert(keys[i], slots ? slots[i] : 0);
      } else {
        synth_full_row(sh, keys[i], slots ? slots[i] : 0, o, fd);
        if (found) found[i] = 1;
        return;
      }
    }
    if (r < 0) {
      std::fill_n(o, fd, 0.0f);
      if (found) found[i] = 0;
      return;
    }
    if (found) found[i] = 1;
    sh->export_row(r, o);
  });
}

// Bulk full-row insert into the HOT tier (cache flush-back) — erases any
// stale cold copy from the INDEX only (same semantics as promote): the
// newer value lives in volatile RAM, so the stale file record must stay
// replayable — a tombstone here would make a crash lose the feature
// outright instead of resurrecting the stale copy. Bypasses admission:
// a flush-back is a trusted explicit write, not an observation.
void sst_insert_full(void* h, const uint64_t* keys, const float* values,
                     int64_t n) {
  SsdTable* t = static_cast<SsdTable*>(h);
  int32_t fd = t->fdim;
  fan_out(t, keys, n, [&](Shard* sh, DiskShard* d, int64_t i) {
    const float* v = values + i * fd;
    int32_t r = sh->lookup_or_insert(keys[i], static_cast<int32_t>(v[0]));
    sh->import_row(r, v);
    d->index.erase(keys[i],
                   [&](int64_t o) { return log_key_at(t, d->log, o); });
  });
}

// Bulk full-row insert into the COLD tier (bulk model load: the feature
// population goes to disk; training promotes what it touches). Bypasses
// admission — a restore must materialize every checkpointed row. Raw
// mode writes contiguous bounded slices per shard: the per-row pwrite
// path costs a syscall per ~200-byte record, which collapsed bulk-load
// throughput 3.6x by 100M rows (SSD_SCALE_XL.json found it); comp mode
// gets the same amortization from block sealing. Returns the number of
// rows durably loaded+indexed; on a raw-mode short write (ENOSPC) the
// partial slice is ftruncate'd away so n_records and the file length
// stay consistent for replay, and the shortfall is visible to the
// caller instead of silently dropped.
int64_t sst_load_cold(void* h, const uint64_t* keys, const float* values,
                      int64_t n) {
  SsdTable* t = static_cast<SsdTable*>(h);
  int32_t fd = t->fdim;
  // bounded staging: big enough to amortize the syscall, small enough
  // that an un-chunked 100M-row load_cold does not allocate
  // input-proportional memory
  const size_t kSliceBytes = size_t(32) << 20;
  size_t slice_rows = std::max<size_t>(1, kSliceBytes / t->rec_bytes);
  std::atomic<int64_t> loaded{0};
  fan_out_batched(t, keys, n, [&](Shard* sh, DiskShard* d,
                                  const std::vector<int64_t>& idx) {
    auto key_at = [&](int64_t o) { return log_key_at(t, d->log, o); };
    std::vector<uint8_t> buf;
    uint32_t flag = 1;
    for (size_t lo = 0; lo < idx.size(); lo += slice_rows) {
      size_t nb = std::min(slice_rows, idx.size() - lo);
      // pre-size so the wave doesn't pay per-insert index growth (a
      // rebuild mid-wave re-reads records — fine, but not per insert)
      d->index.reserve_rows(d->index.used + static_cast<int64_t>(nb),
                            key_at);
      if (d->log.comp) {
        for (size_t j = 0; j < nb; ++j) {
          int64_t i = idx[lo + j];
          int64_t ord = log_append_row(t, d->log, keys[i], 1,
                                       values + i * fd);
          if (ord < 0) return;
          sh->erase(keys[i]);  // hot copy (if any) is superseded
          d->index.upsert(keys[i], ord, key_at);
          loaded.fetch_add(1);
        }
        continue;
      }
      buf.resize(nb * t->rec_bytes);
      for (size_t j = 0; j < nb; ++j) {
        int64_t i = idx[lo + j];
        uint8_t* r = buf.data() + j * t->rec_bytes;
        std::memcpy(r, &keys[i], 8);
        std::memcpy(r + 8, &flag, 4);
        pack_row(t, r + 12, values + i * fd);
      }
      int64_t ord0 = d->log.n;
      if (pwrite(d->log.fd, buf.data(), buf.size(), ord0 * t->rec_bytes) !=
          static_cast<ssize_t>(buf.size())) {
        // a written-but-unindexed tail past n_records would be replayed
        // after a restart and shadow newer records — truncate it away
        (void)ftruncate(d->log.fd, ord0 * t->rec_bytes);
        return;  // this shard stops; `loaded` reports the shortfall
      }
      io_account(t, d->log, static_cast<int64_t>(buf.size()));
      d->log.n = ord0 + static_cast<int64_t>(nb);
      if (getenv("SST_DEBUG"))
        std::fprintf(stderr, "slice wrote ord0=%lld nb=%zu\n",
                     (long long)ord0, nb);
      for (size_t j = 0; j < nb; ++j) {
        int64_t i = idx[lo + j];
        sh->erase(keys[i]);  // hot copy (if any) is superseded
        d->index.upsert(keys[i], ord0 + static_cast<int64_t>(j), key_at);
      }
      if (getenv("SST_DEBUG"))
        std::fprintf(stderr, "slice indexed ord0=%lld cap=%llu occ=%lld\n",
                     (long long)ord0,
                     (unsigned long long)(d->index.mask + 1),
                     (long long)d->index.occupied);
      loaded.fetch_add(static_cast<int64_t>(nb));
    }
  });
  return loaded.load();
}

// Spill the coldest RAM rows to disk until at most `budget` rows stay
// hot (global budget, split evenly across shards). Coldness order:
// highest unseen_days first, then lowest show/click score. Returns the
// number of rows spilled.
int64_t sst_spill(void* h, int64_t budget) {
  SsdTable* t = static_cast<SsdTable*>(h);
  int32_t ns = t->mem->cfg.shard_num;
  int64_t per = budget / ns;
  std::vector<int64_t> spilled(ns, 0);
  per_shard(t, [&](Shard* sh, DiskShard* d, int32_t s) {
    if (sh->used <= per) return;
    struct Cold {
      float unseen, score;
      uint64_t key;
      int32_t row;
    };
    std::vector<Cold> live;
    live.reserve(sh->used);
    for (uint64_t hh = 0; hh <= sh->mask; ++hh) {
      int32_t r = sh->slot_state[hh];
      if (r < 0) continue;
      live.push_back({sh->f_unseen[r],
                      sh->show_click_score(sh->f_show[r], sh->f_click[r]),
                      sh->slot_keys[hh], r});
    }
    int64_t excess = static_cast<int64_t>(live.size()) - per;
    std::nth_element(live.begin(), live.begin() + excess, live.end(),
                     [](const Cold& a, const Cold& b) {
                       if (a.unseen != b.unseen) return a.unseen > b.unseen;
                       return a.score < b.score;
                     });
    auto key_at = [&](int64_t o) { return log_key_at(t, d->log, o); };
    d->index.reserve_rows(d->index.used + excess, key_at);
    std::vector<float> row(t->fdim);
    for (int64_t i = 0; i < excess; ++i) {
      sh->export_row(live[i].row, row.data());
      int64_t ord = log_append_row(t, d->log, live[i].key, 1, row.data());
      if (ord < 0) break;  // disk full — keep the row hot
      d->index.upsert(live[i].key, ord, key_at);
      sh->erase(live[i].key);
      ++spilled[s];
    }
    maybe_compact(t, d);
  });
  int64_t tot = 0;
  for (int64_t v : spilled) tot += v;
  return tot;
}

// Lifecycle shrink over BOTH tiers: decay show/click, unseen_days++,
// delete dead features (ctr_accessor Shrink semantics). Disk rows are
// rewritten in place in the log (append + index update). The admission
// sketch decays here too — one halving per lifecycle boundary, so a
// key needs sustained observations (not stale accumulated mass) to
// stay admitted.
int64_t sst_shrink(void* h) {
  SsdTable* t = static_cast<SsdTable*>(h);
  std::vector<int64_t> erased(t->mem->shards.size(), 0);
  const TableNativeConfig& c = t->mem->cfg;
  per_shard(t, [&](Shard* sh, DiskShard* d, int32_t s) {
    if (d->sketch.enabled()) d->sketch.decay();
    erased[s] = sh->shrink();
    // disk sweep: collect ordinals first (rewrites mutate the index);
    // sorted for sequential record reads
    auto key_at = [&](int64_t o) { return log_key_at(t, d->log, o); };
    std::vector<int64_t> entries;
    entries.reserve(static_cast<size_t>(d->index.used));
    d->index.for_each([&](int64_t ord) { entries.push_back(ord); });
    std::sort(entries.begin(), entries.end());
    std::vector<float> v(t->fdim);
    for (int64_t ord : entries) {
      uint64_t key;
      uint32_t flag;
      if (!read_record(t, d, ord, &key, &flag, v.data()) || !flag) continue;
      if (pstpu::shrink_one(c, &v[3], &v[4], &v[1])) {
        d->index.erase(key, key_at);
        log_append_row(t, d->log, key, 0, nullptr);
        ++erased[s];
      } else {
        int64_t nord = log_append_row(t, d->log, key, 1, v.data());
        if (nord >= 0) d->index.upsert(key, nord, key_at);
      }
    }
    // the sweep just rewrote EVERY live cold row, so the log is now
    // >=50% garbage by construction — the lazy 4x amortized policy
    // (maybe_compact) would let daily shrinks stack the log to 3-4x
    // the live footprint before reclaiming (found by the endurance
    // run: +1x table size of disk per shrink). Compact eagerly here:
    // one extra sequential rewrite per daily boundary keeps disk at
    // ~1x live between days (handed to the bg worker when running).
    if (d->log.n > 2 * std::max<int64_t>(d->index.used, 1) &&
        d->log.n > 4096) {
      if (t->bg_on.load(std::memory_order_relaxed))
        request_bg_compact(t, d->sid, 2);
      else
        compact_shard_locked(t, d);
    }
  });
  int64_t tot = 0;
  for (int64_t e : erased) tot += e;
  return tot;
}

int64_t sst_compact(void* h) {
  SsdTable* t = static_cast<SsdTable*>(h);
  if (t->bg_on.load(std::memory_order_relaxed)) {
    // route through the worker (there must be exactly one compactor per
    // shard), then wait for the backlog to drain so callers keep the
    // "returns the compacted footprint" contract
    std::unique_lock<std::mutex> g(t->bg_mu);  // LOCK: bg_mu
    for (auto& v : t->bg_dirty) v = 2;
    t->bg_cv.notify_all();
    t->bg_cv.wait(g, [&] {
      if (t->bg_stop.load(std::memory_order_relaxed)) return true;
      if (t->bg_busy) return false;
      for (uint8_t v : t->bg_dirty)
        if (v) return false;
      return true;
    });
  } else {
    per_shard(t, [&](Shard*, DiskShard* d, int32_t) {
      compact_shard_locked(t, d);
    });
  }
  int64_t bytes = 0;
  for (DiskShard* d : t->disk) {
    // log bytes mutate under the disk mutex (append/spill workers of a
    // CONCURRENT caller may still be running) — read under the lock
    std::lock_guard<std::mutex> g(d->mu);
    bytes += log_bytes(t, d->log);
  }
  return bytes;
}

// Save protocol (begin/fetch), both tiers; same mode semantics as the
// RAM engine. Disk rows needing update_stat_after_save (modes 2/3) are
// rewritten in the log. Both tier locks are held together PER SHARD so
// the snapshot is atomic against concurrent promote/spill on that shard
// (a key's tiers live in one shard; cross-shard skew is fine — the RAM
// engine has the same per-shard granularity).
int64_t sst_save_begin(void* h, int32_t mode) {
  SsdTable* t = static_cast<SsdTable*>(h);
  std::lock_guard<std::mutex> sg(t->save_mu);       // LOCK: ssd_save_mu
  std::lock_guard<std::mutex> mg(t->mem->save_mu);  // LOCK: mem_save_mu
  t->mem->save_keys.clear();
  t->mem->save_values.clear();
  const TableNativeConfig& c = t->mem->cfg;
  int32_t fd = t->fdim;
  for (size_t s = 0; s < t->mem->shards.size(); ++s) {
    Shard* sh = t->mem->shards[s];
    DiskShard* d = t->disk[s];
    std::lock_guard<std::mutex> g1(sh->mu);  // LOCK: shard_mu
    std::lock_guard<std::mutex> g2(d->mu);  // LOCK: disk_mu
    // hot tier (the table_save_snapshot_locked body, one shard)
    for (uint64_t hh = 0; hh <= sh->mask; ++hh) {
      int32_t r = sh->slot_state[hh];
      if (r < 0) continue;
      if (!sh->save_keep(r, mode)) continue;
      sh->update_stat_after_save(r, mode);
      t->mem->save_keys.push_back(sh->slot_keys[hh]);
      size_t off = t->mem->save_values.size();
      t->mem->save_values.resize(off + fd);
      sh->export_row(r, t->mem->save_values.data() + off);
    }
    // cold tier sweep (sorted ordinals: sequential block reads)
    auto key_at = [&](int64_t o) { return log_key_at(t, d->log, o); };
    std::vector<int64_t> entries;
    entries.reserve(static_cast<size_t>(d->index.used));
    d->index.for_each([&](int64_t ord) { entries.push_back(ord); });
    std::sort(entries.begin(), entries.end());
    std::vector<float> v(fd);
    for (int64_t ord : entries) {
      uint64_t key;
      uint32_t flag;
      if (!read_record(t, d, ord, &key, &flag, v.data()) || !flag) continue;
      if (!save_keep_values(c, v.data(), mode)) continue;
      // update_stat_after_save applies BEFORE the snapshot copy — the
      // RAM engine exports after updating
      bool dirty = false;
      if (mode == 3) {
        v[1] += 1.0f;
        dirty = true;
      } else if (mode == 1 || mode == 2) {
        // mode 1: the reference resets delta_score on rows a delta save
        // kept (CtrCommonAccessor::UpdateStatAfterSave param=1) so
        // repeated deltas don't re-emit unchanged rows; mode 2 keeps the
        // round-1 behavior of starting a fresh delta epoch at base saves
        v[2] = 0.0f;
        dirty = true;
      }
      t->mem->save_keys.push_back(key);
      size_t off = t->mem->save_values.size();
      t->mem->save_values.resize(off + fd);
      std::memcpy(t->mem->save_values.data() + off, v.data(),
                  4 * static_cast<size_t>(fd));
      if (dirty) {
        int64_t nord = log_append_row(t, d->log, key, 1, v.data());
        if (nord >= 0) d->index.upsert(key, nord, key_at);
      }
    }
    // modes 2/3 rewrite every kept cold row — without compaction here,
    // repeated checkpoints grow the log unboundedly
    maybe_compact(t, d);
  }
  return static_cast<int64_t>(t->mem->save_keys.size());
}

void sst_save_fetch(void* h, uint64_t* keys_out, float* values_out) {
  SsdTable* t = static_cast<SsdTable*>(h);
  std::lock_guard<std::mutex> sg(t->save_mu);  // LOCK: ssd_save_mu
  pstpu::table_save_drain(t->mem, keys_out, values_out);
}

void sst_flush(void* h) {
  SsdTable* t = static_cast<SsdTable*>(h);
  for (DiskShard* d : t->disk) {
    std::lock_guard<std::mutex> g(d->mu);
    log_seal(t, d->log);  // comp mode: the open block is volatile
    fsync(d->log.fd);
  }
}

// Streaming checkpoint save straight to a shard file — the save path
// for populations whose snapshot cannot be materialized in RAM (the
// begin/fetch protocol stages the WHOLE keep-set; at 1e9 rows that is
// tens of GB). Same per-shard atomicity, filter and
// update_stat_after_save semantics as sst_save_begin. Returns rows
// written, or -1 on an IO error (partial file removed).
//
// format (the use_gzip arg doubles as a format selector):
//   0 = plain text (sparse_table.h format_text_row)
//   1 = gzip'd text (zlib level 1; portable, compact on low-entropy
//       rows, but CPU-bound on zlib+printf at 1e9 rows)
//   2 = RAW BINARY: header [u32 'PTSB', u32 version=1, u32 fdim,
//       u32 reserved] then fixed records [u64 key][f32 full_row[fdim]]
//       — runs at IO speed (no format/parse CPU), trading bytes for
//       throughput on high-entropy rows; same filter semantics
constexpr uint32_t kBinMagic = 0x42535450u;  // 'PTSB'

int64_t sst_save_file(void* h, const char* path, int32_t mode,
                      int32_t use_gzip) {
  SsdTable* t = static_cast<SsdTable*>(h);
  std::lock_guard<std::mutex> sg(t->save_mu);  // LOCK: ssd_save_mu
  const TableNativeConfig& c = t->mem->cfg;
  int32_t fd = t->fdim;
  int32_t ed = pstpu::rule_state_dim(c.embed_rule, 1);
  gzFile gz = nullptr;
  FILE* fp = nullptr;
  bool binary = use_gzip == 2;
  if (use_gzip == 1) {
    // level 1: the save is CPU-bound on zlib at 1e9 rows; fast-level
    // ratio on this low-entropy text is within ~25% of default-6
    gz = gzopen(path, "wb1");
    if (!gz) return -1;
  } else {
    fp = std::fopen(path, binary ? "wb" : "w");
    if (!fp) return -1;
    if (binary) {
      uint32_t hdr[4] = {kBinMagic, 1u, static_cast<uint32_t>(fd), 0u};
      if (std::fwrite(hdr, 1, sizeof(hdr), fp) != sizeof(hdr)) {
        std::fclose(fp);
        std::remove(path);
        return -1;
      }
    }
  }
  std::vector<char> line(64 + 24 * static_cast<size_t>(fd));
  int64_t written = 0;
  bool io_ok = true;
  size_t rec = 8 + 4 * static_cast<size_t>(fd);
  auto emit = [&](uint64_t key, const float* v) {
    bool ok;
    if (binary) {
      std::memcpy(line.data(), &key, 8);
      std::memcpy(line.data() + 8, v, 4 * static_cast<size_t>(fd));
      ok = std::fwrite(line.data(), 1, rec, fp) == rec;
    } else {
      int len = pstpu::format_text_row(line.data(), line.size(), key, v,
                                       fd, ed);
      ok = gz ? gzwrite(gz, line.data(), len) == len
              : std::fwrite(line.data(), 1, (size_t)len, fp) == (size_t)len;
    }
    if (ok)
      ++written;
    else
      io_ok = false;
  };
  for (size_t s = 0; io_ok && s < t->mem->shards.size(); ++s) {
    Shard* sh = t->mem->shards[s];
    DiskShard* d = t->disk[s];
    std::lock_guard<std::mutex> g1(sh->mu);  // LOCK: shard_mu
    std::lock_guard<std::mutex> g2(d->mu);  // LOCK: disk_mu
    std::vector<float> row(fd);
    for (uint64_t hh = 0; io_ok && hh <= sh->mask; ++hh) {
      int32_t r = sh->slot_state[hh];
      if (r < 0) continue;
      if (!sh->save_keep(r, mode)) continue;
      sh->update_stat_after_save(r, mode);
      sh->export_row(r, row.data());
      emit(sh->slot_keys[hh], row.data());
    }
    auto key_at = [&](int64_t o) { return log_key_at(t, d->log, o); };
    std::vector<int64_t> entries;
    entries.reserve(static_cast<size_t>(d->index.used));
    d->index.for_each([&](int64_t ord) { entries.push_back(ord); });
    std::sort(entries.begin(), entries.end());
    for (int64_t ord : entries) {
      if (!io_ok) break;
      uint64_t key;
      uint32_t flag;
      if (!read_record(t, d, ord, &key, &flag, row.data()) || !flag) continue;
      if (!save_keep_values(c, row.data(), mode)) continue;
      bool dirty = false;
      if (mode == 3) {
        row[1] += 1.0f;
        dirty = true;
      } else if (mode == 1 || mode == 2) {
        row[2] = 0.0f;
        dirty = true;
      }
      emit(key, row.data());
      if (dirty) {
        int64_t nord = log_append_row(t, d->log, key, 1, row.data());
        if (nord >= 0) d->index.upsert(key, nord, key_at);
      }
    }
    maybe_compact(t, d);
  }
  if (gz ? gzclose(gz) != Z_OK : std::fclose(fp) != 0) io_ok = false;
  if (!io_ok) {
    std::remove(path);
    return -1;
  }
  return written;
}

// Streaming load of a shard file (format per sst_save_file: 0 text,
// 1 gzip text, 2 raw binary) into the COLD tier in bounded batches
// (the restart/reload path at populations that must not stage in RAM).
// Returns rows loaded, or -(parsed+1) when the underlying bulk load
// fell short (disk full), or -1 on open/header errors.
int64_t sst_load_file(void* h, const char* path, int32_t use_gzip) {
  SsdTable* t = static_cast<SsdTable*>(h);
  const TableNativeConfig& c = t->mem->cfg;
  int32_t fd = t->fdim;
  int32_t ed = pstpu::rule_state_dim(c.embed_rule, 1);
  if (use_gzip == 2) {
    FILE* bf = std::fopen(path, "rb");
    if (!bf) return -1;
    uint32_t hdr[4];
    if (std::fread(hdr, 1, sizeof(hdr), bf) != sizeof(hdr) ||
        hdr[0] != kBinMagic || hdr[1] != 1u ||
        hdr[2] != static_cast<uint32_t>(fd)) {
      std::fclose(bf);
      return -1;  // wrong magic/version or fdim mismatch
    }
    const int64_t kBatch = 1 << 19;
    size_t rec = 8 + 4 * static_cast<size_t>(fd);
    std::vector<uint8_t> buf(static_cast<size_t>(kBatch) * rec);
    std::vector<uint64_t> keys(kBatch);
    std::vector<float> vals(static_cast<size_t>(kBatch) * fd);
    int64_t loaded = 0;
    bool short_load = false;
    while (!short_load) {
      size_t got = std::fread(buf.data(), rec, kBatch, bf);
      if (!got) break;
      for (size_t j = 0; j < got; ++j) {
        std::memcpy(&keys[j], buf.data() + j * rec, 8);
        std::memcpy(vals.data() + j * fd, buf.data() + j * rec + 8,
                    4 * static_cast<size_t>(fd));
      }
      int64_t n = sst_load_cold(h, keys.data(), vals.data(),
                                static_cast<int64_t>(got));
      loaded += n;
      if (n != static_cast<int64_t>(got)) short_load = true;
    }
    std::fclose(bf);
    return short_load ? -(loaded + 1) : loaded;
  }
  gzFile gz = nullptr;
  FILE* fp = nullptr;
  if (use_gzip == 1) {
    gz = gzopen(path, "rb");
    if (!gz) return -1;
  } else {
    fp = std::fopen(path, "r");
    if (!fp) return -1;
  }
  const int64_t kBatch = 1 << 19;  // ~0.5M rows per cold-tier append wave
  std::vector<uint64_t> keys;
  std::vector<float> vals;
  keys.reserve(kBatch);
  vals.reserve(kBatch * fd);
  std::vector<char> line(64 + 32 * static_cast<size_t>(fd));
  std::vector<float> row(fd);
  int64_t loaded = 0;
  bool short_load = false;
  auto flush_batch = [&]() {
    if (keys.empty()) return;
    int64_t got = sst_load_cold(h, keys.data(), vals.data(),
                                static_cast<int64_t>(keys.size()));
    loaded += got;
    if (got != static_cast<int64_t>(keys.size())) short_load = true;
    keys.clear();
    vals.clear();
  };
  while (!short_load) {
    char* got = gz ? gzgets(gz, line.data(), (int)line.size())
                   : std::fgets(line.data(), (int)line.size(), fp);
    if (!got) break;
    uint64_t key;
    if (!pstpu::parse_text_row(line.data(), &key, row.data(), fd, ed,
                               c.embedx_dim))
      continue;
    keys.push_back(key);
    vals.insert(vals.end(), row.begin(), row.end());
    if (static_cast<int64_t>(keys.size()) >= kBatch) flush_batch();
  }
  if (!short_load) flush_batch();
  if (gz) gzclose(gz); else std::fclose(fp);
  return short_load ? -(loaded + 1) : loaded;
}

}  // extern "C"
