// paddle_tpu_torch's own copy of paddle_tpu/csrc/sparse_table.h. New rows are a
// pure function of (key, table seed) and the row rules round every f32
// operation on its own (-ffp-contract=off), so both copies must stay
// identical in behaviour: the port's SSD table is held bit for bit
// against the JAX package's.
//
// Native MemorySparseTable engine — shared structs (see sparse_table.cc
// for provenance and the C ABI; ps_service.cc embeds these for the
// server-side tables).
//
// Lock hierarchy (checked by tools/lint/lock_order.py; grammar in
// docs/STATIC_ANALYSIS.md): table_save_snapshot takes the table-wide
// save_mu, and the *_locked body then takes each shard's mu in turn —
// so save_mu always precedes any shard mu, and no two shard mus are
// ever held together.
// LOCK ORDER: save_mu < shard_mu
#pragma once

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <utility>
#include <vector>

namespace pstpu {


// ---------------------------------------------------------------------------
// config / rule ids
// ---------------------------------------------------------------------------

enum RuleId : int32_t {
  kRuleNaive = 0,
  kRuleAdaGrad = 1,
  kRuleStdAdaGrad = 2,
  kRuleAdam = 3,
};

enum AccessorId : int32_t {
  kAccessorCtr = 0,     // pull = [show, click, embed_w, embedx_w...]
  kAccessorSparse = 1,  // pull = [embed_w, embedx_w...]
};

struct SgdConfig {
  float learning_rate = 0.05f;
  float initial_g2sum = 3.0f;
  float initial_range = 1e-4f;
  float weight_lo = -10.0f;
  float weight_hi = 10.0f;
  float beta1 = 0.9f;
  float beta2 = 0.999f;
  float ada_epsilon = 1e-8f;
};

struct TableNativeConfig {
  int32_t shard_num = 16;
  int32_t accessor = kAccessorCtr;
  int32_t embedx_dim = 8;
  int32_t embed_rule = kRuleAdaGrad;
  int32_t embedx_rule = kRuleAdaGrad;
  uint64_t seed = 0;
  // accessor lifecycle (CtrAccessorParameter mirror)
  float nonclk_coeff = 0.1f;
  float click_coeff = 1.0f;
  float base_threshold = 1.5f;
  float delta_threshold = 0.25f;
  float delta_keep_days = 16.0f;
  float show_click_decay_rate = 0.98f;
  float delete_threshold = 0.8f;
  float delete_after_unseen_days = 30.0f;
  float embedx_threshold = 10.0f;
  SgdConfig sgd;
};

// -- lifecycle math shared by the RAM and SSD engines (one definition:
// the disk tier must keep/delete/decay EXACTLY like the hot tier) ------

inline float show_click_score(const TableNativeConfig& c, float show,
                              float click) {
  return (show - click) * c.nonclk_coeff + click * c.click_coeff;
}

// Save keep filter (ctr_accessor.cc:55-135 semantics; mode 0=all,
// 1=delta, 2=base, 3=batch).
inline bool save_keep(const TableNativeConfig& c, float score,
                      float delta_score, float unseen, int32_t mode) {
  if (mode == 0 || mode == 3) return true;
  float dth = (mode == 2) ? 0.0f : c.delta_threshold;
  return score >= c.base_threshold && delta_score >= dth &&
         unseen <= c.delta_keep_days;
}

// Daily shrink step on one feature: decay + age; returns true when the
// feature is dead (delete it).
inline bool shrink_one(const TableNativeConfig& c, float* show, float* click,
                       float* unseen) {
  *show *= c.show_click_decay_rate;
  *click *= c.show_click_decay_rate;
  *unseen += 1.0f;
  float score = show_click_score(c, *show, *click);
  return score < c.delete_threshold || *unseen > c.delete_after_unseen_days;
}

inline int32_t rule_state_dim(int32_t rule, int32_t dim) {
  switch (rule) {
    case kRuleNaive: return 0;
    case kRuleAdaGrad: return 1;
    case kRuleStdAdaGrad: return dim;
    case kRuleAdam: return 2 * dim + 2;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// IEEE fp16 <-> fp32 (no F16C dependency — must build on any host the
// toolchain targets). Shared by the half-precision pull/push wire
// formats (ps_service.cc) and the SSD fp16 record format
// (ssd_table.cc); numpy's float16 casts produce the identical bits
// (both are IEEE round-to-nearest-even), which is what lets the Python
// client and the C++ server agree byte-for-byte.
// ---------------------------------------------------------------------------

inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((x >> 23) & 0xff) - 127 + 15;
  uint32_t mant = x & 0x7fffffu;
  if (exp >= 0x1f) {  // overflow/inf/nan
    if (((x >> 23) & 0xff) == 0xff && mant)
      return static_cast<uint16_t>(sign | 0x7e00u);  // nan (quiet)
    return static_cast<uint16_t>(sign | 0x7c00u);    // inf / overflow
  }
  if (exp <= 0) {  // subnormal or zero
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;  // implicit leading 1
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1))) half++;
    return static_cast<uint16_t>(sign | half);
  }
  uint32_t half = (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;  // RNE
  return static_cast<uint16_t>(sign | half);
}

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  int32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0x1f) {  // inf / nan (widening keeps the payload)
    bits = sign | 0x7f800000u | (mant << 13);
  } else if (exp == 0) {
    if (!mant) {
      bits = sign;  // signed zero
    } else {        // subnormal: renormalize into fp32's range
      exp = 1;
      while (!(mant & 0x400u)) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3ffu;
      bits = sign | (static_cast<uint32_t>(exp - 15 + 127) << 23) |
             (mant << 13);
    }
  } else {
    bits = sign | (static_cast<uint32_t>(exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// ---------------------------------------------------------------------------
// SGD rules (sparse_sgd_rule.cc math, batched-of-one form)
// ---------------------------------------------------------------------------

struct SgdRule {
  int32_t id;
  int32_t dim;        // embedding dim this rule drives
  int32_t state_dim;  // optimizer-state floats per feature
  SgdConfig cfg;

  SgdRule(int32_t id_, int32_t dim_, const SgdConfig& c)
      : id(id_), dim(dim_), state_dim(rule_state_dim(id_, dim_)), cfg(c) {}

  inline float clip(float w) const {
    return std::min(std::max(w, cfg.weight_lo), cfg.weight_hi);
  }

  // init: weights uniform(-initial_range, initial_range); state zeros
  // (adam: beta powers start at beta1/beta2).
  void init(float* w, float* state, std::mt19937_64& rng) const {
    std::uniform_real_distribution<float> u(-cfg.initial_range, cfg.initial_range);
    for (int32_t i = 0; i < dim; ++i) w[i] = u(rng);
    for (int32_t i = 0; i < state_dim; ++i) state[i] = 0.0f;
    if (id == kRuleAdam) {
      state[2 * dim] = cfg.beta1;
      state[2 * dim + 1] = cfg.beta2;
    }
  }

  // update one feature's weights in place. grad has `dim` floats; scale
  // is the push_show scale (AdaGrad family divides by it; Adam ignores
  // it, matching the reference).
  void update(float* w, float* state, const float* grad, float scale) const {
    switch (id) {
      case kRuleNaive: {
        for (int32_t i = 0; i < dim; ++i)
          w[i] = clip(w[i] - cfg.learning_rate * grad[i]);
        break;
      }
      case kRuleAdaGrad: {
        float s = std::max(scale, 1e-10f);
        float g2sum = state[0];
        float ratio = std::sqrt(cfg.initial_g2sum / (cfg.initial_g2sum + g2sum));
        float add = 0.0f;
        for (int32_t i = 0; i < dim; ++i) {
          float sg = grad[i] / s;
          w[i] = clip(w[i] - cfg.learning_rate * sg * ratio);
          add += sg * sg;
        }
        state[0] = g2sum + add / static_cast<float>(dim);
        break;
      }
      case kRuleStdAdaGrad: {
        float s = std::max(scale, 1e-10f);
        for (int32_t i = 0; i < dim; ++i) {
          float sg = grad[i] / s;
          float ratio =
              std::sqrt(cfg.initial_g2sum / (cfg.initial_g2sum + state[i]));
          w[i] = clip(w[i] - cfg.learning_rate * sg * ratio);
          state[i] += sg * sg;
        }
        break;
      }
      case kRuleAdam: {
        float* m = state;
        float* v = state + dim;
        float b1p = state[2 * dim];
        float b2p = state[2 * dim + 1];
        for (int32_t i = 0; i < dim; ++i) {
          float g = grad[i];
          m[i] = cfg.beta1 * m[i] + (1.0f - cfg.beta1) * g;
          v[i] = cfg.beta2 * v[i] + (1.0f - cfg.beta2) * g * g;
          float m_hat = m[i] / (1.0f - b1p);
          float v_hat = v[i] / (1.0f - b2p);
          w[i] = clip(w[i] - cfg.learning_rate * m_hat /
                                 (std::sqrt(v_hat) + cfg.ada_epsilon));
        }
        state[2 * dim] = b1p * cfg.beta1;
        state[2 * dim + 1] = b2p * cfg.beta2;
        break;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// open-addressing key -> row index (same scheme as sparse_index.cc)
// ---------------------------------------------------------------------------

constexpr int32_t kEmpty = -1;
constexpr int32_t kTombstone = -2;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Per-INSTANCE hash salt for every linear-probing index. Load-bearing,
// found the hard way at 0.66e9 rows (round 5): checkpoint saves emit
// rows in the SOURCE index's hash order, and re-inserting keys in
// home-slot order into a linear-probing table is the classic quadratic
// pathology — the occupied slots form one solid run, every insert
// whose home falls inside it probes to the run's end (millions of
// probes, below any full-table guard), and a 1e8-row restore "hangs".
// Salting each index instance randomly means no two tables agree on
// home order, so any iteration order of one table is random order for
// another. Process-local entropy only — hash order was never a
// persisted contract (files are keyed text; values replay by key).
inline uint64_t next_hash_salt() {
  // counter makes instances within a process distinct; the clock makes
  // instance #k of one process distinct from instance #k of another
  // (the restore case: fresh server processes re-creating tables in
  // the same order as the savers did)
  static std::atomic<uint64_t> ctr{0x243F6A8885A308D3ULL};
  uint64_t now = static_cast<uint64_t>(
      std::chrono::steady_clock::now().time_since_epoch().count());
  return splitmix64(ctr.fetch_add(0x9E3779B97F4A7C15ULL) ^ now);
}

// ---------------------------------------------------------------------------
// shard: index + columnar feature storage + accessor math
// ---------------------------------------------------------------------------

struct Shard {
  const TableNativeConfig* cfg;
  SgdRule embed_rule;
  SgdRule embedx_rule;
  // Row-init randomness is a PURE FUNCTION of (key, table seed), NOT a
  // stream-positioned generator. A shared-seed stream only stays
  // aligned between a primary and a subscriber that replayed every
  // frame from draw zero; a snapshot-attached subscriber (rejoined
  // backup, serving replica) copies rows but not the generator
  // position, so the first lazily-initialized embedx after the cut
  // would draw different values on each side — a silent bit-divergence
  // the change-feed digests caught. Keyed init makes every catch-up
  // path (live tail, snapshot+tail, mixed) converge bit-for-bit.
  uint64_t init_seed;
  std::mutex mu;

  // index
  std::vector<uint64_t> slot_keys;
  std::vector<int32_t> slot_state;  // row | kEmpty | kTombstone
  uint64_t mask = 0;
  uint64_t hash_salt = next_hash_salt();  // see next_hash_salt()
  // atomic so size probes (pst_size, ps_service sparse_rows — the
  // replication insert-detector on the pull hot path) read it WITHOUT
  // taking the shard lock; all writes still happen under mu
  std::atomic<int64_t> used{0};
  int64_t occupied = 0;

  uint64_t slot_of(uint64_t key) const {
    return splitmix64(key ^ hash_salt) & mask;
  }

  // rows (SoA). row_alive gates recycled rows.
  std::vector<uint64_t> row_key;
  std::vector<uint8_t> row_alive;
  std::vector<int32_t> free_rows;
  std::vector<int32_t> f_slot;
  std::vector<float> f_unseen, f_delta_score, f_show, f_click;
  std::vector<float> f_embed_w;       // [rows]
  std::vector<float> f_embed_state;   // [rows, es]
  std::vector<float> f_embedx_w;      // [rows, xd]
  std::vector<float> f_embedx_state;  // [rows, xs]
  std::vector<uint8_t> f_has_embedx;

  Shard(const TableNativeConfig* c, uint64_t seed)
      : cfg(c),
        embed_rule(c->embed_rule, 1, c->sgd),
        embedx_rule(c->embedx_rule, c->embedx_dim, c->sgd),
        init_seed(seed) {
    slot_keys.assign(1024, 0);
    slot_state.assign(1024, kEmpty);
    mask = 1023;
  }

  // per-key init generator; the salt decorrelates the embed draw from
  // the embedx draw for the same key (same distribution bounds would
  // otherwise make embed_w == embedx_w[0] on every fresh row)
  std::mt19937_64 init_rng(uint64_t key, uint64_t salt) const {
    return std::mt19937_64(splitmix64(key ^ init_seed ^ salt));
  }

  int32_t es() const { return embed_rule.state_dim; }
  int32_t xd() const { return cfg->embedx_dim; }
  int32_t xs() const { return embedx_rule.state_dim; }

  void grow_index() {
    std::vector<uint64_t> ok(std::move(slot_keys));
    std::vector<int32_t> os(std::move(slot_state));
    uint64_t cap = (mask + 1) << 1;
    slot_keys.assign(cap, 0);
    slot_state.assign(cap, kEmpty);
    mask = cap - 1;
    occupied = 0;
    for (size_t i = 0; i < ok.size(); ++i) {
      if (os[i] >= 0) {
        uint64_t h = slot_of(ok[i]);
        while (slot_state[h] != kEmpty) h = (h + 1) & mask;
        slot_keys[h] = ok[i];
        slot_state[h] = os[i];
        ++occupied;
      }
    }
  }

  int32_t find(uint64_t key) const {
    uint64_t h = slot_of(key);
    uint64_t probes = 0;
    while (true) {
      int32_t s = slot_state[h];
      if (s == kEmpty) return -1;
      if (s >= 0 && slot_keys[h] == key) return s;
      h = (h + 1) & mask;
      if (++probes > mask + 1) {
        std::fprintf(stderr, "Shard.find: full-table probe (cap=%llu "
                             "used=%lld occupied=%lld)\n",
                     (unsigned long long)(mask + 1), (long long)used,
                     (long long)occupied);
        std::abort();
      }
    }
  }

  int32_t alloc_row(uint64_t key) {
    int32_t r;
    if (!free_rows.empty()) {
      r = free_rows.back();
      free_rows.pop_back();
    } else {
      r = static_cast<int32_t>(row_key.size());
      row_key.push_back(0);
      row_alive.push_back(0);
      f_slot.push_back(0);
      f_unseen.push_back(0);
      f_delta_score.push_back(0);
      f_show.push_back(0);
      f_click.push_back(0);
      f_embed_w.push_back(0);
      f_embed_state.resize(f_embed_state.size() + es(), 0.0f);
      f_embedx_w.resize(f_embedx_w.size() + xd(), 0.0f);
      f_embedx_state.resize(f_embedx_state.size() + xs(), 0.0f);
      f_has_embedx.push_back(0);
    }
    row_key[r] = key;
    row_alive[r] = 1;
    return r;
  }

  // Create (insert-on-miss): full reset — recycled rows must not inherit
  // the dead feature's stats.
  void create_row(int32_t r, int32_t slot) {
    f_slot[r] = slot;
    f_unseen[r] = 0;
    f_delta_score[r] = 0;
    f_show[r] = 0;
    f_click[r] = 0;
    std::mt19937_64 g = init_rng(row_key[r], 0xA0761D6478BD642FULL);
    embed_rule.init(&f_embed_w[r], es() ? &f_embed_state[r * es()] : nullptr, g);
    std::fill_n(&f_embedx_w[static_cast<size_t>(r) * xd()], xd(), 0.0f);
    if (xs())
      std::fill_n(&f_embedx_state[static_cast<size_t>(r) * xs()], xs(), 0.0f);
    f_has_embedx[r] = 0;  // embedx lazy (NeedExtendMF)
  }

  int32_t lookup_or_insert(uint64_t key, int32_t slot) {
    uint64_t h = slot_of(key);
    int64_t first_tomb = -1;
    uint64_t probes = 0;
    while (true) {
      if (probes++ > mask + 1) {
        std::fprintf(stderr, "Shard.lookup_or_insert: full-table probe "
                             "(cap=%llu used=%lld occupied=%lld)\n",
                     (unsigned long long)(mask + 1), (long long)used,
                     (long long)occupied);
        std::abort();
      }
      int32_t s = slot_state[h];
      if (s == kEmpty) {
        uint64_t target = (first_tomb >= 0) ? static_cast<uint64_t>(first_tomb) : h;
        int32_t r = alloc_row(key);
        create_row(r, slot);
        slot_keys[target] = key;
        slot_state[target] = r;
        ++used;
        if (first_tomb < 0) ++occupied;
        if (occupied * 10 >= static_cast<int64_t>(mask + 1) * 7) grow_index();
        return r;
      }
      if (s == kTombstone) {
        if (first_tomb < 0) first_tomb = static_cast<int64_t>(h);
      } else if (slot_keys[h] == key) {
        return s;
      }
      h = (h + 1) & mask;
    }
  }

  void erase(uint64_t key) {
    uint64_t h = slot_of(key);
    uint64_t probes = 0;
    while (true) {
      int32_t s = slot_state[h];
      if (s == kEmpty) return;
      if (s >= 0 && slot_keys[h] == key) {
        slot_state[h] = kTombstone;
        row_alive[s] = 0;
        free_rows.push_back(s);
        --used;
        return;
      }
      h = (h + 1) & mask;
      if (++probes > mask + 1) {
        std::fprintf(stderr,
                     "Shard.erase: full-table probe (cap=%llu used=%d "
                     "state[0..3]=%d,%d,%d,%d) — no empty slot\n",
                     (unsigned long long)(mask + 1), (int)used,
                     (int)slot_state[0], (int)slot_state[1],
                     (int)slot_state[2], (int)slot_state[3]);
        std::abort();
      }
    }
  }

  float show_click_score(float show, float click) const {
    return pstpu::show_click_score(*cfg, show, click);
  }

  int32_t pull_dim() const {
    return cfg->accessor == kAccessorCtr ? 3 + xd() : 1 + xd();
  }
  int32_t push_dim() const { return 4 + xd(); }

  // Select (pull): CTR = [show, click, embed_w, embedx_w...]; Sparse
  // drops the stats.
  void select_into(int32_t r, float* out) const {
    const float* xw = &f_embedx_w[static_cast<size_t>(r) * xd()];
    float have = f_has_embedx[r] ? 1.0f : 0.0f;
    if (cfg->accessor == kAccessorCtr) {
      out[0] = f_show[r];
      out[1] = f_click[r];
      out[2] = f_embed_w[r];
      for (int32_t i = 0; i < xd(); ++i) out[3 + i] = xw[i] * have;
    } else {
      out[0] = f_embed_w[r];
      for (int32_t i = 0; i < xd(); ++i) out[1 + i] = xw[i] * have;
    }
  }

  // Push one merged record: [slot, show, click, embed_g, embedx_g...]
  // (ctr_accessor.cc:219 semantics).
  void push_one(int32_t r, const float* pv) {
    float push_show = pv[1], push_click = pv[2];
    f_show[r] += push_show;
    f_click[r] += push_click;
    f_delta_score[r] += (push_show - push_click) * cfg->nonclk_coeff +
                        push_click * cfg->click_coeff;
    f_unseen[r] = 0.0f;
    embed_rule.update(&f_embed_w[r], es() ? &f_embed_state[r * es()] : nullptr,
                      pv + 3, push_show);
    float score = show_click_score(f_show[r], f_click[r]);
    size_t xo = static_cast<size_t>(r) * xd();
    if (!f_has_embedx[r] && score >= cfg->embedx_threshold) {
      std::mt19937_64 g = init_rng(row_key[r], 0xE7037ED1A0B428DBULL);
      embedx_rule.init(&f_embedx_w[xo],
                       xs() ? &f_embedx_state[static_cast<size_t>(r) * xs()] : nullptr,
                       g);
      f_has_embedx[r] = 1;
      // creation happens before the embedx update, so the fresh row
      // consumes this push's embedx gradient (same order as the Python
      // accessor and the reference's CtrCommonAccessor::Update)
      embedx_rule.update(&f_embedx_w[xo],
                         xs() ? &f_embedx_state[static_cast<size_t>(r) * xs()] : nullptr,
                         pv + 4, push_show);
    } else if (f_has_embedx[r]) {
      embedx_rule.update(&f_embedx_w[xo],
                         xs() ? &f_embedx_state[static_cast<size_t>(r) * xs()] : nullptr,
                         pv + 4, push_show);
    }
  }

  // Shrink (daily): decay show/click, unseen++, drop dead features.
  int64_t shrink() {
    int64_t erased = 0;
    for (uint64_t h = 0; h <= mask; ++h) {
      int32_t r = slot_state[h];
      if (r < 0) continue;
      if (shrink_one(*cfg, &f_show[r], &f_click[r], &f_unseen[r])) {
        slot_state[h] = kTombstone;
        row_alive[r] = 0;
        free_rows.push_back(r);
        --used;
        ++erased;
      }
    }
    return erased;
  }

  // Retain (live resharding, ps/reshard.py): drop every row whose key
  // falls outside the (modulus, residue) ownership class — the
  // key-range filter a reshard cutover applies after the migrated
  // residues have been copied off this shard. Caller holds mu.
  int64_t retain(uint64_t mod, uint64_t res) {
    int64_t erased = 0;
    for (uint64_t h = 0; h <= mask; ++h) {
      int32_t r = slot_state[h];
      if (r < 0) continue;
      if (slot_keys[h] % mod != res) {
        slot_state[h] = kTombstone;
        row_alive[r] = 0;
        free_rows.push_back(r);
        --used;
        ++erased;
      }
    }
    return erased;
  }

  // full-row layout helpers (save/export/import share one definition;
  // layout: slot, unseen, delta_score, show, click, embed_w,
  // embed_state[es], has_embedx, embedx_w[xd], embedx_state[xs])
  void export_row(int32_t r, float* o) const {
    int32_t e = es(), x = xd(), s = xs();
    o[0] = static_cast<float>(f_slot[r]);
    o[1] = f_unseen[r];
    o[2] = f_delta_score[r];
    o[3] = f_show[r];
    o[4] = f_click[r];
    o[5] = f_embed_w[r];
    for (int32_t j = 0; j < e; ++j) o[6 + j] = f_embed_state[r * e + j];
    o[6 + e] = f_has_embedx[r] ? 1.0f : 0.0f;
    for (int32_t j = 0; j < x; ++j)
      o[7 + e + j] = f_embedx_w[static_cast<size_t>(r) * x + j];
    for (int32_t j = 0; j < s; ++j)
      o[7 + e + x + j] = f_embedx_state[static_cast<size_t>(r) * s + j];
  }

  void import_row(int32_t r, const float* v) {
    int32_t e = es(), x = xd(), s = xs();
    f_slot[r] = static_cast<int32_t>(v[0]);
    f_unseen[r] = v[1];
    f_delta_score[r] = v[2];
    f_show[r] = v[3];
    f_click[r] = v[4];
    f_embed_w[r] = v[5];
    for (int32_t j = 0; j < e; ++j) f_embed_state[r * e + j] = v[6 + j];
    f_has_embedx[r] = v[6 + e] != 0.0f;
    for (int32_t j = 0; j < x; ++j)
      f_embedx_w[static_cast<size_t>(r) * x + j] = v[7 + e + j];
    for (int32_t j = 0; j < s; ++j)
      f_embedx_state[static_cast<size_t>(r) * s + j] = v[7 + e + x + j];
  }

  bool save_keep(int32_t r, int32_t mode) const {
    return pstpu::save_keep(*cfg, show_click_score(f_show[r], f_click[r]),
                            f_delta_score[r], f_unseen[r], mode);
  }

  void update_stat_after_save(int32_t r, int32_t mode) {
    if (mode == 3)
      f_unseen[r] += 1.0f;
    else if (mode == 1 || mode == 2)
      // mode 1: delta-save keep-set resets delta_score so repeated
      // deltas don't re-emit unchanged rows (CtrCommonAccessor::
      // UpdateStatAfterSave param=1); mode 2 additionally starts a
      // fresh delta epoch at base saves (deliberate superset)
      f_delta_score[r] = 0.0f;
  }
};

// ---------------------------------------------------------------------------
// table: shard fan-out
// ---------------------------------------------------------------------------

struct NativeTable {
  TableNativeConfig cfg;
  std::vector<Shard*> shards;
  // save snapshot (begin/fetch protocol): values are MATERIALIZED at
  // begin time under the shard locks, so concurrent push/shrink between
  // begin and fetch cannot corrupt the checkpoint
  std::mutex save_mu;
  std::vector<uint64_t> save_keys;
  std::vector<float> save_values;

  explicit NativeTable(const TableNativeConfig& c) : cfg(c) {
    shards.reserve(cfg.shard_num);
    for (int32_t i = 0; i < cfg.shard_num; ++i)
      shards.push_back(new Shard(&cfg, cfg.seed + static_cast<uint64_t>(i)));
  }
  ~NativeTable() {
    for (Shard* s : shards) delete s;
  }

  int32_t route(uint64_t key) const {
    return static_cast<int32_t>(key % static_cast<uint64_t>(cfg.shard_num));
  }

  // fan a batch over shards with one worker thread per non-empty shard
  template <typename Fn>
  void parallel_over_shards(const uint64_t* keys, int64_t n, Fn fn) {
    int32_t ns = cfg.shard_num;
    std::vector<std::vector<int64_t>> per_shard(ns);
    for (int64_t i = 0; i < n; ++i) per_shard[route(keys[i])].push_back(i);
    std::vector<std::thread> ts;
    for (int32_t s = 0; s < ns; ++s) {
      if (per_shard[s].empty()) continue;
      ts.emplace_back([&, s]() {
        Shard* sh = shards[s];
        std::lock_guard<std::mutex> g(sh->mu);
        for (int64_t i : per_shard[s]) fn(sh, i);
      });
    }
    for (auto& t : ts) t.join();
  }
};

// full save/load row width: slot, unseen, delta_score, show, click,
// embed_w, embed_state[es], has_embedx, embedx_w[xd], embedx_state[xs]
inline int32_t table_full_dim(const NativeTable* t) {
  const Shard* s = t->shards[0];
  return 7 + s->es() + s->xd() + s->xs();
}

// iparams: shard_num, accessor, embedx_dim, embed_rule, embedx_rule, seed
// fparams: nonclk, click, base_th, delta_th, delta_keep, decay, del_th,
//          del_unseen, embedx_th, lr, init_g2sum, init_range, w_lo, w_hi,
//          beta1, beta2, ada_eps
inline TableNativeConfig parse_table_config(const int32_t* ip, const float* fp) {
  TableNativeConfig c;
  c.shard_num = ip[0];
  c.accessor = ip[1];
  c.embedx_dim = ip[2];
  c.embed_rule = ip[3];
  c.embedx_rule = ip[4];
  c.seed = static_cast<uint64_t>(ip[5]);
  c.nonclk_coeff = fp[0];
  c.click_coeff = fp[1];
  c.base_threshold = fp[2];
  c.delta_threshold = fp[3];
  c.delta_keep_days = fp[4];
  c.show_click_decay_rate = fp[5];
  c.delete_threshold = fp[6];
  c.delete_after_unseen_days = fp[7];
  c.embedx_threshold = fp[8];
  c.sgd.learning_rate = fp[9];
  c.sgd.initial_g2sum = fp[10];
  c.sgd.initial_range = fp[11];
  c.sgd.weight_lo = fp[12];
  c.sgd.weight_hi = fp[13];
  c.sgd.beta1 = fp[14];
  c.sgd.beta2 = fp[15];
  c.sgd.ada_epsilon = fp[16];
  return c;
}

// Snapshot the save keep-set (mode filter + update_stat_after_save)
// into t->save_keys/save_values under the shard locks. Caller holds
// t->save_mu (the _locked variant); the plain wrapper takes it.
inline int64_t table_save_snapshot_locked(NativeTable* t, int32_t mode) {
  int32_t fd = table_full_dim(t);
  t->save_keys.clear();
  t->save_values.clear();
  for (Shard* sh : t->shards) {
    std::lock_guard<std::mutex> g(sh->mu);
    for (uint64_t hh = 0; hh <= sh->mask; ++hh) {
      int32_t r = sh->slot_state[hh];
      if (r < 0) continue;
      if (sh->save_keep(r, mode)) {
        sh->update_stat_after_save(r, mode);
        t->save_keys.push_back(sh->slot_keys[hh]);
        size_t off = t->save_values.size();
        t->save_values.resize(off + fd);
        sh->export_row(r, t->save_values.data() + off);
      }
    }
  }
  return static_cast<int64_t>(t->save_keys.size());
}

inline int64_t table_save_snapshot(NativeTable* t, int32_t mode) {
  std::lock_guard<std::mutex> sg(t->save_mu);
  return table_save_snapshot_locked(t, mode);
}

// Copy + clear the snapshot. Returns the count copied (0 if no snapshot).
inline int64_t table_save_drain(NativeTable* t, uint64_t* keys_out,
                                float* values_out) {
  std::lock_guard<std::mutex> sg(t->save_mu);
  int64_t n = static_cast<int64_t>(t->save_keys.size());
  if (n) {
    std::memcpy(keys_out, t->save_keys.data(), n * sizeof(uint64_t));
    std::memcpy(values_out, t->save_values.data(),
                t->save_values.size() * sizeof(float));
  }
  t->save_keys.clear();
  t->save_values.clear();
  return n;
}

// Export full rows for a key subset; found may be null. With create,
// missing keys are inserted first (slot from slots[] or 0) — the
// single-traversal pass-build load (pull-with-create + state export in
// one shard visit; round-1 did two full traversals here).
inline void table_export(NativeTable* t, const uint64_t* keys, int64_t n,
                         float* values_out, uint8_t* found,
                         int32_t create = 0, const int32_t* slots = nullptr) {
  int32_t fd = table_full_dim(t);
  t->parallel_over_shards(keys, n, [&](Shard* sh, int64_t i) {
    int32_t r = create ? sh->lookup_or_insert(keys[i], slots ? slots[i] : 0)
                       : sh->find(keys[i]);
    float* o = values_out + i * fd;
    if (r < 0) {
      std::fill_n(o, fd, 0.0f);
      if (found) found[i] = 0;
      return;
    }
    if (found) found[i] = 1;
    sh->export_row(r, o);
  });
}

// Bulk insert/overwrite of full rows (load path / cache flush-back).
inline void table_insert_full(NativeTable* t, const uint64_t* keys,
                              const float* values, int64_t n) {
  int32_t fd = table_full_dim(t);
  t->parallel_over_shards(keys, n, [&](Shard* sh, int64_t i) {
    const float* v = values + i * fd;
    int32_t r = sh->lookup_or_insert(keys[i], static_cast<int32_t>(v[0]));
    sh->import_row(r, v);
  });
}

// -- accessor checkpoint text row -------------------------------------------
// ONE definition of the shard-file line format, shared by the RAM and
// SSD engines' server-side save/load (ps_service kSaveFile/kLoadFile)
// and byte-compatible with the Python writer/parser
// (ps/table.py format_shard_row / parse_shard_row): fields are
//   key slot unseen delta_score show click embed_w embed_state[ed]
//   [embedx_w[xd] embedx_state...]     (embedx block omitted when the
// has_embedx flag at v[6+ed] is 0). %g precisions match the Python
// f-strings exactly (.6g head stats, .8g weights/state).

inline int format_text_row(char* buf, size_t cap, uint64_t key,
                           const float* v, int32_t fd, int32_t ed) {
  int off = std::snprintf(buf, cap, "%llu %d %.6g %.6g %.6g %.6g %.8g",
                          static_cast<unsigned long long>(key),
                          static_cast<int>(v[0]), v[1], v[2], v[3], v[4],
                          v[5]);
  for (int32_t i = 0; i < ed; ++i)
    off += std::snprintf(buf + off, cap - off, " %.8g", v[6 + i]);
  if (v[6 + ed] != 0.0f)
    for (int32_t i = 7 + ed; i < fd; ++i)
      off += std::snprintf(buf + off, cap - off, " %.8g", v[i]);
  buf[off++] = '\n';
  buf[off] = '\0';
  return off;
}

// Parse one line into (key, full row). Returns false on a malformed
// line (short head). A tail with >= xd floats sets the has_embedx flag;
// anything shorter leaves the embedx block zero (row never promoted).
inline bool parse_text_row(const char* line, uint64_t* key, float* row,
                           int32_t fd, int32_t ed, int32_t xd) {
  char* end = nullptr;
  unsigned long long k = std::strtoull(line, &end, 10);
  if (end == line) return false;
  *key = static_cast<uint64_t>(k);
  const char* p = end;
  std::memset(row, 0, sizeof(float) * static_cast<size_t>(fd));
  int32_t head = 6 + ed;
  for (int32_t i = 0; i < head; ++i) {
    float v = std::strtof(p, &end);
    if (end == p) return false;
    row[i] = v;
    p = end;
  }
  int32_t tmax = fd - head - 1;
  int32_t cnt = 0;
  while (cnt < tmax) {
    float v = std::strtof(p, &end);
    if (end == p) break;
    row[head + 1 + cnt] = v;
    p = end;
    ++cnt;
  }
  if (cnt >= xd && xd > 0) row[head] = 1.0f;
  return true;
}

// -- content digest ---------------------------------------------------------
// Order-independent 64-bit digest of a table's full logical content:
// per-row FNV-1a over [key bytes ++ full-row float bytes], combined with
// wrapping ADD so shard layout, index salt, and iteration order do not
// matter — two replicas that hold bit-identical rows produce the same
// digest regardless of how their hash tables arranged them. Shared by
// the RAM engine (here), the SSD engine (ssd_table.cc hashes both
// tiers), and the PS service's kDigest command, which is how the HA
// tests assert primary ≡ backup without shipping every row.

inline uint64_t row_hash(uint64_t key, const float* v, int32_t fd) {
  uint64_t h = 14695981039346656037ULL;  // FNV-1a offset basis
  auto mix = [&h](const void* b, size_t n) {
    const uint8_t* q = static_cast<const uint8_t*>(b);
    for (size_t i = 0; i < n; ++i) {
      h ^= q[i];
      h *= 1099511628211ULL;  // FNV prime
    }
  };
  mix(&key, 8);
  mix(v, 4 * static_cast<size_t>(fd));
  return h;
}

inline uint64_t table_digest(NativeTable* t) {
  int32_t fd = table_full_dim(t);
  std::vector<float> row(fd);
  uint64_t dg = 0;
  for (Shard* sh : t->shards) {
    std::lock_guard<std::mutex> g(sh->mu);  // LOCK: shard_mu
    for (uint64_t hh = 0; hh <= sh->mask; ++hh) {
      int32_t r = sh->slot_state[hh];
      if (r < 0) continue;
      sh->export_row(r, row.data());
      dg += row_hash(sh->slot_keys[hh], row.data(), fd);
    }
  }
  return dg;
}

// Digest restricted to one (modulus, residue) key class — the reshard
// verification primitive (ps/reshard.py): the digest is a wrapping SUM
// of per-row hashes, so digest(all) == digest(class A) + digest(class
// B) for any partition, and "no row lost or doubled" across a
// migration is an O(1) equality over these filtered sums.
inline uint64_t table_digest_filtered(NativeTable* t, uint64_t mod,
                                      uint64_t res) {
  int32_t fd = table_full_dim(t);
  std::vector<float> row(fd);
  uint64_t dg = 0;
  for (Shard* sh : t->shards) {
    std::lock_guard<std::mutex> g(sh->mu);  // LOCK: shard_mu
    for (uint64_t hh = 0; hh <= sh->mask; ++hh) {
      int32_t r = sh->slot_state[hh];
      if (r < 0) continue;
      if (sh->slot_keys[hh] % mod != res) continue;
      sh->export_row(r, row.data());
      dg += row_hash(sh->slot_keys[hh], row.data(), fd);
    }
  }
  return dg;
}

}  // namespace pstpu
