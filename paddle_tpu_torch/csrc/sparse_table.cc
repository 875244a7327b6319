// paddle_tpu_torch's own copy of paddle_tpu/csrc/sparse_table.cc: the C ABI of
// the native RAM table engine (sparse_table.h's NativeTable), the engine the
// PS service's RAM tables run. A trainer-local table on it
// (ps.table.NativeMemorySparseTable) applies the servers' accessor and SGD
// rules bit for bit, which the measured-placement collective plane needs.
//
// Threading model: one worker thread per shard per request, a per-shard
// mutex making concurrent requests safe. The snapshot paths take the
// table-wide save_mu, then each shard's mu (both declared in
// sparse_table.h); this file only ever holds ONE per-shard mu at a time.
//
// C ABI only (ctypes-friendly); all batch buffers are caller-owned.

#include "sparse_table.h"

using pstpu::NativeTable;
using pstpu::Shard;
using pstpu::TableNativeConfig;
using pstpu::table_full_dim;

namespace {
// unqualified name kept for the ABI bodies below; pstpu::table_full_dim
// is the shared definition
inline int32_t full_dim(const NativeTable* t) { return pstpu::table_full_dim(t); }
}  // namespace


// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* pst_create(const int32_t* iparams, const float* fparams) {
  // param order documented at pstpu::parse_table_config (sparse_table.h)
  return new NativeTable(pstpu::parse_table_config(iparams, fparams));
}

void pst_destroy(void* h) { delete static_cast<NativeTable*>(h); }

int32_t pst_pull_dim(void* h) {
  return static_cast<NativeTable*>(h)->shards[0]->pull_dim();
}
int32_t pst_push_dim(void* h) {
  return static_cast<NativeTable*>(h)->shards[0]->push_dim();
}
int32_t pst_full_dim(void* h) { return full_dim(static_cast<NativeTable*>(h)); }

int64_t pst_size(void* h) {
  NativeTable* t = static_cast<NativeTable*>(h);
  int64_t n = 0;
  for (Shard* s : t->shards) n += s->used;
  return n;
}

// per-shard live-row counts (PrintTableStat support); out has shard_num slots
void pst_shard_sizes(void* h, int64_t* out) {
  NativeTable* t = static_cast<NativeTable*>(h);
  for (size_t i = 0; i < t->shards.size(); ++i) out[i] = t->shards[i]->used;
}

// Pull with insert-on-miss (create != 0). keys [n], slots [n] (may be
// null -> slot 0), out [n, pull_dim]. Missing keys w/o create pull zeros.
void pst_pull(void* h, const uint64_t* keys, const int32_t* slots, int64_t n,
              int32_t create, float* out) {
  NativeTable* t = static_cast<NativeTable*>(h);
  int32_t pd = t->shards[0]->pull_dim();
  t->parallel_over_shards(keys, n, [&](Shard* sh, int64_t i) {
    int32_t r = create ? sh->lookup_or_insert(keys[i], slots ? slots[i] : 0)
                       : sh->find(keys[i]);
    float* o = out + i * pd;
    if (r >= 0)
      sh->select_into(r, o);
    else
      std::fill_n(o, pd, 0.0f);
  });
}

// Push merged records: keys [n] (caller pre-merges duplicates), push
// [n, push_dim] = slot, show, click, embed_g, embedx_g...
void pst_push(void* h, const uint64_t* keys, const float* push, int64_t n) {
  NativeTable* t = static_cast<NativeTable*>(h);
  int32_t pd = t->shards[0]->push_dim();
  t->parallel_over_shards(keys, n, [&](Shard* sh, int64_t i) {
    const float* pv = push + i * pd;
    int32_t r = sh->lookup_or_insert(keys[i], static_cast<int32_t>(pv[0]));
    sh->push_one(r, pv);
  });
}

int64_t pst_shrink(void* h) {
  NativeTable* t = static_cast<NativeTable*>(h);
  std::vector<std::thread> ts;
  std::vector<int64_t> erased(t->shards.size(), 0);
  for (size_t s = 0; s < t->shards.size(); ++s)
    ts.emplace_back([&, s]() {
      std::lock_guard<std::mutex> g(t->shards[s]->mu);
      erased[s] = t->shards[s]->shrink();
    });
  for (auto& th : ts) th.join();
  int64_t tot = 0;
  for (int64_t e : erased) tot += e;
  return tot;
}

// Save protocol: begin(mode) snapshots the keep-set (applying
// update_stat_after_save) and returns its count; fetch copies
// keys [count] + values [count, full_dim] out and clears the cursor.
int64_t pst_save_begin(void* h, int32_t mode) {
  return pstpu::table_save_snapshot(static_cast<NativeTable*>(h), mode);
}

void pst_save_fetch(void* h, uint64_t* keys_out, float* values_out) {
  pstpu::table_save_drain(static_cast<NativeTable*>(h), keys_out, values_out);
}

// Bulk export of full rows for a key subset (cache pass-build state
// load): no insert-on-miss; found[i]=0 rows are zero-filled.
void pst_export(void* h, const uint64_t* keys, int64_t n, float* values_out,
                uint8_t* found) {
  pstpu::table_export(static_cast<NativeTable*>(h), keys, n, values_out, found);
}

// Export with insert-on-miss: one shard traversal creates missing rows
// (slots[] or 0) AND reads the full state (begin_pass build).
void pst_export_create(void* h, const uint64_t* keys, const int32_t* slots,
                       int64_t n, float* values_out, uint8_t* found) {
  pstpu::table_export(static_cast<NativeTable*>(h), keys, n, values_out,
                      found, 1, slots);
}

// Bulk insert of full rows (load path / cache flush-back): keys [n],
// values [n, full_dim] in the save layout.
void pst_insert_full(void* h, const uint64_t* keys, const float* values,
                     int64_t n) {
  pstpu::table_insert_full(static_cast<NativeTable*>(h), keys, values, n);
}

// Order-independent content digest (pstpu::row_hash over every live
// row, wrapping-add combine) — HA replica consistency checks compare
// this across servers instead of shipping rows.
uint64_t pst_digest(void* h) {
  return pstpu::table_digest(static_cast<NativeTable*>(h));
}

}  // extern "C"
