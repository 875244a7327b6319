// paddle_tpu_torch's own copy of paddle_tpu/csrc/ps_service.cc. The wire format
// (the 44-byte request header, command ids, status codes) and the table
// handlers must stay identical in behaviour: a client of either package
// talks to a server of either package, and rows pushed through either
// come out bit for bit equal (-ffp-contract=off, as the JAX build).
// Two changes to the ABI: pss_create takes the IPv4 address to listen on
// (the JAX service always listens on every interface), and the catalog is
// read by pss_catalog_copy into the caller's buffer (pss_catalog_get
// staged it in the shipper's buffer, which a migration's snapshot thread
// would race).
//
// Native TCP parameter-server transport: the DCN control/data plane for
// multi-host CPU tables.
//
// TPU-build counterpart of the reference's brpc PS service
// (paddle/fluid/distributed/ps/service/brpc_ps_{client,server}.cc and
// sendrecv.proto PsCmdID command dispatch — behaviorally: one connection
// per client/server pair, length-prefixed request frames dispatched by
// command id to table handlers, async on the client via caller threads).
// Intra-pod parameter movement rides ICI inside compiled XLA programs;
// this service carries what stays host-side: pull/push of CPU-resident
// sparse/dense tables, GEO deltas, barriers, save/load streaming.
//
// Wire format (little-endian, host order — same-arch cluster assumed):
//   request:  [u64 payload_len][u32 cmd][u32 table_id][i64 n][i32 aux]
//             [payload bytes]
//   response: [u64 payload_len][i64 status][payload bytes]
// status >= 0 is the command's count/result; < 0 is an error code.
//
// Server: accept thread + one handler thread per connection (a handful
// of trainers per server; the reference sizes brpc thread pools
// similarly). Tables are the sparse_table.h engine (shard-parallel, so
// one busy connection still uses all cores).
//
// Lock hierarchy (checked by tools/lint/lock_order.py): the registry
// lock tables_mu is released BEFORE any per-table lock is taken (see
// kSaveAll: the ssd_save_mu pointer is copied out under tables_mu, then
// locked after the scope closes) — the declared order below is the only
// legal nesting if a future handler ever must hold both. conn_mu,
// bar_mu, the per-dense/geo-table mu and the client-side PsConn mu are
// LEAF locks: nothing may be acquired while one is held — the lint
// enforces this via the LOCK LEAF decl, which is what keeps the
// interleaved per-connection request path (N handler threads hitting
// the same tables while the parallel client fans out) deadlock-free by
// construction. The table engines' internal order
// (save_mu < shard_mu < ...) is declared where those locks live
// (sparse_table.h, ssd_table.cc).
// The HA additions keep the same discipline: oplog_mu (oplog ring +
// catalog + staging), gate_mu (mutation pause gate), and fault_mu
// (chaos faultpoints) are all LEAF locks — the tap/gate/fault sections
// in handle() acquire exactly one of them, release it, and only then
// enter table code; the replication shipper thread (Python-side,
// through pss_oplog_next) likewise touches only oplog_mu.
// The observability additions follow the same discipline:
// obs_mu (per-table wire counters + the bounded server-span ring) is a
// LEAF lock — obs_account() and the kObsSnap handler acquire exactly
// it, never while holding any other lock, and never enter table code
// under it.
// The tenancy additions likewise: tenants_mu (the tenant
// registry — token buckets, quotas, shed counters) is a LEAF lock.
// tenant_admit() copies the tenant's config out under it, releases it,
// and only then walks tables_mu for the quota usage probe; the bucket
// charge re-acquires it alone.
// LOCK ORDER: tables_mu < save_mu < shard_mu
// LOCK ORDER: tables_mu < dense_mu
// LOCK LEAF: conn_mu bar_mu mu oplog_mu gate_mu fault_mu obs_mu tenants_mu

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <netdb.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <deque>
#include <map>
#include <memory>
#include <string>
#include <unordered_map>

#include <zlib.h>

#include "graph_store.h"
#include "sparse_table.h"

// two-tier SSD table engine (ssd_table.cc, same shared library): the
// server routes a table's commands to this ABI when the create request
// asks for storage=ssd
extern "C" {
void* sst_create(const int32_t* iparams, const float* fparams, const char* dir);
void* sst_create2(const int32_t* iparams, const float* fparams,
                  const char* dir, int32_t flags);
void sst_destroy(void* h);
int32_t sst_pull_dim(void* h);
int32_t sst_push_dim(void* h);
int32_t sst_full_dim(void* h);
int64_t sst_size(void* h);
void sst_stats(void* h, int64_t* out3);
void sst_pull(void* h, const uint64_t* keys, const int32_t* slots, int64_t n,
              int32_t create, float* out);
void sst_push(void* h, const uint64_t* keys, const float* push, int64_t n);
void sst_export(void* h, const uint64_t* keys, const int32_t* slots,
                int64_t n, int32_t create, float* values_out, uint8_t* found);
void sst_insert_full(void* h, const uint64_t* keys, const float* values,
                     int64_t n);
int64_t sst_spill(void* h, int64_t budget);
int64_t sst_shrink(void* h);
int64_t sst_compact(void* h);
int64_t sst_save_begin(void* h, int32_t mode);
void sst_save_fetch(void* h, uint64_t* keys_out, float* values_out);
int64_t sst_load_cold(void* h, const uint64_t* keys, const float* values,
                      int64_t n);
int64_t sst_save_file(void* h, const char* path, int32_t mode,
                      int32_t use_gzip);
int64_t sst_load_file(void* h, const char* path, int32_t use_gzip);
uint64_t sst_digest(void* h);
}

namespace {

using pstpu::NativeTable;
using pstpu::TableNativeConfig;
using pstpu::table_full_dim;

// a sparse table is one of the two engines
struct SparseRef {
  NativeTable* mem = nullptr;
  void* ssd = nullptr;
  int32_t pull_dim() const {
    return mem ? mem->shards[0]->pull_dim() : sst_pull_dim(ssd);
  }
  int32_t push_dim() const {
    return mem ? mem->shards[0]->push_dim() : sst_push_dim(ssd);
  }
  int32_t full_dim() const {
    return mem ? table_full_dim(mem) : sst_full_dim(ssd);
  }
};

enum Cmd : uint32_t {
  kCreateSparse = 1,
  kCreateDense = 2,
  kPullSparse = 3,
  kPushSparse = 4,
  kPullDense = 5,
  kPushDense = 6,
  kSetDense = 7,
  kSize = 8,
  kShrink = 9,
  kSaveBegin = 10,
  kSaveFetch = 11,
  kInsertFull = 12,
  kExport = 13,
  kBarrier = 14,
  kStop = 15,
  kPing = 16,
  kGlobalStep = 17,
  kCreateGeo = 18,
  kPushGeo = 19,
  kPullGeo = 20,
  kSaveAll = 21,
  kSpill = 22,   // aux unused; n = hot-row budget (SSD tables)
  kStats = 23,   // -> [hot_rows, cold_rows, disk_bytes] i64[3]
  kCompact = 24,
  // graph service (common_graph_table.cc over the PS transport; the
  // graph brpc service role). Node ids partition client-side by
  // id % num_servers; edges live with their SRC node.
  kCreateGraph = 25,         // aux = shard_num (0 → 16)
  kGraphAddNodes = 26,       // n ids; aux = feat_dim; payload ids [+ feats]
  kGraphAddEdges = 27,       // n edges; payload src + dst + w
  kGraphSampleNeighbors = 28,  // n ids; aux = k | weighted<<30 → nbrs+mask
  kGraphDegree = 29,         // n ids → i32 degrees
  kGraphNodeFeat = 30,       // n ids; aux = feat_dim → f32 [n, feat_dim]
  kGraphSetNodeFeat = 31,    // n ids; aux = feat_dim; payload ids + feats
  kGraphSampleNodes = 32,    // n = count → u64 ids (uniform, this server)
  kGraphStats = 33,          // → i64 [nodes, edges]
  // bulk model load/save for populations that must not stage in client
  // RAM or cross the wire as one frame (the 1e9-row regime)
  kLoadCold = 34,   // n rows; payload keys + full rows → cold tier (SSD)
  kSaveFile = 35,   // aux = mode | gzip<<8; payload = server-local path;
                    // server streams its shard to the file itself
  kLoadFile = 36,   // aux = gzip<<8; payload = path; streams it back in
  // -- HA / replication (ps/ha.py drives these; docs/OPERATIONS.md §6) --
  kReplicate = 37,  // apply a primary's oplog entry: payload = inner
                    // frame [ReqHeader][payload]; n = oplog seq (-1 =
                    // untracked catalog replay); aux = primary's epoch —
                    // rejected with kErrStaleEpoch when behind ours
                    // (a demoted primary cannot overwrite its successor)
  kEpoch = 38,      // n < 0: read; n >= 0: set epoch = n. status = epoch
  kReplState = 39,  // n < 0: read → i64[2]{applied_seq, epoch};
                    // n >= 0: set applied_seq = n (post-snapshot rebase)
  kDigest = 40,     // → u64 order-independent content digest (row_hash)
  kDenseSnap = 41,  // dense table full state → [i64 t][values][m][v]
                    // (m/v present only for adam); status = dim
  kDenseRestore = 42,  // payload as kDenseSnap's response; replaces state
  // -- live elastic resharding (ps/reshard.py; docs/OPERATIONS.md §15) --
  kRetain = 44,   // n = modulus (0 = read), aux = residue. Sets this
                  // server's key-OWNERSHIP predicate (key % n == aux;
                  // aux = -1 owns NOTHING — the retiring-shard fence)
                  // and, when 0 <= aux < n, erases every RAM-table row
                  // outside it (the key-range filter a reshard cutover
                  // applies after migrating the moved residues away).
                  // Once ownership is set, keyed data commands carrying
                  // a non-owned key bounce whole with kErrWrongShard —
                  // a stale-topology client re-resolves the routing
                  // table and replays (RpcPsClient misroute replay).
                  // Pause-EXEMPT (issued while the cutover gate holds
                  // writers) but tapped into the oplog, so a shard's
                  // backups converge to the same retained row set.
                  // n = 0 reads: payload i64[2]{modulus, residue}.
  // -- observability (paddle_tpu/obs drives this; docs/OPERATIONS.md §13) --
  kObsSnap = 43,  // per-table wire counters + server-side trace spans:
                  // aux&1 drains the span ring, aux&2 resets the wire
                  // counters. Response: [u32 n_tables][u32 n_spans]
                  // [i64 spans_dropped] ++ n_tables × WireRec(48B) ++
                  // n_spans × SpanRec(64B) — obs/trace.py mirrors the
                  // two record structs (SERVER_WIRE_STRUCT /
                  // SERVER_SPAN_STRUCT); drift = parse failure in
                  // tests, not silent misreads (sizes are asserted).
  // -- multi-tenancy (ps/tenancy.py drives these; docs/OPERATIONS.md
  // §20). The tenant tag is the table_id's HIGH BYTE (kTenantShift):
  // a connection bound to tenant T != 0 can only address tables tagged
  // T, so one tenant can never read or write another tenant's rows.
  kTenantHello = 45,   // bind THIS connection to tenant n (1..255);
                       // payload = auth token bytes. Tenant 0 (the
                       // operator/default plane — legacy clients,
                       // replication shippers, control tools) needs no
                       // hello and sees the whole server.
  kTenantConfig = 46,  // operator plane only. n = 1: install/update a
                       // tenant from the packed payload (id, priority
                       // class, token-bucket rate/burst, row/SSD-byte
                       // quotas, token). n = 0: read the tenant's usage
                       // meter → [rows, ssd_bytes, throttled,
                       // quota_refused i64×4][tokens f64][pclass i64].
};

enum Err : int64_t {
  kErrBadCmd = -1,
  kErrNoTable = -2,
  kErrBadSize = -3,
  kErrInternal = -4,
  kErrStaleEpoch = -5,  // kReplicate from a fenced (demoted) primary
  kErrSeqGap = -6,      // kReplicate seq skipped entries — resync needed
  kErrReadOnly = -7,    // training-plane mutation on a read-only replica
  kErrWrongShard = -8,  // keyed data op carrying a key outside this
                        // server's (modulus, residue) ownership — the
                        // client routed with a STALE shard topology and
                        // must re-resolve the routing table and replay
                        // (rejected whole, before any state change, so
                        // the replay applies each key exactly once)
  kErrWrongTenant = -9,  // the cmd addressed a table outside the
                         // connection's tenant namespace (table_id high
                         // byte), named an unknown tenant or bad hello
                         // token, or is a control-plane cmd from a
                         // non-operator connection. Rejected whole,
                         // before any state change or oplog tap.
  kErrQuota = -10,       // the tenant's row/SSD-byte quota is exhausted:
                         // row-creating commands refuse whole — another
                         // tenant's rows are NEVER evicted to make room
  kErrThrottled = -11,   // the tenant's token-bucket request budget is
                         // dry: shed with a hint — response payload is
                         // one i64, the suggested retry_after_ms
};

// commands whose application changes table state: these are the ops a
// primary taps into its oplog for the backup (pull/export only when the
// insert-on-miss bit is set — a miss creates a row). kLoadFile/kSaveFile
// are deliberately NOT replicated: they are operator restore/backup
// flows with server-local paths (ha.py documents the restriction).
inline bool is_mutating_cmd(uint32_t cmd, int32_t aux, int64_t n) {
  switch (cmd) {
    case kPushSparse:
    case kPushDense:
    case kSetDense:
    case kInsertFull:
    case kLoadCold:
    case kPushGeo:
    case kPullGeo:
    case kShrink:
    case kDenseRestore:
      return true;
    // the shared step counter survives failover; an n == 0 call is a
    // pure READ and must stay ungated — the snapshot path reads it
    // from a primary whose mutations are paused
    case kGlobalStep:
      return n != 0;
    // creates ride the oplog too, so a live backup sees a table exist
    // BEFORE its first replicated push (the separate catalog covers
    // rejoin, where the ring may have dropped them)
    case kCreateSparse:
    case kCreateDense:
    case kCreateGeo:
      return true;
    case kPullSparse:
    case kExport:
      return (aux & 1) != 0;
    // ownership install + row drop must reach the shard's backups (the
    // retained row set is part of the replicated state); n == 0 reads
    // stay untapped
    case kRetain:
      return n != 0;
    default:
      return false;
  }
}

// keyed data commands whose payload leads with [u64 keys × n] — the
// set the ownership fence (kRetain / kErrWrongShard) scans. Kept in
// lockstep with the case bodies' payload layouts.
inline bool is_keyed_data_cmd(uint32_t cmd) {
  switch (cmd) {
    case kPullSparse:
    case kPushSparse:
    case kExport:
    case kInsertFull:
    case kLoadCold:
    case kPushGeo:
      return true;
    default:
      return false;
  }
}

inline bool is_create_cmd(uint32_t cmd) {
  return cmd == kCreateSparse || cmd == kCreateDense || cmd == kCreateGeo;
}

// the subset of mutating commands a READ-ONLY replica (serving plane,
// ps/serving) refuses from direct clients: the streaming TRAINING data
// plane. The replication/bootstrap plane stays open — kReplicate applies
// via apply_op (never passes this check), and the shipper's full-sync
// path sends kInsertFull / kDenseRestore / kGlobalStep / creates
// directly, so those must keep working for the snapshot catch-up of the
// very replica this flag protects. kPullSparse's insert-on-miss bit is
// DOWNGRADED instead (missing rows read as zeros — the serving contract
// for out-of-population features), so a sloppy serve client cannot
// create phantom rows that diverge from the primary.
inline bool is_training_plane_cmd(uint32_t cmd, int32_t aux, int64_t n) {
  switch (cmd) {
    case kPushSparse:
    case kPushDense:
    case kSetDense:
    case kPushGeo:
    case kPullGeo:  // reading GEO DRAINS it — state-changing
    case kShrink:
    case kLoadCold:
      return true;
    case kExport:  // create-export is the pass-build path, not serving
      return (aux & 1) != 0;
    // reshard control plane: the APPLY (n > 0) reaches replicas via
    // the replication stream (apply_op), never directly; the n == 0
    // ownership READ is introspection (an operator re-attaching a
    // serving observer inspects its fence) and stays open
    case kRetain:
      return n != 0;
    default:
      return false;
  }
}

// commands a tenant-bound (non-operator) connection may issue: the
// table-addressed data/util plane plus kPing. Everything else —
// replication, epoch fencing, server-local save/load paths, stop,
// obs drains, ownership installs, barriers — is the operator plane
// (tenant 0) and bounces with kErrWrongTenant.
inline bool is_tenant_cmd(uint32_t cmd) {
  switch (cmd) {
    case kPing:
    case kCreateSparse:
    case kCreateDense:
    case kCreateGeo:
    case kPullSparse:
    case kPushSparse:
    case kPullDense:
    case kPushDense:
    case kSetDense:
    case kSize:
    case kShrink:
    case kInsertFull:
    case kExport:
    case kSpill:
    case kStats:
    case kCompact:
    case kLoadCold:
    case kSaveAll:
    case kDigest:
    case kCreateGraph:
    case kGraphAddNodes:
    case kGraphAddEdges:
    case kGraphSampleNeighbors:
    case kGraphDegree:
    case kGraphNodeFeat:
    case kGraphSetNodeFeat:
    case kGraphSampleNodes:
    case kGraphStats:
    case kPushGeo:
    case kPullGeo:
      return true;
    default:
      return false;
  }
}

// commands that may CREATE rows (quota enforcement point): creates,
// bulk inserts, pushes (lookup_or_insert on miss), and pull/export
// with the insert-on-miss bit. Kept in lockstep with the case bodies.
inline bool is_row_creating_cmd(uint32_t cmd, int32_t aux) {
  switch (cmd) {
    case kCreateSparse:
    case kCreateDense:
    case kCreateGeo:
    case kPushSparse:
    case kInsertFull:
    case kLoadCold:
      return true;
    case kPullSparse:
    case kExport:
      return (aux & 1) != 0;
    default:
      return false;
  }
}

constexpr uint64_t kMaxPayload = 1ULL << 32;  // 4 GiB frame cap

// tenant namespace tag: table_id's high byte (ps/tenancy.py mirrors
// this as TENANT_SHIFT — pinned by tests/test_tenancy.py)
constexpr uint32_t kTenantShift = 24;

// fp16 wire conversions live in sparse_table.h (pstpu::f32_to_f16 /
// f16_to_f32 — shared with the SSD fp16 record format). Used by the
// half-precision pull wire (kPullSparse aux & 2) and the quantized
// push wire (PushWireFlag below).
using pstpu::f16_to_f32;
using pstpu::f32_to_f16;

// push-value wire encodings (kPushSparse aux bit flags; the client
// resolves them from TableConfig.push_wire_dtype). The server — and a
// backup replaying the tapped frame, which carries the SAME aux —
// dequantizes before apply, so server state stays fp32 and primary ≡
// backup bit-identically. Mirrored in ps/rpc.py (_PUSH_WIRE_*) and
// pinned by graftlint pass 8 (tools/lint/wire_contract.py
// FLAG_CONTRACT) — drift fails tier-1.
enum PushWireFlag : int32_t {
  kPushWireF16 = 1,         // gradient columns ride IEEE fp16
  kPushWireI8 = 2,          // int8 gradients + per-block fp32 scales
  kPushWireBlockShift = 8,  // (aux >> shift) & 0xffff = int8 block size
};


// RAM-engine shard-file save/load (kSaveFile/kLoadFile for mem tables;
// the SSD engine has streaming equivalents in ssd_table.cc). The mem
// snapshot is RAM-bounded by construction, so staging it is fine.
// Format selector matches sst_save_file: 0 text, 1 gzip text, 2 raw
// binary ([u32 magic,u32 ver,u32 fdim,u32 rsvd] + [u64 key][f32 row]).
constexpr uint32_t kMemBinMagic = 0x42535450u;  // 'PTSB'

int64_t mem_save_file(NativeTable* t, const char* path, int32_t mode,
                      int32_t fmt) {
  int32_t fdim = table_full_dim(t);
  int32_t ed = pstpu::rule_state_dim(t->cfg.embed_rule, 1);
  std::lock_guard<std::mutex> sg(t->save_mu);
  int64_t n = pstpu::table_save_snapshot_locked(t, mode);
  bool binary = fmt == 2;
  gzFile gz = nullptr;
  FILE* fp = nullptr;
  if (fmt == 1 ? !(gz = gzopen(path, "wb1"))
               : !(fp = std::fopen(path, binary ? "wb" : "w"))) {
    t->save_keys.clear();
    t->save_values.clear();
    return -1;
  }
  bool ok = true;
  if (binary) {
    uint32_t hdr[4] = {kMemBinMagic, 1u, static_cast<uint32_t>(fdim), 0u};
    ok = std::fwrite(hdr, 1, sizeof(hdr), fp) == sizeof(hdr);
  }
  std::vector<char> line(64 + 24 * static_cast<size_t>(fdim));
  size_t rec = 8 + 4 * static_cast<size_t>(fdim);
  for (int64_t i = 0; ok && i < n; ++i) {
    if (binary) {
      std::memcpy(line.data(), &t->save_keys[i], 8);
      std::memcpy(line.data() + 8, t->save_values.data() + i * fdim,
                  4 * static_cast<size_t>(fdim));
      ok = std::fwrite(line.data(), 1, rec, fp) == rec;
    } else {
      int len = pstpu::format_text_row(line.data(), line.size(),
                                       t->save_keys[i],
                                       t->save_values.data() + i * fdim,
                                       fdim, ed);
      ok = gz ? gzwrite(gz, line.data(), len) == len
              : std::fwrite(line.data(), 1, (size_t)len, fp) == (size_t)len;
    }
  }
  if (gz ? gzclose(gz) != Z_OK : std::fclose(fp) != 0) ok = false;
  t->save_keys.clear();
  t->save_values.clear();
  if (!ok) {
    std::remove(path);
    return -1;
  }
  return n;
}

int64_t mem_load_file(NativeTable* t, const char* path, int32_t fmt) {
  int32_t fdim = table_full_dim(t);
  int32_t ed = pstpu::rule_state_dim(t->cfg.embed_rule, 1);
  if (fmt == 2) {
    FILE* bf = std::fopen(path, "rb");
    if (!bf) return -1;
    uint32_t hdr[4];
    if (std::fread(hdr, 1, sizeof(hdr), bf) != sizeof(hdr) ||
        hdr[0] != kMemBinMagic || hdr[1] != 1u ||
        hdr[2] != static_cast<uint32_t>(fdim)) {
      std::fclose(bf);
      return -1;
    }
    const int64_t kBatch = 1 << 19;
    size_t rec = 8 + 4 * static_cast<size_t>(fdim);
    std::vector<uint8_t> buf(static_cast<size_t>(kBatch) * rec);
    std::vector<uint64_t> keys(kBatch);
    std::vector<float> vals(static_cast<size_t>(kBatch) * fdim);
    int64_t loaded = 0;
    while (true) {
      size_t got = std::fread(buf.data(), rec, kBatch, bf);
      if (!got) break;
      for (size_t j = 0; j < got; ++j) {
        std::memcpy(&keys[j], buf.data() + j * rec, 8);
        std::memcpy(vals.data() + j * fdim, buf.data() + j * rec + 8,
                    4 * static_cast<size_t>(fdim));
      }
      pstpu::table_insert_full(t, keys.data(), vals.data(),
                               static_cast<int64_t>(got));
      loaded += static_cast<int64_t>(got);
    }
    std::fclose(bf);
    return loaded;
  }
  gzFile gz = nullptr;
  FILE* fp = nullptr;
  if (fmt == 1 ? !(gz = gzopen(path, "rb")) : !(fp = std::fopen(path, "r")))
    return -1;
  const int64_t kBatch = 1 << 19;
  std::vector<uint64_t> keys;
  std::vector<float> vals;
  std::vector<char> line(64 + 32 * static_cast<size_t>(fdim));
  std::vector<float> row(fdim);
  int64_t loaded = 0;
  auto flush = [&]() {
    if (keys.empty()) return;
    pstpu::table_insert_full(t, keys.data(), vals.data(),
                             static_cast<int64_t>(keys.size()));
    loaded += static_cast<int64_t>(keys.size());
    keys.clear();
    vals.clear();
  };
  while (true) {
    char* got = gz ? gzgets(gz, line.data(), (int)line.size())
                   : std::fgets(line.data(), (int)line.size(), fp);
    if (!got) break;
    uint64_t key;
    if (!pstpu::parse_text_row(line.data(), &key, row.data(), fdim, ed,
                               t->cfg.embedx_dim))
      continue;
    keys.push_back(key);
    vals.insert(vals.end(), row.begin(), row.end());
    if (static_cast<int64_t>(keys.size()) >= kBatch) flush();
  }
  flush();
  if (gz) gzclose(gz); else std::fclose(fp);
  return loaded;
}

struct ReqHeader {
  uint64_t payload_len;
  uint32_t cmd;
  uint32_t table_id;
  int64_t n;
  int32_t aux;
  // fixed trace-context field (paddle_tpu/obs/trace.py wire_context):
  // zero when tracing is off/unsampled — the header NEVER grows beyond
  // these 16 bytes for tracing (the obs CI gate asserts it). A nonzero
  // trace_id makes the server record a span for this request keyed by
  // span_id (the CLIENT span), fetched later via kObsSnap. Rides the
  // oplog/replication frames untouched (apply_op ignores it).
  uint64_t trace_id;
  uint64_t span_id;
} __attribute__((packed));

// Decode a kPushSparse payload into fp32 push rows [n, pd]. The fp32
// wire returns a pointer straight into the frame (zero-copy); the
// quantized wires widen into `scratch`. Keys always LEAD the payload
// regardless of encoding, so the key-ownership fence and the oplog tap
// see one shape. The 3-column head (slot/show/click) stays exact fp32
// in every encoding: counts feed the lifecycle stats and slot feeds
// row creation — only the gradient block is quantized. Layouts:
//   fp32: [keys u64 x n][rows f32 n x pd]
//   f16:  [keys][head f32 n x 3][grad f16 n x gd]            gd = pd-3
//   i8:   [keys][head f32 n x 3][scales f32 n x nblk][grad i8 n x gd]
//         nblk = ceil(gd / block); blocks tile a ROW (never straddle
//         rows), the last block of a row may be ragged
int64_t decode_push_rows(const ReqHeader& h, const char* p, int32_t pd,
                         std::vector<float>* scratch, const float** rows) {
  int64_t n = h.n;
  int32_t flags = h.aux & 0xff;
  if (!(flags & (kPushWireF16 | kPushWireI8))) {
    if (h.payload_len != static_cast<uint64_t>(n) * (8 + 4 * pd))
      return kErrBadSize;
    *rows = reinterpret_cast<const float*>(p + n * 8);
    return 0;
  }
  int32_t gd = pd - 3;
  if (gd <= 0) return kErrBadSize;  // no gradient block to quantize
  // validate the frame length BEFORE sizing scratch from the
  // wire-supplied n: a malformed/hostile header (huge n, small
  // payload) must reject with kErrBadSize, not throw out of resize
  // and take the server down
  const char* q = p + n * 8;
  const float* head = reinterpret_cast<const float*>(q);
  q += n * 12;
  if (flags & kPushWireI8) {
    int64_t block = (h.aux >> kPushWireBlockShift) & 0xffff;
    if (block <= 0) return kErrBadSize;
    int64_t nblk = (gd + block - 1) / block;
    uint64_t want = static_cast<uint64_t>(n) * (8 + 12 + 4 * nblk + gd);
    if (h.payload_len != want) return kErrBadSize;
    scratch->resize(static_cast<size_t>(n) * pd);
    const float* scales = reinterpret_cast<const float*>(q);
    const int8_t* grad = reinterpret_cast<const int8_t*>(q + n * nblk * 4);
    for (int64_t i = 0; i < n; ++i) {
      float* o = scratch->data() + i * pd;
      std::memcpy(o, head + i * 3, 12);
      const float* sc = scales + i * nblk;
      const int8_t* g = grad + i * gd;
      for (int32_t j = 0; j < gd; ++j)
        o[3 + j] = static_cast<float>(g[j]) * sc[j / block];
    }
  } else {
    uint64_t want = static_cast<uint64_t>(n) * (8 + 12 + 2 * gd);
    if (h.payload_len != want) return kErrBadSize;
    scratch->resize(static_cast<size_t>(n) * pd);
    const uint16_t* grad = reinterpret_cast<const uint16_t*>(q);
    for (int64_t i = 0; i < n; ++i) {
      float* o = scratch->data() + i * pd;
      std::memcpy(o, head + i * 3, 12);
      const uint16_t* g = grad + i * gd;
      for (int32_t j = 0; j < gd; ++j) o[3 + j] = f16_to_f32(g[j]);
    }
  }
  *rows = scratch->data();
  return 0;
}

// obs timestamp helpers: wall anchor for cross-process merge, steady
// for durations (same split obs/trace.py uses python-side)
inline int64_t mono_us() {
  timespec ts;
  ::clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000 + ts.tv_nsec / 1000;
}
inline int64_t wall_us() {
  timespec ts;
  ::clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000 + ts.tv_nsec / 1000;
}

// per-handler-thread obs scratch (one handler thread per connection):
// respond() records the response payload size; gate_enter() records the
// time a mutating request waited on the pause gate — both consumed by
// obs_account() after the handler returns.
thread_local uint64_t t_resp_bytes = 0;
thread_local int64_t t_gate_wait_us = 0;
// tenant_admit()'s retry hint for a kErrThrottled response (ms) — set
// on the shed path, consumed by the respond site in handle()
thread_local int64_t t_retry_after_ms = 0;

bool read_full(int fd, void* buf, size_t len) {
  char* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t r = ::recv(fd, p, len, 0);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    p += r;
    len -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t len) {
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t r = ::send(fd, p, len, MSG_NOSIGNAL);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    p += r;
    len -= static_cast<size_t>(r);
  }
  return true;
}

// server-side dense table (memory_dense_table.cc role: server applies
// the dense optimizer; sgd/adam/sum match the host MemoryDenseTable)
struct DenseTable {
  std::vector<float> values;
  int32_t opt = 1;  // 0 sgd, 1 adam, 2 sum
  float lr = 0.001f;
  std::vector<float> m, v;
  int64_t t = 0;
  std::mutex mu;

  DenseTable(int32_t dim, int32_t opt_, float lr_) : opt(opt_), lr(lr_) {
    values.assign(dim, 0.0f);
    if (opt == 1) {
      m.assign(dim, 0.0f);
      v.assign(dim, 0.0f);
    }
  }

  void push(const float* grad) {
    std::lock_guard<std::mutex> g(mu);
    size_t d = values.size();
    if (opt == 0) {
      for (size_t i = 0; i < d; ++i) values[i] -= lr * grad[i];
    } else if (opt == 2) {
      for (size_t i = 0; i < d; ++i) values[i] += grad[i];
    } else {
      ++t;
      const float b1 = 0.9f, b2 = 0.999f, eps = 1e-8f;
      float b1c = 1.0f - std::pow(b1, static_cast<float>(t));
      float b2c = 1.0f - std::pow(b2, static_cast<float>(t));
      for (size_t i = 0; i < d; ++i) {
        m[i] = b1 * m[i] + (1.0f - b1) * grad[i];
        v[i] = b2 * v[i] + (1.0f - b2) * grad[i] * grad[i];
        values[i] -= lr * (m[i] / b1c) / (std::sqrt(v[i] / b2c) + eps);
      }
    }
  }
};

// server-side GEO delta table (memory_sparse_geo_table: accumulate
// per-key deltas; pull drains means)
struct GeoTable {
  int32_t dim;
  std::unordered_map<uint64_t, std::pair<std::vector<float>, int32_t>> acc;
  std::mutex mu;

  explicit GeoTable(int32_t d) : dim(d) {}

  void push(const uint64_t* keys, const float* deltas, int64_t n) {
    std::lock_guard<std::mutex> g(mu);
    for (int64_t i = 0; i < n; ++i) {
      auto& e = acc[keys[i]];
      if (e.first.empty()) e.first.assign(dim, 0.0f);
      for (int32_t j = 0; j < dim; ++j) e.first[j] += deltas[i * dim + j];
      e.second += 1;
    }
  }

  // drain into (keys, mean deltas)
  void pull(std::vector<uint64_t>* keys, std::vector<float>* deltas) {
    std::lock_guard<std::mutex> g(mu);
    keys->reserve(acc.size());
    deltas->reserve(acc.size() * dim);
    for (auto& kv : acc) {
      keys->push_back(kv.first);
      float inv = 1.0f / std::max(kv.second.second, 1);
      for (int32_t j = 0; j < dim; ++j)
        deltas->push_back(kv.second.first[j] * inv);
    }
    acc.clear();
  }
};

struct PsServer {
  int listen_fd = -1;
  int port = 0;
  int n_trainers = 1;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::vector<std::thread> conn_threads;
  std::vector<int> conn_fds;
  std::mutex conn_mu;

  std::map<uint32_t, SparseRef> sparse;
  std::map<uint32_t, DenseTable*> dense;
  std::map<uint32_t, GeoTable*> geo;
  std::map<uint32_t, pstpu::GraphStore*> graphs;
  std::mutex tables_mu;
  // per-table: the sst two-phase save (begin fills, fetch drains) must
  // not interleave between two savers of the SAME table; different
  // tables save concurrently
  std::map<uint32_t, std::unique_ptr<std::mutex>> ssd_save_mu;

  // barrier (BarrierTable semantics: all trainers arrive, then release)
  std::mutex bar_mu;
  std::condition_variable bar_cv;
  int bar_count = 0;
  int64_t bar_gen = 0;

  // global step (GlobalStepTable)
  std::atomic<int64_t> global_step{0};

  // -- HA / replication state (ps/ha.py ReplicationManager is the
  // consumer; see docs/OPERATIONS.md §6) ------------------------------
  // routing epoch: bumped by the failover coordinator on promotion;
  // kReplicate frames carry the sender's epoch and are fenced below it
  std::atomic<int64_t> epoch{0};
  // last kReplicate seq applied (backup role; seqs start at 1, so 0 =
  // nothing applied — a post-snapshot rebase sets this to the snapshot
  // cut S and the tail resumes at S+1)
  std::atomic<int64_t> applied_seq{0};
  // read-only attach mode (serving replicas, paddle_tpu/serving): direct
  // training-plane mutations bounce with kErrReadOnly; replication and
  // snapshot-plane commands still apply (see is_training_plane_cmd)
  std::atomic<bool> read_only{false};
  // key-ownership predicate (live resharding, ps/reshard.py): when
  // own_mod > 0, a direct keyed data command carrying any key with
  // key % own_mod != own_res bounces whole with kErrWrongShard — the
  // deterministic stale-topology fence that makes a client re-resolve
  // the epoch-stamped routing table. 0 = own everything (the static-
  // topology default); own_res = -1 owns nothing (a retiring shard).
  // The replication plane (kReplicate → apply_op) bypasses the check:
  // a bootstrap snapshot deliberately carries not-yet-owned residues.
  std::atomic<int64_t> own_mod{0};
  std::atomic<int64_t> own_res{0};
  // bumped whenever DENSE state changes (direct or replicated apply):
  // the serving replica's feed watcher reads this counter instead of
  // polling table bytes — a dense-tower refresh triggers exactly when
  // the change feed delivered one
  std::atomic<int64_t> dense_version{0};
  // oplog ring (primary role): every mutating request frame, stamped
  // with a monotonically increasing seq; the Python shipper thread
  // drains it via pss_oplog_next and forwards kReplicate frames.
  // Bounded: overflow drops the OLDEST entry (oplog_dropped counts) —
  // the shipper detects the seq gap and falls back to a full snapshot.
  struct OplogEntry {
    int64_t seq;
    std::vector<char> frame;  // [ReqHeader][payload]
  };
  std::atomic<bool> repl_enabled{false};
  size_t oplog_cap = 1 << 16;
  int64_t oplog_seq = 0;
  int64_t oplog_dropped = 0;
  std::deque<OplogEntry> oplog;
  std::mutex oplog_mu;  // leaf: append/pop only, nothing nests inside
  std::condition_variable oplog_cv;
  // create-command frames, replayed to a rejoining backup before the
  // data snapshot (recorded unconditionally — creates are rare/small)
  std::vector<std::vector<char>> catalog;
  // staging buffer for pss_oplog_next (single consumer: the one shipper
  // thread). The catalog is read by pss_catalog_copy into the caller's
  // buffer instead: a migration's snapshot runs on a thread of its own,
  // beside the shipper.
  std::vector<char> staged;

  // mutation pause gate: full-snapshot sync quiesces writers so the
  // snapshot + seq rebase is a consistent cut (mutators block briefly —
  // within the client IO deadline — rather than fail)
  std::mutex gate_mu;  // leaf: only the gate fields live under it
  std::condition_variable gate_cv;
  bool gate_paused = false;
  int gate_active = 0;

  // deterministic fault injection (the chaos-test harness; armed via
  // pss_arm_fault or ha.py faultpoints). A fault matches requests by
  // cmd (0 = any), counts matches, and fires once `after` is reached:
  //   kill-shard  → request_stop() and drop the connection
  //   drop-frame  → drop the connection without responding
  //   delay-ms    → sleep `param` ms before handling (stays armed)
  struct Fault {
    uint32_t cmd = 0;
    int64_t after = 0;
    int64_t param = 0;
    int64_t seen = 0;
    bool armed = true;
  };
  std::map<std::string, Fault> faults;
  std::mutex fault_mu;  // leaf

  // -- multi-tenancy (kTenantHello/kTenantConfig; ps/tenancy.py) --------
  // Registered tenants, keyed by tenant id (1..255). A connection binds
  // via kTenantHello and is then confined to its namespace, its token
  // bucket, and its quotas — all enforced in handle() BEFORE the
  // read-only check, the pause gate, the ownership fence and the oplog
  // tap, so a refused frame changed state nowhere and was never
  // replicated. The replication plane bypasses tenancy entirely
  // (kReplicate arrives on operator-plane connections; apply_op runs no
  // tenant checks), so namespaced frames replay on backups unchanged.
  struct TenantState {
    int32_t pclass = 1;         // 0 = serve (queues briefly), >=1 = batch
    double rate = 0.0;          // bucket refill, cost units/s (0 = unmetered)
    double burst = 0.0;         // bucket depth
    double tokens = 0.0;
    int64_t last_refill_us = 0;
    int64_t max_rows = 0;       // row quota across the namespace (0 = none)
    int64_t max_ssd_bytes = 0;  // SSD file-byte quota (0 = none)
    int64_t throttled = 0;      // requests shed with kErrThrottled
    int64_t quota_refused = 0;  // requests refused with kErrQuota
    std::string token;          // hello credential
  };
  std::map<uint32_t, TenantState> tenants;
  std::mutex tenants_mu;  // leaf: small-struct copies/updates only

  // -- observability (kObsSnap; paddle_tpu/obs consumes) ----------------
  // per-table wire accounting: "in" = client→server payload bytes/rows
  // (pushes, inserts), "out" = server→client response bytes/rows
  // (pulls, exports). One leaf-lock acquisition per DATA request — the
  // requests themselves move kilobytes to gigabytes, so the counter is
  // noise next to the socket IO it measures.
  struct WireStat {
    int64_t in_bytes = 0, out_bytes = 0, in_rows = 0, out_rows = 0,
            reqs = 0;
  };
  std::map<uint32_t, WireStat> wire;
  // server-side trace spans, recorded only for requests whose header
  // carried a nonzero trace_id (sampled client spans). Bounded ring:
  // overflow drops the OLDEST and counts it — a forgotten drain can
  // never grow the server.
  struct ObsSpan {
    uint64_t trace_id, span_id;
    uint32_t cmd, table_id;
    int64_t ts_us, dur_us, gate_us;
    uint64_t req_bytes, resp_bytes;
  } __attribute__((packed));
  static_assert(sizeof(ObsSpan) == 64, "obs/trace.py SERVER_SPAN_STRUCT");
  std::deque<ObsSpan> obs_spans;
  size_t obs_spans_cap = 4096;
  int64_t obs_spans_dropped = 0;
  std::mutex obs_mu;  // leaf: counters/ring only, nothing nests inside

  // commands whose payloads are table data worth metering (the control
  // plane — barriers, epochs, stats reads — is not wire accounting)
  static bool is_data_cmd(uint32_t cmd) {
    switch (cmd) {
      case kPullSparse:
      case kPushSparse:
      case kPullDense:
      case kPushDense:
      case kSetDense:
      case kInsertFull:
      case kExport:
      case kSaveAll:
      case kLoadCold:
      case kPushGeo:
      case kPullGeo:
        return true;
      default:
        return false;
    }
  }

  void obs_account(const ReqHeader& h, int64_t ts_us, int64_t dur_us) {
    bool data = is_data_cmd(h.cmd);
    if (!data && h.trace_id == 0) return;
    std::lock_guard<std::mutex> g(obs_mu);  // LOCK: obs_mu
    if (data) {
      WireStat& w = wire[h.table_id];
      w.reqs += 1;
      w.in_bytes += static_cast<int64_t>(h.payload_len);
      w.out_bytes += static_cast<int64_t>(t_resp_bytes);
      switch (h.cmd) {
        case kPushSparse:
        case kInsertFull:
        case kLoadCold:
        case kPushGeo:
          w.in_rows += h.n;
          break;
        case kPullSparse:
        case kExport:
          w.out_rows += h.n;
          break;
        default:
          break;  // dense/geo-pull/save: bytes carry the signal
      }
    }
    if (h.trace_id != 0) {
      ObsSpan s{h.trace_id, h.span_id, h.cmd, h.table_id, ts_us, dur_us,
                t_gate_wait_us, sizeof(ReqHeader) + h.payload_len,
                t_resp_bytes};
      obs_spans.push_back(s);
      while (obs_spans.size() > obs_spans_cap) {
        obs_spans.pop_front();
        ++obs_spans_dropped;
      }
    }
  }

  void log_op(const ReqHeader& h, const char* p) {
    std::lock_guard<std::mutex> g(oplog_mu);  // LOCK: oplog_mu
    if (!repl_enabled.load()) return;
    OplogEntry e;
    e.seq = ++oplog_seq;
    e.frame.resize(sizeof(ReqHeader) + h.payload_len);
    std::memcpy(e.frame.data(), &h, sizeof(ReqHeader));
    if (h.payload_len)
      std::memcpy(e.frame.data() + sizeof(ReqHeader), p, h.payload_len);
    oplog.push_back(std::move(e));
    while (oplog.size() > oplog_cap) {
      oplog.pop_front();
      ++oplog_dropped;
    }
    oplog_cv.notify_one();
  }

  void log_catalog(const ReqHeader& h, const char* p) {
    std::lock_guard<std::mutex> g(oplog_mu);  // LOCK: oplog_mu
    std::vector<char> f(sizeof(ReqHeader) + h.payload_len);
    std::memcpy(f.data(), &h, sizeof(ReqHeader));
    if (h.payload_len) std::memcpy(f.data() + sizeof(ReqHeader), p, h.payload_len);
    catalog.push_back(std::move(f));
  }

  void gate_enter() {
    std::unique_lock<std::mutex> lk(gate_mu);  // LOCK: gate_mu
    if (gate_paused && !stopping.load()) {
      // the one genuine QUEUE in this server: mutators blocked behind a
      // snapshot gate. Measured only on the blocked path (the unpaused
      // fast path pays zero clock reads) and surfaced as the span's
      // gate_us — "where did this slow push wait" in the merged trace.
      int64_t w0 = mono_us();
      gate_cv.wait(lk, [&]() { return !gate_paused || stopping.load(); });
      t_gate_wait_us += mono_us() - w0;
    }
    ++gate_active;
  }

  void gate_exit() {
    {
      std::lock_guard<std::mutex> g(gate_mu);  // LOCK: gate_mu
      --gate_active;
    }
    gate_cv.notify_all();
  }

  // RAII so every respond() path in the mutating switch releases the gate
  struct MutGuard {
    PsServer* s;
    bool on;
    MutGuard(PsServer* srv, bool enable) : s(srv), on(enable) {
      if (on) s->gate_enter();
    }
    ~MutGuard() {
      if (on) s->gate_exit();
    }
  };

  void pause_mutations(bool on) {
    std::unique_lock<std::mutex> lk(gate_mu);  // LOCK: gate_mu
    gate_paused = on;
    if (on)
      gate_cv.wait(lk, [&]() { return gate_active == 0 || stopping.load(); });
    else
      gate_cv.notify_all();
  }

  // fault check for one request; returns the armed action to take
  // ("" = none). delay-ms sleeps here and keeps going.
  std::string fault_action(uint32_t cmd) {
    int64_t delay = 0;
    std::string act;
    {
      std::lock_guard<std::mutex> g(fault_mu);  // LOCK: fault_mu
      for (auto& kv : faults) {
        Fault& f = kv.second;
        if (!f.armed || (f.cmd != 0 && f.cmd != cmd)) continue;
        if (++f.seen < f.after) continue;
        if (kv.first == "delay-ms") {
          delay = f.param;  // stays armed: every matching op is slowed
        } else {
          f.armed = false;  // kill-shard / drop-frame fire once
          act = kv.first;
          break;
        }
      }
    }
    if (delay > 0)
      std::this_thread::sleep_for(std::chrono::milliseconds(delay));
    return act;
  }

  ~PsServer() {
    for (auto& kv : sparse) {
      delete kv.second.mem;
      if (kv.second.ssd) sst_destroy(kv.second.ssd);
    }
    for (auto& kv : dense) delete kv.second;
    for (auto& kv : geo) delete kv.second;
    for (auto& kv : graphs) delete kv.second;
  }

  // host: the IPv4 address to listen on ("127.0.0.1" for loopback only,
  // "0.0.0.0" for every interface); false if it does not parse.
  bool start(const char* host, int want_port, int trainers) {
    n_trainers = trainers;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) return false;
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
      return false;
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    if (::listen(listen_fd, 64) < 0) return false;
    accept_thread = std::thread([this]() { accept_loop(); });
    return true;
  }

  void accept_loop() {
    while (!stopping.load()) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (stopping.load()) break;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(conn_mu);
      conn_fds.push_back(fd);
      conn_threads.emplace_back([this, fd]() { serve_conn(fd); });
    }
  }

  // signal-only: safe to call from a connection handler thread
  void request_stop() {
    if (stopping.exchange(true)) return;
    ::shutdown(listen_fd, SHUT_RDWR);
    ::close(listen_fd);
    // nudge open connections: in-flight requests finish (handler writes
    // the response), then the next read fails and the thread exits —
    // live trainers on other connections are NOT cut mid-request
    {
      std::lock_guard<std::mutex> g(conn_mu);
      for (int cfd : conn_fds) ::shutdown(cfd, SHUT_RD);
    }
    // wake any barrier waiters so their connections can drain
    {
      std::lock_guard<std::mutex> g(bar_mu);
      bar_gen++;
      bar_count = 0;
    }
    bar_cv.notify_all();
    // wake the oplog shipper and any gate-blocked mutators: both wait
    // on predicates that include stopping
    oplog_cv.notify_all();
    gate_cv.notify_all();
  }

  // full shutdown: join all threads. Must NOT run on a handler thread.
  void stop() {
    request_stop();
    if (accept_thread.joinable()) accept_thread.join();
    std::vector<std::thread> ts;
    {
      std::lock_guard<std::mutex> g(conn_mu);
      ts.swap(conn_threads);
    }
    for (auto& t : ts)
      if (t.joinable()) t.join();
  }

  // lock-free row-count probe (Shard::used is atomic): runs TWICE per
  // replicated pull-with-create to detect inserts, so it must not
  // serialize against the shard locks the traversal holds
  static int64_t sparse_rows(const SparseRef& t) {
    if (t.ssd) return sst_size(t.ssd);
    int64_t n = 0;
    for (auto* sh : t.mem->shards) n += sh->used.load();
    return n;
  }

  bool get_sparse(uint32_t id, SparseRef* out) {
    std::lock_guard<std::mutex> g(tables_mu);
    auto it = sparse.find(id);
    if (it == sparse.end()) return false;
    *out = it->second;
    return true;
  }
  DenseTable* get_dense(uint32_t id) {
    std::lock_guard<std::mutex> g(tables_mu);
    auto it = dense.find(id);
    return it == dense.end() ? nullptr : it->second;
  }
  GeoTable* get_geo(uint32_t id) {
    std::lock_guard<std::mutex> g(tables_mu);
    auto it = geo.find(id);
    return it == geo.end() ? nullptr : it->second;
  }
  pstpu::GraphStore* get_graph(uint32_t id) {
    std::lock_guard<std::mutex> g(tables_mu);
    auto it = graphs.find(id);
    return it == graphs.end() ? nullptr : it->second;
  }

  bool respond(int fd, int64_t status, const void* payload, uint64_t plen) {
    t_resp_bytes = plen + 16;  // obs wire accounting (payload + resp hdr)
    uint64_t hdr[2] = {plen, static_cast<uint64_t>(status)};
    if (!write_full(fd, hdr, sizeof(hdr))) return false;
    if (plen && !write_full(fd, payload, plen)) return false;
    return true;
  }

  // -- tenancy: admission, metering, quota -----------------------------

  // Billing meter: rows + SSD file bytes across every sparse table in
  // the tenant's namespace. Walks tables_mu only to collect SparseRefs
  // (cheap map scan); the per-table probes are lock-free (sparse_rows
  // reads atomics, sst_stats reads the tier's own counters).
  void tenant_usage(uint32_t tenant, int64_t* rows, int64_t* ssd_bytes) {
    std::vector<SparseRef> refs;
    {
      std::lock_guard<std::mutex> g(tables_mu);  // LOCK: tables_mu
      for (auto& kv : sparse)
        if ((kv.first >> kTenantShift) == tenant) refs.push_back(kv.second);
    }
    *rows = 0;
    *ssd_bytes = 0;
    for (auto& t : refs) {
      *rows += sparse_rows(t);
      if (t.ssd) {
        int64_t s3[3] = {0, 0, 0};
        sst_stats(t.ssd, s3);
        *ssd_bytes += s3[2];
      }
    }
  }

  // Refill-and-charge against the tenant's token bucket. Returns true
  // if the bucket covered the cost. rate == 0 means unmetered.
  bool try_charge(uint32_t tenant, double cost) {
    std::lock_guard<std::mutex> g(tenants_mu);  // LOCK: tenants_mu
    auto it = tenants.find(tenant);
    if (it == tenants.end()) return true;
    TenantState& t = it->second;
    if (t.rate <= 0) return true;
    int64_t now = mono_us();
    t.tokens = std::min(
        t.burst, t.tokens + (now - t.last_refill_us) * 1e-6 * t.rate);
    t.last_refill_us = now;
    if (t.tokens >= cost) {
      t.tokens -= cost;
      return true;
    }
    return false;
  }

  // Weighted admission for a tenant-bound connection. Returns 0 to
  // admit, else the error status to bounce the frame with. Ordering:
  // namespace fence first (a frame addressing another tenant's table is
  // wrong regardless of budget), then the token bucket, then quota on
  // row-creating commands. NEVER holds tenants_mu across tables_mu:
  // config is copied out, usage probed, counters bumped on re-acquire.
  int64_t tenant_admit(uint32_t tenant, const ReqHeader& h) {
    if (!is_tenant_cmd(h.cmd)) return kErrWrongTenant;
    if (h.cmd != kPing && (h.table_id >> kTenantShift) != tenant)
      return kErrWrongTenant;
    int32_t pclass;
    double rate;
    int64_t max_rows, max_ssd;
    {
      std::lock_guard<std::mutex> g(tenants_mu);  // LOCK: tenants_mu
      auto it = tenants.find(tenant);
      if (it == tenants.end()) return kErrWrongTenant;
      pclass = it->second.pclass;
      rate = it->second.rate;
      max_rows = it->second.max_rows;
      max_ssd = it->second.max_ssd_bytes;
    }
    if (rate > 0) {
      // cost = 1 per frame + 1 per key/row it names, so a hot-key flood
      // of fat pulls drains the bucket proportionally to server work
      double cost = 1.0 + static_cast<double>(std::max<int64_t>(0, h.n));
      bool ok = try_charge(tenant, cost);
      if (!ok && pclass == 0) {
        // serve class QUEUES briefly instead of shedding: one bounded
        // wait sized to the refill the charge needs, then re-try
        int64_t wait_ms = std::min<int64_t>(
            50, static_cast<int64_t>(cost / rate * 1e3) + 1);
        std::this_thread::sleep_for(std::chrono::milliseconds(wait_ms));
        ok = try_charge(tenant, cost);
      }
      if (!ok) {
        std::lock_guard<std::mutex> g(tenants_mu);  // LOCK: tenants_mu
        auto it = tenants.find(tenant);
        if (it != tenants.end()) {
          ++it->second.throttled;
          t_retry_after_ms = std::max<int64_t>(
              1, static_cast<int64_t>((cost - it->second.tokens) /
                                      std::max(rate, 1e-9) * 1e3));
        } else {
          t_retry_after_ms = 1;
        }
        return kErrThrottled;
      }
    }
    if ((max_rows > 0 || max_ssd > 0) && is_row_creating_cmd(h.cmd, h.aux)) {
      // Quota is enforced at batch granularity: the LAST admitted batch
      // may overshoot the cap, but the next row-creating frame refuses.
      // kPushSparse counts as row-creating (lookup_or_insert), so a
      // tenant at quota sees pushes refuse too — by design: shrink or
      // raise the quota, we never evict another tenant's rows to make
      // room (see docs/OPERATIONS.md §20).
      int64_t rows = 0, ssd_bytes = 0;
      tenant_usage(tenant, &rows, &ssd_bytes);
      if ((max_rows > 0 && rows >= max_rows) ||
          (max_ssd > 0 && ssd_bytes >= max_ssd)) {
        std::lock_guard<std::mutex> g(tenants_mu);  // LOCK: tenants_mu
        auto it = tenants.find(tenant);
        if (it != tenants.end()) ++it->second.quota_refused;
        return kErrQuota;
      }
    }
    return 0;
  }

  // kTenantConfig body (operator plane only — handle() enforces that).
  // n == 1: install/update from packed payload
  //   [u32 tenant_id][i32 pclass][f64 rate][f64 burst][i64 max_rows]
  //   [i64 max_ssd_bytes][u32 token_len][u32 pad][token bytes]
  // n == 0: read h.table_id's usage meter →
  //   [rows, ssd_bytes, throttled, quota_refused i64×4][tokens f64]
  //   [pclass i64]
  bool do_tenant_config(int fd, const ReqHeader& h, const char* p) {
    if (h.n == 1) {
      constexpr uint64_t kFixed = 4 + 4 + 8 + 8 + 8 + 8 + 4 + 4;
      if (h.payload_len < kFixed) return respond(fd, kErrBadSize, nullptr, 0);
      uint32_t tid, token_len;
      int32_t pclass;
      double rate, burst;
      int64_t max_rows, max_ssd;
      std::memcpy(&tid, p, 4);
      std::memcpy(&pclass, p + 4, 4);
      std::memcpy(&rate, p + 8, 8);
      std::memcpy(&burst, p + 16, 8);
      std::memcpy(&max_rows, p + 24, 8);
      std::memcpy(&max_ssd, p + 32, 8);
      std::memcpy(&token_len, p + 40, 4);
      if (h.payload_len != kFixed + token_len)
        return respond(fd, kErrBadSize, nullptr, 0);
      if (tid == 0 || tid > 255)  // 0 = operator plane, not registrable
        return respond(fd, kErrBadSize, nullptr, 0);
      std::lock_guard<std::mutex> g(tenants_mu);  // LOCK: tenants_mu
      TenantState& t = tenants[tid];
      t.pclass = pclass;
      t.rate = rate;
      t.burst = burst;
      // a (re)config starts the bucket full so admission ramps cleanly
      t.tokens = burst;
      t.last_refill_us = mono_us();
      t.max_rows = max_rows;
      t.max_ssd_bytes = max_ssd;
      t.token.assign(p + kFixed, token_len);
      return respond(fd, 0, nullptr, 0);
    }
    if (h.n == 0) {
      uint32_t tid = h.table_id;
      int64_t rows = 0, ssd_bytes = 0;
      tenant_usage(tid, &rows, &ssd_bytes);
      int64_t throttled = 0, refused = 0, pclass = 1;
      double tokens = 0;
      {
        std::lock_guard<std::mutex> g(tenants_mu);  // LOCK: tenants_mu
        auto it = tenants.find(tid);
        if (it == tenants.end()) return respond(fd, kErrNoTable, nullptr, 0);
        throttled = it->second.throttled;
        refused = it->second.quota_refused;
        tokens = it->second.tokens;
        pclass = it->second.pclass;
      }
      char out[48];
      std::memcpy(out, &rows, 8);
      std::memcpy(out + 8, &ssd_bytes, 8);
      std::memcpy(out + 16, &throttled, 8);
      std::memcpy(out + 24, &refused, 8);
      std::memcpy(out + 32, &tokens, 8);
      std::memcpy(out + 40, &pclass, 8);
      return respond(fd, 0, out, sizeof(out));
    }
    return respond(fd, kErrBadCmd, nullptr, 0);
  }

  // -- create bodies, shared by the interactive path (handle) and the
  // replication catalog-replay path (apply_op) -------------------------

  int64_t do_create_sparse(const ReqHeader& h, const char* p, int32_t dims[3]) {
    // payload: iparams[6 i32] + fparams[17 f32], optionally followed
    // by [i32 storage][u32 path_len][path]. storage low byte: 1 = ssd;
    // storage bit 8: fp16 value columns in the SSD records
    // (TableConfig.ssd_value_dtype="fp16") — old clients send exactly
    // 1, which decodes identically
    constexpr uint64_t kBase = 6 * 4 + 17 * 4;
    if (h.payload_len < kBase) return kErrBadSize;
    int32_t storage = 0;
    std::string path;
    if (h.payload_len > kBase) {
      if (h.payload_len < kBase + 8) return kErrBadSize;
      uint32_t plen;
      std::memcpy(&storage, p + kBase, 4);
      std::memcpy(&plen, p + kBase + 4, 4);
      if (h.payload_len != kBase + 8 + plen) return kErrBadSize;
      path.assign(p + kBase + 8, plen);
    }
    TableNativeConfig c = pstpu::parse_table_config(
        reinterpret_cast<const int32_t*>(p),
        reinterpret_cast<const float*>(p + 24));
    // build the engine OUTSIDE tables_mu: an SSD create replays the
    // whole cold-tier log, and that must not stall other tables'
    // traffic. Losing a create race destroys the duplicate.
    SparseRef fresh;
    if ((storage & 0xff) == 1) {
      fresh.ssd = sst_create2(reinterpret_cast<const int32_t*>(p),
                              reinterpret_cast<const float*>(p + 24),
                              path.c_str(), (storage >> 8) & 1);
      if (!fresh.ssd) return kErrInternal;
    } else {
      fresh.mem = new NativeTable(c);
    }
    SparseRef t;
    {
      std::lock_guard<std::mutex> g(tables_mu);
      auto it = sparse.find(h.table_id);
      if (it != sparse.end()) {
        t = it->second;  // idempotent re-create from another trainer
      } else {
        t = fresh;
        fresh = SparseRef{};
        sparse[h.table_id] = t;
        if (t.ssd) ssd_save_mu[h.table_id] = std::make_unique<std::mutex>();
      }
    }
    delete fresh.mem;
    if (fresh.ssd) sst_destroy(fresh.ssd);
    dims[0] = t.pull_dim();
    dims[1] = t.push_dim();
    dims[2] = t.full_dim();
    return 0;
  }

  int64_t do_create_dense(const ReqHeader& h, const char* p) {
    if (h.payload_len != 12) return kErrBadSize;
    int32_t dim, opt;
    float lr;
    std::memcpy(&dim, p, 4);
    std::memcpy(&opt, p + 4, 4);
    std::memcpy(&lr, p + 8, 4);
    std::lock_guard<std::mutex> g(tables_mu);
    if (!dense.count(h.table_id))
      dense[h.table_id] = new DenseTable(dim, opt, lr);
    return 0;
  }

  int64_t do_create_geo(const ReqHeader& h, const char* p) {
    if (h.payload_len != 4) return kErrBadSize;
    int32_t dim;
    std::memcpy(&dim, p, 4);
    std::lock_guard<std::mutex> g(tables_mu);
    if (!geo.count(h.table_id)) geo[h.table_id] = new GeoTable(dim);
    return 0;
  }

  int64_t do_dense_restore(const ReqHeader& h, const char* p) {
    DenseTable* t = get_dense(h.table_id);
    if (!t) return kErrNoTable;
    std::lock_guard<std::mutex> g(t->mu);
    size_t d = t->values.size();
    size_t want = 8 + 4 * d * (t->opt == 1 ? 3 : 1);
    if (h.payload_len != want) return kErrBadSize;
    std::memcpy(&t->t, p, 8);
    std::memcpy(t->values.data(), p + 8, 4 * d);
    if (t->opt == 1) {
      std::memcpy(t->m.data(), p + 8 + 4 * d, 4 * d);
      std::memcpy(t->v.data(), p + 8 + 8 * d, 4 * d);
    }
    dense_version.fetch_add(1);
    return 0;
  }

  // Apply one replicated frame WITHOUT a socket response (pull/export
  // outputs are discarded — only the insert-on-miss side effect
  // matters). Validation is kept in lockstep with handle() so a frame
  // that failed on the primary fails identically on the backup.
  // kRetain body, shared by the interactive path and the replication
  // apply (a shard's backups must converge to the same ownership AND
  // the same retained row set). Returns rows erased (>= 0) or an error.
  int64_t do_retain(int64_t mod, int64_t res) {
    if (mod <= 0) return kErrBadSize;
    std::vector<SparseRef> tabs;
    {
      std::lock_guard<std::mutex> g(tables_mu);
      for (auto& kv : sparse) tabs.push_back(kv.second);
    }
    // erase needs the RAM engine's slot walk; SSD cold tiers have no
    // retain (ps/reshard.py refuses SSD tables before it starts) —
    // fail BEFORE installing ownership, so a refused retain leaves the
    // server serving its old key set instead of half-fenced
    if (res >= 0 && res < mod)
      for (auto& t : tabs)
        if (t.ssd) return kErrInternal;
    own_mod.store(mod);
    own_res.store(res);
    if (res < 0 || res >= mod) return 0;  // fence-only: rows untouched
    int64_t erased = 0;
    for (auto& t : tabs) {
      for (auto* sh : t.mem->shards) {
        std::lock_guard<std::mutex> g(sh->mu);
        erased += sh->retain(static_cast<uint64_t>(mod),
                             static_cast<uint64_t>(res));
      }
    }
    return erased;
  }

  int64_t apply_op(const ReqHeader& h, const char* p) {
    if (h.n < 0 || static_cast<uint64_t>(h.n) > kMaxPayload) return kErrBadSize;
    switch (h.cmd) {
      case kCreateSparse: {
        int32_t dims[3];
        return do_create_sparse(h, p, dims);
      }
      case kCreateDense:
        return do_create_dense(h, p);
      case kCreateGeo:
        return do_create_geo(h, p);
      case kDenseRestore:
        return do_dense_restore(h, p);
      case kPullSparse: {  // replicated only with aux&1: the row creates
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return kErrNoTable;
        int32_t pd = t.pull_dim();
        if (h.payload_len != static_cast<uint64_t>(h.n) * 12) return kErrBadSize;
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        const int32_t* slots = reinterpret_cast<const int32_t*>(p + h.n * 8);
        std::vector<float> out(static_cast<size_t>(h.n) * pd);
        if (t.ssd) {
          sst_pull(t.ssd, keys, slots, h.n, 1, out.data());
        } else {
          t.mem->parallel_over_shards(keys, h.n, [&](pstpu::Shard* sh, int64_t i) {
            int32_t r = sh->lookup_or_insert(keys[i], slots[i]);
            sh->select_into(r, out.data() + i * pd);
          });
        }
        return h.n;
      }
      case kExport: {  // replicated only with aux&1
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return kErrNoTable;
        if (h.payload_len != static_cast<uint64_t>(h.n) * 12) return kErrBadSize;
        int32_t fdim = t.full_dim();
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        const int32_t* slots = reinterpret_cast<const int32_t*>(p + h.n * 8);
        std::vector<float> vals(static_cast<size_t>(h.n) * fdim);
        std::vector<uint8_t> found(h.n);
        if (t.ssd)
          sst_export(t.ssd, keys, slots, h.n, 1, vals.data(), found.data());
        else
          pstpu::table_export(t.mem, keys, h.n, vals.data(), found.data(), 1,
                              slots);
        return h.n;
      }
      case kPushSparse: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return kErrNoTable;
        int32_t pd = t.push_dim();
        // quantized wire (PushWireFlag in h.aux): the tapped frame
        // carries the SAME encoded bytes the primary decoded, so this
        // dequant is bit-identical to the primary's apply
        std::vector<float> wide;
        const float* push;
        int64_t st = decode_push_rows(h, p, pd, &wide, &push);
        if (st < 0) return st;
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        if (t.ssd) {
          sst_push(t.ssd, keys, push, h.n);
        } else {
          t.mem->parallel_over_shards(keys, h.n, [&](pstpu::Shard* sh, int64_t i) {
            const float* pv = push + i * pd;
            int32_t r = sh->lookup_or_insert(keys[i], static_cast<int32_t>(pv[0]));
            sh->push_one(r, pv);
          });
        }
        return h.n;
      }
      case kPushDense: {
        DenseTable* t = get_dense(h.table_id);
        if (!t) return kErrNoTable;
        if (h.payload_len != t->values.size() * 4) return kErrBadSize;
        t->push(reinterpret_cast<const float*>(p));
        dense_version.fetch_add(1);
        return 0;
      }
      case kSetDense: {
        DenseTable* t = get_dense(h.table_id);
        if (!t) return kErrNoTable;
        if (h.payload_len != t->values.size() * 4) return kErrBadSize;
        {
          std::lock_guard<std::mutex> g(t->mu);
          std::memcpy(t->values.data(), p, h.payload_len);
        }
        dense_version.fetch_add(1);
        return 0;
      }
      case kInsertFull:
      case kLoadCold: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return kErrNoTable;
        int32_t fdim = t.full_dim();
        if (h.payload_len != static_cast<uint64_t>(h.n) * (8 + 4 * fdim))
          return kErrBadSize;
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        const float* vals = reinterpret_cast<const float*>(p + h.n * 8);
        if (t.ssd) {
          if (h.cmd == kLoadCold) return sst_load_cold(t.ssd, keys, vals, h.n);
          sst_insert_full(t.ssd, keys, vals, h.n);
        } else {
          pstpu::table_insert_full(t.mem, keys, vals, h.n);
        }
        return h.n;
      }
      case kPushGeo: {
        GeoTable* t = get_geo(h.table_id);
        if (!t) return kErrNoTable;
        if (h.payload_len != static_cast<uint64_t>(h.n) * (8 + 4 * t->dim))
          return kErrBadSize;
        t->push(reinterpret_cast<const uint64_t*>(p),
                reinterpret_cast<const float*>(p + h.n * 8), h.n);
        return h.n;
      }
      case kPullGeo: {  // primary drained — backup must drop the same acc
        GeoTable* t = get_geo(h.table_id);
        if (!t) return kErrNoTable;
        std::vector<uint64_t> keys;
        std::vector<float> deltas;
        t->pull(&keys, &deltas);
        return static_cast<int64_t>(keys.size());
      }
      case kShrink: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return kErrNoTable;
        if (t.ssd) return sst_shrink(t.ssd);
        int64_t erased = 0;
        for (auto* sh : t.mem->shards) {
          std::lock_guard<std::mutex> g(sh->mu);
          erased += sh->shrink();
        }
        return erased;
      }
      case kGlobalStep:
        return global_step.fetch_add(h.n) + h.n;
      case kRetain:
        return do_retain(h.n, h.aux);
      default:
        return kErrBadCmd;
    }
  }

  void serve_conn(int fd) {
    std::vector<char> buf;
    // tenant binding is per-CONNECTION: 0 (operator/default plane) until
    // a kTenantHello lands, then pinned to that tenant for the socket's
    // lifetime — a rebind attempt is refused, so a leaked descriptor
    // can't hop namespaces
    uint32_t conn_tenant = 0;
    while (true) {
      ReqHeader h;
      if (!read_full(fd, &h, sizeof(h))) break;
      if (h.payload_len > kMaxPayload) break;
      buf.resize(h.payload_len);
      if (h.payload_len && !read_full(fd, buf.data(), h.payload_len)) break;
      // obs wrapper: service time is frame-parsed → response-written,
      // the span the client's wire context (trace_id/span_id) keys
      t_resp_bytes = 0;
      t_gate_wait_us = 0;
      int64_t ob_ts = wall_us();
      int64_t ob_t0 = mono_us();
      bool ok = handle(fd, h, buf.data(), &conn_tenant);
      obs_account(h, ob_ts, mono_us() - ob_t0);
      if (!ok) break;
      if (h.cmd == kStop) break;
    }
    ::close(fd);
    std::lock_guard<std::mutex> g(conn_mu);
    for (size_t i = 0; i < conn_fds.size(); ++i)
      if (conn_fds[i] == fd) {
        conn_fds.erase(conn_fds.begin() + i);
        break;
      }
  }

  // h by VALUE: read-only mode may downgrade a pull's insert-on-miss
  // bit before dispatch (24 trivially-copyable bytes). `tenant` is the
  // connection's binding slot (serve_conn local): kTenantHello writes
  // it, every later frame is admitted against it.
  bool handle(int fd, ReqHeader h, const char* p, uint32_t* tenant) {
    // global count sanity bound BEFORE any `h.n * width` arithmetic: a
    // huge n would overflow the int64 size checks (n*8 ≡ 0 mod 2^64)
    // and bypass them into out-of-bounds reads. No legitimate command
    // carries more elements than the frame cap has bytes; with
    // n ≤ kMaxPayload every downstream n·width product fits in 64 bits.
    if (h.n < 0 || static_cast<uint64_t>(h.n) > kMaxPayload) {
      // exemptions: kEpoch reads with n = -1; kReplicate/kReplState
      // carry an oplog SEQ in n (any int64 >= -1, NOT an element
      // count — a long-lived shard's lifetime mutation count exceeds
      // the 2^32 frame-cap bound this check enforces for count-shaped
      // n, and a snapshot rebase must be able to SET such a cut)
      bool ok = h.cmd == kEpoch && h.n == -1;
      ok = ok || ((h.cmd == kReplicate || h.cmd == kReplState) && h.n >= -1);
      if (!ok) return respond(fd, kErrBadSize, nullptr, 0);
    }
    // deterministic fault injection (chaos harness): fires BEFORE any
    // state change so a dropped/killed request is all-or-nothing
    {
      std::string act = fault_action(h.cmd);
      if (act == "kill-shard") {
        request_stop();  // the whole server dies, like a SIGKILL'd host
        return false;
      }
      if (act == "drop-frame") return false;  // vanish without a response
      if (act == "close-socket") {
        ::shutdown(fd, SHUT_RDWR);
        return false;
      }
    }
    // -- tenancy fence: runs BEFORE the read-only check, the pause
    // gate, the ownership fence and the oplog tap, so a refused frame
    // changed state nowhere and never entered the replication stream.
    if (h.cmd == kTenantHello) {
      // bind this connection to tenant h.n; payload = auth token
      if (h.n < 1 || h.n > 255) return respond(fd, kErrBadSize, nullptr, 0);
      if (*tenant != 0)  // rebind refused — binding is socket-lifetime
        return respond(fd, kErrWrongTenant, nullptr, 0);
      bool ok = false;
      {
        std::lock_guard<std::mutex> g(tenants_mu);  // LOCK: tenants_mu
        auto it = tenants.find(static_cast<uint32_t>(h.n));
        ok = it != tenants.end() &&
             it->second.token ==
                 std::string(p, static_cast<size_t>(h.payload_len));
      }
      if (!ok) return respond(fd, kErrWrongTenant, nullptr, 0);
      *tenant = static_cast<uint32_t>(h.n);
      return respond(fd, 0, nullptr, 0);
    }
    if (h.cmd == kTenantConfig) {
      // operator plane only: a tenant-bound connection may not inspect
      // or rewrite the tenant registry (not even its own entry — quota
      // self-service would defeat the point)
      if (*tenant != 0) return respond(fd, kErrWrongTenant, nullptr, 0);
      return do_tenant_config(fd, h, p);
    }
    if (*tenant != 0) {
      int64_t st = tenant_admit(*tenant, h);
      if (st == kErrThrottled) {
        int64_t retry = t_retry_after_ms;
        return respond(fd, kErrThrottled, &retry, 8);
      }
      if (st < 0) return respond(fd, st, nullptr, 0);
    }
    // read-only attach mode (serving replicas): refuse the training
    // data plane outright, BEFORE the pause gate and the oplog tap — a
    // refused request must neither block on the gate nor land in the
    // ring. A pull's insert-on-miss bit is downgraded instead so a
    // serve client reading an out-of-population key gets zeros, not a
    // phantom row the primary never created.
    if (read_only.load()) {
      if (is_training_plane_cmd(h.cmd, h.aux, h.n))
        return respond(fd, kErrReadOnly, nullptr, 0);
      if (h.cmd == kPullSparse) h.aux &= ~1;
    }
    bool mutating = is_mutating_cmd(h.cmd, h.aux, h.n);
    // snapshot quiesce gate + oplog tap: mutating requests block while a
    // full-sync pauses writers, then land in the oplog in the order this
    // serialized section admits them. NB the tap happens before the
    // apply; with multiple client connections the engine-apply order of
    // racing same-key pushes may differ from oplog order (async
    // replication tolerates bounded divergence; sync-mode bit-identical
    // guarantees assume serialized pushes — ps/ha.py docstring).
    // kRetain is pause-EXEMPT: the reshard cutover issues it while the
    // mutation gate already holds every writer out — gating it too
    // would deadlock the cutover against its own gate. It still taps
    // (below), so backups replay the same retain at the same point in
    // the op stream.
    MutGuard mg(this, mutating && h.cmd != kRetain);
    // key-ownership fence (live resharding): reject a stale-topology
    // client's frame WHOLE — before the tap and any apply, so the
    // bounced keys changed state nowhere and the client's
    // re-resolve-and-replay applies each key exactly once. MUST sit
    // AFTER the gate: a mutator that blocked through a reshard cutover
    // re-validates against the ownership the cutover installed while
    // it waited (checked before the gate, it would re-create the very
    // rows the cutover just migrated away). Keys lead every keyed
    // payload; the length guard defers short frames to kErrBadSize.
    {
      int64_t om = own_mod.load(std::memory_order_relaxed);
      if (om > 0 && is_keyed_data_cmd(h.cmd) && h.n > 0 &&
          h.payload_len >= static_cast<uint64_t>(h.n) * 8) {
        int64_t orr = own_res.load(std::memory_order_relaxed);
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        for (int64_t i = 0; i < h.n; ++i)
          if (static_cast<int64_t>(keys[i] % static_cast<uint64_t>(om)) !=
              orr)
            return respond(fd, kErrWrongShard, nullptr, 0);
      }
    }
    // pull/export-with-create defer their tap into the case body: when
    // the traversal inserts NOTHING the op is a state no-op and skipping
    // it halves steady-state replication traffic (a stream trainer
    // re-pulls the same working set every batch). All other mutators tap
    // here, before the apply.
    bool deferred_tap = h.cmd == kPullSparse || h.cmd == kExport;
    if (mutating && !deferred_tap && repl_enabled.load()) log_op(h, p);
    if (is_create_cmd(h.cmd)) log_catalog(h, p);
    switch (h.cmd) {
      case kPing:
        return respond(fd, 0, nullptr, 0);
      case kCreateSparse: {
        int32_t dims[3];
        int64_t st = do_create_sparse(h, p, dims);
        if (st < 0) return respond(fd, st, nullptr, 0);
        return respond(fd, 0, dims, sizeof(dims));
      }
      case kCreateDense:
        return respond(fd, do_create_dense(h, p), nullptr, 0);
      case kCreateGeo:
        return respond(fd, do_create_geo(h, p), nullptr, 0);
      case kPullSparse: {
        // aux bit 0: insert-on-miss; aux bit 1: fp16 wire values (the
        // table-config pull_wire_dtype knob — halves response bytes)
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        int32_t pd = t.pull_dim();
        int32_t create = h.aux & 1;
        bool wire_f16 = (h.aux & 2) != 0;
        uint64_t want = static_cast<uint64_t>(h.n) * (8 + 4);
        if (h.payload_len != want) return respond(fd, kErrBadSize, nullptr, 0);
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        const int32_t* slots = reinterpret_cast<const int32_t*>(p + h.n * 8);
        // deferred tap: only replicate this pull if it actually INSERTS
        // (row-count delta; exact under one connection's serialized
        // stream — the same window the sync bit-identity contract names)
        bool tap = create && repl_enabled.load();
        int64_t rows_before = tap ? sparse_rows(t) : 0;
        std::vector<float> out(static_cast<size_t>(h.n) * pd);
        if (t.ssd) {
          sst_pull(t.ssd, keys, slots, h.n, create, out.data());
        } else {
          t.mem->parallel_over_shards(keys, h.n, [&](pstpu::Shard* sh, int64_t i) {
            int32_t r = create ? sh->lookup_or_insert(keys[i], slots[i])
                               : sh->find(keys[i]);
            float* o = out.data() + i * pd;
            if (r >= 0)
              sh->select_into(r, o);
            else
              std::fill_n(o, pd, 0.0f);
          });
        }
        if (tap && sparse_rows(t) != rows_before) log_op(h, p);
        if (wire_f16) {
          std::vector<uint16_t> half(out.size());
          for (size_t i = 0; i < out.size(); ++i) half[i] = f32_to_f16(out[i]);
          return respond(fd, h.n, half.data(), half.size() * 2);
        }
        return respond(fd, h.n, out.data(), out.size() * 4);
      }
      case kPushSparse: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        int32_t pd = t.push_dim();
        // dequant-before-apply (PushWireFlag in h.aux): server state
        // stays fp32; a bad encoding rejects whole BEFORE any apply
        std::vector<float> wide;
        const float* push;
        int64_t st = decode_push_rows(h, p, pd, &wide, &push);
        if (st < 0) return respond(fd, st, nullptr, 0);
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        if (t.ssd) {
          sst_push(t.ssd, keys, push, h.n);
        } else {
          t.mem->parallel_over_shards(keys, h.n, [&](pstpu::Shard* sh, int64_t i) {
            const float* pv = push + i * pd;
            int32_t r = sh->lookup_or_insert(keys[i], static_cast<int32_t>(pv[0]));
            sh->push_one(r, pv);
          });
        }
        return respond(fd, h.n, nullptr, 0);
      }
      case kPullDense: {
        DenseTable* t = get_dense(h.table_id);
        if (!t) return respond(fd, kErrNoTable, nullptr, 0);
        std::lock_guard<std::mutex> g(t->mu);
        return respond(fd, static_cast<int64_t>(t->values.size()),
                       t->values.data(), t->values.size() * 4);
      }
      case kPushDense: {
        DenseTable* t = get_dense(h.table_id);
        if (!t) return respond(fd, kErrNoTable, nullptr, 0);
        if (h.payload_len != t->values.size() * 4)
          return respond(fd, kErrBadSize, nullptr, 0);
        t->push(reinterpret_cast<const float*>(p));
        dense_version.fetch_add(1);
        return respond(fd, 0, nullptr, 0);
      }
      case kSetDense: {
        DenseTable* t = get_dense(h.table_id);
        if (!t) return respond(fd, kErrNoTable, nullptr, 0);
        if (h.payload_len != t->values.size() * 4)
          return respond(fd, kErrBadSize, nullptr, 0);
        {
          std::lock_guard<std::mutex> g(t->mu);
          std::memcpy(t->values.data(), p, h.payload_len);
        }
        dense_version.fetch_add(1);
        return respond(fd, 0, nullptr, 0);
      }
      case kSize: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        return respond(fd, sparse_rows(t), nullptr, 0);
      }
      case kShrink: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        if (t.ssd) return respond(fd, sst_shrink(t.ssd), nullptr, 0);
        int64_t erased = 0;
        for (auto* sh : t.mem->shards) {
          std::lock_guard<std::mutex> g(sh->mu);
          erased += sh->shrink();
        }
        return respond(fd, erased, nullptr, 0);
      }
      case kSpill: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        // RAM-only tables have nothing to spill — 0, not an error
        return respond(fd, t.ssd ? sst_spill(t.ssd, h.n) : 0, nullptr, 0);
      }
      case kStats: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        int64_t s3[3] = {0, 0, 0};
        if (t.ssd) {
          sst_stats(t.ssd, s3);
        } else {
          for (auto* sh : t.mem->shards) s3[0] += sh->used;
        }
        return respond(fd, 0, s3, sizeof(s3));
      }
      case kCompact: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        return respond(fd, t.ssd ? sst_compact(t.ssd) : 0, nullptr, 0);
      }
      case kLoadCold: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        int32_t fdim = t.full_dim();
        uint64_t want = static_cast<uint64_t>(h.n) * (8 + 4 * fdim);
        if (h.payload_len != want) return respond(fd, kErrBadSize, nullptr, 0);
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        const float* vals = reinterpret_cast<const float*>(p + h.n * 8);
        int64_t got;
        if (t.ssd) {
          got = sst_load_cold(t.ssd, keys, vals, h.n);
        } else {
          pstpu::table_insert_full(t.mem, keys, vals, h.n);
          got = h.n;  // RAM engine has no cold tier: hot insert
        }
        return respond(fd, got, nullptr, 0);
      }
      case kSaveFile: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        if (!h.payload_len) return respond(fd, kErrBadSize, nullptr, 0);
        int32_t mode = h.aux & 0xff, fmt = (h.aux >> 8) & 0xff;
        std::string path(p, h.payload_len);
        int64_t cnt = t.ssd ? sst_save_file(t.ssd, path.c_str(), mode, fmt)
                            : mem_save_file(t.mem, path.c_str(), mode, fmt);
        return respond(fd, cnt < 0 ? kErrInternal : cnt, nullptr, 0);
      }
      case kLoadFile: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        if (!h.payload_len) return respond(fd, kErrBadSize, nullptr, 0);
        int32_t fmt = (h.aux >> 8) & 0xff;
        std::string path(p, h.payload_len);
        int64_t cnt = t.ssd ? sst_load_file(t.ssd, path.c_str(), fmt)
                            : mem_load_file(t.mem, path.c_str(), fmt);
        return respond(fd, cnt < 0 ? kErrInternal : cnt, nullptr, 0);
      }
      case kCreateGraph: {
        std::lock_guard<std::mutex> g(tables_mu);
        if (graphs.find(h.table_id) == graphs.end())
          graphs[h.table_id] = new pstpu::GraphStore(
              h.aux > 0 ? h.aux : 16, /*seed=*/h.table_id + 1);
        return respond(fd, 0, nullptr, 0);
      }
      case kGraphAddNodes: {
        pstpu::GraphStore* gt = get_graph(h.table_id);
        if (!gt) return respond(fd, kErrNoTable, nullptr, 0);
        int fdim = h.aux;
        uint64_t want = h.n * 8 + (fdim > 0 ? h.n * fdim * 4 : 0);
        if (h.payload_len != want) return respond(fd, kErrBadSize, nullptr, 0);
        gt->add_nodes(reinterpret_cast<const uint64_t*>(p), h.n,
                      fdim > 0 ? reinterpret_cast<const float*>(p + h.n * 8)
                               : nullptr,
                      fdim);
        return respond(fd, h.n, nullptr, 0);
      }
      case kGraphAddEdges: {
        pstpu::GraphStore* gt = get_graph(h.table_id);
        if (!gt) return respond(fd, kErrNoTable, nullptr, 0);
        if (h.payload_len != static_cast<uint64_t>(h.n) * 20)
          return respond(fd, kErrBadSize, nullptr, 0);
        gt->add_edges(reinterpret_cast<const uint64_t*>(p),
                      reinterpret_cast<const uint64_t*>(p + h.n * 8),
                      reinterpret_cast<const float*>(p + h.n * 16), h.n);
        return respond(fd, h.n, nullptr, 0);
      }
      case kGraphSampleNeighbors: {
        pstpu::GraphStore* gt = get_graph(h.table_id);
        if (!gt) return respond(fd, kErrNoTable, nullptr, 0);
        if (h.payload_len != static_cast<uint64_t>(h.n) * 8)
          return respond(fd, kErrBadSize, nullptr, 0);
        int k = h.aux & 0xFFFF;
        bool weighted = (h.aux >> 30) & 1;
        // bound the RESPONSE to the frame cap too — a legitimate-looking
        // (n, k) pair can demand gigabytes the client would reject anyway
        if (k <= 0 || static_cast<uint64_t>(h.n) * k * 9 > kMaxPayload)
          return respond(fd, kErrBadSize, nullptr, 0);
        std::vector<char> out(h.n * k * 9);  // u64 nbrs ++ u8 mask
        gt->sample_neighbors(
            reinterpret_cast<const uint64_t*>(p), h.n, k, weighted,
            reinterpret_cast<uint64_t*>(out.data()),
            reinterpret_cast<uint8_t*>(out.data() + h.n * k * 8));
        return respond(fd, h.n, out.data(), out.size());
      }
      case kGraphDegree: {
        pstpu::GraphStore* gt = get_graph(h.table_id);
        if (!gt) return respond(fd, kErrNoTable, nullptr, 0);
        if (h.payload_len != static_cast<uint64_t>(h.n) * 8)
          return respond(fd, kErrBadSize, nullptr, 0);
        std::vector<int32_t> out(h.n);
        gt->degrees(reinterpret_cast<const uint64_t*>(p), h.n, out.data());
        return respond(fd, h.n, out.data(), out.size() * 4);
      }
      case kGraphNodeFeat: {
        pstpu::GraphStore* gt = get_graph(h.table_id);
        if (!gt) return respond(fd, kErrNoTable, nullptr, 0);
        int fdim = h.aux;
        if (fdim <= 0 || h.payload_len != static_cast<uint64_t>(h.n) * 8 ||
            static_cast<uint64_t>(h.n) * fdim * 4 > kMaxPayload)
          return respond(fd, kErrBadSize, nullptr, 0);
        std::vector<float> out(h.n * fdim);
        gt->node_feat(reinterpret_cast<const uint64_t*>(p), h.n, fdim,
                      out.data());
        return respond(fd, h.n, out.data(), out.size() * 4);
      }
      case kGraphSetNodeFeat: {
        pstpu::GraphStore* gt = get_graph(h.table_id);
        if (!gt) return respond(fd, kErrNoTable, nullptr, 0);
        int fdim = h.aux;
        if (fdim <= 0 ||
            h.payload_len != static_cast<uint64_t>(h.n) * (8 + fdim * 4))
          return respond(fd, kErrBadSize, nullptr, 0);
        bool ok = gt->set_node_feat(
            reinterpret_cast<const uint64_t*>(p), h.n, fdim,
            reinterpret_cast<const float*>(p + h.n * 8));
        return respond(fd, ok ? h.n : kErrNoTable, nullptr, 0);
      }
      case kGraphSampleNodes: {
        pstpu::GraphStore* gt = get_graph(h.table_id);
        if (!gt) return respond(fd, kErrNoTable, nullptr, 0);
        // no payload bounds h.n here — validate before allocating
        if (h.n <= 0 || static_cast<uint64_t>(h.n) * 8 > kMaxPayload)
          return respond(fd, kErrBadSize, nullptr, 0);
        std::vector<uint64_t> out(h.n);
        int64_t got = gt->sample_nodes(h.n, out.data());
        return respond(fd, got, out.data(), got * 8);
      }
      case kGraphStats: {
        pstpu::GraphStore* gt = get_graph(h.table_id);
        if (!gt) return respond(fd, kErrNoTable, nullptr, 0);
        int64_t out[2];
        gt->stats(&out[0], &out[1]);
        return respond(fd, 0, out, sizeof(out));
      }
      case kSaveAll: {
        // snapshot + stream in ONE command — atomic against concurrent
        // savers (the two-phase begin/fetch protocol could interleave)
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        int32_t fdim = t.full_dim();
        std::vector<char> out;
        int64_t cnt;
        if (t.ssd) {
          std::mutex* save_mu;
          {
            std::lock_guard<std::mutex> g(tables_mu);
            save_mu = ssd_save_mu.at(h.table_id).get();
          }
          std::lock_guard<std::mutex> sg(*save_mu);
          cnt = sst_save_begin(t.ssd, h.aux);
          out.resize(cnt * 8 + cnt * fdim * 4);
          if (cnt)
            sst_save_fetch(t.ssd, reinterpret_cast<uint64_t*>(out.data()),
                           reinterpret_cast<float*>(out.data() + cnt * 8));
        } else {
          std::lock_guard<std::mutex> sg(t.mem->save_mu);
          pstpu::table_save_snapshot_locked(t.mem, h.aux);
          cnt = static_cast<int64_t>(t.mem->save_keys.size());
          out.resize(cnt * 8 + cnt * fdim * 4);
          if (cnt) {
            std::memcpy(out.data(), t.mem->save_keys.data(), cnt * 8);
            std::memcpy(out.data() + cnt * 8, t.mem->save_values.data(),
                        t.mem->save_values.size() * 4);
          }
          t.mem->save_keys.clear();
          t.mem->save_values.clear();
        }
        return respond(fd, cnt, out.data(), out.size());
      }
      case kInsertFull: {
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        int32_t fdim = t.full_dim();
        uint64_t want = static_cast<uint64_t>(h.n) * (8 + 4 * fdim);
        if (h.payload_len != want) return respond(fd, kErrBadSize, nullptr, 0);
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        const float* vals = reinterpret_cast<const float*>(p + h.n * 8);
        if (t.ssd)
          sst_insert_full(t.ssd, keys, vals, h.n);
        else
          pstpu::table_insert_full(t.mem, keys, vals, h.n);
        return respond(fd, h.n, nullptr, 0);
      }
      case kExport: {
        // aux==1: export WITH insert-on-miss (the pass-build BuildPull
        // from remote shards) — payload then carries [keys][slots i32]
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        uint64_t want = static_cast<uint64_t>(h.n) * (h.aux ? 12 : 8);
        if (h.payload_len != want) return respond(fd, kErrBadSize, nullptr, 0);
        int32_t fdim = t.full_dim();
        std::vector<char> out(static_cast<size_t>(h.n) * fdim * 4 + h.n);
        const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
        const int32_t* slots =
            h.aux ? reinterpret_cast<const int32_t*>(p + h.n * 8) : nullptr;
        float* vals = reinterpret_cast<float*>(out.data());
        uint8_t* found = reinterpret_cast<uint8_t*>(out.data() + h.n * fdim * 4);
        // same deferred no-insert-no-tap rule as kPullSparse above
        bool tap = (h.aux & 1) && repl_enabled.load();
        int64_t rows_before = tap ? sparse_rows(t) : 0;
        if (t.ssd)
          sst_export(t.ssd, keys, slots, h.n, h.aux ? 1 : 0, vals, found);
        else
          pstpu::table_export(t.mem, keys, h.n, vals, found, h.aux ? 1 : 0,
                              slots);
        if (tap && sparse_rows(t) != rows_before) log_op(h, p);
        return respond(fd, h.n, out.data(), out.size());
      }
      case kPushGeo: {
        GeoTable* t = get_geo(h.table_id);
        if (!t) return respond(fd, kErrNoTable, nullptr, 0);
        uint64_t want = static_cast<uint64_t>(h.n) * (8 + 4 * t->dim);
        if (h.payload_len != want) return respond(fd, kErrBadSize, nullptr, 0);
        t->push(reinterpret_cast<const uint64_t*>(p),
                reinterpret_cast<const float*>(p + h.n * 8), h.n);
        return respond(fd, h.n, nullptr, 0);
      }
      case kPullGeo: {
        GeoTable* t = get_geo(h.table_id);
        if (!t) return respond(fd, kErrNoTable, nullptr, 0);
        std::vector<uint64_t> keys;
        std::vector<float> deltas;
        t->pull(&keys, &deltas);
        std::vector<char> out(keys.size() * 8 + deltas.size() * 4);
        std::memcpy(out.data(), keys.data(), keys.size() * 8);
        std::memcpy(out.data() + keys.size() * 8, deltas.data(),
                    deltas.size() * 4);
        return respond(fd, static_cast<int64_t>(keys.size()), out.data(),
                       out.size());
      }
      case kReplicate: {
        // apply a primary's oplog entry. n = seq (-1 = untracked catalog
        // replay), aux = sender's epoch. Epoch fencing first: a demoted
        // primary (network-partitioned through its own death sentence)
        // must not overwrite the promoted successor's state.
        if (static_cast<int64_t>(h.aux) < epoch.load())
          return respond(fd, kErrStaleEpoch, nullptr, 0);
        if (h.payload_len < sizeof(ReqHeader))
          return respond(fd, kErrBadSize, nullptr, 0);
        ReqHeader ih;
        std::memcpy(&ih, p, sizeof(ih));
        if (ih.payload_len != h.payload_len - sizeof(ReqHeader))
          return respond(fd, kErrBadSize, nullptr, 0);
        int64_t seq = h.n;
        if (seq >= 0) {
          int64_t expect = applied_seq.load() + 1;
          if (seq < expect)  // replay after reconnect: ack idempotently
            return respond(fd, seq, nullptr, 0);
          if (seq > expect)  // entries lost — shipper must full-sync
            return respond(fd, kErrSeqGap, nullptr, 0);
        }
        int64_t st = apply_op(ih, p + sizeof(ReqHeader));
        // a frame that fails VALIDATION failed identically on the
        // primary (the tap happens before the case body's payload
        // checks, and apply_op's checks are kept in lockstep): state
        // changed on NEITHER side, so ack it and advance — otherwise
        // one malformed client request would wedge the backup into an
        // endless drop/resync loop. kErrNoTable is in the same class:
        // creates ride the SAME ordered stream, so a table missing here
        // at seq K was also missing on the primary at its tap time.
        bool rejected = st == kErrBadSize || st == kErrBadCmd ||
                        st == kErrNoTable;
        if (rejected) st = 0;
        if (st < 0) return respond(fd, st, nullptr, 0);
        if (seq >= 0) applied_seq.store(seq);
        // chain the inner frame into OUR oplog too: a promoted backup
        // already holds the history its own backups will need (no-op
        // rejected frames aren't worth forwarding further)
        if (!rejected) {
          if (is_mutating_cmd(ih.cmd, ih.aux, ih.n) && repl_enabled.load())
            log_op(ih, p + sizeof(ReqHeader));
          if (is_create_cmd(ih.cmd)) log_catalog(ih, p + sizeof(ReqHeader));
        }
        return respond(fd, seq >= 0 ? seq : st, nullptr, 0);
      }
      case kEpoch: {
        if (h.n >= 0) epoch.store(h.n);
        return respond(fd, epoch.load(), nullptr, 0);
      }
      case kReplState: {
        if (h.n >= 0) {
          applied_seq.store(h.n);
          return respond(fd, h.n, nullptr, 0);
        }
        int64_t oseq, opend;
        {
          std::lock_guard<std::mutex> g(oplog_mu);  // LOCK: oplog_mu
          oseq = oplog_seq;
          opend = static_cast<int64_t>(oplog.size());
        }
        // applied/epoch answer "how caught up is this backup"; the
        // oplog pair answers "how far ahead is this primary" — together
        // a CLIENT can run a cross-process sync-replication barrier
        // (ha.drain_remote) with no shared store
        int64_t out[4] = {applied_seq.load(), epoch.load(), oseq, opend};
        return respond(fd, 0, out, sizeof(out));
      }
      case kDigest: {
        // n > 0: digest restricted to keys with key % n == aux — the
        // reshard migration check (digests are wrapping sums of row
        // hashes, so class digests ADD: no row lost or doubled across
        // a cutover is an O(1) equality). n = 0: whole table.
        SparseRef t;
        if (!get_sparse(h.table_id, &t)) return respond(fd, kErrNoTable, nullptr, 0);
        uint64_t dg;
        if (h.n > 0) {
          if (t.ssd || h.aux < 0 || h.aux >= h.n)
            return respond(fd, kErrBadSize, nullptr, 0);
          dg = pstpu::table_digest_filtered(
              t.mem, static_cast<uint64_t>(h.n),
              static_cast<uint64_t>(h.aux));
        } else {
          dg = t.ssd ? sst_digest(t.ssd) : pstpu::table_digest(t.mem);
        }
        return respond(fd, 0, &dg, sizeof(dg));
      }
      case kRetain: {
        if (h.n == 0) {  // ownership read (introspection/tests)
          int64_t out[2] = {own_mod.load(), own_res.load()};
          return respond(fd, 0, out, sizeof(out));
        }
        return respond(fd, do_retain(h.n, h.aux), nullptr, 0);
      }
      case kDenseSnap: {
        DenseTable* t = get_dense(h.table_id);
        if (!t) return respond(fd, kErrNoTable, nullptr, 0);
        std::lock_guard<std::mutex> g(t->mu);
        size_t d = t->values.size();
        std::vector<char> out(8 + 4 * d * (t->opt == 1 ? 3 : 1));
        std::memcpy(out.data(), &t->t, 8);
        std::memcpy(out.data() + 8, t->values.data(), 4 * d);
        if (t->opt == 1) {
          std::memcpy(out.data() + 8 + 4 * d, t->m.data(), 4 * d);
          std::memcpy(out.data() + 8 + 8 * d, t->v.data(), 4 * d);
        }
        return respond(fd, static_cast<int64_t>(d), out.data(), out.size());
      }
      case kDenseRestore:
        return respond(fd, do_dense_restore(h, p), nullptr, 0);
      case kObsSnap: {
        // per-table wire counters + the server-span ring, one frame.
        // aux&1 drains the spans (the aggregator's normal read); aux&2
        // zeroes the wire counters (bench epochs take deltas).
        bool drain = (h.aux & 1) != 0;
        bool reset_wire = (h.aux & 2) != 0;
        std::vector<char> out;
        {
          std::lock_guard<std::mutex> g(obs_mu);  // LOCK: obs_mu
          uint32_t nt = static_cast<uint32_t>(wire.size());
          uint32_t ns = static_cast<uint32_t>(obs_spans.size());
          out.resize(16 + static_cast<size_t>(nt) * 48 +
                     static_cast<size_t>(ns) * sizeof(ObsSpan));
          char* w = out.data();
          std::memcpy(w, &nt, 4);
          std::memcpy(w + 4, &ns, 4);
          std::memcpy(w + 8, &obs_spans_dropped, 8);
          w += 16;
          for (auto& kv : wire) {
            uint32_t tid = kv.first, pad = 0;
            std::memcpy(w, &tid, 4);
            std::memcpy(w + 4, &pad, 4);
            std::memcpy(w + 8, &kv.second.in_bytes, 8);
            std::memcpy(w + 16, &kv.second.out_bytes, 8);
            std::memcpy(w + 24, &kv.second.in_rows, 8);
            std::memcpy(w + 32, &kv.second.out_rows, 8);
            std::memcpy(w + 40, &kv.second.reqs, 8);
            w += 48;
          }
          for (auto& s : obs_spans) {
            std::memcpy(w, &s, sizeof(ObsSpan));
            w += sizeof(ObsSpan);
          }
          if (drain) {
            obs_spans.clear();
            obs_spans_dropped = 0;
          }
          if (reset_wire) wire.clear();
        }
        return respond(fd, 0, out.data(), out.size());
      }
      case kBarrier: {
        std::unique_lock<std::mutex> lk(bar_mu);
        int64_t my_gen = bar_gen;
        if (++bar_count >= n_trainers) {
          bar_count = 0;
          bar_gen++;
          bar_cv.notify_all();
        } else {
          // wait in slices, watching the waiter's own connection: if the
          // client gave up (deadline) or died, CANCEL its arrival — a
          // phantom arrival would release the next generation with n-1
          // real trainers, permanently desynchronizing the group
          for (;;) {
            // system_clock wait_until (NOT wait_for/steady): libstdc++
            // lowers the steady-clock wait to pthread_cond_clockwait,
            // which gcc-10's TSAN doesn't intercept — the invisible
            // unlock inside the wait turns every later bar_mu/oplog_mu
            // acquisition into ghost double-lock/race reports. The
            // 100 ms slice has no steady-clock correctness dependence.
            if (bar_cv.wait_until(
                    lk, std::chrono::system_clock::now() +
                            std::chrono::milliseconds(100), [&]() {
                      return bar_gen != my_gen || stopping.load();
                    }))
              break;
            char probe;
            ssize_t r = ::recv(fd, &probe, 1, MSG_PEEK | MSG_DONTWAIT);
            if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
              if (bar_gen == my_gen) --bar_count;  // still un-released
              return false;  // drop the connection; no response owed
            }
          }
        }
        return respond(fd, 0, nullptr, 0);
      }
      case kGlobalStep: {
        int64_t s = global_step.fetch_add(h.n) + h.n;
        return respond(fd, s, nullptr, 0);
      }
      case kStop: {
        respond(fd, 0, nullptr, 0);
        request_stop();  // join happens in pss_stop/pss_destroy
        return false;
      }
      default:
        return respond(fd, kErrBadCmd, nullptr, 0);
    }
  }
};

// client connection: synchronous request/response; a mutex serializes
// callers (the python Communicator provides async via its own threads).
// Timeouts mirror the brpc client's FLAGS_pserver_connect_timeout_ms /
// FLAGS_pserver_timeout_ms knobs (brpc_ps_client.cc:24-45). The socket
// stays non-blocking; every send/recv waits via poll against ONE
// absolute deadline for the whole RPC — a per-syscall SO_RCVTIMEO would
// let a server dripping bytes stretch a "30s" call indefinitely.
static int64_t now_ms() {
  timespec ts;
  ::clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

// coalesce threshold for scatter-gather sends: below this the header +
// parts memcpy into the connection's reusable size-classed buffer and
// ship as ONE send (TCP_NODELAY would otherwise put each tiny part on
// the wire alone); above it each part streams straight from caller
// memory — zero client-side staging for bulk payloads.
constexpr uint64_t kCoalesceMax = 64 * 1024;

struct PsConn {
  int fd = -1;
  int io_ms = 0;  // whole-call budget; 0 = no deadline
  std::mutex mu;
  // reused across calls, grown in powers of two, never shrunk: the
  // per-call allocation the tobytes() framing used to pay is gone
  std::vector<char> sendbuf;

  ~PsConn() {
    if (fd >= 0) ::close(fd);
  }

  bool connect_to(const char* host, int port, int connect_ms, int io_ms_) {
    io_ms = io_ms_;
    // resolve hostnames too (cluster endpoint lists are usually names)
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    char portstr[16];
    std::snprintf(portstr, sizeof(portstr), "%d", port);
    if (::getaddrinfo(host, portstr, &hints, &res) != 0 || res == nullptr)
      return false;
    fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd < 0) {
      ::freeaddrinfo(res);
      return false;
    }
    int fl = ::fcntl(fd, F_GETFL, 0);
    ::fcntl(fd, F_SETFL, fl | O_NONBLOCK);  // stays non-blocking for life
    int rc = ::connect(fd, res->ai_addr, res->ai_addrlen);
    bool ok = rc == 0;
    if (rc < 0 && errno == EINPROGRESS) {
      int64_t deadline = connect_ms > 0 ? now_ms() + connect_ms : 0;
      for (;;) {
        int wait = -1;
        if (deadline) {
          int64_t rem = deadline - now_ms();
          if (rem <= 0) break;  // timed out
          wait = static_cast<int>(rem);
        }
        pollfd pfd{fd, POLLOUT, 0};
        int pr = ::poll(&pfd, 1, wait);
        if (pr < 0 && errno == EINTR) continue;  // signal ≠ failure
        if (pr == 1) {
          int err = 0;
          socklen_t elen = sizeof(err);
          ::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen);
          ok = err == 0;
        }
        break;
      }
    }
    ::freeaddrinfo(res);
    if (!ok) {
      ::close(fd);
      fd = -1;
      return false;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // detect a silently dead peer even on deadline-less calls (barrier):
    // probe after 30s idle, 3 probes 10s apart → ~60s to surface (the
    // kernel defaults of 2h idle would defeat the purpose)
    ::setsockopt(fd, SOL_SOCKET, SO_KEEPALIVE, &one, sizeof(one));
    int idle = 30, intvl = 10, cnt = 3;
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPIDLE, &idle, sizeof(idle));
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPINTVL, &intvl, sizeof(intvl));
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPCNT, &cnt, sizeof(cnt));
    return true;
  }

  // one fully-sent/received buffer under the call's absolute deadline;
  // 0 ok, -1000 peer reset/gone, -1001 deadline expired
  int64_t io_full(void* buf, size_t len, bool wr, int64_t deadline) {
    char* p = static_cast<char*>(buf);
    while (len > 0) {
      ssize_t r = wr ? ::send(fd, p, len, MSG_NOSIGNAL)
                     : ::recv(fd, p, len, 0);
      if (r > 0) {
        p += r;
        len -= static_cast<size_t>(r);
        continue;
      }
      if (r == 0) return -1000;  // orderly shutdown mid-frame
      if (errno == EINTR) continue;
      if (errno != EAGAIN && errno != EWOULDBLOCK) return -1000;
      int wait = -1;
      if (deadline) {
        int64_t rem = deadline - now_ms();
        if (rem <= 0) return -1001;
        wait = static_cast<int>(rem);
      }
      pollfd pfd{fd, static_cast<short>(wr ? POLLOUT : POLLIN), 0};
      int pr = ::poll(&pfd, 1, wait);
      if (pr < 0) {
        if (errno == EINTR) continue;
        return -1000;
      }
      if (pr == 0) return -1001;
      // POLLERR/POLLHUP: fall through — the next send/recv reports it
    }
    return 0;
  }

  // returns status; fills resp (resized). -1000 on transport failure
  // (peer reset/gone), -1001 on whole-call deadline expiry. Either way
  // the protocol stream is undefined afterwards — callers must
  // reconnect before reusing the handle. ``io_override``: per-call
  // deadline in ms (-1 = connection default, 0 = none).
  int64_t call(uint32_t cmd, uint32_t table_id, int64_t n, int32_t aux,
               const void* payload, uint64_t plen, std::vector<char>* resp,
               int io_override = -1) {
    const void* parts[1] = {payload};
    uint64_t lens[1] = {plen};
    return callv(cmd, table_id, n, aux, plen ? 1 : 0, parts, lens, resp,
                 io_override, 0, 0);
  }

  // scatter-gather call: the request payload is the concatenation of
  // `nparts` caller-owned buffers (numpy arrays on the Python side) —
  // nothing is re-materialized per call. Small frames coalesce into
  // sendbuf (one send); large frames stream each part directly.
  int64_t callv(uint32_t cmd, uint32_t table_id, int64_t n, int32_t aux,
                int32_t nparts, const void* const* parts,
                const uint64_t* lens, std::vector<char>* resp,
                int io_override = -1, uint64_t trace_id = 0,
                uint64_t span_id = 0) {
    std::lock_guard<std::mutex> g(mu);  // LOCK: mu
    if (fd < 0) return -1000;
    uint64_t plen = 0;
    for (int32_t i = 0; i < nparts; ++i) plen += lens[i];
    int ms = io_override >= 0 ? io_override : io_ms;
    int64_t deadline = ms > 0 ? now_ms() + ms : 0;
    ReqHeader h{plen, cmd, table_id, n, aux, trace_id, span_id};
    int64_t rc;
    if (sizeof(h) + plen <= kCoalesceMax) {
      uint64_t total = sizeof(h) + plen;
      if (sendbuf.size() < total) {
        uint64_t cap = sendbuf.empty() ? 4096 : sendbuf.size();
        while (cap < total) cap *= 2;
        sendbuf.resize(cap);
      }
      std::memcpy(sendbuf.data(), &h, sizeof(h));
      uint64_t off = sizeof(h);
      for (int32_t i = 0; i < nparts; ++i) {
        if (lens[i]) std::memcpy(sendbuf.data() + off, parts[i], lens[i]);
        off += lens[i];
      }
      if ((rc = io_full(sendbuf.data(), total, true, deadline)) != 0)
        return rc;
    } else {
      if ((rc = io_full(&h, sizeof(h), true, deadline)) != 0) return rc;
      for (int32_t i = 0; i < nparts; ++i) {
        if (lens[i] && (rc = io_full(const_cast<void*>(parts[i]), lens[i],
                                     true, deadline)) != 0)
          return rc;
      }
    }
    uint64_t rh[2];
    if ((rc = io_full(rh, sizeof(rh), false, deadline)) != 0) return rc;
    if (rh[0] > kMaxPayload) return -1000;
    resp->resize(rh[0]);
    if (rh[0] && (rc = io_full(resp->data(), rh[0], false, deadline)) != 0)
      return rc;
    return static_cast<int64_t>(rh[1]);
  }
};

thread_local std::vector<char> g_resp;

}  // namespace

extern "C" {

// ---- server ----
void* pss_create(const char* host, int port, int n_trainers) {
  PsServer* s = new PsServer();
  if (!s->start(host, port, n_trainers)) {
    delete s;
    return nullptr;
  }
  return s;
}
int pss_port(void* h) { return static_cast<PsServer*>(h)->port; }
int pss_stopped(void* h) {
  return static_cast<PsServer*>(h)->stopping.load() ? 1 : 0;
}
void pss_stop(void* h) { static_cast<PsServer*>(h)->stop(); }
void pss_destroy(void* h) {
  PsServer* s = static_cast<PsServer*>(h);
  s->stop();
  delete s;
}

// ---- server HA / replication / chaos ABI (ps/ha.py consumes) ----

void pss_set_replication(void* h, int enable, int64_t cap_entries) {
  PsServer* s = static_cast<PsServer*>(h);
  std::lock_guard<std::mutex> g(s->oplog_mu);
  s->repl_enabled.store(enable != 0);
  if (cap_entries > 0) s->oplog_cap = static_cast<size_t>(cap_entries);
  if (!enable) s->oplog.clear();
}

// Pop the next oplog entry into the staging buffer (SINGLE consumer:
// the one shipper thread). Returns its seq, -1 on timeout, -2 when the
// server is stopping and the ring is drained.
int64_t pss_oplog_next(void* h, int32_t timeout_ms) {
  PsServer* s = static_cast<PsServer*>(h);
  std::unique_lock<std::mutex> lk(s->oplog_mu);
  // system_clock wait_until, not wait_for: see the kBarrier comment
  // (pthread_cond_clockwait is invisible to gcc-10 TSAN)
  s->oplog_cv.wait_until(
      lk, std::chrono::system_clock::now() +
              std::chrono::milliseconds(timeout_ms), [&]() {
        return !s->oplog.empty() || s->stopping.load();
      });
  if (s->oplog.empty()) return s->stopping.load() ? -2 : -1;
  PsServer::OplogEntry e = std::move(s->oplog.front());
  s->oplog.pop_front();
  s->staged = std::move(e.frame);
  return e.seq;
}

uint64_t pss_staged_len(void* h) {
  return static_cast<PsServer*>(h)->staged.size();
}
const void* pss_staged_ptr(void* h) {
  PsServer* s = static_cast<PsServer*>(h);
  return s->staged.empty() ? nullptr : s->staged.data();
}

int64_t pss_oplog_seq(void* h) {
  PsServer* s = static_cast<PsServer*>(h);
  std::lock_guard<std::mutex> g(s->oplog_mu);
  return s->oplog_seq;
}
int64_t pss_oplog_pending(void* h) {
  PsServer* s = static_cast<PsServer*>(h);
  std::lock_guard<std::mutex> g(s->oplog_mu);
  return static_cast<int64_t>(s->oplog.size());
}
int64_t pss_oplog_dropped(void* h) {
  PsServer* s = static_cast<PsServer*>(h);
  std::lock_guard<std::mutex> g(s->oplog_mu);
  return s->oplog_dropped;
}

int64_t pss_catalog_count(void* h) {
  PsServer* s = static_cast<PsServer*>(h);
  std::lock_guard<std::mutex> g(s->oplog_mu);
  return static_cast<int64_t>(s->catalog.size());
}
// copy catalog frame i into buf when it fits in cap bytes; returns its
// length (-1: no such frame). Safe beside the shipper's pss_oplog_next.
int64_t pss_catalog_copy(void* h, int64_t i, void* buf, int64_t cap) {
  PsServer* s = static_cast<PsServer*>(h);
  std::lock_guard<std::mutex> g(s->oplog_mu);
  if (i < 0 || i >= static_cast<int64_t>(s->catalog.size())) return -1;
  const std::vector<char>& f = s->catalog[static_cast<size_t>(i)];
  int64_t n = static_cast<int64_t>(f.size());
  if (buf != nullptr && n <= cap && n > 0) std::memcpy(buf, f.data(), f.size());
  return n;
}

void pss_pause_mutations(void* h, int on) {
  static_cast<PsServer*>(h)->pause_mutations(on != 0);
}

int64_t pss_epoch(void* h) { return static_cast<PsServer*>(h)->epoch.load(); }
void pss_set_epoch(void* h, int64_t e) {
  static_cast<PsServer*>(h)->epoch.store(e);
}
int64_t pss_applied_seq(void* h) {
  return static_cast<PsServer*>(h)->applied_seq.load();
}

// ---- serving-plane attach mode (paddle_tpu/serving consumes) ----
void pss_set_read_only(void* h, int on) {
  static_cast<PsServer*>(h)->read_only.store(on != 0);
}
int pss_read_only(void* h) {
  return static_cast<PsServer*>(h)->read_only.load() ? 1 : 0;
}
int64_t pss_dense_version(void* h) {
  return static_cast<PsServer*>(h)->dense_version.load();
}

// arm a deterministic faultpoint: name in {kill-shard, drop-frame,
// close-socket, delay-ms}; cmd 0 = any command; fires once `after`
// matching requests have been seen (delay-ms stays armed, param = ms)
void pss_arm_fault(void* h, const char* name, uint32_t cmd, int64_t after,
                   int64_t param) {
  PsServer* s = static_cast<PsServer*>(h);
  std::lock_guard<std::mutex> g(s->fault_mu);
  PsServer::Fault f;
  f.cmd = cmd;
  f.after = after;
  f.param = param;
  s->faults[name] = f;
}

// ---- client ----
void* psc_connect2(const char* host, int port, int connect_ms, int io_ms) {
  PsConn* c = new PsConn();
  if (!c->connect_to(host, port, connect_ms, io_ms)) {
    delete c;
    return nullptr;
  }
  return c;
}
void* psc_connect(const char* host, int port) {
  return psc_connect2(host, port, 0, 0);  // legacy: blocking, no deadline
}
void psc_close(void* h) { delete static_cast<PsConn*>(h); }

// generic call: returns status; response payload stashed thread-locally,
// fetched via psc_resp_len / psc_resp_copy (avoids a resp-size handshake
// per command in the ctypes layer).
int64_t psc_call(void* h, uint32_t cmd, uint32_t table_id, int64_t n,
                 int32_t aux, const void* payload, uint64_t plen) {
  return static_cast<PsConn*>(h)->call(cmd, table_id, n, aux, payload, plen,
                                       &g_resp);
}
// per-call deadline variant: timeout_ms -1 = connection default, 0 = none
int64_t psc_call2(void* h, uint32_t cmd, uint32_t table_id, int64_t n,
                  int32_t aux, const void* payload, uint64_t plen,
                  int32_t timeout_ms) {
  return static_cast<PsConn*>(h)->call(cmd, table_id, n, aux, payload, plen,
                                       &g_resp, timeout_ms);
}
// scatter-gather variant: the payload is parts[0..nparts) concatenated
// (each a caller-owned buffer, e.g. a numpy array) — no client-side
// re-materialization of the frame
int64_t psc_callv(void* h, uint32_t cmd, uint32_t table_id, int64_t n,
                  int32_t aux, int32_t nparts, const void* const* parts,
                  const uint64_t* lens, int32_t timeout_ms) {
  return static_cast<PsConn*>(h)->callv(cmd, table_id, n, aux, nparts, parts,
                                        lens, &g_resp, timeout_ms);
}
// trace-context variant (paddle_tpu/obs): stamps the caller's sampled
// span into the frame header's fixed context field; (0, 0) = untraced
int64_t psc_callv2(void* h, uint32_t cmd, uint32_t table_id, int64_t n,
                   int32_t aux, int32_t nparts, const void* const* parts,
                   const uint64_t* lens, int32_t timeout_ms,
                   uint64_t trace_id, uint64_t span_id) {
  return static_cast<PsConn*>(h)->callv(cmd, table_id, n, aux, nparts, parts,
                                        lens, &g_resp, timeout_ms, trace_id,
                                        span_id);
}
uint64_t psc_resp_len(void*) { return g_resp.size(); }
void psc_resp_copy(void*, void* out) {
  if (!g_resp.empty()) std::memcpy(out, g_resp.data(), g_resp.size());
}
// zero-copy view of the calling thread's last response: valid until
// that thread's next psc_call*/psc_close — callers must consume (or
// copy out) before issuing another call on the same thread
const void* psc_resp_ptr(void*) {
  return g_resp.empty() ? nullptr : g_resp.data();
}

}  // extern "C"
