// hot_kernels: the persistent hot tier's probe, probe+gather and
// scatter+apply on Hopper (sm_90a), plus the deterministic merge of the
// pass cache.
//
// Replaces the Pallas kernels of paddle_tpu/ops/hot_kernels.py:
//
// - hot_probe_gather (kern + _probe_body): the bucketized linear probe of
//   the dynamic key map fused with the gather of embed_w ++ embedx_w.
//   The TPU grid is key-block x bank and merges the bank results by
//   revisiting the output block in grid order. Hopper has no sequential
//   grid, and needs none: one thread per key computes its own bank and
//   probe window (the dynamic_probe_buckets hash in native uint32
//   arithmetic) and probes only that bank's region, which is the same
//   answer. Tie rules as in the reference: inside a bucket the MAX row
//   among matching slots with row >= 0; the FIRST bucket with a hit wins.
//   Bound: HBM bytes, random 32-B sectors (~276 B per key: the key, two
//   buckets x three arrays, the row, and the outputs) - about 8.8 us for
//   106,496 keys at 3.35 TB/s. A thread reads 8 slots of one bucket
//   from one 32-B sector per array, so the probe is sector-efficient.
//
// - hot_probe: the same probe without the gather (rows only), the local
//   half of the sharded tier's step: each shard resolves its batch slice
//   against the replicated map and the rows, not the values, cross to the
//   owner shard. One thread per key through the same probe function as
//   hot_probe_gather (probe_row), so the two cannot drift apart. Integer
//   work only: bitwise equal to dynamic_map_lookup. Bound: HBM bytes, the
//   key, the probed bucket sectors and the row out (~108 B per key).
//
// - hot_scatter_apply (merge_sparse_grads + kern): the push, in two
//   parts. (1) A stable LSD radix sort of the rows (radix_sort_launch;
//   it stands where jnp.unique stands in front of the Pallas kernel): in
//   bounded mode the key is the row, with every row outside [0, C) made
//   C, on bit_length(C) bits (20 at C = 2^19: 3 passes of 8 bits); the
//   first pass reads the int32 or int64 rows directly. (2) The segment
//   walk (segment_walk_kernel): each run of equal sorted rows is summed
//   in occurrence order from 0.0f (show, click and the 1+dim grads; the
//   JAX package's segment_sum order, bit for bit) by a thread, a warp or
//   the block by its length, and one thread applies the shared CTR rule
//   (ctr_rule.cuh) to its row in place. Every row belongs to one segment,
//   so no two threads touch one row: no atomics, and the result does not
//   change from run to run. The dropped segment (C) is not walked.
//   Bound: HBM bytes, ~15.7 MB at n = 106,496 (~4.7 us). What bounds it
//   here is not that: the tier keeps one array per column, so a touched
//   row costs seven random 32-byte sectors read and written (~39 MB for
//   ~87k rows, ~12 us at 3.35 TB/s), each entry's show, click and grad
//   row three to four more; and the sort's four kernels wait on each
//   other (hot_scatter_probe.py splits the time).
//
// - segment_merge: the same walk writing the merged sums and the sorted
//   unique rows (padded with the sentinel C) instead of applying them:
//   merge_sparse_grads of the pass cache, deterministic on the card. Its
//   sort runs in full mode (32-bit keys: the int32 row with its sign bit
//   flipped, 4 passes), because the merge keeps rows outside [0, C).
//
// Each entry returns its launches' CUDA error (0 if none); the Python
// wrapper raises if it is not 0. The kernels launch on the caller's stream
// and allocate nothing.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "ctr_rule.cuh"

namespace {

using ctr_rule::RowParams;

// the JAX package's bank-hash seed (device_hash._BANK_SEED), never rotated
constexpr uint32_t kBankSeed = 0x243F6A88u;
// widest embedx a merging thread keeps in its local sum buffer
constexpr int kMaxDim = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t hi, uint32_t lo,
                                          uint32_t seed) {
  uint32_t h = seed ^ hi;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h ^= lo;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The probe of one key: its bank's region (a fixed-seed hash, as the host
// mirror's bank_of), then probe_buckets buckets of that region from the
// seeded start, wrapping inside the region. Inside a bucket the MAX row
// among matching slots with row >= 0 wins; the FIRST bucket with a hit
// wins. -1 = missing.
__device__ __forceinline__ int32_t probe_row(
    const int32_t* __restrict__ map_hi, const int32_t* __restrict__ map_lo,
    const int32_t* __restrict__ map_row, uint32_t seed, uint32_t hi,
    uint32_t lo, int64_t nbuckets, int bslots, int probe_buckets, int banks) {
  const uint32_t nbpb = static_cast<uint32_t>(nbuckets / banks);  // pow2
  const uint32_t local_mask = nbpb - 1u;
  uint32_t base = 0u;
  if (banks > 1)
    base = (mix32(hi, lo, kBankSeed) & static_cast<uint32_t>(banks - 1)) * nbpb;
  const uint32_t b0 = mix32(hi, lo, seed) & local_mask;

  int32_t found = -1;
  for (int t = 0; t < probe_buckets && found < 0; ++t) {
    const int64_t b = static_cast<int64_t>(base + ((b0 + t) & local_mask));
    const int64_t s0 = b * bslots;
    int32_t hit = -1;
    for (int l = 0; l < bslots; ++l) {
      const int32_t r = map_row[s0 + l];
      if (r >= 0 && static_cast<uint32_t>(map_hi[s0 + l]) == hi &&
          static_cast<uint32_t>(map_lo[s0 + l]) == lo)
        hit = r > hit ? r : hit;
    }
    found = hit;
  }
  return found;
}

__global__ void hot_probe_gather_kernel(
    const int32_t* __restrict__ map_hi, const int32_t* __restrict__ map_lo,
    const int32_t* __restrict__ map_row, const int32_t* __restrict__ seed_p,
    const int32_t* __restrict__ keys_hi, const int32_t* __restrict__ keys_lo,
    const float* __restrict__ embed_w, const float* __restrict__ embedx_w,
    int32_t* __restrict__ o_rows, float* __restrict__ o_pull, int64_t n,
    int64_t nbuckets, int bslots, int probe_buckets, int banks, int64_t C,
    int dim) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t found = probe_row(
      map_hi, map_lo, map_row, static_cast<uint32_t>(*seed_p),
      static_cast<uint32_t>(keys_hi[i]), static_cast<uint32_t>(keys_lo[i]),
      nbuckets, bslots, probe_buckets, banks);
  o_rows[i] = found;

  float* out = o_pull + i * (1 + dim);
  if (found >= 0) {
    const int64_t r = found < C ? found : C - 1;
    out[0] = embed_w[r];
    const float* x = embedx_w + r * dim;
    for (int d = 0; d < dim; ++d) out[1 + d] = x[d];
  } else {
    for (int d = 0; d <= dim; ++d) out[d] = 0.0f;
  }
}

__global__ void hot_probe_kernel(
    const int32_t* __restrict__ map_hi, const int32_t* __restrict__ map_lo,
    const int32_t* __restrict__ map_row, const int32_t* __restrict__ seed_p,
    const int32_t* __restrict__ keys_hi, const int32_t* __restrict__ keys_lo,
    int32_t* __restrict__ o_rows, int64_t n, int64_t nbuckets, int bslots,
    int probe_buckets, int banks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  o_rows[i] = probe_row(
      map_hi, map_lo, map_row, static_cast<uint32_t>(*seed_p),
      static_cast<uint32_t>(keys_hi[i]), static_cast<uint32_t>(keys_lo[i]),
      nbuckets, bslots, probe_buckets, banks);
}

// -- the stable radix sort of the rows ---------------------------------------
//
// A least-significant-digit radix sort of uint32 keys with int32 values
// (the positions 0..n-1), 8-bit digits, 2048-key tiles. Each pass ranks
// a tile's keys stably inside the block (a warp's lanes in order, the
// warps in order, the digits in order) and scatters each key to
// (exclusive prefix of its digit over the whole [digit x tile] count
// matrix) + (its rank among the tile's keys of that digit), so equal
// keys keep their input order: the permutation is torch.sort's
// (stable=True). No look-back: one count kernel writes pass 0's
// [tile x digit] counts, every scatter kernel scans the whole matrix of
// its pass in its prologue (52 x 256 counts at n = 106,496) and adds the
// next pass's counts by destination tile with integer atomics, which
// commute, so the result is the same on every run.
//
// Bound: the bytes are nothing (12 B a key in and out: ~0.4 us at n =
// 106,496); each pass is a chain of dependent steps in 52 blocks (load,
// scan, rank, exchange, scatter), so the time is latency: the passes are
// launched chained (pdl_acquire) and the tile is sized for the most blocks
// whose prologue stays short (hot_scatter_probe.py times 1024 and 4096).

constexpr int kSortTile = 2048;           // keys a block ranks
constexpr int kSortThreads = 512;         // 4 keys a thread
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortKeysPerThread = kSortTile / kSortThreads;
constexpr int kRadixBits = 8;
constexpr int kRadixBins = 1 << kRadixBits;
constexpr uint32_t kFull = 0xFFFFFFFFu;

static_assert(kSortWarps * kRadixBins >= 2 * kSortTile,
              "the warp counts are reused as the tile's key and value buffers");

// What the first pass reads: int32 or int64 rows, turned into keys on
// the fly (no separate cast kernel). Full mode: the int32 value with its
// sign bit flipped. Bounded mode: the row, or `bound` for a row outside
// [0, bound).
struct SortInput {
  const void* rows;
  int rows64;
  int full;
  uint32_t bound;
};

__device__ __forceinline__ uint32_t sort_key(const SortInput& in, int64_t i) {
  const int64_t r = in.rows64 ? static_cast<const int64_t*>(in.rows)[i]
                              : static_cast<const int32_t*>(in.rows)[i];
  if (in.full) return static_cast<uint32_t>(static_cast<int32_t>(r)) ^ 0x80000000u;
  return (r >= 0 && r < static_cast<int64_t>(in.bound)) ? static_cast<uint32_t>(r)
                                                        : in.bound;
}

__device__ __forceinline__ uint32_t lanemask_lt() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Programmatic dependent launch (sm_90): the sort's kernels and the walk
// each wait on the kernel before them, and each call of a launch is ~2.7
// us of a card otherwise idle. Launched with launch_chained, a kernel's
// blocks start while the one before it runs (the next kernel may launch
// as soon as this one has started: pdl_release) and wait in pdl_acquire
// until it has finished and its writes are visible. A kernel calls
// pdl_acquire before it reads anything the kernels before it wrote; a
// kernel launched without the attribute returns from it at once.
__device__ __forceinline__ void pdl_release() {
  asm volatile("griddepcontrol.launch_dependents;");
}

__device__ __forceinline__ void pdl_acquire() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Exclusive prefix sum over the 256 digits held by threads 0..255 (the
// others pass 0 and get 0). Every thread of the block must call it;
// `scratch` holds 8 words.
__device__ __forceinline__ uint32_t digit_exclusive_scan(uint32_t v,
                                                         uint32_t* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31 && w < kRadixBins / 32) scratch[w] = inc;
  __syncthreads();
  uint32_t before = 0;
  if (tid < kRadixBins)
    for (int i = 0; i < w; ++i) before += scratch[i];
  return tid < kRadixBins ? before + inc - v : 0u;
}

// Pass 0's counts: counts[t][d] = keys of tile t with low digit d. Also
// zeroes this tile's rows of the later passes' matrices, which the
// scatter kernels fill with atomics. Each warp counts into its own
// histogram (shared atomics; a heavy row contends only inside a warp).
__global__ void __launch_bounds__(kSortThreads) radix_count_kernel(
    SortInput in, int64_t n, uint32_t* __restrict__ counts, int tiles,
    int passes) {
  __shared__ uint32_t hist[kSortWarps][kRadixBins];
  const int tid = threadIdx.x, w = tid >> 5;
  const int t = blockIdx.x;
  pdl_release();
  pdl_acquire();
  // every key's load in flight before the first waits
  const int64_t base = static_cast<int64_t>(t) * kSortTile;
  uint32_t digit[kSortKeysPerThread];
#pragma unroll
  for (int k = 0; k < kSortKeysPerThread; ++k) {
    const int64_t i = base + k * kSortThreads + tid;
    digit[k] = i < n ? (sort_key(in, i) & (kRadixBins - 1)) : kRadixBins;
  }
  for (int i = tid; i < kSortWarps * kRadixBins; i += kSortThreads) (&hist[0][0])[i] = 0;
  for (int p = 1; p < passes; ++p)
    for (int d = tid; d < kRadixBins; d += kSortThreads)
      counts[(static_cast<int64_t>(p) * tiles + t) * kRadixBins + d] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSortKeysPerThread; ++k)
    if (digit[k] < kRadixBins) atomicAdd(&hist[w][digit[k]], 1u);
  __syncthreads();
  for (int d = tid; d < kRadixBins; d += kSortThreads) {
    uint32_t c = 0;
#pragma unroll
    for (int u = 0; u < kSortWarps; ++u) c += hist[u][d];
    counts[static_cast<int64_t>(t) * kRadixBins + d] = c;
  }
}

// One pass: rank tile blockIdx.x's keys stably by digit `pass`, scatter
// them, and count the next pass's digits by destination tile. The last
// pass writes the caller's sorted rows and permutation (int32 or int64).
__global__ void __launch_bounds__(kSortThreads) radix_scatter_kernel(
    SortInput in, const uint32_t* __restrict__ keys_in,
    const int32_t* __restrict__ vals_in, uint32_t* __restrict__ keys_out,
    int32_t* __restrict__ vals_out, void* __restrict__ out_rows,
    void* __restrict__ out_perm, int out64, int64_t n,
    uint32_t* __restrict__ counts, int tiles, int pass, int passes) {
  // warp digit counts, then (after the ranks are taken) the tile's keys
  // and values in sorted order
  __shared__ uint32_t s_warp[kSortWarps][kRadixBins];
  __shared__ uint32_t s_dest[kRadixBins];   // global start of (digit, tile)
  __shared__ uint32_t s_start[kRadixBins];  // tile-local start of each digit
  __shared__ uint32_t s_scan[2][kRadixBins / 32];
  uint32_t* s_keys = &s_warp[0][0];
  int32_t* s_vals = reinterpret_cast<int32_t*>(s_keys + kSortTile);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int t = blockIdx.x;
  const int shift = pass * kRadixBits;
  const bool first = pass == 0, last = pass == passes - 1;
  const int64_t base = static_cast<int64_t>(t) * kSortTile;
  pdl_release();
  pdl_acquire();

  // the warp's 256 consecutive keys, 32 a round: every load in flight
  // before anything waits on one
  uint32_t key[kSortKeysPerThread], digit[kSortKeysPerThread];
  uint32_t rank[kSortKeysPerThread];
  int32_t val[kSortKeysPerThread];
#pragma unroll
  for (int j = 0; j < kSortKeysPerThread; ++j) {
    const int64_t i = base + w * (kSortTile / kSortWarps) + j * 32 + lane;
    key[j] = 0;
    val[j] = 0;
    if (i < n) {
      key[j] = first ? sort_key(in, i) : keys_in[i];
      val[j] = first ? static_cast<int32_t>(i) : vals_in[i];
    }
  }

  for (int i = tid; i < kSortWarps * kRadixBins; i += kSortThreads)
    (&s_warp[0][0])[i] = 0;

  // where each digit of this tile starts in the output: all keys of the
  // smaller digits, then this digit's keys of the earlier tiles
  uint32_t total = 0, before = 0;
  if (tid < kRadixBins) {
    const uint32_t* c = counts + static_cast<int64_t>(pass) * tiles * kRadixBins + tid;
#pragma unroll 8
    for (int u = 0; u < tiles; ++u) {
      const uint32_t x = c[static_cast<int64_t>(u) * kRadixBins];
      total += x;
      before += u < t ? x : 0u;
    }
  }
  const uint32_t digit_base = digit_exclusive_scan(total, s_scan[0]);
  if (tid < kRadixBins) s_dest[tid] = digit_base + before;

  // stable rank inside the warp's keys; warp-private digit counts
  // (s_warp) carry over from round to round
#pragma unroll
  for (int j = 0; j < kSortKeysPerThread; ++j) {
    const int64_t i = base + w * (kSortTile / kSortWarps) + j * 32 + lane;
    const bool valid = i < n;
    digit[j] = valid ? (key[j] >> shift) & (kRadixBins - 1) : kRadixBins;
    const uint32_t peers = __match_any_sync(kFull, digit[j]);
    const int leader = __ffs(peers) - 1;
    uint32_t b = 0;
    if (valid && lane == leader) {
      b = s_warp[w][digit[j]];
      s_warp[w][digit[j]] = b + __popc(peers);
    }
    rank[j] = __shfl_sync(kFull, b, leader) + __popc(peers & lanemask_lt());
    __syncwarp();
  }
  __syncthreads();

  // each digit: its warps' exclusive prefix, and its tile-local start
  uint32_t tile_count = 0;
  if (tid < kRadixBins) {
    for (int u = 0; u < kSortWarps; ++u) {
      const uint32_t x = s_warp[u][tid];
      s_warp[u][tid] = tile_count;
      tile_count += x;
    }
  }
  const uint32_t tile_start = digit_exclusive_scan(tile_count, s_scan[1]);
  if (tid < kRadixBins) s_start[tid] = tile_start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortKeysPerThread; ++j)
    if (digit[j] < kRadixBins) rank[j] += s_start[digit[j]] + s_warp[w][digit[j]];
  __syncthreads();  // s_warp becomes the key and value buffer
#pragma unroll
  for (int j = 0; j < kSortKeysPerThread; ++j) {
    if (digit[j] < kRadixBins) {
      s_keys[rank[j]] = key[j];
      s_vals[rank[j]] = val[j];
    }
  }
  __syncthreads();

  // write in the tile's sorted order: neighbouring threads write
  // neighbouring addresses inside a digit's run
  const int64_t tile_len = n - base < kSortTile ? n - base : kSortTile;
#pragma unroll
  for (int k = 0; k < kSortKeysPerThread; ++k) {
    const int li = k * kSortThreads + tid;
    const bool valid = li < tile_len;
    const uint32_t kk = valid ? s_keys[li] : 0u;
    const int32_t vv = valid ? s_vals[li] : 0;
    const uint32_t d = (kk >> shift) & (kRadixBins - 1);
    const int64_t dest = valid ? static_cast<int64_t>(s_dest[d]) + li - s_start[d] : 0;
    if (last) {
      if (valid) {
        const int32_t row = in.full ? static_cast<int32_t>(kk ^ 0x80000000u)
                                    : static_cast<int32_t>(kk);
        if (out64) {
          static_cast<int64_t*>(out_rows)[dest] = row;
          static_cast<int64_t*>(out_perm)[dest] = vv;
        } else {
          static_cast<int32_t*>(out_rows)[dest] = row;
          static_cast<int32_t*>(out_perm)[dest] = vv;
        }
      }
    } else {
      if (valid) {
        keys_out[dest] = kk;
        vals_out[dest] = vv;
      }
      // the next pass's counts by destination tile, one atomic per
      // distinct (tile, digit) of the warp
      const uint32_t tag = valid ? static_cast<uint32_t>(dest / kSortTile) << kRadixBits |
                                       ((kk >> (shift + kRadixBits)) & (kRadixBins - 1))
                                 : kFull;
      const uint32_t peers = __match_any_sync(kFull, tag);
      if (valid && lane == __ffs(peers) - 1)
        atomicAdd(&counts[(static_cast<int64_t>(pass + 1) * tiles + (tag >> kRadixBits)) *
                              kRadixBins + (tag & (kRadixBins - 1))],
                  __popc(peers));
    }
  }
}

// -- the segment walk, shared by hot_scatter_apply and segment_merge --------
//
// One block per 256 sorted positions. A segment (a run of equal sorted
// rows) belongs to the block whose tile holds its first position. The
// block loads its keys and a 32-key halo into shared memory and marks
// the segment starts with one ballot per warp; each start's end is the
// next marked position, found with find-first-set over those words, so
// the walk knows every segment's [start, end) before it loads an entry
// and issues a segment's perm and row loads ahead of its adds.
//
// - A segment shorter than 32 (nearly all of them: the hot path's batch
//   has ~87k distinct rows in 106,496 entries) is summed by the thread
//   of its first position, four entries' loads in flight at a time.
// - A longer one (its end past the halo is found by a warp's search,
//   32 probes a step) goes to a warp when shorter than kWalkBlockMin,
//   else to the whole block. Either stages perm and the entries'
//   columns through shared memory in chunks, and each lane (thread) owns
//   one column (show, click, the 1+dim grads: 11 at dim 8) and sums it
//   sequentially over the chunk.
//
// Every column is summed with __fadd_rn from 0.0f in sorted order, which
// is occurrence order: the JAX package's segment_sum order, bit for bit,
// whichever path a segment takes. One thread then applies the rule to
// the row (B4) or writes the merged sums (the merge). No two threads
// touch one row, so there are no atomics and every run gives the same
// bits. B4 walks no dropped segment (rows < 0 or >= C, which the sort
// maps to the sentinel C).
//
// DIM >= 0 instantiates a fixed embedx width (8: every CTR configuration
// the port runs), so the sum buffer lives in registers; DIM = -1 takes
// the width at run time (up to kMaxDim, its buffer in local memory).

constexpr int kWalkTile = 256;                   // sorted positions a block owns
constexpr int kWalkThreads = kWalkTile;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kHalo = 32;                        // = the thread/warp threshold
// segments at least this long go to the block (hot_scatter_probe.py times
// 64, 128, 512 and warps only on the heavy-hitter batch)
constexpr int kWalkBlockMin = 256;
constexpr int kMaskWords = (kWalkTile + kHalo) / 32;
constexpr int kStageFloats = kWalkThreads * 12;  // staged columns, all warps
constexpr int kWarpStage = kStageFloats / kWalkWarps;
constexpr int kMaxLong = kWalkTile / kHalo;      // segments >= 32 starting in a tile
constexpr int kThreadUnroll = 4;

static_assert(kMaxLong <= kWalkWarps, "one warp per long segment of a tile");

struct WalkArgs {
  const int32_t* skeys;  // sorted rows
  const int32_t* perm;   // their positions in the batch
  const float* shows;
  const float* clicks;
  const float* grads;    // [n, width]
  int64_t n;
  int width;             // 1 + dim
  // hot_scatter_apply: the tier's columns, updated in place
  float *show, *click, *ew, *estate, *xw, *xstate, *has;
  int64_t C;
  RowParams p;
  // segment_merge: the segment starts of each walk tile, the outputs and
  // the value that pads uniq past the last segment
  const int32_t* tile_starts;
  void* o_uniq;
  int uniq64;
  int64_t capacity;
  float *o_show, *o_click, *o_g;
};

template <int DIM>
struct Width {
  static constexpr bool kFixed = DIM >= 0;
  static constexpr int kG = kFixed ? 1 + DIM : 1 + kMaxDim;  // sum buffer
  static constexpr int kAcc = (2 + kG + 31) / 32;           // columns a lane owns
  __device__ static int width(const WalkArgs& a) { return kFixed ? 1 + DIM : a.width; }
};

// Column c of batch entry k: show, click, then the grads.
__device__ __forceinline__ float entry_col(const WalkArgs& a, int64_t k, int c,
                                           int width) {
  return c == 0 ? a.shows[k] : c == 1 ? a.clicks[k] : a.grads[k * width + (c - 2)];
}

// The row's merged deltas are done: apply the rule (B4) to row r.
template <int DIM>
__device__ __forceinline__ void apply_row(const WalkArgs& a, int64_t r, float ds,
                                          float dc, const float* g) {
  const int64_t es = a.p.es, xs = a.p.xs;
  const int64_t dim = Width<DIM>::kFixed ? DIM : a.p.dim;
  ctr_rule::ctr_row_update<DIM>(
      a.show[r], a.click[r], a.ew + r, a.estate + r * es, a.xw + r * dim,
      a.xstate + r * xs, a.has[r], ds, dc, g, g + 1, a.show + r, a.click + r,
      a.ew + r, a.estate + r * es, a.xw + r * dim, a.xstate + r * xs,
      a.has + r, a.p);
}

__device__ __forceinline__ void write_uniq(const WalkArgs& a, int64_t o, int64_t r) {
  if (a.uniq64)
    static_cast<int64_t*>(a.o_uniq)[o] = r;
  else
    static_cast<int32_t*>(a.o_uniq)[o] = static_cast<int32_t>(r);
}

// A short segment [s, e), summed by one thread. o: the merge's output
// slot (the segment's ordinal).
template <int DIM, bool APPLY>
__device__ __forceinline__ void thread_segment(const WalkArgs& a, int64_t s,
                                               int64_t e, int32_t r, int64_t o) {
  using Wd = Width<DIM>;
  const int width = Wd::width(a);
  float ds = 0.0f, dc = 0.0f, g[Wd::kG];
#pragma unroll
  for (int c = 0; c < Wd::kG; ++c) g[c] = 0.0f;
  if constexpr (Wd::kFixed) {
    for (int64_t j0 = s; j0 < e; j0 += kThreadUnroll) {
      int64_t k[kThreadUnroll];
      float vs[kThreadUnroll], vc[kThreadUnroll], vg[kThreadUnroll][Wd::kG];
#pragma unroll
      for (int u = 0; u < kThreadUnroll; ++u) k[u] = j0 + u < e ? a.perm[j0 + u] : -1;
#pragma unroll
      for (int u = 0; u < kThreadUnroll; ++u) {
        if (k[u] >= 0) {
          vs[u] = a.shows[k[u]];
          vc[u] = a.clicks[k[u]];
#pragma unroll
          for (int c = 0; c < Wd::kG; ++c) vg[u][c] = a.grads[k[u] * Wd::kG + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kThreadUnroll; ++u) {
        if (k[u] >= 0) {
          ds = __fadd_rn(ds, vs[u]);
          dc = __fadd_rn(dc, vc[u]);
#pragma unroll
          for (int c = 0; c < Wd::kG; ++c) g[c] = __fadd_rn(g[c], vg[u][c]);
        }
      }
    }
  } else {
    for (int64_t j = s; j < e; ++j) {
      const int64_t k = a.perm[j];
      ds = __fadd_rn(ds, a.shows[k]);
      dc = __fadd_rn(dc, a.clicks[k]);
      const float* gk = a.grads + k * width;
      for (int c = 0; c < width; ++c) g[c] = __fadd_rn(g[c], gk[c]);
    }
  }
  if constexpr (APPLY) {
    apply_row<DIM>(a, r, ds, dc, g);
  } else {
    write_uniq(a, o, r);
    a.o_show[o] = ds;
    a.o_click[o] = dc;
    for (int c = 0; c < width; ++c) a.o_g[o * width + c] = g[c];
  }
}

// The column sums of a long segment are in `sums` (shared memory, one
// per column, written by their owners and made visible by the caller's
// barrier): one thread finishes the row.
template <int DIM, bool APPLY>
__device__ __forceinline__ void finish_long(const WalkArgs& a, int64_t o, int32_t r,
                                            const float* sums) {
  using Wd = Width<DIM>;
  const int width = Wd::width(a);
  if constexpr (APPLY) {
    float g[Wd::kG];
#pragma unroll
    for (int c = 0; c < Wd::kG; ++c) g[c] = c < width ? sums[2 + c] : 0.0f;
    apply_row<DIM>(a, r, sums[0], sums[1], g);
  } else {
    write_uniq(a, o, r);
    a.o_show[o] = sums[0];
    a.o_click[o] = sums[1];
    for (int c = 0; c < width; ++c) a.o_g[o * width + c] = sums[2 + c];
  }
}

// A long segment [s, e) summed by one warp: chunks of up to 32 entries,
// each lane loading one entry's columns into the warp's stage, then each
// lane summing the columns it owns over the chunk, in order.
template <int DIM, bool APPLY>
__device__ void warp_segment(const WalkArgs& a, int64_t s, int64_t e, int32_t r,
                             int64_t o, float* stage, int lane) {
  using Wd = Width<DIM>;
  const int width = Wd::width(a), cols = 2 + width;
  const int per = kWarpStage / cols < 32 ? kWarpStage / cols : 32;
  float acc[Wd::kAcc];
#pragma unroll
  for (int t = 0; t < Wd::kAcc; ++t) acc[t] = 0.0f;
  for (int64_t j0 = s; j0 < e; j0 += per) {
    const int cnt = e - j0 < per ? static_cast<int>(e - j0) : per;
    if (lane < cnt) {
      const int64_t k = a.perm[j0 + lane];
      for (int c = 0; c < cols; ++c) stage[lane * cols + c] = entry_col(a, k, c, width);
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < Wd::kAcc; ++t) {
      const int c = lane + 32 * t;
      if (c < cols)
        for (int q = 0; q < cnt; ++q) acc[t] = __fadd_rn(acc[t], stage[q * cols + c]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int t = 0; t < Wd::kAcc; ++t)
    if (lane + 32 * t < cols) stage[lane + 32 * t] = acc[t];
  __syncwarp();
  if (lane == 0) finish_long<DIM, APPLY>(a, o, r, stage);
  __syncwarp();
}

// A long segment [s, e) summed by the block: chunks of up to 256
// entries, one entry a thread, then thread c sums column c.
template <int DIM, bool APPLY>
__device__ void block_segment(const WalkArgs& a, int64_t s, int64_t e, int32_t r,
                              int64_t o, float* stage, int tid) {
  using Wd = Width<DIM>;
  const int width = Wd::width(a), cols = 2 + width;
  const int per = kStageFloats / cols < kWalkThreads ? kStageFloats / cols : kWalkThreads;
  float acc = 0.0f;
  for (int64_t j0 = s; j0 < e; j0 += per) {
    const int cnt = e - j0 < per ? static_cast<int>(e - j0) : per;
    if (tid < cnt) {
      const int64_t k = a.perm[j0 + tid];
      for (int c = 0; c < cols; ++c) stage[tid * cols + c] = entry_col(a, k, c, width);
    }
    __syncthreads();
    if (tid < cols)
      for (int q = 0; q < cnt; ++q) acc = __fadd_rn(acc, stage[q * cols + tid]);
    __syncthreads();
  }
  if (tid < cols) stage[tid] = acc;
  __syncthreads();
  if (tid == 0) finish_long<DIM, APPLY>(a, o, r, stage);
  __syncthreads();
}

// The end of the segment of row r known to hold every position < lo: the
// first position in [lo, hi] whose row differs (hi = n). A warp probes 32
// positions a step, first at lo + 2^lane - 1 (a gallop), then evenly; the
// probes inside the segment form a prefix because the rows are sorted.
__device__ int64_t find_end(const int32_t* skeys, int64_t lo, int64_t hi, int32_t r,
                            int lane) {
  bool gallop = true;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = gallop ? lo + ((int64_t{1} << lane) - 1) : lo + lane * step;
    const bool probed = p < hi;
    const bool in = probed && skeys[p] == r;
    const int c = __popc(__ballot_sync(kFull, in));
    const int probes = __popc(__ballot_sync(kFull, probed));
    const int64_t last_in = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    const int64_t first_out = __shfl_sync(kFull, p, c < 32 ? c : 31);
    if (c > 0) lo = last_in + 1;
    if (c < probes) hi = first_out;
    gallop = false;
  }
  return lo;
}

// The merge's segment ordinals: how many segments start in each walk
// tile (the walk adds up the tiles before its own).
__global__ void __launch_bounds__(kWalkThreads) segment_count_kernel(
    const int32_t* __restrict__ skeys, int64_t n, int32_t* __restrict__ tile_starts) {
  pdl_release();
  pdl_acquire();
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kWalkTile + threadIdx.x;
  const bool start = q < n && (q == 0 || skeys[q - 1] != skeys[q]);
  const int c = __syncthreads_count(start);
  if (threadIdx.x == 0) tile_starts[blockIdx.x] = c;
}

template <int DIM, bool APPLY>
__global__ void __launch_bounds__(kWalkThreads) segment_walk_kernel(WalkArgs a) {
  __shared__ int32_t s_key[kWalkTile + kHalo + 1];  // positions ts-1 ...
  __shared__ uint32_t s_mask[kMaskWords];           // segment starts
  __shared__ int64_t s_long_s[kMaxLong], s_long_e[kMaxLong], s_long_o[kMaxLong];
  __shared__ int s_long_block[kMaxLong];
  __shared__ int s_nlong;
  __shared__ int64_t s_part[2][kWalkWarps];
  __shared__ float s_stage[kStageFloats];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t n = a.n;
  const int64_t ts = static_cast<int64_t>(blockIdx.x) * kWalkTile;
  if (tid == 0) s_nlong = 0;
  pdl_release();
  pdl_acquire();
  for (int i = tid; i < kWalkTile + kHalo + 1; i += kWalkThreads) {
    const int64_t q = ts - 1 + i;
    s_key[i] = (q >= 0 && q < n) ? a.skeys[q] : 0;
  }
  // the merge: segments that start before this tile, and in all
  int64_t obase = 0, total = 0;
  if constexpr (!APPLY) {
    const int64_t tiles = (n + kWalkTile - 1) / kWalkTile;
    for (int64_t u = tid; u < tiles; u += kWalkThreads) {
      const int64_t x = a.tile_starts[u];
      total += x;
      obase += u < blockIdx.x ? x : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_down_sync(kFull, total, off);
      obase += __shfl_down_sync(kFull, obase, off);
    }
    if (lane == 0) {
      s_part[0][w] = obase;
      s_part[1][w] = total;
    }
  }
  __syncthreads();
  if constexpr (!APPLY) {
    obase = total = 0;
    for (int u = 0; u < kWalkWarps; ++u) {
      obase += s_part[0][u];
      total += s_part[1][u];
    }
  }
  // start flags of positions ts .. ts+287; every position >= n is flagged
  // so that the last segment ends at n
  for (int i = tid; i < kWalkTile + kHalo; i += kWalkThreads) {
    const int64_t q = ts + i;
    const bool start = q >= n || q == 0 || s_key[i] != s_key[i + 1];
    const uint32_t m = __ballot_sync(kFull, start);
    if (lane == 0) s_mask[i >> 5] = m;
  }
  __syncthreads();

  const int64_t s = ts + tid;
  if (s < n && ((s_mask[tid >> 5] >> lane) & 1u)) {
    const int32_t r = s_key[tid + 1];
    if (!(APPLY && (r < 0 || r >= a.C))) {
      int64_t o = 0;  // the merge's output slot: starts before this one
      if constexpr (!APPLY) {
        o = obase + __popc(s_mask[tid >> 5] & ((1u << lane) - 1u));
        for (int b = 0; b < (tid >> 5); ++b) o += __popc(s_mask[b]);
      }
      int b = tid >> 5;
      uint32_t m = s_mask[b] & ~((2u << lane) - 1u);  // starts after this one
      while (m == 0u && ++b < kMaskWords) m = s_mask[b];
      const int64_t e = m ? ts + b * 32 + __ffs(m) - 1 : -1;  // -1: past the halo
      if (e >= 0 && e - s < kHalo) {
        thread_segment<DIM, APPLY>(a, s, e, r, o);
      } else {
        const int slot = atomicAdd(&s_nlong, 1);
        s_long_s[slot] = s;
        s_long_e[slot] = e;
        s_long_o[slot] = o;
      }
    }
  }
  if constexpr (!APPLY) {  // pad the outputs past the last segment
    const int64_t p = ts + tid;
    if (p < n && p >= total) {
      write_uniq(a, p, a.capacity);
      a.o_show[p] = 0.0f;
      a.o_click[p] = 0.0f;
      for (int c = 0; c < a.width; ++c) a.o_g[p * a.width + c] = 0.0f;
    }
  }
  __syncthreads();

  const int nlong = s_nlong;
  if (w < nlong) {
    const int64_t ls = s_long_s[w];
    const int32_t r = s_key[ls - ts + 1];
    int64_t le = s_long_e[w];
    if (le < 0) le = find_end(a.skeys, ts + kWalkTile + kHalo, n, r, lane);
    const bool to_block = le - ls >= kWalkBlockMin;
    if (!to_block)
      warp_segment<DIM, APPLY>(a, ls, le, r, s_long_o[w], s_stage + w * kWarpStage, lane);
    if (lane == 0) {
      s_long_e[w] = le;
      s_long_block[w] = to_block;
    }
  }
  __syncthreads();
  for (int q = 0; q < nlong; ++q)
    if (s_long_block[q])
      block_segment<DIM, APPLY>(a, s_long_s[q], s_long_e[q], s_key[s_long_s[q] - ts + 1],
                                s_long_o[q], s_stage, tid);
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// A launch that may overlap the kernel before it on the stream (see
// pdl_acquire).
template <typename... Params, typename... Args>
cudaError_t launch_chained(void (*kernel)(Params...), unsigned grid, unsigned block,
                           cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <bool APPLY>
int launch_walk(const WalkArgs& a, void* stream) {
  const unsigned blocks = static_cast<unsigned>((a.n + kWalkTile - 1) / kWalkTile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      a.width == 1 + 8 ? launch_chained(segment_walk_kernel<8, APPLY>, blocks, kWalkThreads, st, a)
                       : launch_chained(segment_walk_kernel<-1, APPLY>, blocks, kWalkThreads, st,
                                        a));
}

}  // namespace

extern "C" int hot_probe_gather_launch(
    const int32_t* map_hi, const int32_t* map_lo, const int32_t* map_row,
    const int32_t* seed, const int32_t* keys_hi, const int32_t* keys_lo,
    const float* embed_w, const float* embedx_w, int32_t* o_rows,
    float* o_pull, int64_t n, int64_t nbuckets, int bslots,
    int probe_buckets, int banks, int64_t C, int dim, void* stream) {
  if (n <= 0) return 0;
  hot_probe_gather_kernel<<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      map_hi, map_lo, map_row, seed, keys_hi, keys_lo, embed_w, embedx_w,
      o_rows, o_pull, n, nbuckets, bslots, probe_buckets, banks, C, dim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hot_probe_launch(
    const int32_t* map_hi, const int32_t* map_lo, const int32_t* map_row,
    const int32_t* seed, const int32_t* keys_hi, const int32_t* keys_lo,
    int32_t* o_rows, int64_t n, int64_t nbuckets, int bslots,
    int probe_buckets, int banks, void* stream) {
  if (n <= 0) return 0;
  hot_probe_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      map_hi, map_lo, map_row, seed, keys_hi, keys_lo, o_rows, n, nbuckets,
      bslots, probe_buckets, banks);
  return static_cast<int>(cudaGetLastError());
}

// Digit passes of a sort: ceil(bit_length(bound) / 8), at least 1, in
// bounded mode, 4 in full mode; 0 for a bound outside [0, 2^31).
extern "C" int radix_sort_passes(int full, int64_t bound) {
  if (full) return 32 / kRadixBits;
  if (bound < 0 || bound > INT32_MAX) return 0;
  int bits = 0;
  while (bits < 32 && (bound >> bits) != 0) ++bits;
  const int passes = (bits + kRadixBits - 1) / kRadixBits;
  return passes > 1 ? passes : 1;
}

// The int32 words of radix_sort_launch's `work` for n rows: two key/value
// buffers (4n) and the passes' [tile x digit] count matrices; -1 when n
// is too large or the bound is invalid.
extern "C" int64_t radix_sort_work_words(int64_t n, int full, int64_t bound) {
  const int passes = radix_sort_passes(full, bound);
  if (n < 0 || n > INT32_MAX - kSortTile || passes == 0) return -1;
  return 4 * n + static_cast<int64_t>(passes) * ((n + kSortTile - 1) / kSortTile) * kRadixBins;
}

// Sorts n rows stably: out_rows = the sorted rows (bounded mode: rows
// outside [0, bound) become bound), out_perm = their positions, both
// int32 or both int64 (out64). `work` holds radix_sort_work_words(n,
// full, bound) int32. Launches 1 + radix_sort_passes(full, bound) kernels.
extern "C" int radix_sort_launch(const void* rows, int rows64, int64_t n, int full,
                                 int64_t bound, void* out_rows, void* out_perm, int out64,
                                 int32_t* work, void* stream) {
  if (n <= 0) return 0;
  const int passes = radix_sort_passes(full, bound);
  if (radix_sort_work_words(n, full, bound) < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>((n + kSortTile - 1) / kSortTile);
  const SortInput in{rows, rows64, full, static_cast<uint32_t>(bound)};
  uint32_t* keys[2] = {reinterpret_cast<uint32_t*>(work),
                       reinterpret_cast<uint32_t*>(work + 2 * n)};
  int32_t* vals[2] = {work + n, work + 3 * n};
  uint32_t* counts = reinterpret_cast<uint32_t*>(work + 4 * n);
  cudaError_t err =
      launch_chained(radix_count_kernel, tiles, kSortThreads, st, in, n, counts, tiles, passes);
  for (int p = 0; p < passes && err == cudaSuccess; ++p) {
    err = launch_chained(radix_scatter_kernel, tiles, kSortThreads, st, in,
                         static_cast<const uint32_t*>(keys[(p + 1) & 1]),
                         static_cast<const int32_t*>(vals[(p + 1) & 1]), keys[p & 1],
                         vals[p & 1], out_rows, out_perm, out64, n, counts, tiles, p, passes);
  }
  return static_cast<int>(err);
}

// srows/perm: the int32 output of radix_sort_launch in bounded mode with
// bound C (the dropped rows sorted last as C).
extern "C" int hot_scatter_apply_launch(
    const int32_t* srows, const int32_t* perm, const float* shows,
    const float* clicks, const float* grads, float* show, float* click,
    float* ew, float* estate, float* xw, float* xstate, float* has,
    int64_t n, int64_t C, int dim, int es, int xs, int embed_rule,
    int embedx_rule, int create_applies_grad, float lr, float initial_g2sum,
    float wmin, float wmax, float beta1, float beta2, float eps,
    float nonclk_coeff, float click_coeff, float embedx_threshold,
    void* stream) {
  if (n <= 0) return 0;
  if (dim > kMaxDim || dim < 0) return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.skeys = srows;
  a.perm = perm;
  a.shows = shows;
  a.clicks = clicks;
  a.grads = grads;
  a.n = n;
  a.width = 1 + dim;
  a.show = show;
  a.click = click;
  a.ew = ew;
  a.estate = estate;
  a.xw = xw;
  a.xstate = xstate;
  a.has = has;
  a.C = C;
  a.p = RowParams{{lr, initial_g2sum, wmin, wmax, beta1, beta2, eps},
                  nonclk_coeff, click_coeff, embedx_threshold,
                  dim, es, xs, embed_rule, embedx_rule, create_applies_grad};
  return launch_walk<true>(a, stream);
}

// The int32 words of segment_merge_launch's `tile_starts` for n rows.
extern "C" int64_t segment_merge_work_words(int64_t n) {
  return (n + kWalkTile - 1) / kWalkTile;
}

// srows/perm: the int32 output of radix_sort_launch in full mode.
// tile_starts: int32 [segment_merge_work_words(n)] scratch. Writes the sorted unique
// rows to o_uniq (int64 when uniq64) and the sums, in segment order, and
// pads both to n with capacity and zeros. Launches 2 kernels.
extern "C" int segment_merge_launch(
    const int32_t* srows, const int32_t* perm, const float* shows,
    const float* clicks, const float* grads, int32_t* tile_starts, void* o_uniq,
    int uniq64, int64_t capacity, float* o_show, float* o_click, float* o_g,
    int64_t n, int width, void* stream) {
  if (n <= 0) return 0;
  if (width > 1 + kMaxDim || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.skeys = srows;
  a.perm = perm;
  a.shows = shows;
  a.clicks = clicks;
  a.grads = grads;
  a.n = n;
  a.width = width;
  a.tile_starts = tile_starts;
  a.o_uniq = o_uniq;
  a.uniq64 = uniq64;
  a.capacity = capacity;
  a.o_show = o_show;
  a.o_click = o_click;
  a.o_g = o_g;
  const unsigned blocks = static_cast<unsigned>((n + kWalkTile - 1) / kWalkTile);
  const cudaError_t err = launch_chained(segment_count_kernel, blocks, kWalkThreads,
                                         static_cast<cudaStream_t>(stream),
                                         static_cast<const int32_t*>(srows), n, tile_starts);
  return err != cudaSuccess ? static_cast<int>(err) : launch_walk<false>(a, stream);
}

extern "C" int hot_kernels_max_dim() { return kMaxDim; }
