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
// - hot_scatter_apply (merge_sparse_grads + kern): the push. The caller
//   sorts the rows stably (torch.sort, the library step that stands where
//   jnp.unique stands outside the Pallas kernel); then one thread per
//   sorted position. The thread that starts a segment walks its entries
//   in order, so it sums show, click and the 1+dim grads in occurrence
//   order from 0.0f (the JAX package's segment_sum order, bit for bit),
//   then applies the shared CTR rule (ctr_rule.cuh) to its row in place.
//   Every row belongs to one segment, so no two threads touch one row: no
//   atomics, and the result does not change from run to run. Rows < 0 or
//   >= C drop. Bound: HBM bytes, ~17 MB at n = 106,496 (~5 us). A key
//   with many occurrences makes one thread walk them all; that is right,
//   and its length is reported beside the time.
//
// - segment_merge: the same sorted walk writing the merged sums and the
//   sorted unique rows (padded with the sentinel C) instead of applying
//   them: merge_sparse_grads of the pass cache, deterministic on the card.
//
// Each entry returns cudaGetLastError(); the Python wrapper raises if it
// is not 0. The kernels launch on the caller's stream and allocate
// nothing.

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

__device__ __forceinline__ bool segment_start(const int64_t* srows, int64_t i) {
  return i == 0 || srows[i - 1] != srows[i];
}

// The merge of the segment that starts at sorted position i: its entries
// walked in sorted (= occurrence) order, each column summed from 0.0f.
// g holds the `width` grad sums.
__device__ __forceinline__ void segment_sums(
    const int64_t* __restrict__ srows, const int64_t* __restrict__ perm,
    const float* __restrict__ shows, const float* __restrict__ clicks,
    const float* __restrict__ grads, int64_t i, int64_t n, int width,
    float* ds, float* dc, float* g) {
  const int64_t r = srows[i];
  for (int d = 0; d < width; ++d) g[d] = 0.0f;
  float s = 0.0f, c = 0.0f;
  for (int64_t j = i; j < n && srows[j] == r; ++j) {
    const int64_t k = perm[j];
    s = __fadd_rn(s, shows[k]);
    c = __fadd_rn(c, clicks[k]);
    const float* gk = grads + k * width;
    for (int d = 0; d < width; ++d) g[d] = __fadd_rn(g[d], gk[d]);
  }
  *ds = s;
  *dc = c;
}

__global__ void hot_scatter_apply_kernel(
    const int64_t* __restrict__ srows, const int64_t* __restrict__ perm,
    const float* __restrict__ shows, const float* __restrict__ clicks,
    const float* __restrict__ grads, float* show, float* click, float* ew,
    float* estate, float* xw, float* xstate, float* has, int64_t n,
    int64_t C, RowParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !segment_start(srows, i)) return;
  const int64_t r = srows[i];
  if (r < 0 || r >= C) return;
  float g[1 + kMaxDim];
  float ds, dc;
  segment_sums(srows, perm, shows, clicks, grads, i, n, 1 + p.dim, &ds, &dc, g);
  const int64_t es = p.es, xs = p.xs, dim = p.dim;
  ctr_rule::ctr_row_update(
      show[r], click[r], ew + r, estate + r * es, xw + r * dim,
      xstate + r * xs, has[r], ds, dc, g, g + 1, show + r, click + r, ew + r,
      estate + r * es, xw + r * dim, xstate + r * xs, has + r, p);
}

__global__ void segment_merge_kernel(
    const int64_t* __restrict__ srows, const int64_t* __restrict__ perm,
    const int64_t* __restrict__ seg, const float* __restrict__ shows,
    const float* __restrict__ clicks, const float* __restrict__ grads,
    int64_t* __restrict__ o_uniq, float* __restrict__ o_show,
    float* __restrict__ o_click, float* __restrict__ o_g, int64_t n,
    int width) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n || !segment_start(srows, i)) return;
  const int64_t o = seg[i];
  float g[1 + kMaxDim];
  segment_sums(srows, perm, shows, clicks, grads, i, n, width, o_show + o,
               o_click + o, g);
  o_uniq[o] = srows[i];
  for (int d = 0; d < width; ++d) o_g[o * width + d] = g[d];
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
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

extern "C" int hot_scatter_apply_launch(
    const int64_t* srows, const int64_t* perm, const float* shows,
    const float* clicks, const float* grads, float* show, float* click,
    float* ew, float* estate, float* xw, float* xstate, float* has,
    int64_t n, int64_t C, int dim, int es, int xs, int embed_rule,
    int embedx_rule, int create_applies_grad, float lr, float initial_g2sum,
    float wmin, float wmax, float beta1, float beta2, float eps,
    float nonclk_coeff, float click_coeff, float embedx_threshold,
    void* stream) {
  if (n <= 0) return 0;
  if (dim > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const RowParams p{{lr, initial_g2sum, wmin, wmax, beta1, beta2, eps},
                    nonclk_coeff, click_coeff, embedx_threshold,
                    dim, es, xs, embed_rule, embedx_rule, create_applies_grad};
  hot_scatter_apply_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      srows, perm, shows, clicks, grads, show, click, ew, estate, xw, xstate,
      has, n, C, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_merge_launch(
    const int64_t* srows, const int64_t* perm, const int64_t* seg,
    const float* shows, const float* clicks, const float* grads,
    int64_t* o_uniq, float* o_show, float* o_click, float* o_g, int64_t n,
    int width, void* stream) {
  if (n <= 0) return 0;
  if (width > 1 + kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  segment_merge_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      srows, perm, seg, shows, clicks, grads, o_uniq, o_show, o_click, o_g, n,
      width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hot_kernels_max_dim() { return kMaxDim; }
