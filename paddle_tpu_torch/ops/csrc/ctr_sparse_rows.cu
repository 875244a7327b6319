// ctr_sparse_rows: the per-row CTR sparse optimizer on Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/sparse_optimizer.py::
// ctr_sparse_rows (body _kernel -> fused_row_update). For pre-merged
// touched rows it applies, per row: show/click accumulation, the embed
// rule step, lazy embedx creation on the show/click score, and the
// embedx rule step, for the naive / adagrad / std_adagrad / adam rules.
// The rule itself is ctr_rule.cuh, shared with the hot tier's
// scatter-apply (hot_kernels.cu), so every kernel runs one definition.
//
// Design (ctr_rows_at_kernel): the update in place, by index. A block
// takes a tile of kTile entries of the merge's outputs (uniq, the
// show/click sums and the [n, 1+dim] grad sums); one thread issues a bulk
// asynchronous copy a column into shared memory, all on one mbarrier (a
// short last tile, or deltas that do not start on 16 bytes, read their
// entries from global memory instead: a bulk copy moves whole 16-byte
// units). Each thread takes one entry, skips it when its row lies outside
// [0, capacity) (the merge's padding), issues every piece of the row's
// seven cache columns as cp.async copies into shared memory before one
// wait (a block has all of its random sectors in flight at once), runs the
// rule in registers and writes the row back in place. The merge's rows are
// distinct, so no two threads touch one row. The pass cache's push calls
// it on the merge's outputs as they are; rows in, rows out (the Pallas
// kernel's contract) is the same kernel on copies of the rows with
// uniq = 0 .. n-1.
//
// A piece is 16, 8 or 4 bytes: the widest that divides both a column's
// row and the address the column starts at, so a column may start
// anywhere (a shard's block of rows, a view). The widths and rules are
// compile-time for the main path's shape (embedx dim 8, each embedx rule,
// every column at its row's natural alignment: the row lives in registers,
// every loop unrolls) and run-time otherwise (the rule reads shared memory
// and writes global memory; a tile of fewer entries when a wide row would
// overflow shared memory).
//
// Bound: HBM bytes. Per touched row (adagrad/adagrad, dim 8) the rule
// does a few dozen flops on 156 useful bytes, far below the card's ~20
// flop/byte balance; each row's seven columns are seven random 32-byte
// sectors read and written, the layout's floor.
//
// PTX for the copies and barriers: async_copy.cuh.

#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "ctr_rule.cuh"

namespace {

using ctr_rule::RowParams;
namespace ac = async_copy;

constexpr int kTile = 128;                 // rows (entries) a block, one a thread
constexpr int kMinTile = 32;               // the smallest tile of a wide row
constexpr int kMaxDim = 128;               // the widest embedx row the kernel takes
constexpr unsigned kSmemCap = 200 * 1024;  // shared memory a block may take

// The seven state columns, in this order everywhere.
enum { kShow, kClick, kEw, kEs, kXw, kXs, kHas, kCols };

// -- the row in registers (compile-time widths) ---------------------------

template <int DIM, int XRULE>
struct Row {
  static constexpr int kXsw = ctr_rule::state_dim(XRULE, DIM);
  float show, click, ew, es[4], xw[DIM], xs[kXsw > 0 ? kXsw : 1], has;
};

// W floats of a row at p (of a column at its row's natural alignment)
// in the widest loads that alignment allows.
template <int W>
__device__ __forceinline__ void load_vec(float* v, const float* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = p[i];
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2)
      *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = v[i];
  }
}

// Row r of the seven columns at col (embed state width es: 0, 1 or 4).
template <int DIM, int XRULE>
__device__ __forceinline__ void load_row(Row<DIM, XRULE>& v, float* const* col, int es,
                                         int64_t r) {
  constexpr int kXsw = Row<DIM, XRULE>::kXsw;
  v.show = col[kShow][r];
  v.click = col[kClick][r];
  v.ew = col[kEw][r];
  if (es == 4)
    load_vec<4>(v.es, col[kEs] + r * 4);
  else if (es == 1)
    v.es[0] = col[kEs][r];
  load_vec<DIM>(v.xw, col[kXw] + r * DIM);
  if constexpr (kXsw > 0) load_vec<kXsw>(v.xs, col[kXs] + r * kXsw);
  v.has = col[kHas][r];
}

template <int DIM, int XRULE>
__device__ __forceinline__ void store_row(float* const* col, int es, int64_t r,
                                          const Row<DIM, XRULE>& v) {
  constexpr int kXsw = Row<DIM, XRULE>::kXsw;
  col[kShow][r] = v.show;
  col[kClick][r] = v.click;
  col[kEw][r] = v.ew;
  if (es == 4)
    store_vec<4>(col[kEs] + r * 4, v.es);
  else if (es == 1)
    col[kEs][r] = v.es[0];
  store_vec<DIM>(col[kXw] + r * DIM, v.xw);
  if constexpr (kXsw > 0) store_vec<kXsw>(col[kXs] + r * kXsw, v.xs);
  col[kHas][r] = v.has;
}

// The rule on a row in registers; gx: the row's DIM merged embedx grads.
template <int DIM, int XRULE>
__device__ __forceinline__ void update_row(const Row<DIM, XRULE>& in, float ds, float dc,
                                           float ge, const float* gx,
                                           Row<DIM, XRULE>& out, const RowParams& p) {
  ctr_rule::ctr_row_update<DIM, XRULE>(in.show, in.click, &in.ew, in.es, in.xw, in.xs,
                                       in.has, ds, dc, &ge, gx, &out.show, &out.click,
                                       &out.ew, out.es, out.xw, out.xs, &out.has, p);
}

// The rule on row r of columns in (read) and row ro of out (written), run
// time widths w; ge and gx point at the row's merged grads.
__device__ __forceinline__ void update_row_rt(float* const* in, int64_t r, float* const* out,
                                              int64_t ro, const int* w, float ds, float dc,
                                              const float* ge, const float* gx,
                                              const RowParams& p) {
  ctr_rule::ctr_row_update<-1>(
      in[kShow][r], in[kClick][r], in[kEw] + r, in[kEs] + r * w[kEs], in[kXw] + r * w[kXw],
      in[kXs] + r * w[kXs], in[kHas][r], ds, dc, ge, gx, out[kShow] + ro, out[kClick] + ro,
      out[kEw] + ro, out[kEs] + ro * w[kEs], out[kXw] + ro * w[kXw], out[kXs] + ro * w[kXs],
      out[kHas] + ro, p);
}

// -- in place, by index ---------------------------------------------------

struct AtArgs {
  float* col[kCols];    // the cache's seven state columns, updated in place
  int w[kCols];         // floats a row of each column (0: absent)
  int piece[kCols];     // bytes a cp.async piece of each column's row: 4, 8, 16
  const void* uniq;     // [n] rows (int32 or int64); outside [0, capacity): skipped
  int uniq64;
  int bulk;             // the deltas start on 16 bytes: whole tiles by bulk copies
  const float* ds;      // [n] merged show sums
  const float* dc;      // [n]
  const float* g;       // [n, 1+dim] merged grads: embed then embedx
  int64_t n, capacity;
  int tile;             // entries a block (= blockDim.x)
  unsigned off[4 + kCols];  // shared-memory byte offsets: uniq, ds, dc, g, staged rows
  RowParams p;
};

// W floats of a row at src into dst by cp.async, in the widest pieces the
// row's natural alignment allows.
template <int W>
__device__ __forceinline__ void stage_vec(float* dst, const float* src) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) ac::copy_async<16>(dst + i, src + i);
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2) ac::copy_async<8>(dst + i, src + i);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) ac::copy_async<4>(dst + i, src + i);
  }
}

// w floats of a row at src into dst by cp.async in pieces of `piece` bytes.
__device__ __forceinline__ void stage_rt(float* dst, const float* src, int w, int piece) {
  if (piece == 16) {
    for (int i = 0; i < w; i += 4) ac::copy_async<16>(dst + i, src + i);
  } else if (piece == 8) {
    for (int i = 0; i < w; i += 2) ac::copy_async<8>(dst + i, src + i);
  } else {
    for (int i = 0; i < w; ++i) ac::copy_async<4>(dst + i, src + i);
  }
}

// Slot t of the stage tiles <- row r of the cache columns, every piece in
// flight before the one wait.
template <int DIM, int XRULE>
__device__ __forceinline__ void stage_row(float* const* stage, const AtArgs& a, int64_t r,
                                          int t) {
  if constexpr (DIM >= 0) {
    constexpr int kXsw = Row<DIM, XRULE>::kXsw;
    stage_vec<1>(stage[kShow] + t, a.col[kShow] + r);
    stage_vec<1>(stage[kClick] + t, a.col[kClick] + r);
    stage_vec<1>(stage[kEw] + t, a.col[kEw] + r);
    if (a.w[kEs] == 4)
      stage_vec<4>(stage[kEs] + t * 4, a.col[kEs] + r * 4);
    else if (a.w[kEs] == 1)
      stage_vec<1>(stage[kEs] + t, a.col[kEs] + r);
    stage_vec<DIM>(stage[kXw] + t * DIM, a.col[kXw] + r * DIM);
    if constexpr (kXsw > 0) stage_vec<kXsw>(stage[kXs] + t * kXsw, a.col[kXs] + r * kXsw);
    stage_vec<1>(stage[kHas] + t, a.col[kHas] + r);
  } else {
    for (int c = 0; c < kCols; ++c)
      if (a.w[c]) stage_rt(stage[c] + t * a.w[c], a.col[c] + r * a.w[c], a.w[c], a.piece[c]);
  }
  ac::copy_async_wait();
}

template <int DIM, int XRULE>
__global__ void ctr_rows_at_kernel(const AtArgs a) {
  const int t = threadIdx.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * a.tile;
  const int gw = (DIM >= 0 ? DIM : a.w[kXw]) + 1;  // floats a row of g
  unsigned char* smem = ac::dynamic_smem();
  // the entry's deltas: from the block's tiles (index t) or, in the short
  // tile, straight from global memory (index i0 + t)
  const void* uniq = a.uniq;
  const float *ds = a.ds, *dc = a.dc, *g = a.g;
  int64_t k = i0 + t;
  if (a.bulk && i0 + a.tile <= a.n) {
    __shared__ uint64_t bar;
    void* tu = smem + a.off[0];
    float* tds = reinterpret_cast<float*>(smem + a.off[1]);
    float* tdc = reinterpret_cast<float*>(smem + a.off[2]);
    float* tg = reinterpret_cast<float*>(smem + a.off[3]);
    if (t == 0) ac::mbar_init(&bar, 1);
    __syncthreads();
    if (t == 0) {
      const unsigned rows4 = static_cast<unsigned>(a.tile) * 4u;
      const unsigned ubytes = rows4 * (a.uniq64 ? 2u : 1u);
      ac::mbar_arrive_expect(&bar, ubytes + rows4 * (2u + static_cast<unsigned>(gw)));
      ac::bulk_load(tu, static_cast<const char*>(a.uniq) + i0 * (a.uniq64 ? 8 : 4), ubytes,
                    &bar);
      ac::bulk_load(tds, a.ds + i0, rows4, &bar);
      ac::bulk_load(tdc, a.dc + i0, rows4, &bar);
      ac::bulk_load(tg, a.g + i0 * gw, rows4 * gw, &bar);
    }
    ac::mbar_wait(&bar, 0);
    uniq = tu;
    ds = tds;
    dc = tdc;
    g = tg;
    k = t;
  } else if (k >= a.n) {
    return;
  }
  int64_t r = a.uniq64 ? static_cast<const int64_t*>(uniq)[k]
                       : static_cast<const int32_t*>(uniq)[k];
  if (r < 0 || r >= a.capacity) return;  // a sentinel: nothing to read or write
  float* stage[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) stage[c] = reinterpret_cast<float*>(smem + a.off[4 + c]);
  const float* gk = g + k * gw;
  stage_row<DIM, XRULE>(stage, a, r, t);
  if constexpr (DIM >= 0) {
    Row<DIM, XRULE> in, out;
    float gx[DIM];
    load_row(in, stage, a.w[kEs], t);
#pragma unroll
    for (int i = 0; i < DIM; ++i) gx[i] = gk[1 + i];
    update_row(in, ds[k], dc[k], gk[0], gx, out, a.p);
    store_row(a.col, a.w[kEs], r, out);
  } else {
    update_row_rt(stage, t, a.col, r, a.w, ds[k], dc[k], gk, gk + 1, a.p);
  }
}

// -- launch -----------------------------------------------------------------

using Kernel = void (*)(AtArgs);

template <int DIM, int XRULE>
Kernel at_kernel() {
  return ctr_rows_at_kernel<DIM, XRULE>;
}

// The instantiation for (dim, embedx rule): compile-time widths for the
// main path's dim when every column sits at its rows' natural alignment
// (`natural`), run time for the rest.
Kernel pick(int dim, int xrule, bool natural) {
  if (dim == 8 && natural) {
    switch (xrule) {
      case ctr_rule::kNaive: return at_kernel<8, ctr_rule::kNaive>();
      case ctr_rule::kAdagrad: return at_kernel<8, ctr_rule::kAdagrad>();
      case ctr_rule::kStdAdagrad: return at_kernel<8, ctr_rule::kStdAdagrad>();
      case ctr_rule::kAdam: return at_kernel<8, ctr_rule::kAdam>();
    }
  }
  return at_kernel<-1, -1>();
}

// Bytes of the widest piece (16, 8 or 4) that divides both a row of w
// floats and the address p.
int piece_bytes(int w, const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int b = 16; b > 4; b /= 2)
    if ((4 * w) % b == 0 && a % b == 0) return b;
  return 4;
}

// Entries a block: kTile, halved while the block's shared memory
// (bytes_per_row an entry) would pass kSmemCap; 0 when even kMinTile does.
int tile_rows(unsigned bytes_per_row) {
  int tile = kTile;
  while (tile > kMinTile && static_cast<unsigned>(tile) * bytes_per_row > kSmemCap) tile /= 2;
  return static_cast<unsigned>(tile) * bytes_per_row > kSmemCap ? 0 : tile;
}

bool widths_ok(int dim, int es, int xs, int embed_rule, int embedx_rule) {
  return dim >= 1 && dim <= kMaxDim && embed_rule >= 0 && embed_rule <= 3 &&
         embedx_rule >= 0 && embedx_rule <= 3 && es == ctr_rule::state_dim(embed_rule, 1) &&
         xs == ctr_rule::state_dim(embedx_rule, dim);
}

}  // namespace

// In place, by index: for each entry i of [0, n) whose row r = uniq[i]
// lies in [0, capacity), row r of the seven state columns (show ...
// has_embedx) gets the rule with deltas ds[i], dc[i], g[i, :]. The valid
// entries of uniq must be distinct. Columns are contiguous [rows, width]
// and may start at any float; a zero-width state column may be null.
// Returns a CUDA error code.
extern "C" int ctr_sparse_rows_at_launch(
    float* show, float* click, float* ew, float* estate, float* xw, float* xstate,
    float* has, const void* uniq, int uniq64, const float* ds, const float* dc,
    const float* g, int64_t n, int64_t capacity, int dim, int es, int xs, int embed_rule,
    int embedx_rule, int create_applies_grad, float lr, float initial_g2sum, float wmin,
    float wmax, float beta1, float beta2, float eps, float nonclk_coeff, float click_coeff,
    float embedx_threshold, void* stream) {
  if (n <= 0) return 0;
  if (!widths_ok(dim, es, xs, embed_rule, embedx_rule))
    return static_cast<int>(cudaErrorInvalidValue);
  AtArgs a{};
  float* col[kCols] = {show, click, ew, estate, xw, xstate, has};
  const int w[kCols] = {1, 1, 1, es, dim, xs, 1};
  bool natural = true;
  for (int c = 0; c < kCols; ++c) {
    a.col[c] = col[c];
    a.w[c] = w[c];
    a.piece[c] = piece_bytes(w[c], col[c]);
    natural = natural && (!w[c] || a.piece[c] == piece_bytes(w[c], nullptr));
  }
  const void* deltas[4] = {uniq, ds, dc, g};
  a.bulk = 1;
  for (const void* d : deltas) a.bulk = a.bulk && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  a.uniq = uniq;
  a.uniq64 = uniq64;
  a.ds = ds;
  a.dc = dc;
  a.g = g;
  a.n = n;
  a.capacity = capacity;
  a.p = RowParams{{lr, initial_g2sum, wmin, wmax, beta1, beta2, eps},
                  nonclk_coeff, click_coeff, embedx_threshold,
                  dim, es, xs, embed_rule, embedx_rule, create_applies_grad};
  // tiles: uniq, ds, dc, g, then one staged row a thread of each column
  const int tw[4 + kCols] = {uniq64 ? 2 : 1, 1, 1, 1 + dim, 1, 1, 1, es, dim, xs, 1};
  unsigned row_floats = 0;
  for (int c = 0; c < 4 + kCols; ++c) row_floats += static_cast<unsigned>(tw[c]);
  a.tile = tile_rows(row_floats * 4u);
  if (a.tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned off = 0;
  for (int c = 0; c < 4 + kCols; ++c) {
    a.off[c] = off;
    off += static_cast<unsigned>(a.tile) * 4u * static_cast<unsigned>(tw[c]);
  }
  const Kernel k = pick(dim, embedx_rule, natural);
  if (off > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(off));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((n + a.tile - 1) / a.tile);
  k<<<blocks, a.tile, off, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The widest embedx row the kernel takes.
extern "C" int ctr_rows_max_dim() { return kMaxDim; }
