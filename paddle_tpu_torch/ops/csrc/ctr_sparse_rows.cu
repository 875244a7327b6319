// ctr_sparse_rows: the per-row CTR sparse optimizer on Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/sparse_optimizer.py::
// ctr_sparse_rows (body _kernel -> fused_row_update). For pre-merged
// touched rows it applies, per row: show/click accumulation, the embed
// rule step, lazy embedx creation on the show/click score, and the
// embedx rule step, for the naive / adagrad / std_adagrad / adam rules.
//
// Design: one thread per row, the reference GPU shape (heter_ps
// optimizer.cuh.h update_value, one thread per feature). A thread loads
// its row's seven state columns and four delta columns, runs the rules
// with the rule ids, dim and hyperparameters as kernel arguments (a
// runtime switch), and writes the seven updated columns. The TPU
// kernel's 1024-row blocks carry nothing over between blocks, so rows
// map straight onto independent threads.
//
// Bound: HBM bytes. Per row (adagrad/adagrad, dim 8) it reads 25 f32 and
// writes 14 f32 (~156 B) and does a few dozen flops, far below the
// card's ~20 flop/byte balance point. At the main-path shape
// (n = 4096*26 padded uniques) that is ~16.6 MB, ~5 us at 3.35 TB/s, so
// a call is launch-bound; later work fuses it with the gather and
// scatter around it.
//
// Rounding and the rule itself: ctr_rule.cuh, shared with the hot
// tier's scatter-apply (hot_kernels.cu), so both kernels run one
// definition of the rule.

#include <cstdint>
#include <cuda_runtime.h>

#include "ctr_rule.cuh"

namespace {

using ctr_rule::RowParams;

__global__ void ctr_sparse_rows_kernel(
    const float* __restrict__ show, const float* __restrict__ click,
    const float* __restrict__ ew, const float* __restrict__ estate,
    const float* __restrict__ xw, const float* __restrict__ xstate,
    const float* __restrict__ has, const float* __restrict__ dshow,
    const float* __restrict__ dclick, const float* __restrict__ ge,
    const float* __restrict__ gx, float* __restrict__ o_show,
    float* __restrict__ o_click, float* __restrict__ o_ew,
    float* __restrict__ o_es, float* __restrict__ o_xw,
    float* __restrict__ o_xs, float* __restrict__ o_has, int64_t n,
    RowParams p) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int64_t es = p.es, xs = p.xs, dim = p.dim;
  ctr_rule::ctr_row_update(
      show[r], click[r], ew + r, estate + r * es, xw + r * dim,
      xstate + r * xs, has[r], dshow[r], dclick[r], ge + r, gx + r * dim,
      o_show + r, o_click + r, o_ew + r, o_es + r * es, o_xw + r * dim,
      o_xs + r * xs, o_has + r, p);
}

}  // namespace

extern "C" int ctr_sparse_rows_launch(
    const float* show, const float* click, const float* ew,
    const float* estate, const float* xw, const float* xstate,
    const float* has, const float* dshow, const float* dclick,
    const float* ge, const float* gx, float* o_show, float* o_click,
    float* o_ew, float* o_es, float* o_xw, float* o_xs, float* o_has,
    int64_t n, int dim, int es, int xs, int embed_rule, int embedx_rule,
    int create_applies_grad, float lr, float initial_g2sum, float wmin,
    float wmax, float beta1, float beta2, float eps, float nonclk_coeff,
    float click_coeff, float embedx_threshold, void* stream) {
  if (n <= 0) return 0;
  const RowParams p{{lr, initial_g2sum, wmin, wmax, beta1, beta2, eps},
                    nonclk_coeff, click_coeff, embedx_threshold,
                    dim, es, xs, embed_rule, embedx_rule, create_applies_grad};
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ctr_sparse_rows_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      show, click, ew, estate, xw, xstate, has, dshow, dclick, ge, gx, o_show,
      o_click, o_ew, o_es, o_xw, o_xs, o_has, n, p);
  return static_cast<int>(cudaGetLastError());
}
