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
// Rounding: bit-parity with the plain PyTorch version, the JAX package
// and the numpy host rules needs every f32 op rounded separately. The
// library is built with --fmad=false and without fast-math, and the
// arithmetic below uses the explicit round-to-nearest intrinsics, so no
// product is ever contracted into an FMA and division and sqrt are IEEE.
// m32 keeps the JAX package's `t + 0*t` seal so a +-inf product turns
// into NaN exactly as it does there; max/min propagate NaN like
// jnp.maximum / jnp.clip.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Rule { kNaive = 0, kAdagrad = 1, kStdAdagrad = 2, kAdam = 3 };

struct Hyper {
  float lr, initial_g2sum, wmin, wmax, beta1, beta2, eps;
};

__device__ __forceinline__ float m32(float a, float b) {
  float t = __fmul_rn(a, b);
  return __fadd_rn(t, __fmul_rn(0.0f, t));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float clip(float x, const Hyper& h) {
  return min_nan(max_nan(x, h.wmin), h.wmax);
}

// One rule step on one row: w/g of width d, state of the rule's width.
// `state` is read from st_in and written to st_out (the two may differ:
// a freshly created embedx row starts from the rule's init state).
__device__ void rule_update(int rule, int d, const float* w, const float* g,
                            float scale, const float* st_in, float* w_out,
                            float* st_out, const Hyper& h) {
  switch (rule) {
    case kNaive:
      for (int i = 0; i < d; ++i)
        w_out[i] = clip(__fsub_rn(w[i], m32(h.lr, g[i])), h);
      break;
    case kAdagrad: {  // one shared g2sum: sequential sum, ONE divide
      const float st = st_in[0];
      const float ratio = __fsqrt_rn(
          __fdiv_rn(h.initial_g2sum, __fadd_rn(h.initial_g2sum, st)));
      float add = 0.0f;
      for (int i = 0; i < d; ++i) {
        const float sg = __fdiv_rn(g[i], scale);
        w_out[i] = clip(__fsub_rn(w[i], m32(m32(h.lr, sg), ratio)), h);
        add = (i == 0) ? m32(sg, sg) : __fadd_rn(add, m32(sg, sg));
      }
      st_out[0] = __fadd_rn(st, __fdiv_rn(add, static_cast<float>(d)));
      break;
    }
    case kStdAdagrad:  // per-dim g2sum
      for (int i = 0; i < d; ++i) {
        const float st = st_in[i];
        const float sg = __fdiv_rn(g[i], scale);
        const float ratio = __fsqrt_rn(
            __fdiv_rn(h.initial_g2sum, __fadd_rn(h.initial_g2sum, st)));
        w_out[i] = clip(__fsub_rn(w[i], m32(m32(h.lr, sg), ratio)), h);
        st_out[i] = __fadd_rn(st, m32(sg, sg));
      }
      break;
    case kAdam: {  // state = [m x d, v x d, beta1_pow, beta2_pow]
      const float b1p = st_in[2 * d], b2p = st_in[2 * d + 1];
      const float omb1 = __fsub_rn(1.0f, h.beta1);
      const float omb2 = __fsub_rn(1.0f, h.beta2);
      for (int i = 0; i < d; ++i) {
        const float m2 = __fadd_rn(m32(h.beta1, st_in[i]), m32(omb1, g[i]));
        const float v2 =
            __fadd_rn(m32(h.beta2, st_in[d + i]), m32(m32(omb2, g[i]), g[i]));
        const float m_hat = __fdiv_rn(m2, __fsub_rn(1.0f, b1p));
        const float v_hat = __fdiv_rn(v2, __fsub_rn(1.0f, b2p));
        const float step = __fdiv_rn(m32(h.lr, m_hat),
                                     __fadd_rn(__fsqrt_rn(v_hat), h.eps));
        w_out[i] = clip(__fsub_rn(w[i], step), h);
        st_out[i] = m2;
        st_out[d + i] = v2;
      }
      st_out[2 * d] = m32(b1p, h.beta1);
      st_out[2 * d + 1] = m32(b2p, h.beta2);
      break;
    }
  }
}

__global__ void ctr_sparse_rows_kernel(
    const float* __restrict__ show, const float* __restrict__ click,
    const float* __restrict__ ew, const float* __restrict__ estate,
    const float* __restrict__ xw, const float* __restrict__ xstate,
    const float* __restrict__ has, const float* __restrict__ dshow,
    const float* __restrict__ dclick, const float* __restrict__ ge,
    const float* __restrict__ gx, float* __restrict__ o_show,
    float* __restrict__ o_click, float* __restrict__ o_ew,
    float* __restrict__ o_es, float* __restrict__ o_xw,
    float* __restrict__ o_xs, float* __restrict__ o_has, int64_t n, int dim,
    int es, int xs, int embed_rule, int embedx_rule, int create_applies_grad,
    Hyper h, float nonclk_coeff, float click_coeff, float embedx_threshold) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;

  const float ds = dshow[r];
  const float show_new = __fadd_rn(show[r], ds);
  const float click_new = __fadd_rn(click[r], dclick[r]);
  const float scale = max_nan(ds, 1e-10f);
  o_show[r] = show_new;
  o_click[r] = click_new;

  // embed (1-d) block: always applied
  rule_update(embed_rule, 1, ew + r, ge + r, scale, estate + r * es,
              o_ew + r, o_es + r * es, h);

  // lazy embedx creation on the show/click score over the new totals
  const float score = __fadd_rn(m32(__fsub_rn(show_new, click_new), nonclk_coeff),
                                m32(click_new, click_coeff));
  const float has_r = has[r];
  const bool had = has_r > 0.0f;
  const bool create = !had && score >= embedx_threshold;
  const bool apply = create_applies_grad ? (had || create) : had;
  o_has[r] = create ? 1.0f : has_r;

  // a created row starts from the rule's init state (zeros; Adam's beta
  // powers at beta1/beta2), written first so the rule reads it back
  const float* x_in = xstate + r * xs;
  float* x_out = o_xs + r * xs;
  if (create) {
    for (int i = 0; i < xs; ++i) x_out[i] = 0.0f;
    if (embedx_rule == kAdam) {
      x_out[2 * dim] = h.beta1;
      x_out[2 * dim + 1] = h.beta2;
    }
    x_in = x_out;
  }
  const float* w_in = xw + r * dim;
  float* w_out = o_xw + r * dim;
  if (apply) {
    rule_update(embedx_rule, dim, w_in, gx + r * dim, scale, x_in, w_out,
                x_out, h);
  } else {
    for (int i = 0; i < dim; ++i) w_out[i] = w_in[i];
    if (!create)
      for (int i = 0; i < xs; ++i) x_out[i] = x_in[i];
  }
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
  const Hyper h{lr, initial_g2sum, wmin, wmax, beta1, beta2, eps};
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ctr_sparse_rows_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      show, click, ew, estate, xw, xstate, has, dshow, dclick, ge, gx, o_show,
      o_click, o_ew, o_es, o_xw, o_xs, o_has, n, dim, es, xs, embed_rule,
      embedx_rule, create_applies_grad, h, nonclk_coeff, click_coeff,
      embedx_threshold);
  return static_cast<int>(cudaGetLastError());
}
