// ctr_rule.cuh: the per-row CTR rule on Hopper, one definition shared by
// the kernels that apply it (ctr_sparse_rows.cu, hot_kernels.cu), as the
// JAX package shares fused_row_update by import.
//
// For one touched row with its merged deltas it applies: show/click
// accumulation, the embed rule step, lazy embedx creation on the
// show/click score, and the embedx rule step, for the naive / adagrad /
// std_adagrad / adam rules.
//
// Rounding: bit-parity with the plain PyTorch version, the JAX package
// and the numpy host rules needs every f32 op rounded separately. The
// libraries are built with --fmad=false and without fast-math, and the
// arithmetic below uses the explicit round-to-nearest intrinsics, so no
// product is ever contracted into an FMA and division and sqrt are IEEE.
// m32 keeps the JAX package's `t + 0*t` seal so a +-inf product turns
// into NaN exactly as it does there; max/min propagate NaN like
// jnp.maximum / jnp.clip.
//
// In place: ctr_row_update reads every input of a column before it
// writes that column, so the output pointers may alias the inputs (the
// hot tier's scatter-apply and ctr_sparse_rows_at update their rows in
// place).

#pragma once

#include <cstdint>

namespace ctr_rule {

enum Rule { kNaive = 0, kAdagrad = 1, kStdAdagrad = 2, kAdam = 3 };

struct Hyper {
  float lr, initial_g2sum, wmin, wmax, beta1, beta2, eps;
};

// Everything of the update that is fixed for a launch.
struct RowParams {
  Hyper h;
  float nonclk_coeff, click_coeff, embedx_threshold;
  int dim, es, xs, embed_rule, embedx_rule, create_applies_grad;
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

// Optimizer-state floats a row of width d (sparse_sgd_rule slot dims).
__host__ __device__ constexpr int state_dim(int rule, int d) {
  return rule == kAdagrad ? 1 : rule == kStdAdagrad ? d : rule == kAdam ? 2 * d + 2 : 0;
}

// One rule step on one row: w/g of width d, state of the rule's width.
// `state` is read from st_in and written to st_out (the two may differ:
// a freshly created embedx row starts from the rule's init state).
// D >= 0 fixes the width at compile time (d is then ignored): the loops
// unroll, so a caller's g array indexed only here stays in registers.
template <int D = -1>
__device__ __forceinline__ void rule_update(int rule, int d_rt, const float* w,
                                            const float* g, float scale,
                                            const float* st_in, float* w_out,
                                            float* st_out, const Hyper& h) {
  const int d = D >= 0 ? D : d_rt;
  switch (rule) {
    case kNaive:
#pragma unroll
      for (int i = 0; i < d; ++i)
        w_out[i] = clip(__fsub_rn(w[i], m32(h.lr, g[i])), h);
      break;
    case kAdagrad: {  // one shared g2sum: sequential sum, ONE divide
      const float st = st_in[0];
      const float ratio = __fsqrt_rn(
          __fdiv_rn(h.initial_g2sum, __fadd_rn(h.initial_g2sum, st)));
      float add = 0.0f;
#pragma unroll
      for (int i = 0; i < d; ++i) {
        const float sg = __fdiv_rn(g[i], scale);
        w_out[i] = clip(__fsub_rn(w[i], m32(m32(h.lr, sg), ratio)), h);
        add = (i == 0) ? m32(sg, sg) : __fadd_rn(add, m32(sg, sg));
      }
      st_out[0] = __fadd_rn(st, __fdiv_rn(add, static_cast<float>(d)));
      break;
    }
    case kStdAdagrad:  // per-dim g2sum
#pragma unroll
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
#pragma unroll
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

// The whole per-row update. Inputs: the row's seven state columns
// (show, click, ew[1], estate[es], xw[dim], xstate[xs], has) and its
// merged deltas (ds, dc, ge[1], gx[dim]); outputs: the seven columns.
// Zero-width state columns (naive rule) may be null. DIM >= 0 fixes the
// embedx width at compile time (p.dim must equal it), so that a caller's
// sum buffer gx stays in registers; XRULE >= 0 with it fixes the embedx
// rule (p.embedx_rule and p.xs must agree), so that every loop over the
// row unrolls and a caller's row arrays stay in registers too.
template <int DIM = -1, int XRULE = -1>
__device__ __forceinline__ void ctr_row_update(
    float show, float click, const float* ew, const float* estate,
    const float* xw, const float* xstate, float has, float ds, float dc,
    const float* ge, const float* gx, float* o_show, float* o_click,
    float* o_ew, float* o_es, float* o_xw, float* o_xs, float* o_has,
    const RowParams& p) {
  const Hyper& h = p.h;
  const int dim = DIM >= 0 ? DIM : p.dim;
  constexpr bool kFixed = DIM >= 0 && XRULE >= 0;
  const int xrule = kFixed ? XRULE : p.embedx_rule;
  const int xs = kFixed ? state_dim(XRULE, DIM) : p.xs;
  const float show_new = __fadd_rn(show, ds);
  const float click_new = __fadd_rn(click, dc);
  const float scale = max_nan(ds, 1e-10f);
  *o_show = show_new;
  *o_click = click_new;

  // embed (1-d) block: always applied
  rule_update<1>(p.embed_rule, 1, ew, ge, scale, estate, o_ew, o_es, h);

  // lazy embedx creation on the show/click score over the new totals
  const float score =
      __fadd_rn(m32(__fsub_rn(show_new, click_new), p.nonclk_coeff),
                m32(click_new, p.click_coeff));
  const bool had = has > 0.0f;
  const bool create = !had && score >= p.embedx_threshold;
  const bool apply = p.create_applies_grad ? (had || create) : had;
  *o_has = create ? 1.0f : has;

  // a created row starts from the rule's init state (zeros; Adam's beta
  // powers at beta1/beta2). Compile-time widths: the state the rule reads
  // is selected element by element into registers (a pointer chosen
  // between two arrays would send both to local memory).
  if constexpr (kFixed) {
    constexpr int kXs = state_dim(XRULE, DIM);
    float st[kXs > 0 ? kXs : 1];
#pragma unroll
    for (int i = 0; i < kXs; ++i) {
      const float init = XRULE == kAdam && i == 2 * DIM     ? h.beta1
                         : XRULE == kAdam && i == 2 * DIM + 1 ? h.beta2
                                                              : 0.0f;
      st[i] = create ? init : xstate[i];
    }
    if (apply) {
      rule_update<DIM>(XRULE, DIM, xw, gx, scale, st, o_xw, o_xs, h);
    } else {
#pragma unroll
      for (int i = 0; i < DIM; ++i) o_xw[i] = xw[i];
#pragma unroll
      for (int i = 0; i < kXs; ++i) o_xs[i] = st[i];
    }
    return;
  }
  // run-time widths: the init state is written first so the rule reads it
  // back
  const float* x_in = xstate;
  if (create) {
#pragma unroll
    for (int i = 0; i < xs; ++i) o_xs[i] = 0.0f;
    if (xrule == kAdam) {
      o_xs[2 * dim] = h.beta1;
      o_xs[2 * dim + 1] = h.beta2;
    }
    x_in = o_xs;
  }
  if (apply) {
    rule_update<DIM>(xrule, dim, xw, gx, scale, x_in, o_xw, o_xs, h);
  } else {
#pragma unroll
    for (int i = 0; i < dim; ++i) o_xw[i] = xw[i];
    if (!create) {
#pragma unroll
      for (int i = 0; i < xs; ++i) o_xs[i] = x_in[i];
    }
  }
}

}  // namespace ctr_rule
