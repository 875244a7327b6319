"""Per-row CTR sparse optimizer: plain PyTorch version and CUDA kernel.

``ctr_sparse_rows`` is the port of the JAX package's Pallas kernel
``paddle_tpu.ops.sparse_optimizer.ctr_sparse_rows``: the whole per-row
CTR update of pre-merged touched rows — show/click accumulation, the
embed rule step, lazy embedx creation on the show/click score, the
embedx rule step — for the naive, adagrad, std_adagrad and adam rules.

On a CUDA tensor it launches the hand-written kernel
``ops/csrc/ctr_sparse_rows.cu`` (one thread per row, the reference's
``optimizer.cuh.h`` shape; the rule itself is ``ops/csrc/ctr_rule.cuh``,
shared with the hot tier's scatter-apply), built at first use with ``nvcc`` for
``sm_90a``; on a CPU tensor it runs ``fused_row_update``, the plain
PyTorch version beside it. There is no fallback between the two.

f32 rounding contract (shared with the JAX package, the numpy host rules
and the kernel): every f32 operation rounds separately — no FMA
contraction (``_m32``'s ``t + 0*t`` seal; the kernel builds with
``--fmad=false``), IEEE division and square root (torch's CPU float32
``sqrt`` is not correctly rounded, so ``_sqrt32`` goes through float64,
which is), adagrad's g2sum as a sequential sum over dims then one
divide, and ``(1 - beta)`` rounded in f32. Scalars enter as f32 tensors
on the data's device: PyTorch computes ``python_float / tensor`` as a
reciprocal times the scalar, which rounds twice.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ._build import build_cuda_library

__all__ = ["ctr_sparse_rows", "fused_row_update", "rule_init_state",
           "rule_state_dim", "rule_update"]

_RULE_IDS = {"naive": 0, "adagrad": 1, "std_adagrad": 2, "adam": 3}
_F32 = torch.float32


def rule_state_dim(rule: str, dim: int) -> int:
    """Optimizer-state floats per feature (sparse_sgd_rule slot dims)."""
    return {"naive": 0, "adagrad": 1, "std_adagrad": dim, "adam": 2 * dim + 2}[rule]


def rule_init_state(rule: str, n: int, dim: int, *, beta1: float, beta2: float,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Fresh-feature optimizer state: zeros; Adam's beta powers start at
    beta1/beta2 (sparse_sgd_rule.cc InitValueWork)."""
    sd = rule_state_dim(rule, dim)
    st = torch.zeros((n, sd), dtype=_F32, device=device)
    if rule == "adam":
        st[:, 2 * dim] = beta1
        st[:, 2 * dim + 1] = beta2
    return st


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    """Python float → 0-dim f32 tensor on ``like``'s device."""
    return torch.tensor(x, dtype=_F32, device=like.device)


def _m32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product sealed as ``t + 0*t``: the JAX package's guard against
    FMA contraction, kept so a ±inf product becomes NaN here exactly as
    it does there."""
    t = a * b
    return t + _c(0.0, t) * t


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (float64 sqrt, one rounding)."""
    return torch.sqrt(x.to(torch.float64)).to(_F32)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, _c(lo, x)), _c(hi, x))


def rule_update(rule: str, w, state, g, scale, *, lr, initial_g2sum, wmin,
                wmax, beta1, beta2, eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched rule step on touched rows: (w [n,d], state [n,sd],
    g [n,d] merged grads, scale [n,1] push_show) → (w', state'). Adam
    puts eps after the bias-corrected sqrt(v_hat) and ignores the scale,
    like the JAX package."""
    lrf = _c(lr, w)
    if rule == "naive":
        return _clip(w - _m32(lrf, g), wmin, wmax), state
    if rule in ("adagrad", "std_adagrad"):
        g2 = _c(initial_g2sum, w)
        sg = g / scale
        ratio = _sqrt32(g2 / (g2 + state))
        w2 = _clip(w - _m32(_m32(lrf, sg), ratio), wmin, wmax)
        if rule == "std_adagrad":  # per-dim g2sum
            return w2, state + _m32(sg, sg)
        # one shared g2sum: sequential sum over dims, ONE divide
        add = _m32(sg[:, 0], sg[:, 0])
        for i in range(1, g.shape[1]):
            add = add + _m32(sg[:, i], sg[:, i])
        return w2, state + (add / _c(float(g.shape[1]), w))[:, None]
    if rule == "adam":
        d = w.shape[1]
        m, v = state[:, :d], state[:, d:2 * d]
        b1p, b2p = state[:, 2 * d:2 * d + 1], state[:, 2 * d + 1:2 * d + 2]
        b1f, b2f, one = _c(beta1, w), _c(beta2, w), _c(1.0, w)
        m2 = _m32(b1f, m) + _m32(one - b1f, g)
        v2 = _m32(b2f, v) + _m32(_m32(one - b2f, g), g)
        m_hat = m2 / (one - b1p)
        v_hat = v2 / (one - b2p)
        w2 = _clip(w - _m32(lrf, m_hat) / (_sqrt32(v_hat) + _c(eps, w)), wmin, wmax)
        return w2, torch.cat([m2, v2, _m32(b1p, b1f), _m32(b2p, b2f)], dim=1)
    raise KeyError(f"unknown sparse sgd rule {rule!r}")


def fused_row_update(show, click, ew, estate, xw, xstate, has, dshow, dclick,
                     ge, gx, *, embed_rule, embedx_rule, dim, lr, initial_g2sum,
                     wmin, wmax, beta1, beta2, eps, nonclk_coeff, click_coeff,
                     embedx_threshold, create_applies_grad):
    """The plain PyTorch version of the per-row CTR update (touched rows,
    pre-merged): returns the seven updated columns (show, click, ew,
    estate, xw, xstate, has). Zero-width state columns pass through."""
    kw = dict(lr=lr, initial_g2sum=initial_g2sum, wmin=wmin, wmax=wmax,
              beta1=beta1, beta2=beta2, eps=eps)
    show_new = show + dshow
    click_new = click + dclick
    scale = torch.maximum(dshow, _c(1e-10, dshow))[:, None]

    es = rule_state_dim(embed_rule, 1)
    xs = rule_state_dim(embedx_rule, dim)
    ew_new, es_new = rule_update(embed_rule, ew, estate, ge, scale, **kw)

    # lazy embedx creation on the show/click score over the new totals;
    # create_applies_grad selects CPU order (create + apply,
    # ctr_accessor.cc) or GPU order (create only, optimizer.cuh.h:81-94)
    score = (_m32(show_new - click_new, _c(nonclk_coeff, show))
             + _m32(click_new, _c(click_coeff, show)))
    had = has > 0
    create = ~had & (score >= _c(embedx_threshold, show))
    apply_mask = (had | create) if create_applies_grad else had
    if xs > 0:
        init = rule_init_state(embedx_rule, show.shape[0], dim, beta1=beta1,
                               beta2=beta2, device=show.device)
        st_base = torch.where(create[:, None], init, xstate)
    else:
        st_base = xstate
    xw_new, xs_new = rule_update(embedx_rule, xw, st_base, gx, scale, **kw)
    return (show_new, click_new, ew_new,
            es_new if es > 0 else estate,
            torch.where(apply_mask[:, None], xw_new, xw),
            torch.where(apply_mask[:, None], xs_new, st_base) if xs > 0 else xstate,
            torch.where(create, _c(1.0, has), has))


# -- the CUDA kernel ------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_KLOCK = threading.Lock()
_KLIB: Optional[ctypes.CDLL] = None


def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; raises on failure."""
    global _KLIB
    with _KLOCK:
        if _KLIB is None:
            lib = ctypes.CDLL(build_cuda_library(
                "ctr_sparse_rows", os.path.join(_CSRC, "ctr_sparse_rows.cu"),
                (os.path.join(_CSRC, "ctr_rule.cuh"),)))
            fn = lib.ctr_sparse_rows_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int64]
                           + [ctypes.c_int] * 6 + [ctypes.c_float] * 10
                           + [ctypes.c_void_p])
            _KLIB = lib
        return _KLIB


def _launch(cols, deltas, outs, *, dim, es, xs, embed_rule, embedx_rule,
            create_applies_grad, hyper):
    # a zero-width state column has no storage to point at; the kernel
    # never touches it (es/xs == 0)
    ptr = lambda t: t.data_ptr() if t.numel() else None
    n = cols[0].shape[0]
    err = load_kernel().ctr_sparse_rows_launch(
        *[ptr(t) for t in cols], *[ptr(t) for t in deltas],
        *[ptr(t) for t in outs], n, dim, es, xs, _RULE_IDS[embed_rule],
        _RULE_IDS[embedx_rule], int(bool(create_applies_grad)),
        *[ctypes.c_float(h) for h in hyper],
        torch.cuda.current_stream(cols[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ctr_sparse_rows kernel launch failed: CUDA error {err}")


def ctr_sparse_rows(
    rows_state: Tuple[torch.Tensor, ...],  # show, click, ew, estate, xw, xstate, has
    dshow: torch.Tensor,     # [n] merged show deltas
    dclick: torch.Tensor,    # [n]
    g_embed: torch.Tensor,   # [n, 1] merged embed grads
    g_embedx: torch.Tensor,  # [n, dim]
    *,
    embed_rule: str, embedx_rule: str,
    lr: float, initial_g2sum: float, weight_bounds: Tuple[float, float],
    beta1: float, beta2: float, eps: float,
    nonclk_coeff: float, click_coeff: float, embedx_threshold: float,
    create_applies_grad: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Fused per-row CTR update over gathered rows; returns the seven
    updated state columns in the same order. CUDA tensors launch the
    kernel (and count one in ``ctr_sparse_rows.launches``); CPU tensors
    run :func:`fused_row_update`. Zero-width state columns (naive rule)
    are returned as given."""
    show, click, ew, estate, xw, xstate, has = rows_state
    n, dim = xw.shape
    es = rule_state_dim(embed_rule, 1)
    xs = rule_state_dim(embedx_rule, dim)
    # a mismatched cache/table state layout must fail loudly, never
    # corrupt rows silently
    enforce(estate.shape[1] == es and xstate.shape[1] == xs,
            f"optimizer-state width mismatch: estate {tuple(estate.shape)} vs "
            f"{es}, xstate {tuple(xstate.shape)} vs {xs}")
    cols = (show, click, ew, estate, xw, xstate, has)
    deltas = (dshow, dclick, g_embed, g_embedx)
    shapes = [(n,), (n,), (n, 1), (n, es), (n, dim), (n, xs), (n,),
              (n,), (n,), (n, 1), (n, dim)]
    for t, shape in zip(cols + deltas, shapes):
        enforce(tuple(t.shape) == shape and t.dtype == _F32,
                f"ctr_sparse_rows: expected float32 {shape}, got "
                f"{t.dtype} {tuple(t.shape)}", InvalidArgumentError)
        enforce(t.device == show.device,
                "ctr_sparse_rows: all tensors must be on one device",
                InvalidArgumentError)
    if show.device.type == "cpu":
        return fused_row_update(
            *cols, *deltas, embed_rule=embed_rule, embedx_rule=embedx_rule,
            dim=dim, lr=lr, initial_g2sum=initial_g2sum,
            wmin=weight_bounds[0], wmax=weight_bounds[1], beta1=beta1,
            beta2=beta2, eps=eps, nonclk_coeff=nonclk_coeff,
            click_coeff=click_coeff, embedx_threshold=embedx_threshold,
            create_applies_grad=create_applies_grad)
    enforce(show.device.type == "cuda",
            f"ctr_sparse_rows: no kernel for device {show.device}",
            InvalidArgumentError)
    for t in cols + deltas:
        enforce(t.is_contiguous(), "ctr_sparse_rows: inputs must be contiguous",
                InvalidArgumentError)
    outs = tuple(torch.empty_like(t) for t in cols)
    if n:
        _launch(cols, deltas, outs, dim=dim, es=es, xs=xs,
                embed_rule=embed_rule, embedx_rule=embedx_rule,
                create_applies_grad=create_applies_grad,
                hyper=(lr, initial_g2sum, weight_bounds[0], weight_bounds[1],
                       beta1, beta2, eps, nonclk_coeff, click_coeff,
                       embedx_threshold))
        ctr_sparse_rows.launches += 1
    o_show, o_click, o_ew, o_es, o_xw, o_xs, o_has = outs
    return (o_show, o_click, o_ew, o_es if es else estate, o_xw,
            o_xs if xs else xstate, o_has)


#: kernel launches since import (or since a caller reset it to 0)
ctr_sparse_rows.launches = 0
