"""Per-row CTR sparse optimizer: plain PyTorch versions and CUDA kernel.

``ctr_sparse_rows`` is the port of the JAX package's Pallas kernel
``paddle_tpu.ops.sparse_optimizer.ctr_sparse_rows``: the whole per-row
CTR update of pre-merged touched rows — show/click accumulation, the
embed rule step, lazy embedx creation on the show/click score, the
embedx rule step — for the naive, adagrad, std_adagrad and adam rules.
Rows in, rows out, as there.

``ctr_sparse_rows_at`` is the same update in place, by index: the pass
cache's push hands it the merge's outputs as they are (``uniq`` padded
with ``capacity``, the show/click sums and the ``[n, 1+dim]`` grad sums)
and it reads, updates and writes back the cache's rows ``uniq[i]``. It
computes what the JAX package's ``cache_push_sparse`` composes around the
Pallas kernel (gather, kernel, ``.at[uniq].set(mode="drop")``).

On a CUDA tensor both launch the one hand-written kernel
``ops/csrc/ctr_sparse_rows.cu`` (in place by index: a tile of entries a
block moved by bulk asynchronous copies, each row's pieces by
``cp.async``; rows in, rows out is the same kernel on copies of the rows
with ``uniq = 0 .. n-1``; the rule itself is ``ops/csrc/ctr_rule.cuh``,
shared with the hot tier's scatter-apply), built at first use with
``nvcc`` for ``sm_90a``, and count one in ``ctr_sparse_rows.launches``.
On a CPU tensor they run the plain PyTorch versions beside them:
``fused_row_update``, and ``ctr_sparse_rows_at_plain`` (safe gather,
``fused_row_update``, sentinel-safe scatter). There is no fallback
between the two.

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
from typing import Optional, Sequence, Tuple

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ._build import build_cuda_library

__all__ = ["ctr_sparse_rows", "ctr_sparse_rows_at", "ctr_sparse_rows_at_plain",
           "fused_row_update", "rule_init_state", "rule_state_dim", "rule_update"]

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


def _scatter_rows(col: torch.Tensor, uniq: torch.Tensor, vals: torch.Tensor,
                  capacity: int) -> None:
    """``col[uniq] = vals`` in place, dropping sentinel entries (uniq
    outside [0, capacity)) without a host sync: each sentinel entry is
    redirected to write the same value that the first valid entry j writes
    to row uniq[j] (or, when every entry is a sentinel, row 0's own value
    back to row 0), so every duplicate index carries one value and the
    result does not depend on order. The valid entries must be distinct."""
    valid = (uniq >= 0) & (uniq < capacity)
    j = torch.argmax(valid.to(torch.int8))  # the first valid entry, or 0
    first_valid = valid[j]
    tgt0 = torch.where(first_valid, uniq[j], torch.zeros_like(uniq[j]))
    val0 = torch.where(first_valid, vals[j], col[0])
    idx = torch.where(valid, uniq, tgt0)
    mask = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
    col.index_copy_(0, idx.to(torch.int64), torch.where(mask, vals, val0))


def ctr_sparse_rows_at_plain(state, uniq, show_sum, click_sum, g, *, capacity, embed_rule,
                             embedx_rule, lr, initial_g2sum, weight_bounds, beta1, beta2,
                             eps, nonclk_coeff, click_coeff, embedx_threshold,
                             create_applies_grad=True):
    """The plain version of :func:`ctr_sparse_rows_at`: gather the rows
    ``uniq`` (a sentinel reads row 0), :func:`fused_row_update`, scatter
    the valid rows back in place (``_scatter_rows``). Returns ``state``."""
    if not uniq.shape[0]:
        return state
    valid = (uniq >= 0) & (uniq < capacity)
    srows = torch.where(valid, uniq, torch.zeros_like(uniq))  # safe gather index
    new_rows = fused_row_update(
        *(c[srows] for c in state), show_sum, click_sum, g[:, :1], g[:, 1:],
        embed_rule=embed_rule, embedx_rule=embedx_rule, dim=g.shape[1] - 1, lr=lr,
        initial_g2sum=initial_g2sum, wmin=weight_bounds[0], wmax=weight_bounds[1],
        beta1=beta1, beta2=beta2, eps=eps, nonclk_coeff=nonclk_coeff,
        click_coeff=click_coeff, embedx_threshold=embedx_threshold,
        create_applies_grad=create_applies_grad)
    for col, vals in zip(state, new_rows):
        if col.numel():  # zero-width state (naive rule) has nothing to write
            _scatter_rows(col, uniq, vals, capacity)
    return state


# -- the CUDA kernel ------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_KLOCK = threading.Lock()
_KLIB: Optional[ctypes.CDLL] = None


def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; raises on failure."""
    global _KLIB
    with _KLOCK:
        if _KLIB is None:
            _KLIB = bind_kernel(ctypes.CDLL(build_cuda_library(
                "ctr_sparse_rows", os.path.join(_CSRC, "ctr_sparse_rows.cu"),
                (os.path.join(_CSRC, "ctr_rule.cuh"),
                 os.path.join(_CSRC, "async_copy.cuh")))))
        return _KLIB


def bind_kernel(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a built ``ctr_sparse_rows.cu`` (or of
    a variant of it); returns ``lib``."""
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.ctr_sparse_rows_at_launch.restype = i32
    lib.ctr_sparse_rows_at_launch.argtypes = (
        [p] * 8 + [i32] + [p] * 3 + [i64, i64] + [i32] * 6 + [f32] * 10 + [p])
    lib.ctr_rows_max_dim.restype = i32
    lib.ctr_rows_max_dim.argtypes = []
    return lib


def _ptr(t: torch.Tensor) -> Optional[int]:
    # a zero-width state column has no storage to point at; the kernel
    # never touches it (es/xs == 0)
    return t.data_ptr() if t.numel() else None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _hyper(weight_bounds, **kw):
    """The rule's scalars in the C interface's order."""
    return [ctypes.c_float(x) for x in (
        kw["lr"], kw["initial_g2sum"], weight_bounds[0], weight_bounds[1], kw["beta1"],
        kw["beta2"], kw["eps"], kw["nonclk_coeff"], kw["click_coeff"],
        kw["embedx_threshold"])]


def _rule_ids(embed_rule, embedx_rule, create_applies_grad):
    return [_RULE_IDS[embed_rule], _RULE_IDS[embedx_rule], int(bool(create_applies_grad))]


def _check_kernel_inputs(name, tensors, lib, dim) -> None:
    """What the kernel takes beyond the shapes: contiguous tensors and an
    embedx width it was built for. A column may start at any float: the
    kernel picks its pieces from the addresses."""
    for t in tensors:
        enforce(t.is_contiguous(), f"{name}: inputs must be contiguous", InvalidArgumentError)
    enforce(dim <= lib.ctr_rows_max_dim(), f"{name}: embedx dim {dim} above the kernel's "
            f"{lib.ctr_rows_max_dim()}", InvalidArgumentError)


def _launch_rows(lib, cols, deltas, **rule) -> Tuple[torch.Tensor, ...]:
    """Rows in, rows out through the in-place kernel: copies of the seven
    columns updated as rows 0 .. n-1 with the deltas of entries 0 .. n-1."""
    n = cols[0].shape[0]
    dshow, dclick, g_embed, g_embedx = deltas
    outs = tuple(c.clone() for c in cols)
    uniq = torch.arange(n, dtype=torch.int32 if n < 2**31 else torch.int64,
                        device=dshow.device)
    _launch_at(lib, outs, uniq, dshow, dclick, torch.cat([g_embed, g_embedx], 1),
               capacity=n, **rule)
    return outs


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
    kernel once on copies of the rows (counted in
    ``ctr_sparse_rows.launches``; every tensor contiguous); CPU tensors
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
    rule = dict(embed_rule=embed_rule, embedx_rule=embedx_rule, lr=lr,
                initial_g2sum=initial_g2sum, beta1=beta1, beta2=beta2, eps=eps,
                nonclk_coeff=nonclk_coeff, click_coeff=click_coeff,
                embedx_threshold=embedx_threshold, create_applies_grad=create_applies_grad)
    if show.device.type == "cpu":
        return fused_row_update(*cols, *deltas, dim=dim, wmin=weight_bounds[0],
                                wmax=weight_bounds[1], **rule)
    enforce(show.device.type == "cuda",
            f"ctr_sparse_rows: no kernel for device {show.device}",
            InvalidArgumentError)
    lib = load_kernel()
    _check_kernel_inputs("ctr_sparse_rows", cols + deltas, lib, dim)
    outs = _launch_rows(lib, cols, deltas, dim=dim, es=es, xs=xs,
                        weight_bounds=weight_bounds, **rule)
    o_show, o_click, o_ew, o_es, o_xw, o_xs, o_has = outs
    return (o_show, o_click, o_ew, o_es if es else estate, o_xw,
            o_xs if xs else xstate, o_has)


def _launch_at(lib, state, uniq, show_sum, click_sum, g, *, capacity, dim, es, xs,
               embed_rule, embedx_rule, create_applies_grad, weight_bounds, **hyper) -> None:
    n = uniq.shape[0]
    if not n:
        return
    err = lib.ctr_sparse_rows_at_launch(
        *[_ptr(t) for t in state], uniq.data_ptr(), int(uniq.dtype == torch.int64),
        show_sum.data_ptr(), click_sum.data_ptr(), g.data_ptr(), n, capacity, dim, es, xs,
        *_rule_ids(embed_rule, embedx_rule, create_applies_grad),
        *_hyper(weight_bounds, **hyper), _stream(uniq))
    if err != 0:
        raise RuntimeError(f"ctr_sparse_rows_at kernel launch failed: CUDA error {err}")
    ctr_sparse_rows.launches += 1


def ctr_sparse_rows_at(
    state: Sequence[torch.Tensor],  # show, click, ew, estate, xw, xstate, has: [C, ...]
    uniq: torch.Tensor,       # [n] int32/int64 rows, distinct where in [0, capacity)
    show_sum: torch.Tensor,   # [n] merged show deltas
    click_sum: torch.Tensor,  # [n]
    g: torch.Tensor,          # [n, 1+dim] merged grads: embed then embedx
    *,
    capacity: int,
    embed_rule: str, embedx_rule: str,
    lr: float, initial_g2sum: float, weight_bounds: Tuple[float, float],
    beta1: float, beta2: float, eps: float,
    nonclk_coeff: float, click_coeff: float, embedx_threshold: float,
    create_applies_grad: bool = True,
) -> Sequence[torch.Tensor]:
    """The per-row CTR update IN PLACE, by index: for each entry i whose
    row ``uniq[i]`` lies in [0, ``capacity``), row ``uniq[i]`` of the seven
    state columns gets the rule with the deltas of entry i; other entries
    (the merge's padding, ``capacity``) are skipped. The valid entries of
    ``uniq`` must be distinct (``merge_sparse_grads``'s are), so the
    result does not depend on their order. Returns ``state``.

    CUDA tensors launch the kernel's indexed form (one launch, counted in
    ``ctr_sparse_rows.launches``; every tensor contiguous); CPU tensors run :func:`ctr_sparse_rows_at_plain`. Equal,
    bitwise, to the JAX package's gather → ``ctr_sparse_rows`` →
    ``.at[uniq].set(mode="drop")``."""
    show, click, ew, estate, xw, xstate, has = state
    C, dim = xw.shape
    n = uniq.shape[0]
    es = rule_state_dim(embed_rule, 1)
    xs = rule_state_dim(embedx_rule, dim)
    enforce(estate.shape[1] == es and xstate.shape[1] == xs,
            f"optimizer-state width mismatch: estate {tuple(estate.shape)} vs "
            f"{es}, xstate {tuple(xstate.shape)} vs {xs}")
    shapes = [(C,), (C,), (C, 1), (C, es), (C, dim), (C, xs), (C,), (n,), (n,), (n, 1 + dim)]
    for t, shape in zip((*state, show_sum, click_sum, g), shapes):
        enforce(tuple(t.shape) == shape and t.dtype == _F32,
                f"ctr_sparse_rows_at: expected float32 {shape}, got {t.dtype} "
                f"{tuple(t.shape)}", InvalidArgumentError)
    enforce(uniq.dim() == 1 and uniq.dtype in (torch.int32, torch.int64),
            "ctr_sparse_rows_at: uniq must be an int32 or int64 vector", InvalidArgumentError)
    enforce(0 <= capacity <= C, f"ctr_sparse_rows_at: capacity {capacity} outside "
            f"[0, {C}]", InvalidArgumentError)
    tensors = (*state, uniq, show_sum, click_sum, g)
    for t in tensors:
        enforce(t.device == uniq.device, "ctr_sparse_rows_at: all tensors must be on one "
                "device", InvalidArgumentError)
    rule = dict(embed_rule=embed_rule, embedx_rule=embedx_rule, lr=lr,
                initial_g2sum=initial_g2sum, weight_bounds=weight_bounds, beta1=beta1,
                beta2=beta2, eps=eps, nonclk_coeff=nonclk_coeff, click_coeff=click_coeff,
                embedx_threshold=embedx_threshold, create_applies_grad=create_applies_grad)
    if uniq.device.type == "cpu":
        return ctr_sparse_rows_at_plain(state, uniq, show_sum, click_sum, g,
                                        capacity=capacity, **rule)
    enforce(uniq.device.type == "cuda", f"ctr_sparse_rows_at: no kernel for device "
            f"{uniq.device}", InvalidArgumentError)
    lib = load_kernel()
    _check_kernel_inputs("ctr_sparse_rows_at", tensors, lib, dim)
    _launch_at(lib, state, uniq, show_sum, click_sum, g, capacity=capacity, dim=dim, es=es,
               xs=xs, **rule)
    return state


#: kernel launches of both forms since import (or since a caller reset it to 0)
ctr_sparse_rows.launches = 0
