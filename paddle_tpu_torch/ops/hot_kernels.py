"""Kernels of the persistent hot tier: plain PyTorch versions and CUDA.

Port of ``paddle_tpu.ops.hot_kernels``. Two kernels carry the hot tier's
step on one card, a third the sharded tier's probe, and a fourth entry of
the same source makes the pass cache's merge deterministic:

- :func:`hot_probe_gather` — the bucketized linear probe of the dynamic
  key map (``ps.device_hash.DynamicDeviceKeyMap``) fused with the gather
  of ``embed_w ++ embedx_w``: keys → (rows [n] int32, −1 = missing;
  pulled [n, 1+dim], zeros when missing). Its plain version is
  ``dynamic_map_lookup`` + the sentinel-safe gather.
- :func:`hot_probe` — the same probe without the gather: rows [n] int32,
  −1 = missing. The local half of the sharded tier's step
  (``ps.hot_tier.make_sharded_hot_train_step``); its plain version is
  ``dynamic_map_lookup``.
- :func:`hot_scatter_apply` — the push: the merge_grad dedup (rows
  sorted stably, duplicates summed in occurrence order) and the per-row
  CTR rule applied to the tier state IN PLACE (the JAX package returns
  fresh arrays). Rows < 0 or ≥ C drop.
- :func:`merge_sparse_grads` — the dedup alone, in the layout of
  ``jnp.unique(size=n, fill_value=C)`` + ``segment_sum``: ``uniq`` [n]
  sorted and padded with ``capacity``, sums [n].
- :func:`_sort_rows` — the stable sort in front of both (and of
  :func:`sort_segments`, the sharded dedup's): on the card a hand-written
  LSD radix sort on the rows' own bits, bounded (``bit_length(bound)``
  bits) or full (32 bits); on the CPU ``torch.sort(stable=True)``.

On a CUDA tensor each wrapper launches its hand-written kernel
(``ops/csrc/hot_kernels.cu``, nvcc ``sm_90a``, built at first use; the
rule is ``ops/csrc/ctr_rule.cuh``, shared with ``ctr_sparse_rows``) and
counts one in ``<fn>.launches``; on a CPU tensor it runs the plain
version. There is no fallback between the two.

Summation order is part of the contract: the JAX package sums
duplicates with ``segment_sum`` in occurrence order from 0.0. The plain
merge does the same with ``index_add_`` on the CPU; the kernels walk a
stable sort of the rows, which visits each row's entries in occurrence
order, so the card's sums are bit-equal to the CPU's and reproducible
from run to run (CUDA ``index_add_`` would sum with atomics in no fixed
order).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..ps.device_hash import dynamic_map_lookup
from ._build import build_cuda_library
from .sparse_optimizer import _RULE_IDS, fused_row_update, rule_state_dim

__all__ = ["hot_probe", "hot_probe_gather", "hot_probe_gather_plain", "hot_scatter_apply",
           "hot_scatter_apply_plain", "load_hot_kernels", "merge_sparse_grads",
           "merge_sparse_grads_plain", "sort_segments"]

_COLUMNS = ("show", "click", "embed_w", "embed_state", "embedx_w",
            "embedx_state", "has_embedx")
_F32 = torch.float32

# -- plain versions ------------------------------------------------------


def merge_sparse_grads_plain(rows: torch.Tensor, grads: torch.Tensor,
                             shows: torch.Tensor, clicks: torch.Tensor,
                             capacity: int):
    """The plain merge: ``torch.unique`` + ``index_add_`` into zeros. On
    the CPU ``index_add_`` sums in occurrence order, bit-equal to the JAX
    package's ``segment_sum``; on CUDA it sums with atomics (timing
    yardstick only — the card's merge is the kernel)."""
    n = rows.shape[0]
    u, inv = torch.unique(rows, sorted=True, return_inverse=True)
    uniq = torch.full((n,), capacity, dtype=rows.dtype, device=rows.device)
    uniq[: u.shape[0]] = u
    show_sum = torch.zeros(n, dtype=shows.dtype, device=shows.device).index_add_(0, inv, shows)
    click_sum = torch.zeros(n, dtype=clicks.dtype, device=clicks.device).index_add_(0, inv, clicks)
    g = torch.zeros((n, grads.shape[1]), dtype=grads.dtype,
                    device=grads.device).index_add_(0, inv, grads)
    return uniq, show_sum, click_sum, g


def _sort_rows_plain(rows: torch.Tensor, bound: Optional[int] = None,
                     index_dtype: torch.dtype = torch.int32):
    """The sort's plain version (and its oracle): ``torch.sort(stable=True)``
    of the rows, after mapping every row outside [0, ``bound``) to
    ``bound`` when a bound is given."""
    if bound is not None:
        rows = torch.where((rows >= 0) & (rows < bound), rows, bound)
    srows, perm = torch.sort(rows, stable=True)
    return srows.to(index_dtype), perm.to(index_dtype)


def hot_probe_gather_plain(map_state: Dict[str, torch.Tensor], keys_hi: torch.Tensor,
                           keys_lo: torch.Tensor, tier_state: Dict[str, torch.Tensor],
                           *, probe_buckets: int, banks: int = 1):
    """``dynamic_map_lookup`` + the sentinel-safe gather: (rows [n]
    int32, −1 = missing; pulled [n, 1+dim], zeros for a missing key)."""
    rows = dynamic_map_lookup(map_state, keys_hi, keys_lo, probe_buckets, banks)
    C = tier_state["embed_w"].shape[0]
    safe = rows.clamp(0, C - 1).to(torch.int64)
    pulled = torch.cat([tier_state["embed_w"][safe], tier_state["embedx_w"][safe]], dim=1)
    pulled = torch.where((rows >= 0)[:, None], pulled,
                         torch.zeros((), dtype=pulled.dtype, device=pulled.device))
    return rows, pulled


def _rule_kwargs(cfg) -> dict:
    sgd = cfg.sgd
    return dict(embed_rule=cfg.embed_rule, embedx_rule=cfg.embedx_rule,
                lr=sgd.learning_rate, initial_g2sum=sgd.initial_g2sum,
                wmin=sgd.weight_bounds[0], wmax=sgd.weight_bounds[1],
                beta1=sgd.beta1, beta2=sgd.beta2, eps=sgd.ada_epsilon,
                nonclk_coeff=cfg.nonclk_coeff, click_coeff=cfg.click_coeff,
                embedx_threshold=cfg.embedx_threshold,
                create_applies_grad=cfg.create_applies_grad)


def hot_scatter_apply_plain(state: Dict[str, torch.Tensor], rows: torch.Tensor,
                            grads: torch.Tensor, shows: torch.Tensor,
                            clicks: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """The plain push: merge (``merge_sparse_grads_plain``), gather the
    touched rows, ``fused_row_update``, write them back in place. Rows
    < 0 or ≥ C drop. Returns ``state``."""
    C = state["embed_w"].shape[0]
    dim = state["embedx_w"].shape[1]
    uniq, show_sum, click_sum, g = merge_sparse_grads_plain(rows, grads, shows, clicks, C)
    valid = (uniq >= 0) & (uniq < C)
    idx = uniq[valid].to(torch.int64)
    new = fused_row_update(*(state[k][idx] for k in _COLUMNS), show_sum[valid],
                           click_sum[valid], g[valid, :1], g[valid, 1:], dim=dim,
                           **_rule_kwargs(cfg))
    for k, v in zip(_COLUMNS, new):
        if state[k].numel():  # zero-width state (naive rule) has nothing to write
            state[k][idx] = v
    return state


# -- the CUDA kernels -----------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def load_hot_kernels() -> ctypes.CDLL:
    """Build (first use) and load ``hot_kernels.cu``; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind_hot_kernels(ctypes.CDLL(build_cuda_library(
                "hot_kernels", os.path.join(_CSRC, "hot_kernels.cu"),
                (os.path.join(_CSRC, "ctr_rule.cuh"),))))
        return _LIB


def bind_hot_kernels(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a built ``hot_kernels.cu`` (or of a
    variant of it); returns ``lib``."""
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.hot_probe_gather_launch.restype = i32
    lib.hot_probe_gather_launch.argtypes = (
        [p] * 10 + [i64, i64, i32, i32, i32, i64, i32, p])
    lib.hot_probe_launch.restype = i32
    lib.hot_probe_launch.argtypes = [p] * 7 + [i64, i64, i32, i32, i32, p]
    lib.radix_sort_launch.restype = i32
    lib.radix_sort_launch.argtypes = [p, i32, i64, i32, i64, p, p, i32, p, p]
    lib.radix_sort_passes.restype = i32
    lib.radix_sort_passes.argtypes = [i32, i64]
    lib.radix_sort_work_words.restype = i64
    lib.radix_sort_work_words.argtypes = [i64, i32, i64]
    lib.segment_merge_work_words.restype = i64
    lib.segment_merge_work_words.argtypes = [i64]
    lib.hot_scatter_apply_launch.restype = i32
    lib.hot_scatter_apply_launch.argtypes = (
        [p] * 12 + [i64, i64] + [i32] * 6 + [f32] * 10 + [p])
    lib.segment_merge_launch.restype = i32
    lib.segment_merge_launch.argtypes = [p] * 7 + [i32, i64] + [p] * 3 + [i64, i32, p]
    lib.hot_kernels_max_dim.restype = i32
    lib.hot_kernels_max_dim.argtypes = []
    return lib


def _ptr(t: torch.Tensor) -> Optional[int]:
    # a zero-width state column has no storage; the kernel never reads it
    return t.data_ptr() if t.numel() else None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, tensors, dtype, device) -> None:
    for t in tensors:
        enforce(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}",
                InvalidArgumentError)
        enforce(t.device == device, f"{name}: all tensors must be on one device",
                InvalidArgumentError)
        enforce(t.is_contiguous(), f"{name}: inputs must be contiguous",
                InvalidArgumentError)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _sort_rows(rows: torch.Tensor, bound: Optional[int] = None,
               index_dtype: torch.dtype = torch.int32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of the rows [n] (int32 or int64): (sorted rows, their
    positions), both ``index_dtype``. Each row's entries stay in
    occurrence order. No host sync.

    ``bound``: bounded mode — every row outside [0, ``bound``) becomes
    ``bound`` (callers drop those rows, or pass rows already in
    [0, ``bound``]), and the key has ``bit_length(bound)`` bits. Without
    it, full mode: rows are row ids and must lie in int32's range (an
    int64 row outside it is cut to its low 32 bits on the card).

    A CPU tensor runs :func:`_sort_rows_plain`. A CUDA tensor launches
    the radix sort (``radix_sort_launch``: a count kernel and one scatter
    kernel per 8-bit digit, ``radix_sort_passes`` of them) and counts one
    in ``_sort_rows.launches``; its output is bit-identical to the plain
    version's."""
    dev = rows.device
    if dev.type == "cpu":
        return _sort_rows_plain(rows, bound, index_dtype)
    enforce(dev.type == "cuda", f"_sort_rows: no kernel for device {dev}",
            InvalidArgumentError)
    return _radix_sort(rows, bound, index_dtype)


def _radix_sort(rows, bound, index_dtype):
    n = rows.shape[0]
    enforce(rows.dim() == 1 and rows.dtype in (torch.int32, torch.int64)
            and rows.is_contiguous(), "_sort_rows: rows must be a contiguous int32 or "
            "int64 vector", InvalidArgumentError)
    enforce(index_dtype in (torch.int32, torch.int64),
            f"_sort_rows: index_dtype {index_dtype} is not int32 or int64",
            InvalidArgumentError)
    enforce(bound is None or 0 <= bound < 2**31, f"_sort_rows: bound {bound} outside "
            "[0, 2^31)", InvalidArgumentError)
    srows = torch.empty(n, dtype=index_dtype, device=rows.device)
    perm = torch.empty(n, dtype=index_dtype, device=rows.device)
    if n:
        lib = load_hot_kernels()
        full, b = int(bound is None), 0 if bound is None else int(bound)
        words = lib.radix_sort_work_words(n, full, b)
        enforce(words >= 0, f"_sort_rows: {n} rows is too many", InvalidArgumentError)
        work = torch.empty(words, dtype=torch.int32, device=rows.device)
        _raise_on(lib.radix_sort_launch(
            rows.data_ptr(), int(rows.dtype == torch.int64), n, full, b, srows.data_ptr(),
            perm.data_ptr(), int(index_dtype == torch.int64), work.data_ptr(), _stream(rows)),
            "radix_sort")
        _sort_rows.launches += 1
    return srows, perm


def _segment_ids(srows: torch.Tensor) -> torch.Tensor:
    """Segment ordinal of each sorted position: an adjacent difference and
    a cumsum (no host sync)."""
    starts = torch.ones_like(srows)
    starts[1:] = (srows[1:] != srows[:-1]).to(srows.dtype)
    return torch.cumsum(starts, 0, dtype=srows.dtype) - 1


def sort_segments(rows: torch.Tensor, bound: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sorted rows, their stable permutation, segment id of each sorted
    position), all int64: the static-shape form of ``unique``. ``bound``
    as for :func:`_sort_rows` (the sharded dedup passes its sentinel: its
    rows lie in [0, sentinel])."""
    srows, perm = _sort_rows(rows, bound, torch.int64)
    return srows, perm, _segment_ids(srows)


def merge_sparse_grads(rows: torch.Tensor, grads: torch.Tensor, shows: torch.Tensor,
                       clicks: torch.Tensor, capacity: int):
    """merge_grad (the cub sort+reduce step, heter_comm_inl.h:388):
    ``uniq`` [n] sorted distinct rows padded with ``capacity``, and the
    show/click/grad sums [n] in occurrence order from 0.0. CPU tensors run
    :func:`merge_sparse_grads_plain`; CUDA tensors sort (full mode: rows
    are row ids in int32's range) and launch the merge walk (no host
    sync; bit-equal to the CPU for the same inputs)."""
    n = rows.shape[0]
    dev = rows.device
    if dev.type == "cpu":
        return merge_sparse_grads_plain(rows, grads, shows, clicks, capacity)
    enforce(dev.type == "cuda", f"merge_sparse_grads: no kernel for device {dev}",
            InvalidArgumentError)
    width = grads.shape[1]
    enforce(tuple(grads.shape) == (n, width) and tuple(shows.shape) == (n,)
            and tuple(clicks.shape) == (n,),
            "merge_sparse_grads: rows [n], grads [n, w], shows [n], clicks [n]",
            InvalidArgumentError)
    _check("merge_sparse_grads", (grads, shows, clicks), _F32, dev)
    lib = load_hot_kernels()
    enforce(1 <= width <= 1 + lib.hot_kernels_max_dim(),
            f"merge_sparse_grads: grad width {width} outside the kernel's "
            f"[1, {1 + lib.hot_kernels_max_dim()}]", InvalidArgumentError)
    enforce(rows.dtype == torch.int64 or capacity < 2**31, f"merge_sparse_grads: "
            f"capacity {capacity} does not fit int32 rows", InvalidArgumentError)
    return _merge(lib, rows, grads, shows, clicks, capacity)


def _merge(lib, rows, grads, shows, clicks, capacity):
    n, width = grads.shape
    dev = rows.device
    uniq = torch.empty(n, dtype=rows.dtype, device=dev)
    show_sum = torch.empty(n, dtype=_F32, device=dev)
    click_sum = torch.empty(n, dtype=_F32, device=dev)
    g = torch.empty((n, width), dtype=_F32, device=dev)
    if n:
        srows, perm = _radix_sort(rows, None, torch.int32)
        tile_starts = torch.empty(lib.segment_merge_work_words(n), dtype=torch.int32,
                                  device=dev)
        _raise_on(lib.segment_merge_launch(
            srows.data_ptr(), perm.data_ptr(), shows.data_ptr(), clicks.data_ptr(),
            grads.data_ptr(), tile_starts.data_ptr(), uniq.data_ptr(),
            int(uniq.dtype == torch.int64), capacity, show_sum.data_ptr(),
            click_sum.data_ptr(), g.data_ptr(), n, width, _stream(rows)),
            "segment_merge")
        merge_sparse_grads.launches += 1
    return uniq, show_sum, click_sum, g


def _check_map(name: str, map_state: Dict[str, torch.Tensor], keys_hi: torch.Tensor,
               keys_lo: torch.Tensor, banks: int) -> None:
    """The probe kernels' inputs: int32 map arrays and keys on one device,
    a power-of-two bank count dividing the power-of-two bucket count."""
    nbuckets = map_state["row"].shape[0]
    enforce(banks >= 1 and (banks & (banks - 1)) == 0 and nbuckets % banks == 0
            and ((nbuckets // banks) & (nbuckets // banks - 1)) == 0,
            f"{name}: banks {banks} must be a power of two dividing "
            f"the power-of-two bucket count {nbuckets}", InvalidArgumentError)
    enforce(tuple(keys_hi.shape) == tuple(keys_lo.shape) and keys_lo.dim() == 1,
            f"{name}: keys_hi/keys_lo [n]", InvalidArgumentError)
    _check(name, (keys_hi, keys_lo, map_state["hi"], map_state["lo"], map_state["row"],
                  map_state["seed"]), torch.int32, keys_lo.device)


def _map_ptrs(map_state: Dict[str, torch.Tensor]):
    return tuple(map_state[k].data_ptr() for k in ("hi", "lo", "row", "seed"))


def hot_probe(map_state: Dict[str, torch.Tensor], keys_hi: torch.Tensor,
              keys_lo: torch.Tensor, *, probe_buckets: int, banks: int = 1) -> torch.Tensor:
    """Probe only: keys → rows [n] int32, −1 = missing (the sharded tier's
    local half). ``map_state`` and the keys as for
    :func:`hot_probe_gather`. CPU tensors run ``dynamic_map_lookup``;
    CUDA tensors launch the kernel, bit-identical to it."""
    dev = keys_lo.device
    if dev.type == "cpu":
        return dynamic_map_lookup(map_state, keys_hi, keys_lo, probe_buckets, banks)
    enforce(dev.type == "cuda", f"hot_probe: no kernel for device {dev}",
            InvalidArgumentError)
    _check_map("hot_probe", map_state, keys_hi, keys_lo, banks)
    n = keys_lo.shape[0]
    nbuckets, bslots = map_state["row"].shape
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _raise_on(load_hot_kernels().hot_probe_launch(
            *_map_ptrs(map_state), keys_hi.data_ptr(), keys_lo.data_ptr(),
            rows.data_ptr(), n, nbuckets, bslots, int(probe_buckets), int(banks),
            _stream(keys_lo)), "hot_probe")
        hot_probe.launches += 1
    return rows


def hot_probe_gather(map_state: Dict[str, torch.Tensor], keys_hi: torch.Tensor,
                     keys_lo: torch.Tensor, tier_state: Dict[str, torch.Tensor],
                     *, probe_buckets: int, banks: int = 1):
    """Fused probe+gather: keys → (rows [n] int32, −1 = missing; pulled
    [n, 1+dim] f32, zeros for a missing key). ``map_state`` holds
    ``hi``/``lo``/``row`` int32 [nbuckets, slots] and the 0-dim int32
    ``seed`` (uint32 bit patterns); on CUDA the keys are int32 [n] bit
    patterns too. Bit-identical to :func:`hot_probe_gather_plain`."""
    dev = keys_lo.device
    if dev.type == "cpu":
        return hot_probe_gather_plain(map_state, keys_hi, keys_lo, tier_state,
                                      probe_buckets=probe_buckets, banks=banks)
    enforce(dev.type == "cuda", f"hot_probe_gather: no kernel for device {dev}",
            InvalidArgumentError)
    _check_map("hot_probe_gather", map_state, keys_hi, keys_lo, banks)
    n = keys_lo.shape[0]
    nbuckets, bslots = map_state["row"].shape
    ew, xw = tier_state["embed_w"], tier_state["embedx_w"]
    C, dim = xw.shape
    enforce(tuple(ew.shape) == (C, 1), "hot_probe_gather: embed_w [C, 1]",
            InvalidArgumentError)
    _check("hot_probe_gather", (ew, xw), _F32, dev)
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    pulled = torch.empty((n, 1 + dim), dtype=_F32, device=dev)
    if n:
        _raise_on(load_hot_kernels().hot_probe_gather_launch(
            *_map_ptrs(map_state), keys_hi.data_ptr(), keys_lo.data_ptr(), ew.data_ptr(),
            xw.data_ptr(), rows.data_ptr(), pulled.data_ptr(), n, nbuckets, bslots,
            int(probe_buckets), int(banks), C, dim, _stream(keys_lo)),
            "hot_probe_gather")
        hot_probe_gather.launches += 1
    return rows, pulled


def hot_scatter_apply(state: Dict[str, torch.Tensor], rows: torch.Tensor,
                      grads: torch.Tensor, shows: torch.Tensor, clicks: torch.Tensor,
                      cfg) -> Dict[str, torch.Tensor]:
    """Fused push, in place: merge the batch's rows (stable sort,
    occurrence-order sums) and apply the per-row CTR rule of ``cfg`` (a
    ``CacheConfig``) to each touched row of ``state``; rows < 0 or ≥ C
    drop. Returns ``state``. Bit-identical to
    :func:`hot_scatter_apply_plain` and to ``cache_push_sparse``."""
    dev = rows.device
    C = state["embed_w"].shape[0]
    dim = state["embedx_w"].shape[1]
    es = rule_state_dim(cfg.embed_rule, 1)
    xs = rule_state_dim(cfg.embedx_rule, dim)
    enforce(state["embed_state"].shape[1] == es and state["embedx_state"].shape[1] == xs,
            f"optimizer-state width mismatch: embed_state "
            f"{tuple(state['embed_state'].shape)} vs {es}, embedx_state "
            f"{tuple(state['embedx_state'].shape)} vs {xs}")
    if dev.type == "cpu":
        return hot_scatter_apply_plain(state, rows, grads, shows, clicks, cfg)
    enforce(dev.type == "cuda", f"hot_scatter_apply: no kernel for device {dev}",
            InvalidArgumentError)
    n = rows.shape[0]
    enforce(tuple(grads.shape) == (n, 1 + dim) and tuple(shows.shape) == (n,)
            and tuple(clicks.shape) == (n,),
            "hot_scatter_apply: rows [n], grads [n, 1+dim], shows [n], clicks [n]",
            InvalidArgumentError)
    lib = load_hot_kernels()
    enforce(dim <= lib.hot_kernels_max_dim(),
            f"hot_scatter_apply: embedx dim {dim} above the kernel's "
            f"{lib.hot_kernels_max_dim()}", InvalidArgumentError)
    _check("hot_scatter_apply", (grads, shows, clicks, *(state[k] for k in _COLUMNS)),
           _F32, dev)
    _scatter_apply(lib, state, rows, grads, shows, clicks, cfg)
    return state


def _scatter_apply(lib, state, rows, grads, shows, clicks, cfg) -> None:
    n = rows.shape[0]
    if not n:
        return
    C = state["embed_w"].shape[0]
    dim = state["embedx_w"].shape[1]
    kw = _rule_kwargs(cfg)
    srows, perm = _radix_sort(rows, C, torch.int32)
    _raise_on(lib.hot_scatter_apply_launch(
        srows.data_ptr(), perm.data_ptr(), shows.data_ptr(), clicks.data_ptr(),
        grads.data_ptr(), *(_ptr(state[k]) for k in _COLUMNS), n, C, dim,
        state["embed_state"].shape[1], state["embedx_state"].shape[1],
        _RULE_IDS[kw["embed_rule"]], _RULE_IDS[kw["embedx_rule"]],
        int(bool(kw["create_applies_grad"])),
        *[ctypes.c_float(kw[k]) for k in (
            "lr", "initial_g2sum", "wmin", "wmax", "beta1", "beta2", "eps",
            "nonclk_coeff", "click_coeff", "embedx_threshold")],
        _stream(rows)), "hot_scatter_apply")
    hot_scatter_apply.launches += 1


#: kernel launches since import (or since a caller reset them to 0)
merge_sparse_grads.launches = 0
hot_probe.launches = 0
hot_probe_gather.launches = 0
hot_scatter_apply.launches = 0
_sort_rows.launches = 0
