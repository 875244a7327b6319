"""Sharded embedding serving over a K-shard mesh.

Port of ``paddle_tpu.ps.sharded_cache`` (HeterComm's multi-GPU sharded
KV serving: ``split_input_to_shard``, ``walk_to_dest``, ``pull_sparse``,
``push_sparse``). Shard k owns the row block ``[k·C/K, (k+1)·C/K)`` of
the cache or tier state; rows are GLOBAL ids everywhere, and a row's
owner is ``row // (C/K)``. The JAX package runs the per-rank body inside
``shard_map``; here per-rank functions (which take the rank index and K
where the JAX code calls ``lax.axis_index`` and ``psum(1)``) alternate
with collectives, and no collective sits inside a per-rank function, so
the two kinds of mesh differ only in the collectives and in what a
caller holds:

- on a mesh of logical ranks (``core.mesh.make_mesh``) the caller holds
  every rank: the state is one set of contiguous ``[C, ·]`` columns
  (``shard_state`` gives the K blocks as views, so owner-side updates
  land in place), the functions take lists of the K ranks' tensors in
  rank order, and the collectives are ``ops.collectives``' list form;
- on a process mesh (``core.mesh.make_process_mesh``) a process holds
  its own rank: its state is its ``C/K``-row block alone, the functions
  take its own tensors (``axis=`` names the mesh axis, under
  ``ops.collectives.run_ranks``), and the collectives are the axis form
  over that axis (``torch.distributed``). The key map stays replicated:
  every process builds the same map from the same keys.

Two routings, as in the JAX package:

- **key-routed all-to-all** (``routed_cache_pull`` / ``routed_cache_push``):
  each rank dedups its batch slice (``routed_dedup``), partitions the
  unique rows by owner into fixed-capacity buckets ``[K, cap]``, and one
  ``all_to_all`` ships each owner the rows it holds; the owner serves or
  updates O(batch/K) rows. Buckets carry a slack factor and an overflow
  counter reports any dropped entry (``check_route_overflow``).
- **gathered** (``sharded_cache_pull`` / ``sharded_cache_push``):
  ``all_gather`` the whole batch to every shard, each shard does the
  whole batch's work on the rows it owns.

Static shapes and no host sync inside a step, as in the JAX package:
``unique(size=m, fill_value=sentinel)`` is a stable sort, an adjacent
difference and a cumsum (``ops.hot_kernels.sort_segments``);
``mode="drop"`` scatters send out-of-range entries to a trash row that is
cut off afterwards; no boolean-mask indexing and no ``.item()``. Sums
are deterministic: the routed push pre-merges duplicates through
``merge_sparse_grads`` (on the card a stable sort and the merge kernel,
occurrence order from 0.0, the JAX package's ``segment_sum``), and the
owner-side push sums in the order the ranks' buckets arrive.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.enforce import InvalidArgumentError, enforce
from ..core.mesh import Mesh, ps_shard_count
from ..models.ctr import _check_device, _make_loss_fn
from ..ops import collectives
from ..ops.hot_kernels import merge_sparse_grads, sort_segments
from .device_hash import device_hash_lookup
from .embedding_cache import CacheConfig, cache_pull, cache_push, resolve_push_mode

__all__ = [
    "check_route_overflow",
    "make_sharded_ctr_train_step",
    "make_sharded_ctr_train_step_from_keys",
    "route_bucket_capacity",
    "routed_cache_pull",
    "routed_cache_push",
    "routed_dedup",
    "select_routing",
    "shard_spread_rows",
    "shard_state",
    "shard_unspread_rows",
    "sharded_cache_pull",
    "sharded_cache_push",
]

State = Dict[str, torch.Tensor]
_I64 = torch.int64


class _Ranks:
    """The ranks of a K-shard path that the caller holds (``ranks``, in rank
    order) and their exchange: the list form over all K on a mesh of
    logical ranks (``axis`` None), the axis form over ``axis`` for the one
    rank a process holds. Every method takes and returns one entry per
    held rank."""

    def __init__(self, K: int, ranks: Sequence[int], axis: Optional[str] = None) -> None:
        self.K, self.ranks, self.axis = K, list(ranks), axis

    @classmethod
    def of(cls, n: int, axis: Optional[str]) -> "_Ranks":
        """All ``n`` ranks (``axis`` None), or this process's rank over ``axis``."""
        if axis is None:
            return cls(n, range(n))
        return cls(collectives.axis_size(axis), [collectives.axis_index(axis)], axis)

    def all_to_all(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.axis is None:
            return collectives.all_to_all(xs)
        return [collectives.all_to_all(xs[0], self.axis, 0, 0)]

    def all_gather(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.axis is None:
            return collectives.all_gather(xs)
        return [collectives.all_gather(xs[0], self.axis, 0)]

    def reduce_scatter(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.axis is None:
            return collectives.reduce_scatter(xs)
        return [collectives.psum_scatter(xs[0], self.axis, 0)]

    def mean(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """The ranks' mean (the sum divided by K), one tensor."""
        if self.axis is None:
            return collectives.all_reduce(xs, collectives.ReduceOp.AVG)[0]
        return collectives.psum(xs[0], self.axis) / self.K

    def sum(self, xs: List[torch.Tensor]) -> torch.Tensor:
        if self.axis is None:
            return collectives.all_reduce(xs)[0]
        return collectives.psum(xs[0], self.axis)


def _held(x, axis: Optional[str]) -> list:
    """A per-rank argument as the list of held ranks' entries: the list
    itself, or [x] for a process's own (``axis`` set)."""
    return list(x) if axis is None else [x]


def shard_state(state: State, K: int) -> List[State]:
    """The K shards of a row-sharded state: shard k is every column's row
    block ``[k·C/K, (k+1)·C/K)``, a contiguous view (updates write
    through to ``state``)."""
    C = state["embed_w"].shape[0]
    enforce(C % K == 0, f"capacity {C} does not divide over {K} shards",
            InvalidArgumentError)
    b = C // K
    return [{k: v[r * b:(r + 1) * b] for k, v in state.items()} for r in range(K)]


# ---------------------------------------------------------------------------
# key-routed all-to-all serving (split_input_to_shard / walk_to_dest)
# ---------------------------------------------------------------------------


def route_bucket_capacity(m: int, K: int, cap_factor: float = 2.0) -> int:
    """Static per-destination bucket capacity for routing ``m`` local rows
    over ``K`` shards: ``cap_factor`` slack over the mean m/K, +8 absolute
    slack, rounded up to a multiple of 8, at most m (the JAX package's
    rule, so both route the same batches into the same buckets)."""
    cap = math.ceil(cap_factor * m / K) + 8
    cap = (cap + 7) // 8 * 8
    return min(m, cap)


def check_route_overflow(overflow) -> None:
    """Raise if a routed pull/push reported dropped entries (bucket
    capacity exceeded). Reads the count on the host: call it at the
    cadence losses are synced (the trainer does at the end of a pass)."""
    n = int(overflow)
    enforce(n == 0,
            f"sharded-cache routing overflow: {n} row(s) exceeded the per-shard "
            "bucket capacity and were dropped. Raise cap_factor on the sharded "
            "step (or check shard_spread_rows placement).")


def _route_to_buckets(owner: torch.Tensor, K: int, cap: int, payloads: Sequence[torch.Tensor],
                      fills: Sequence, presorted: bool = False):
    """Partition ``m`` local entries into per-destination buckets, stable.

    owner: [m] int64 in [0, K]; K marks entries that are never routed.
    Returns (buckets [K, cap, ...] per payload, src [K, cap] int64 with m
    as padding, overflow count int32). Entries keep their relative order
    inside a bucket. ``presorted``: owner is already non-decreasing (true
    after ``routed_dedup``: block ownership is monotone in the row id)."""
    m = owner.shape[0]
    dev = owner.device
    if presorted:
        order, so = torch.arange(m, device=dev), owner
    else:
        so, order = torch.sort(owner, stable=True)
    start = torch.searchsorted(so, torch.arange(K + 1, dtype=so.dtype, device=dev))
    pos = torch.arange(m, device=dev) - start[so]  # rank within the bucket
    overflow = ((so < K) & (pos >= cap)).sum().to(torch.int32)
    # mode="drop": out-of-range (owner K, pos >= cap) entries go to a
    # trash slot past the K·cap real ones; real slots are hit at most once
    slot = torch.where((so < K) & (pos < cap), so * cap + pos, K * cap)
    buckets = []
    for p, fill in zip(payloads, fills):
        b = torch.full((K * cap + 1,) + tuple(p.shape[1:]), fill, dtype=p.dtype, device=dev)
        b.index_copy_(0, slot, p[order])
        buckets.append(b[:K * cap].reshape((K, cap) + tuple(p.shape[1:])))
    src = torch.full((K * cap + 1,), m, dtype=_I64, device=dev)
    src.index_copy_(0, slot, order)
    return buckets, src[:K * cap].reshape(K, cap), overflow


def _canonical_rows(rows: torch.Tensor, sentinel: int) -> torch.Tensor:
    """int64 rows with negative miss markers mapped to the out-of-range
    sentinel (keeps the sorted-unique output owner-ordered)."""
    rows = rows.to(_I64)
    return torch.where(rows < 0, torch.full_like(rows, sentinel), rows)


def routed_dedup(rows: torch.Tensor, sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local merge's dedup half, shared by routed pull and push:
    (sorted unique rows padded with ``sentinel`` [m], inverse positions
    [m]) — ``jnp.unique(size=m, fill_value=sentinel, return_inverse=True)``.
    Compute once per step when pull and push see the same rows.
    Canonicalizes internally (idempotent)."""
    rows = _canonical_rows(rows, sentinel)
    srows, perm, seg = sort_segments(rows, sentinel)
    uniq = torch.full_like(rows, sentinel).scatter_(0, seg, srows)
    inv = torch.empty_like(seg).scatter_(0, perm, seg)
    return uniq, inv


def _owner_of(rows: torch.Tensor, shard_rows: int, K: int) -> torch.Tensor:
    """Owner shard of each global row id; K for sentinel/out-of-range."""
    valid = (rows >= 0) & (rows < shard_rows * K)
    return torch.where(valid, rows // shard_rows, K).to(_I64)


def _pull_request(rows, K, shard_rows, cap_factor, pre_dedup, dedup):
    """Rank-local: (request buckets [K, cap], src [K, cap], inverse or
    None, overflow) for this rank's [m] global rows."""
    m = rows.shape[0]
    rows = _canonical_rows(rows, shard_rows * K)
    inv = None
    if pre_dedup:
        lookup, inv = dedup if dedup is not None else routed_dedup(rows, shard_rows * K)
    else:
        lookup = rows
    cap = route_bucket_capacity(m, K, cap_factor)
    (breq,), src, overflow = _route_to_buckets(_owner_of(lookup, shard_rows, K), K, cap,
                                               [lookup], [0], presorted=pre_dedup)
    return breq, src, inv, overflow


def _pull_serve(state: State, req: torch.Tensor, rank: int) -> torch.Tensor:
    """Owner-local: the values of the [K, cap] rows this shard serves."""
    shard_rows = state["embed_w"].shape[0]
    K, cap = req.shape
    loc = (req.reshape(-1) - rank * shard_rows).clamp(0, shard_rows - 1)
    return cache_pull(state, loc).reshape(K, cap, -1)


def _pull_reply(back: torch.Tensor, src: torch.Tensor, inv: Optional[torch.Tensor],
                m: int) -> torch.Tensor:
    """Rank-local: the answers back in batch order; the padding index m
    is written many times and cut off."""
    K, cap, D = back.shape
    uvals = torch.zeros((m + 1, D), dtype=back.dtype, device=back.device)
    uvals.index_copy_(0, src.reshape(-1), back.reshape(K * cap, D))
    uvals = uvals[:m]
    return uvals[inv] if inv is not None else uvals


def _check_dedup(dedup, pre_dedup: bool) -> None:
    enforce(dedup is None or pre_dedup,
            "dedup= requires pre_dedup=True (raw routing ignores it)")


def routed_cache_pull(shards, rows, cap_factor: float = 2.0, pre_dedup: bool = True,
                      dedup=None, axis: Optional[str] = None):
    """Key-routed pull: each rank's [m] global rows → ([m, 1+dim] values
    per rank, overflow count summed over the ranks). Local dedup, split
    to shard, all_to_all request, owner gathers, all_to_all reply,
    scatter back to batch order. Sentinel rows (no owner) pull zeros.
    ``dedup``: a precomputed ``routed_dedup`` pair per rank.

    Lists of the K ranks' shards, rows and dedup pairs on a mesh of
    logical ranks; with ``axis`` (a process mesh's rank under
    ``run_ranks``) this rank's own block, rows and pair, and its own
    values back."""
    _check_dedup(dedup, pre_dedup)
    rk = _Ranks.of(len(shards), axis)
    outs, ov = _routed_pull(rk, _held(shards, axis), _held(rows, axis), cap_factor,
                            pre_dedup, None if dedup is None else _held(dedup, axis))
    return (outs if axis is None else outs[0]), ov


def _routed_pull(rk: _Ranks, shards, rows, cap_factor, pre_dedup, dedup):
    K = rk.K
    shard_rows = shards[0]["embed_w"].shape[0]
    reqs = [_pull_request(rows[i], K, shard_rows, cap_factor, pre_dedup,
                          None if dedup is None else dedup[i]) for i in range(len(rk.ranks))]
    served = rk.all_to_all([q[0] for q in reqs])
    vals = [_pull_serve(shards[i], served[i], r) for i, r in enumerate(rk.ranks)]
    back = rk.all_to_all(vals)
    outs = [_pull_reply(back[i], q[1], q[2], rows[i].shape[0]) for i, q in enumerate(reqs)]
    return outs, rk.sum([q[3] for q in reqs])


def _push_request(rows, grads, shows, clicks, K, shard_rows, cap_factor, pre_dedup, dedup):
    """Rank-local: (row buckets [K, cap], payload buckets [K, cap, 3+dim]
    = grads ++ show ++ click, overflow). With ``pre_dedup`` each row's
    entries are merged first (one wire entry per row): the sums are
    ``segment_sum(payload, inv)``, occurrence order from 0.0."""
    m = rows.shape[0]
    C_total = shard_rows * K
    rows = _canonical_rows(rows, C_total)
    if pre_dedup:
        rows, inv = dedup if dedup is not None else routed_dedup(rows, C_total)
        # merged over the inverse positions 0..u-1: sum j is segment j's
        _, shows, clicks, grads = merge_sparse_grads(inv, grads, shows, clicks, m)
    payload = torch.cat([grads, shows[:, None], clicks[:, None]], dim=1)
    cap = route_bucket_capacity(m, K, cap_factor)
    (brow, bpay), _, overflow = _route_to_buckets(
        _owner_of(rows, shard_rows, K), K, cap, [rows, payload], [C_total, 0.0],
        presorted=pre_dedup)
    return brow, bpay, overflow


def _owner_push(state: State, rows: torch.Tensor, grads: torch.Tensor, shows: torch.Tensor,
                clicks: torch.Tensor, rank: int, cfg: CacheConfig, push_fn) -> None:
    """Owner-local: apply the rows this shard owns, in place; the others
    become the dropped sentinel."""
    shard_rows = state["embed_w"].shape[0]
    loc = rows.to(_I64) - rank * shard_rows
    loc = torch.where((loc >= 0) & (loc < shard_rows), loc, shard_rows)
    (push_fn or cache_push)(state, loc, grads.contiguous(), shows.contiguous(),
                            clicks.contiguous(), cfg)


def routed_cache_push(shards, rows, grads, shows, clicks, cfg: CacheConfig,
                      cap_factor: float = 2.0, pre_dedup: bool = True, dedup=None,
                      push_fn: Optional[Callable] = None,
                      axis: Optional[str] = None) -> torch.Tensor:
    """Key-routed push: local merge_grad, split to shard, one all_to_all
    pair ships each owner only its rows and payloads, the owner applies
    the batch-scaled push (``push_fn``, default ``cache_push``; the hot
    tier passes ``hot_scatter_apply``) to its shard IN PLACE. Returns the
    overflow count summed over the ranks. ``axis``: see
    :func:`routed_cache_pull`."""
    _check_dedup(dedup, pre_dedup)
    rk = _Ranks.of(len(shards), axis)
    return _routed_push(rk, *(_held(x, axis) for x in (shards, rows, grads, shows, clicks)),
                        cfg, cap_factor, pre_dedup,
                        None if dedup is None else _held(dedup, axis), push_fn)


def _routed_push(rk: _Ranks, shards, rows, grads, shows, clicks, cfg, cap_factor, pre_dedup,
                 dedup, push_fn):
    K = rk.K
    shard_rows = shards[0]["embed_w"].shape[0]
    reqs = [_push_request(rows[i], grads[i], shows[i], clicks[i], K, shard_rows, cap_factor,
                          pre_dedup, None if dedup is None else dedup[i])
            for i in range(len(rk.ranks))]
    rrow = rk.all_to_all([q[0] for q in reqs])
    rpay = rk.all_to_all([q[1] for q in reqs])
    for i, r in enumerate(rk.ranks):
        pay = rpay[i].reshape(-1, rpay[i].shape[-1])
        _owner_push(shards[i], rrow[i].reshape(-1), pay[:, :-2], pay[:, -2], pay[:, -1], r,
                    cfg, push_fn)
    return rk.sum([q[2] for q in reqs])


def sharded_cache_pull(shards, rows, axis: Optional[str] = None):
    """Gathered pull: every shard gathers the values of the whole batch's
    rows it owns (zeros elsewhere), and a reduce-scatter assembles each
    rank's slice (each row has exactly one owner, so the sum is exact).
    ``axis``: see :func:`routed_cache_pull`."""
    rk = _Ranks.of(len(shards), axis)
    outs = _gathered_pull(rk, _held(shards, axis), _held(rows, axis))
    return outs if axis is None else outs[0]


def _gathered_pull(rk: _Ranks, shards, rows):
    shard_rows = shards[0]["embed_w"].shape[0]
    rows_all = rk.all_gather(list(rows))
    vals = []
    for i, r in enumerate(rk.ranks):
        loc = rows_all[i].to(_I64) - r * shard_rows
        own = (loc >= 0) & (loc < shard_rows)
        v = cache_pull(shards[i], loc.clamp(0, shard_rows - 1))
        vals.append(torch.where(own[:, None], v, torch.zeros((), dtype=v.dtype,
                                                              device=v.device)))
    return rk.reduce_scatter(vals)


def sharded_cache_push(shards, rows, grads, shows, clicks, cfg: CacheConfig,
                       push_fn: Optional[Callable] = None, axis: Optional[str] = None) -> None:
    """Gathered push: every shard runs the push on the whole gathered
    batch, rows it does not own mapped to the dropped sentinel; in place.
    ``push_fn``: see :func:`routed_cache_push`; ``axis``: see
    :func:`routed_cache_pull`."""
    rk = _Ranks.of(len(shards), axis)
    _gathered_push(rk, *(_held(x, axis) for x in (shards, rows, grads, shows, clicks)), cfg,
                   push_fn)


def _gathered_push(rk: _Ranks, shards, rows, grads, shows, clicks, cfg, push_fn):
    gathered = [rk.all_gather(list(x)) for x in (rows, grads, shows, clicks)]
    for i, r in enumerate(rk.ranks):
        _owner_push(shards[i], *(g[i] for g in gathered), r, cfg, push_fn)


def shard_spread_rows(rows: np.ndarray, capacity: int, n_shards: int) -> np.ndarray:
    """Host-side: permute dense row ids round-robin across the block
    partition so shard s owns rows {r : r % n_shards == s} at block offset
    r // n_shards (calc_shard_index's ``key % total_gpu`` placement as a
    permutation). Requires capacity % n_shards == 0."""
    block = capacity // n_shards
    return (rows % n_shards) * block + rows // n_shards


def shard_unspread_rows(rows: np.ndarray, capacity: int, n_shards: int) -> np.ndarray:
    """Inverse of shard_spread_rows."""
    block = capacity // n_shards
    return (rows % block) * n_shards + rows // block


def select_routing(m_local: int, shard_rows: int, K: int, push_mode: str) -> Tuple[str, str]:
    """``(pull_routing, push_routing)`` for ``routing="auto"``, the JAX
    package's decision rule: never mix sides (the routing sort is shared
    by routed pull and push, the gathered forms share nothing with it);
    K ≥ 4 → ``("alltoall", "alltoall")``; K < 4 → ``("allgather",
    "allgather")``. ``m_local`` and ``shard_rows`` are accepted for a
    later recalibration and unused.

    When the job spans processes (``distributed.collective.
    get_world_size() > 1``) a dense push routes at every K
    (``("alltoall", "alltoall")``), the JAX rule's branch for meshes that
    span processes (its cross-process sweep measured the gathered form's
    whole-batch volume losing once a process boundary is in the path; the
    sparse push keeps the K ≥ 4 threshold).

    The rule was calibrated on the JAX package's CPU meshes and has not
    been measured on the card."""
    from ..distributed.collective import get_world_size

    push_mode = resolve_push_mode(push_mode)
    enforce(push_mode in ("dense", "sparse"),
            f"push_mode must be 'dense' or 'sparse', got {push_mode!r}")
    del m_local, shard_rows
    if get_world_size() > 1 and push_mode == "dense":
        return "alltoall", "alltoall"
    if K < 4:
        return "allgather", "allgather"
    return "alltoall", "alltoall"


def _resolve_routing(routing, m_local: int, shard_rows: int, K: int,
                     push_mode: str) -> Tuple[str, str]:
    """``routing``: "auto" → :func:`select_routing`, a single mode → both
    sides, a (pull, push) pair → itself."""
    if routing == "auto":
        return select_routing(m_local, shard_rows, K, push_mode)
    if isinstance(routing, str):
        return routing, routing
    pull, push = routing
    return pull, push


def _check_routing_arg(routing) -> None:
    ok = routing in ("alltoall", "allgather", "auto") or (
        isinstance(routing, tuple) and len(routing) == 2
        and all(r in ("alltoall", "allgather") for r in routing))
    enforce(ok, "routing must be 'alltoall', 'allgather', 'auto' or a "
            f"(pull, push) pair of the former two, got {routing!r}")


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------


def _split_batch(x: torch.Tensor, K: int) -> List[torch.Tensor]:
    """The K equal slices of a global batch along its leading dimension
    (the JAX package's ``P(axis)`` input layout); B % K must be 0."""
    enforce(x.shape[0] % K == 0,
            f"batch of {x.shape[0]} does not split over {K} shards", InvalidArgumentError)
    return list(x.split(x.shape[0] // K))


def _local_grads(model: nn.Module, params, emb: torch.Tensor, dense_x: torch.Tensor,
                 labels: torch.Tensor):
    """Rank-local forward and backward: (mean BCE loss, dense grads,
    embedding grads) of this rank's slice."""
    emb = emb.detach().requires_grad_(True)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = _make_loss_fn(model, dense_x, labels, None)(leaves, emb)
    *g, emb_grad = torch.autograd.grad(loss, [*leaves.values(), emb])
    return loss.detach(), dict(zip(leaves, g)), emb_grad


def _sharded_step_body(model, optimizer, cache_cfg, rk: _Ranks, params, opt_state, shards,
                       flat_rows, B, S, dense_x, labels, routing="auto", cap_factor=2.0,
                       pre_dedup=True, push_fn=None):
    """The sharded CTR step over the held ranks ``rk``: sharded pull, each
    rank's forward/backward on its slice, dense grads and loss averaged
    over the ranks (the Reducer role), one dense update (params are
    replicated), sharded push. ``shards``/``flat_rows``/``dense_x``/
    ``labels``: one entry a held rank; rows are GLOBAL row ids, sentinel
    rows (≥ the global capacity) pull zeros and drop their pushes. Returns
    (params, opt_state, loss, overflow); the shards are updated in place."""
    K, n = rk.K, len(rk.ranks)
    shard_rows = shards[0]["embed_w"].shape[0]
    C_total = shard_rows * K
    pull_r, push_r = _resolve_routing(routing, flat_rows[0].shape[0], shard_rows, K,
                                      cache_cfg.push_mode)
    dedup = None
    if pre_dedup and "alltoall" in (pull_r, push_r):
        # pull and push see the SAME rows: sort once, use twice
        flat_rows = [_canonical_rows(r, C_total) for r in flat_rows]
        dedup = [routed_dedup(r, C_total) for r in flat_rows]
    zero = torch.zeros((), dtype=torch.int32, device=flat_rows[0].device)
    if pull_r == "alltoall":
        emb, ov_pull = _routed_pull(rk, shards, flat_rows, cap_factor, pre_dedup, dedup)
    else:
        emb, ov_pull = _gathered_pull(rk, shards, flat_rows), zero

    local = [_local_grads(model, params, emb[i].reshape(B, S, -1), dense_x[i], labels[i])
             for i in range(n)]
    loss = rk.mean([lo for lo, _, _ in local])
    grads = {k: rk.mean([g[k] for _, g, _ in local]) for k in params}
    # local mean → global mean: 1/K on the embedding grads (exact for a
    # power-of-two K) so the push matches the unsharded step's
    emb_grads = [(eg / K).reshape(B * S, -1) for _, _, eg in local]
    new_params, new_opt = optimizer.update(grads, opt_state, params)

    shows = [torch.ones(B * S, dtype=torch.float32, device=emb_grads[0].device)] * n
    clicks = [torch.repeat_interleave(lab.to(torch.float32), S) for lab in labels]
    with torch.no_grad():
        if push_r == "alltoall":
            ov_push = _routed_push(rk, shards, flat_rows, emb_grads, shows, clicks, cache_cfg,
                                   cap_factor, pre_dedup, dedup, push_fn)
        else:
            _gathered_push(rk, shards, flat_rows, emb_grads, shows, clicks, cache_cfg, push_fn)
            ov_push = zero
    return new_params, new_opt, loss, ov_pull + ov_push


def _make_sharded_step(model: nn.Module, optimizer, cache_cfg: CacheConfig, mesh: Mesh,
                       axis: str, routing, cap_factor: float, pre_dedup: bool,
                       rows_of: Callable, push_fn: Optional[Callable] = None) -> Callable:
    """The step of the sharded factories: ``rows_of(C_total, ranks, K,
    *inputs)`` gives the held ranks' flat global rows of the batch
    ``inputs`` (its last entry is [B, S], the GLOBAL batch); the rest is
    :func:`_sharded_step_body`. step(params, opt_state, state, *inputs,
    dense_x, labels) → (params, opt_state, state, loss, overflow). On a
    mesh of logical ranks ``state`` is the whole ``[C, ·]`` state, cut by
    ``shard_state``; on a process mesh it is this process's ``C/K``-row
    block, and the step runs its rank under ``run_ranks``."""
    _check_routing_arg(routing)
    K = ps_shard_count(mesh, axis)

    def body(rk, params, opt_state, shards, inputs, dense_x, labels):
        B, S = inputs[-1].shape
        C_total = shards[0]["embed_w"].shape[0] * K
        pick = lambda x: [_split_batch(x, K)[r] for r in rk.ranks]
        return _sharded_step_body(
            model, optimizer, cache_cfg, rk, params, opt_state, shards,
            rows_of(C_total, rk.ranks, K, *inputs), B // K, S, pick(dense_x), pick(labels),
            routing, cap_factor, pre_dedup, push_fn)

    def step(params, opt_state, state, *args):
        *inputs, dense_x, labels = args
        _check_device(inputs[-1], mesh.device, "the batch")
        if mesh.is_process_mesh:
            new_p, new_o, loss, ov = collectives.run_ranks(mesh, lambda r: body(
                _Ranks(K, [r], axis), params, opt_state, [state], inputs, dense_x, labels))[0]
        else:
            new_p, new_o, loss, ov = body(_Ranks(K, range(K)), params, opt_state,
                                          shard_state(state, K), inputs, dense_x, labels)
        return new_p, new_o, state, loss, ov

    return step


def _keyed_rows(lookup: Callable, slot_hi: torch.Tensor) -> Callable:
    """``rows_of`` for the key-fed steps: each held rank probes its slice of
    ``keys_lo`` [B, S] (slot-tagged: the hi half is the column's
    ``slot_hi``) with ``lookup(map_state, hi, lo)`` (rows, −1 = missing);
    a missing key becomes the sentinel, the global capacity (no owner)."""

    def rows_of(C_total, ranks, K, map_state, keys_lo):
        B, S = keys_lo.shape
        hi = slot_hi[None, :].expand(B // K, S).reshape(-1)
        slices = _split_batch(keys_lo, K)
        rows = []
        for r in ranks:
            got = lookup(map_state, hi, slices[r].reshape(-1))
            rows.append(torch.where(got >= 0, got, C_total))
        return rows

    return rows_of


def make_sharded_ctr_train_step(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                                mesh: Mesh, axis: str = "ps", routing="auto",
                                cap_factor: float = 2.0, pre_dedup: bool = True) -> Callable:
    """The GPUPS step with the batch split over ``axis`` and the cache
    row-sharded over the same shards (``mesh.device`` holds them all on a
    mesh of logical ranks; on a process mesh each process passes its own
    ``C/K``-row block as ``cache_state`` and the global batch):

    step(params, opt_state, cache_state, rows [B, S], dense_x, labels)
      → (params, opt_state, cache_state, loss, overflow)

    ``rows`` are GLOBAL spread row ids (``HbmEmbeddingCache(mesh=...)
    .lookup``); ``cache_state`` is updated in place and returned.
    ``routing``: "alltoall", "allgather", a ``(pull, push)`` pair, or
    "auto" (:func:`select_routing`). ``overflow`` is an int32 device
    scalar, 0 unless a routed bucket dropped entries
    (:func:`check_route_overflow`)."""
    rows_of = lambda C_total, ranks, K, rows: [_split_batch(rows, K)[r].reshape(-1)
                                               for r in ranks]
    return _make_sharded_step(model, optimizer, cache_cfg, mesh, axis, routing, cap_factor,
                              pre_dedup, rows_of)


def make_sharded_ctr_train_step_from_keys(model: nn.Module, optimizer,
                                          cache_cfg: CacheConfig, mesh: Mesh, slot_ids,
                                          axis: str = "ps", routing="auto",
                                          cap_factor: float = 2.0,
                                          pre_dedup: bool = True) -> Callable:
    """The sharded GPUPS step with the key lookup on the device: each rank
    probes its slice's slot-tagged keys against the replicated per-pass
    key map (``HbmEmbeddingCache(mesh=..., device_map=True)``) and serves
    pull/push from the row-sharded cache.

    step(params, opt_state, cache_state, map_state, keys_lo [B, S],
         dense_x, labels) → (params, opt_state, cache_state, loss, overflow)

    ``keys_lo`` holds the low 32 bits of each key (uint32 values or int32
    bit patterns)."""
    slot_hi = torch.as_tensor(np.asarray(slot_ids, np.int64), device=mesh.device)
    lookup = lambda ms, hi, lo: device_hash_lookup(ms, hi, lo.to(_I64) & 0xFFFFFFFF)
    return _make_sharded_step(model, optimizer, cache_cfg, mesh, axis, routing, cap_factor,
                              pre_dedup, _keyed_rows(lookup, slot_hi))
