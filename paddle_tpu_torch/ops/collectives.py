"""Collectives over the ranks of a one-device shard mesh.

Port of the four collectives of ``paddle_tpu.ops.collectives`` that the
sharded parameter-server paths use. The JAX functions run inside
``shard_map`` on one rank's value and name the mesh axis; here each
takes the list of the K ranks' tensors, in rank order, and returns the
list of what each rank receives (``core.mesh``: the K shards share one
device, so a collective is a tensor move, not a kernel).

Sums run in rank order 0, 1, …, K−1, starting from rank 0's value, so a
result is the same from run to run and on every device. XLA's all-reduce
associates its sum in its own order, so a reduced value can differ from
the JAX package's in the last bits; nothing else here rounds.

Replicated results (``all_reduce``, ``all_gather``) are ONE tensor that
every rank's entry of the returned list refers to: read it, do not
modify it in place.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["ReduceOp", "all_gather", "all_reduce", "all_to_all", "reduce_scatter"]


class ReduceOp:
    SUM = "sum"
    AVG = "avg"


def _rank_sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    enforce(len(xs) >= 1, "a collective needs at least one rank", InvalidArgumentError)
    total = xs[0].clone()
    for x in xs[1:]:
        total = total + x
    return total


def all_reduce(xs: Sequence[torch.Tensor], op: str = ReduceOp.SUM) -> List[torch.Tensor]:
    """``psum`` (``op="sum"``) or ``pmean`` (``op="avg"``: the rank-order
    sum divided by K) — every rank receives the result."""
    total = _rank_sum(xs)
    if op == ReduceOp.AVG:
        total = total / len(xs)
    else:
        enforce(op == ReduceOp.SUM, f"unknown reduce op {op!r}", InvalidArgumentError)
    return [total] * len(xs)


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled ``all_gather``: every rank receives the ranks' tensors
    concatenated along the leading dimension in rank order."""
    full = torch.cat(list(xs))
    return [full] * len(xs)


def reduce_scatter(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled ``psum_scatter``: the rank-order sum, cut into K equal
    tiles along the leading dimension; rank r receives tile r."""
    K = len(xs)
    enforce(xs[0].shape[0] % K == 0,
            f"reduce_scatter: {xs[0].shape[0]} rows do not split over {K} ranks",
            InvalidArgumentError)
    return list(_rank_sum(xs).chunk(K))


def all_to_all(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled ``all_to_all`` along the leading dimension: rank r's tensor
    is cut into K equal tiles; rank s receives tile s of every rank,
    concatenated in rank order. On a ``[K, …]`` bucket array this is
    ``lax.all_to_all(x, axis, 0, 0)``: ``out_s[r] = x_r[s]``."""
    K = len(xs)
    enforce(all(x.shape[0] % K == 0 for x in xs),
            f"all_to_all: the leading dimension does not split over {K} ranks",
            InvalidArgumentError)
    tiles = [x.chunk(K) for x in xs]
    return [torch.cat([tiles[r][s] for r in range(K)]) for s in range(K)]
