"""Tensor (model) parallel layers.

Port of ``paddle_tpu.parallel.mp_layers`` (the reference's
``fleet/meta_parallel/parallel_layers/mp_layers.py``:
``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``, ``ParallelCrossEntropy``). Each layer holds only
its OWN shard of the weight, in the JAX layout (``[in, out]``, used as
``x @ w``), and calls the axis-form collectives of ``ops.collectives``
on the ``mp`` axis: they run inside ``run_ranks`` over a mesh with that
axis, one layer a rank. When the mp size is 1 (or ``mesh_axis`` is
None), or outside ``run_ranks``, they are the serial layers.

The JAX ``ParallelCrossEntropy`` psums through its pinned-identity-VJP
psum; here the ranks' forwards make one autograd graph, so a plain psum
has the right gradient (``ops.collectives``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.enforce import enforce_eq
from ..nn import functional as F
from ..ops import collectives as coll

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy", "RowParallelLinear",
           "VocabParallelEmbedding", "vocab_parallel_cross_entropy", "vocab_parallel_lookup"]

_axis_active = coll.axis_active


def _uniform(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    """The JAX package's default initializer: U(±1/sqrt(fan_in)), fan_in
    the product of all but the last dimension."""
    fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else shape[0]
    bound = 1.0 / np.sqrt(max(fan_in, 1))
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


def vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor, axis: str,
                          num_rows: Optional[int] = None) -> torch.Tensor:
    """Row lookup on a table row-sharded over ``axis`` (``c_embedding``):
    this rank owns rows [rank·per, (rank+1)·per) of the whole table; an id
    outside them (or ≥ ``num_rows``) contributes zeros, and the partial
    rows are summed over the axis."""
    per = table.shape[0]
    local = ids - coll.axis_index(axis) * per
    ok = (local >= 0) & (local < per)
    if num_rows is not None:
        ok = ok & (ids < num_rows)
    out = table[local.clamp(0, per - 1)]
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return coll.psum(out, axis)


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocab dimension sharded over ``mp``
    (``c_embedding`` semantics): each rank owns rows [rank·per,
    (rank+1)·per) of a vocabulary padded up to a multiple of the mp size;
    an id outside the rank's rows (or ≥ ``num_embeddings``) contributes
    zeros, and the partial results are summed over mp."""

    def __init__(self, num_embeddings: int, embedding_dim: int, mp_size: int = 1,
                 mp_rank: int = 0, mesh_axis: Optional[str] = "mp",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        mp = max(mp_size, 1)
        self.num_embeddings = num_embeddings
        self.padded_vocab = ((num_embeddings + mp - 1) // mp) * mp
        self.mesh_axis = mesh_axis if mp_size > 1 else None
        self.per_part = self.padded_vocab // mp
        self.mp_rank = mp_rank
        w = torch.randn((self.per_part, embedding_dim), generator=generator)
        self.weight = nn.Parameter(w * (1.0 / np.sqrt(embedding_dim)))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if not _axis_active(self.mesh_axis):
            return self.weight[ids]
        return vocab_parallel_lookup(self.weight, ids, self.mesh_axis, self.num_embeddings)


class ColumnParallelLinear(nn.Module):
    """Linear with its output features sharded: the input is replicated
    over mp, the output is this rank's column block, all-gathered along
    the last dimension when ``gather_output``."""

    def __init__(self, in_features: int, out_features: int, mp_size: int = 1,
                 gather_output: bool = True, has_bias: bool = True,
                 mesh_axis: Optional[str] = "mp",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        enforce_eq(out_features % max(mp_size, 1), 0, "out_features must divide mp size")
        self.mesh_axis = mesh_axis if mp_size > 1 else None
        self.gather_output = gather_output
        per = out_features // max(mp_size, 1)
        self.weight = _uniform((in_features, per), generator)
        self.bias = nn.Parameter(torch.zeros(per)) if has_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight
        if self.bias is not None:
            y = y + self.bias
        if self.gather_output and _axis_active(self.mesh_axis):
            y = coll.all_gather(y, self.mesh_axis, concat_axis=y.dim() - 1)
        return y


class RowParallelLinear(nn.Module):
    """Linear with its input features sharded: the input is already split
    (``input_is_parallel``, the usual case after a ColumnParallelLinear)
    or split here; the partial products are summed over mp and the bias
    is added once, after the sum."""

    def __init__(self, in_features: int, out_features: int, mp_size: int = 1,
                 input_is_parallel: bool = True, has_bias: bool = True,
                 mesh_axis: Optional[str] = "mp",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        enforce_eq(in_features % max(mp_size, 1), 0, "in_features must divide mp size")
        self.mesh_axis = mesh_axis if mp_size > 1 else None
        self.input_is_parallel = input_is_parallel
        per = in_features // max(mp_size, 1)
        self.weight = _uniform((per, out_features), generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if has_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        active = _axis_active(self.mesh_axis)
        if active and not self.input_is_parallel:
            n = coll.axis_size(self.mesh_axis)
            enforce_eq(x.shape[-1] % n, 0,
                       f"split over {self.mesh_axis!r}: last dim {x.shape[-1]} over {n} ranks")
            x = x.chunk(n, dim=-1)[coll.axis_index(self.mesh_axis)]
        y = x @ self.weight
        if active:
            y = coll.psum(y, self.mesh_axis)
        if self.bias is not None:
            y = y + self.bias
        return y


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 axis: str) -> torch.Tensor:
    """Per-token cross entropy over logits whose last dimension is this
    rank's vocab shard (``c_softmax_with_cross_entropy``): the max (for
    stability only, so without gradient), the sum of exponentials and the
    picked logit reduce over ``axis``; the full vocabulary is never
    materialized."""
    per = logits.shape[-1]
    start = coll.axis_index(axis) * per
    local_max = logits.detach().amax(dim=-1, keepdim=True)
    gmax = coll.pmax(local_max, axis)
    sumexp = torch.exp(logits - gmax).sum(dim=-1, keepdim=True)
    lse = torch.log(coll.psum(sumexp, axis)) + gmax
    local = labels - start
    ok = (local >= 0) & (local < per)
    picked = torch.gather(logits, -1, local.clamp(0, per - 1).long()[..., None])[..., 0]
    picked = coll.psum(torch.where(ok, picked, torch.zeros((), dtype=picked.dtype,
                                                           device=picked.device)), axis)
    return lse[..., 0] - picked


class ParallelCrossEntropy(nn.Module):
    """Cross entropy over vocab-sharded logits
    (:func:`vocab_parallel_cross_entropy`); the serial cross entropy when
    the mp axis is not active."""

    def __init__(self, mp_size: int = 1, mesh_axis: Optional[str] = "mp") -> None:
        super().__init__()
        self.mesh_axis = mesh_axis if mp_size > 1 else None

    def forward(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if not _axis_active(self.mesh_axis):
            return F.cross_entropy(logits, labels, reduction="none")
        return vocab_parallel_cross_entropy(logits, labels, self.mesh_axis)
