"""Group-sharded (ZeRO) API: the reference's dygraph sharding classes.

Port of ``paddle_tpu.parallel.sharding``: ``ShardingStage1`` (optimizer
state sharded), ``ShardingStage2`` (gradients too: the reduce-scatter
step) and ``ShardingStage3`` (parameters too), and
``group_sharded_parallel``'s levels ``"os"``, ``"os_g"`` and
``"p_g_os"``. Each wraps a model and an optimizer and builds a
``parallel.spmd.SpmdTrainer`` at its stage over a mesh with a
``"sharding"`` axis, where the stage's slices live (one device's logical
ranks: see ``parallel.spmd``).
"""

from __future__ import annotations

from typing import Callable, Sequence

from torch import nn

from ..core.enforce import InvalidArgumentError, enforce
from ..core.mesh import Mesh
from .spmd import SpmdTrainer

__all__ = ["ShardingStage1", "ShardingStage2", "ShardingStage3", "group_sharded_parallel"]


class _ShardingStage:
    stage: int = 0

    def __init__(self, model: nn.Module, optimizer) -> None:
        self.model = model
        self.optimizer = optimizer

    def trainer(self, loss_fn: Callable, mesh: Mesh,
                batch_axes: Sequence[str] = ("dp", "sharding"), comm=None, **kw) -> SpmdTrainer:
        """The stage's ``SpmdTrainer``; ``comm`` (a ``CommFusionConfig``)
        sends stage-1/2 gradients through the fused reduce-scatter (the
        optimizer updates each rank's bucket shard)."""
        enforce("sharding" in mesh.axis_names,
                "mesh needs a 'sharding' axis for group-sharded training", InvalidArgumentError)
        return SpmdTrainer(self.model, self.optimizer, loss_fn, mesh, zero_stage=self.stage,
                           batch_axes=batch_axes, comm=comm, **kw)


class ShardingStage1(_ShardingStage):
    """ZeRO-1: optimizer state sharded; params and gradients whole."""

    stage = 1


class ShardingStage2(_ShardingStage):
    """ZeRO-2: gradients and optimizer state sharded (the gradient
    reduction becomes a reduce-scatter over 'sharding')."""

    stage = 2


class ShardingStage3(_ShardingStage):
    """ZeRO-3: parameters sharded too, joined for the forward."""

    stage = 3


_STAGES = {1: ShardingStage1, 2: ShardingStage2, 3: ShardingStage3}


def group_sharded_parallel(model: nn.Module, optimizer, level: str = "os_g") -> _ShardingStage:
    """``paddle.distributed.sharding.group_sharded_parallel``: level 'os'
    is stage 1, 'os_g' stage 2, 'p_g_os' stage 3."""
    levels = {"os": 1, "os_g": 2, "p_g_os": 3}
    enforce(level in levels, f"level must be one of {sorted(levels)}", InvalidArgumentError)
    return _STAGES[levels[level]](model, optimizer)
