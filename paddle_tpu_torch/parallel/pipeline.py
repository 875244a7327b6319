"""Pipeline parallelism: the per-rank pipeline of the hybrid trainer.

Port of ``pipeline_spmd_fn`` from ``paddle_tpu.parallel.pipeline``
(``LayerDesc``, ``PipelineLayer`` and ``PipelineTrainer`` wait for ROADMAP
item 8). Stages live on the ``pp`` axis and are structurally identical,
their parameters stacked on a leading dimension that the rank's view
cuts to its own stage. Micro-batches advance through M + S − 1 ticks:
at tick t stage 0 takes micro-batch t (clamped to the last), every
other stage what its left neighbour sent at the tick before, and each
stage's output moves one hop right by ``shift`` over pp. The last
stage's outputs of ticks [S − 1, S − 1 + M) are the micro-batches'
results. Autograd through the ticks and shifts gives the reverse
pipeline (the F-then-B schedule).

The JAX function replicates the result over pp by a psum of every
stage's output masked to the last stage's; here the last stage's output
is broadcast as it is, so the same value reaches every stage and no
backward runs for the bubbles' outputs. Only the last stage applies the
head.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..ops import collectives as coll

__all__ = ["pipeline_spmd_fn"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_spmd_fn(stage_apply: Callable[[Any, torch.Tensor], torch.Tensor],
                     num_stages: int, num_micro: int, pp_axis: str = "pp",
                     embed_apply: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None,
                     head_apply: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None):
    """The per-rank pipeline function ``fn(stacked_stage_state, aux_state,
    x_micro) -> y_micro``, called inside ``run_ranks`` with this rank's
    view of the stacked stage state (leading dimension 1: its stage) and
    ``x_micro`` [num_micro, micro_batch, ...] — the same on every pp rank
    (a caller may shard micro_batch over dp, as the trainer does). Returns
    the last stage's head output per micro-batch on every pp rank."""

    def fn(stacked_state, aux_state, x_micro):
        stage = coll.axis_index(pp_axis)
        my_state = _tree_map(lambda p: p[0], stacked_state)
        total = num_micro + num_stages - 1
        if embed_apply is not None:
            x_micro = embed_apply(aux_state.get("embed"), x_micro)
        buf = torch.zeros_like(x_micro[0])
        outs = []
        for t in range(total):
            inp = x_micro[min(t, num_micro - 1)] if stage == 0 else buf
            out = stage_apply(my_state, inp)
            outs.append(out)
            if t < total - 1:      # the last tick's send would be discarded
                buf = coll.shift(out, pp_axis, 1)
        last = num_stages - 1
        y = None
        if stage == last:
            y = torch.stack(outs[last:last + num_micro])
            if head_apply is not None:
                y = head_apply(aux_state.get("head"), y)
        return coll.broadcast(y, pp_axis, root=last)

    return fn
