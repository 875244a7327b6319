"""Recompute (activation checkpointing).

Port of ``paddle_tpu.distributed.recompute`` (the reference's
``fleet/utils/recompute.py`` and the static ``RecomputeOptimizer``
pass): run a segment now, keep only what the policy saves, and run it
again in the backward to rebuild the rest. Here that is
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``.

Divergence: JAX's policies (``jax.checkpoint_policies``) act on XLA's
primitives; the port maps each name onto torch's checkpointing:

- ``"full"`` and ``"nothing_saveable"``: save nothing but the segment's
  inputs (plain checkpointing);
- ``"everything_saveable"``: save every activation, so the segment runs
  as it is, with no recompute;
- ``"dots"`` and ``"dots_no_batch"``: save the outputs of the matrix
  products (``create_selective_checkpoint_contexts``): ``mm``, ``addmm``
  and, for ``"dots"`` only, the batched ``bmm`` and ``baddbmm``; the rest
  is recomputed.

Gradients are those of the plain segment (``tests/test_torch_recompute.py``).
The port's dropout draws from explicit generators, which torch's
checkpoint does not replay (it restores only the default generators), so
when ``function`` is a module the replay restores the state of each of
its ``Dropout``s' generators, and leaves each where it found it. (A
closure that draws from an explicit generator is not replayed.)
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["recompute", "recompute_sequential", "RECOMPUTE_POLICIES"]

_aten = torch.ops.aten
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)
_DOTS = _DOTS_NO_BATCH + (_aten.bmm.default, _aten.baddbmm.default)

#: policy name → the ops whose outputs are saved (None: none is saved;
#: "all": the segment is not checkpointed)
RECOMPUTE_POLICIES = {
    "full": None,
    "dots": _DOTS,
    "dots_no_batch": _DOTS_NO_BATCH,
    "nothing_saveable": None,
    "everything_saveable": "all",
}


def _selective(saved_ops):
    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _generators_of(function) -> List[torch.Generator]:
    if not isinstance(function, torch.nn.Module):
        return []
    gens: List[torch.Generator] = []
    for m in function.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator) and all(g is not h for h in gens):
            gens.append(g)
    return gens


def _replaying(function: Callable, generators: Sequence[torch.Generator]) -> Callable:
    """``function`` whose second and later calls (the recompute) start
    every generator from the state the first call started from, and
    give each generator back its state afterwards."""
    start = [g.get_state() for g in generators]
    calls = [0]

    def run(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 1:
            return function(*args, **kwargs)
        now = [g.get_state() for g in generators]
        for g, s in zip(generators, start):
            g.set_state(s)
        try:
            return function(*args, **kwargs)
        finally:
            for g, s in zip(generators, now):
                g.set_state(s)

    return run


def recompute(function: Callable, *args, policy: Optional[str] = "full", **kwargs) -> Any:
    """``paddle.distributed.fleet.utils.recompute(function, *args)``: run
    ``function`` now and recompute its activations in the backward, as
    ``policy`` says (:data:`RECOMPUTE_POLICIES`)."""
    enforce(policy in RECOMPUTE_POLICIES,
            f"unknown recompute policy {policy!r}; one of {sorted(RECOMPUTE_POLICIES)}",
            InvalidArgumentError)
    saved = RECOMPUTE_POLICIES[policy]
    if saved == "all":
        return function(*args, **kwargs)
    gens = _generators_of(function)
    fn = _replaying(function, gens) if gens else function
    if saved is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_selective(saved), **kwargs)


def recompute_sequential(functions: Sequence[Callable], x: Any,
                         policy: Optional[str] = "full") -> Any:
    """Checkpoint each segment of a sequential stack (the
    ``recompute_interval`` pattern of the reference's PipelineLayer):
    each element of ``functions`` is one recompute unit."""
    for fn in functions:
        x = recompute(fn, x, policy=policy)
    return x
