"""NaN/Inf guard (the reference's ``FLAGS_check_nan_inf``).

Port of ``paddle_tpu.core.nan_inf``. The reference scans each op's
outputs (``operator.cc:1252`` → ``nan_inf_utils_detail.cc``); the port,
like the JAX package, checks between steps: ``executor.Trainer`` checks
its loss after a step and ``CtrPassTrainer`` the synced loss sum at the
end of a pass, both only while the ``check_nan_inf`` flag is set.

- :func:`count_nonfinite`: the number of non-finite elements across a
  nested dict/list/tuple of tensors, as ONE tensor on the first leaf's
  device (no host sync until the caller reads it);
- :func:`check_numerics`: a host-side check that raises
  ``PreconditionNotMetError`` naming each leaf that holds a NaN or an Inf,
  with the JAX package's message (``"NaN/Inf found in {label}: {path}:
  {n}/{total} non-finite"``; the path is written as ``jax.tree_util.keystr``
  writes it, and dict keys are visited in sorted order, as JAX flattens
  them).

A leaf is a ``torch.Tensor`` or anything with a ``dtype`` that
``torch.as_tensor`` takes (a numpy array); other leaves are skipped, and
only floating and complex leaves can hold a NaN or an Inf.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple

import torch

from .enforce import PreconditionNotMetError
from .flags import flag

__all__ = ["check_numerics", "count_nonfinite", "nan_inf_enabled"]


def nan_inf_enabled() -> bool:
    return bool(flag("check_nan_inf"))


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    elif hasattr(tree, "dtype"):
        yield path, torch.as_tensor(tree)


def _inexact(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def count_nonfinite(tree: Any) -> torch.Tensor:
    """The count of non-finite elements across the tree's leaves: one int32
    tensor on the first leaf's device (0 on the CPU for a tree with none)."""
    leaves = [t for _, t in _leaves_with_path(tree)]
    if not leaves:
        return torch.zeros((), dtype=torch.int32)
    dev = leaves[0].device
    total = torch.zeros((), dtype=torch.int32, device=dev)
    for t in leaves:
        if _inexact(t):
            total = total + (~torch.isfinite(t)).sum().to(device=dev, dtype=torch.int32)
    return total


def check_numerics(tree: Any, label: str = "tensors") -> None:
    """Raise ``PreconditionNotMetError`` if any leaf holds a NaN or an Inf
    (one host read a floating leaf)."""
    bad: List[Tuple[str, int, int]] = []
    for path, t in _leaves_with_path(tree):
        if not _inexact(t):
            continue
        n_bad = int((~torch.isfinite(t)).sum())
        if n_bad:
            bad.append((path, n_bad, t.numel()))
    if bad:
        detail = ", ".join(f"{k}: {n}/{total} non-finite" for k, n, total in bad)
        raise PreconditionNotMetError(f"NaN/Inf found in {label}: {detail}")
