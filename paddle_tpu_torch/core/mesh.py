"""The shard mesh of the sharded parameter-server paths.

Port of ``paddle_tpu.core.mesh.make_mesh`` for the one layout the port's
sharded slice uses: ONE named axis of K logical shards, all on one
device (the card, or the CPU in the tests). The JAX package's mesh is a
grid of devices and its sharded step a ``shard_map`` over it; here a
shard is a rank index and a contiguous row block of tensors that stay
whole on the device, the per-rank functions run in lockstep over the
ranks, and the collectives between them are plain functions over the
list of per-rank tensors (``ops.collectives``). A mesh over distinct
devices replaces only those collectives (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from .device import resolve_device
from .enforce import InvalidArgumentError, UnavailableError, enforce

__all__ = ["Mesh", "make_mesh", "mesh_axis_size"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps the one axis name to its shard count; every shard
    lives on ``device``."""

    shape: Dict[str, int]
    device: torch.device

    @property
    def axis_names(self):
        return tuple(self.shape)


def make_mesh(axis_sizes: Dict[str, int],
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """``{axis: K}`` → a mesh of K logical shards on one device.
    ``device`` defaults to ``"cuda"`` and raises without a GPU unless the
    caller passes ``device="cpu"``. Any other layout raises: meshes of
    several axes (the hybrid dp/pp/mp/cp/ep layouts) come with ROADMAP
    A11–A12."""
    enforce(len(axis_sizes) == 1,
            f"make_mesh: the port's mesh has exactly one axis, got {dict(axis_sizes)}; "
            "meshes of several axes come with the hybrid parallel layouts "
            "(ROADMAP A11-A12)", UnavailableError)
    (name, k), = axis_sizes.items()
    enforce(isinstance(name, str) and int(k) == k and k >= 1,
            f"make_mesh: axis {name!r} needs a positive integer size, got {k!r}",
            InvalidArgumentError)
    return Mesh({name: int(k)}, resolve_device(device))


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    enforce(axis in mesh.shape,
            f"mesh has no axis {axis!r}; axes: {mesh.axis_names}", InvalidArgumentError)
    return mesh.shape[axis]
