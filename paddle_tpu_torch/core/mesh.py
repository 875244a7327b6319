"""The mesh of logical ranks.

Port of ``paddle_tpu.core.mesh``. The JAX package's mesh is a
grid of devices and its parallel steps a ``shard_map`` over it; here a
mesh is a grid of LOGICAL ranks that all live on one device (the card,
or the CPU in the tests). Ranks are numbered row-major over the axes in
the order they are given, as a JAX mesh orders its devices, so rank r
has the coordinates :meth:`Mesh.coords` gives and
``mesh.rank(**mesh.coords(r)) == r``.

Two kinds of callers run per-rank code on it:

- the sharded parameter-server paths (``ps.hot_tier``,
  ``ps.sharded_cache``, ``ps.embedding_cache``) take a mesh of exactly
  one axis (:func:`ps_shard_count`) and pass lists of per-rank tensors
  to ``ops.collectives``' list form;
- the hybrid parallel layouts (``parallel``, ``models.ernie``) run one
  function per rank in lockstep (``ops.collectives.run_ranks``), whose
  collectives name mesh axes as the JAX code does.

A mesh over distinct devices replaces only the collectives (ROADMAP
item 7).

The JAX module's helpers come along: :data:`HYBRID_AXES` and
:func:`make_hybrid_mesh` (the reference's hybrid topology, every axis
kept at size 1 too), :func:`use_mesh`/:func:`current_mesh` (a stack of
active meshes; nothing on the port's paths reads it, as in JAX, whose
``with mesh`` also enters jax's own context), and :func:`named_sharding`/
:func:`replicated`, which return the port's layout tuples (one entry a
dimension: an axis name, a tuple of names or None — JAX's
``PartitionSpec`` entries, as ``models.ernie.partition_spec`` returns
them), checked against the mesh's axes, where JAX builds a
``NamedSharding``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch

from .device import resolve_device
from .enforce import InvalidArgumentError, UnavailableError, enforce

__all__ = ["HYBRID_AXES", "Mesh", "current_mesh", "make_hybrid_mesh", "make_mesh",
           "mesh_axis_size", "named_sharding", "ps_shard_count", "replicated", "use_mesh"]

#: the hybrid topology's axes in mesh order (innermost last), as the JAX
#: package names them
HYBRID_AXES: Tuple[str, ...] = ("dp", "sharding", "pp", "ep", "cp", "mp")

_ACTIVE_MESH: List["Mesh"] = []


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis name, in order, to its size; every rank
    lives on ``device``."""

    shape: Dict[str, int]
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for k in self.shape.values():
            n *= k
        return n

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank → {axis: coordinate}, row-major (the last axis fastest)."""
        enforce(0 <= rank < self.size, f"rank {rank} out of range {self.size}",
                InvalidArgumentError)
        out = {}
        for name in reversed(self.axis_names):
            out[name] = rank % self.shape[name]
            rank //= self.shape[name]
        return {n: out[n] for n in self.axis_names}

    def rank(self, **coords: int) -> int:
        """{axis: coordinate} for every axis → the rank."""
        enforce(sorted(coords) == sorted(self.axis_names),
                f"rank() needs a coordinate on every axis {self.axis_names}, got {sorted(coords)}",
                InvalidArgumentError)
        r = 0
        for name in self.axis_names:
            c = int(coords[name])
            enforce(0 <= c < self.shape[name],
                    f"coordinate {name}={c} out of range {self.shape[name]}", InvalidArgumentError)
            r = r * self.shape[name] + c
        return r


def make_mesh(axis_sizes: Dict[str, int],
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """``{axis: size, ...}`` (any number of named axes, e.g. ``{"ps": 4}``
    or ``{"dp": 1, "pp": 2, "cp": 2, "mp": 2}``) → a mesh of their
    product of logical ranks on one device. ``device`` defaults to
    ``"cuda"`` and raises without a GPU unless the caller passes
    ``device="cpu"``."""
    enforce(len(axis_sizes) >= 1, "make_mesh: a mesh needs at least one axis",
            InvalidArgumentError)
    shape = {}
    for name, k in axis_sizes.items():
        enforce(isinstance(name, str) and int(k) == k and k >= 1,
                f"make_mesh: axis {name!r} needs a positive integer size, got {k!r}",
                InvalidArgumentError)
        shape[name] = int(k)
    return Mesh(shape, resolve_device(device))


def make_hybrid_mesh(dp: int = 1, sharding: int = 1, pp: int = 1, mp: int = 1, cp: int = 1,
                     ep: int = 1, device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The reference's HybridCommunicateGroup topology with cp and ep: a
    mesh over :data:`HYBRID_AXES`, size-1 axes kept so layouts can always
    name them."""
    sizes = {"dp": dp, "sharding": sharding, "pp": pp, "ep": ep, "cp": cp, "mp": mp}
    return make_mesh({name: sizes[name] for name in HYBRID_AXES}, device=device)


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh of :func:`use_mesh`, or None outside one. No
    entry point reads it: each takes its mesh as an argument."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


@contextlib.contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh`` :func:`current_mesh`'s answer inside the block (for
    callers that read it; no entry point of the package does)."""
    _ACTIVE_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.pop()


def named_sharding(mesh: Mesh, *spec) -> Tuple[Union[None, str, Tuple[str, ...]], ...]:
    """The layout tuple of ``spec`` (an axis name, a tuple of names or
    None a dimension); raises ``InvalidArgumentError`` for a name the
    mesh does not have."""
    for entry in spec:
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        for a in names:
            enforce(a in mesh.shape,
                    f"named_sharding: the mesh {dict(mesh.shape)} has no axis {a!r}",
                    InvalidArgumentError)
    return tuple(spec)


def replicated(mesh: Mesh) -> Tuple[()]:
    """The layout of a value every rank holds whole: the empty tuple."""
    return named_sharding(mesh)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    enforce(axis in mesh.shape,
            f"mesh has no axis {axis!r}; axes: {mesh.axis_names}", InvalidArgumentError)
    return mesh.shape[axis]


def ps_shard_count(mesh: Mesh, axis: str) -> int:
    """The shard count of a sharded parameter-server path's mesh, which
    has exactly the one axis ``axis``. A mesh of several axes raises:
    the PS paths over a hybrid mesh come with the multi-device mesh
    (ROADMAP item 7)."""
    enforce(len(mesh.shape) == 1,
            f"the sharded parameter-server paths take a mesh of one axis, got "
            f"{dict(mesh.shape)}; over a mesh of several axes they come with ROADMAP item 7",
            UnavailableError)
    return mesh_axis_size(mesh, axis)
