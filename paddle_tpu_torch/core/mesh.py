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

A mesh can also be made of PROCESSES (:func:`make_process_mesh`): one
process a rank over ``torch.distributed``, built after
``distributed.collective.init_parallel_env``, with the same row-major
coordinates (rank r is ``torch.distributed`` rank r). Each process holds
its own rank's state only; ``ops.collectives.run_ranks`` runs this
process's rank, and the axis-form collectives map onto the mesh's
process groups (``ops.transport``). Per-rank code does not change. The
paths that one autograd graph across ranks needs (tensor and pipeline
parallelism, GSPMD's ZeRO) stay on the mesh of logical ranks until
differentiable collectives come (ROADMAP item 7b's second half).

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
import itertools
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from .device import resolve_device
from .enforce import (InvalidArgumentError, PreconditionNotMetError, UnavailableError,
                      enforce)

__all__ = ["HYBRID_AXES", "Mesh", "current_mesh", "make_hybrid_mesh", "make_mesh",
           "make_process_mesh", "mesh_axis_size", "named_sharding", "ps_shard_count",
           "replicated", "use_mesh"]

#: the hybrid topology's axes in mesh order (innermost last), as the JAX
#: package names them
HYBRID_AXES: Tuple[str, ...] = ("dp", "sharding", "pp", "ep", "cp", "mp")

_ACTIVE_MESH: List["Mesh"] = []


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis name, in order, to its size. On a mesh of
    logical ranks every rank lives on ``device``; on a process mesh
    (``process_rank`` set, :func:`make_process_mesh`) this process is rank
    ``process_rank`` and ``device`` is its own."""

    shape: Dict[str, int]
    device: torch.device
    process_rank: Optional[int] = None
    #: a process mesh's groups: {axes with a size above 1: (process group
    #: or None for a group of one, the group's ranks in rank order)}
    groups: Optional[Dict[Tuple[str, ...], Tuple[Any, Tuple[int, ...]]]] = \
        dataclasses.field(default=None, compare=False, repr=False)

    @property
    def is_process_mesh(self) -> bool:
        return self.process_rank is not None

    @property
    def local_ranks(self) -> Tuple[int, ...]:
        """The ranks this process runs: all of them on a mesh of logical
        ranks, its own on a process mesh."""
        return (self.process_rank,) if self.is_process_mesh else tuple(range(self.size))

    def group(self, axes: Tuple[str, ...]) -> Tuple[Any, Tuple[int, ...]]:
        """A process mesh's (process group, ranks in rank order) of this
        process's group over ``axes`` (named in mesh order). Axes of size 1
        do not change a group; a group of one rank has no process group
        (None) unless it is the whole world."""
        enforce(self.is_process_mesh, "group() is a process mesh's", InvalidArgumentError)
        key = tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)
        got = self.groups.get(key)
        if got is None:
            return None, (self.process_rank,)
        return got

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


def _process_device(device, rank: int) -> torch.device:
    """A process mesh's device: ``cuda:{rank % device_count}`` for None or
    an unindexed ``"cuda"`` (raising without a GPU), else ``device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_process_mesh(axis_sizes: Dict[str, int],
                      device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """A mesh whose ranks are the processes of the ``torch.distributed``
    job (``distributed.collective.init_parallel_env`` first): rank r of the
    row-major coordinates is process r; this process's rank and device
    (``cuda:{rank % device_count}`` unless ``device="cpu"``) are the
    mesh's. The product of the axes must equal the world size.

    Every process group a collective can name (each combination of the
    axes above size 1, each group of it) is made here, in the same order
    in every process: ``new_group`` is collective over the world, and
    processes that made groups in different orders would deadlock."""
    import torch.distributed as dist

    mesh = make_mesh(axis_sizes, device="cpu")
    enforce(dist.is_available() and dist.is_initialized(),
            "make_process_mesh: no torch.distributed job; call "
            "distributed.collective.init_parallel_env() first", PreconditionNotMetError)
    world, rank = dist.get_world_size(), dist.get_rank()
    enforce(mesh.size == world,
            f"make_process_mesh: the axes {dict(mesh.shape)} hold {mesh.size} ranks, the job "
            f"has {world} processes", InvalidArgumentError)
    dev = _process_device(device, rank)
    enforce(dist.get_backend() != "nccl" or dev.type == "cuda",
            f"make_process_mesh: the job's backend is nccl, which moves CUDA tensors only; "
            f"the mesh was asked for {dev}", InvalidArgumentError)
    coords = [mesh.coords(r) for r in range(world)]
    wide = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    groups: Dict[Tuple[str, ...], Tuple[Any, Tuple[int, ...]]] = {}
    for n in range(1, len(wide) + 1):
        for axes in itertools.combinations(wide, n):
            if len(axes) == len(wide):
                continue
            rest = [a for a in mesh.axis_names if a not in axes]
            for key in sorted({tuple(c[a] for a in rest) for c in coords}):
                ranks = tuple(r for r in range(world)
                              if tuple(coords[r][a] for a in rest) == key)
                pg = dist.new_group(list(ranks))   # every process, every group
                if rank in ranks:
                    groups[axes] = (pg, ranks)
    # the world: every axis above size 1 (or a world of one rank)
    groups[tuple(wide)] = (dist.group.WORLD, tuple(range(world)))
    return Mesh(mesh.shape, dev, rank, groups)


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
    the PS paths over a hybrid mesh come with ROADMAP item 7b's second
    half (a process mesh of one axis works)."""
    enforce(len(mesh.shape) == 1,
            f"the sharded parameter-server paths take a mesh of one axis, got "
            f"{dict(mesh.shape)}; over a mesh of several axes they come with ROADMAP item 7b",
            UnavailableError)
    return mesh_axis_size(mesh, axis)
