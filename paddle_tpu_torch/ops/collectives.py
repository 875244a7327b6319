"""Collectives over the ranks of a mesh: logical ranks of one device, or
processes.

Port of ``paddle_tpu.ops.collectives``. The JAX functions run inside
``shard_map`` on one rank's value and name a mesh axis; XLA performs the
transfer. Here the collectives come in two forms:

- **the list form** (:func:`all_reduce`, :func:`all_gather`,
  :func:`reduce_scatter`, :func:`all_to_all` given a list): the caller
  holds the K ranks' tensors of a one-axis mesh of logical ranks, in rank
  order, and gets the list of what each rank receives.
- **the axis form** (:func:`psum`, :func:`psum_scatter`, :func:`pmax`,
  :func:`all_gather`/:func:`all_to_all` given an axis, :func:`ppermute`,
  :func:`shift`, :func:`broadcast`, :func:`reduce`, :func:`split_axis`,
  :func:`barrier`, :func:`axis_index`, :func:`axis_size`, and
  :class:`ProcessGroup` bound to an axis): called from inside per-rank
  code that :func:`run_ranks` runs. The per-rank code keeps the shape of
  the JAX ``shard_map`` body: ``psum(x, "mp")``, ``shift(k, "cp", 1)``,
  ``axis_index("cp")``.

  On a mesh of logical ranks (``core.mesh.make_mesh``) the ranks run one
  thread each, in lockstep; each call meets the other ranks of its group
  (the ranks that differ from it only on the named axes) at a rendezvous,
  and once all have arrived the group's first rank performs the
  collective once, on all the group's tensors, and each rank takes its
  result. On a process mesh (``core.mesh.make_process_mesh``) this
  process runs its own rank and each call maps onto ``torch.distributed``
  over the mesh's process group of those axes (``ops.transport``, where
  the table of the mapping is).

Gradients: on a mesh of logical ranks the ranks' forwards build ONE
autograd graph in one process, and a collective is a few tensor ops on
the group's tensors (a sum, a slice, a concatenation), so its gradient is
the autograd of those ops: no collective is written for the backward. The
JAX package's ``psum_replicated`` (a psum with a pinned identity VJP) and
``spec_reduced_grads`` (the explicit gradient psums of a
``check_vma=False`` step) exist to get its transposes of ``psum`` right;
with one graph the gradient of a sum is already right, and a parameter
that every rank reads through a view sums its ranks' gradients in the
one ``.grad``, so neither is ported. One autograd graph cannot span
processes: on a process mesh a collective's result carries no gradient
back to the other ranks, so only per-rank code that takes
``autograd.grad`` of its own loss before any collective runs there (the
sharded PS steps, ``SpmdTrainer``'s fused and stage-2 paths). Tensor and
pipeline parallelism, the hybrid trainer and GSPMD's ZeRO need
differentiable collectives over processes (ROADMAP item 7b's second
half).

Sums run in rank order, starting from the group's first rank, on a mesh
of logical ranks, so a result is the same from run to run and on every
device (see :func:`run_ranks` for the backward's order). XLA's
all-reduce, gloo's and NCCL's associate the sum in their own order, so a
reduced value can differ in the last bits at K ≥ 3 (at K = 2 the sum of
two operands commutes); nothing else here rounds. A replicated result
(``psum``, ``all_gather``) is ONE tensor that every rank receives: read
it, do not modify it in place.

A rank that raises aborts the rendezvous: the other ranks' waiting
collectives raise, and :func:`run_ranks` re-raises the first rank's
error. A collective that waits longer than the run's timeout, or whose
group holds a rank that has already returned, raises too, so a failing
or diverging rank never hangs the others. On a process mesh the process
group's own timeout holds instead.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.enforce import InvalidArgumentError, PreconditionNotMetError, enforce
from ..core.mesh import Mesh
from . import transport

__all__ = ["ProcessGroup", "ReduceOp", "all_gather", "all_reduce", "all_to_all", "axis_active", "axis_index",
           "axis_size", "barrier", "broadcast", "pmax", "ppermute", "psum", "psum_scatter",
           "reduce", "reduce_scatter", "run_ranks", "shift", "split_axis"]

AxisName = Union[str, Sequence[str]]

#: seconds a collective waits for its group before it raises
DEFAULT_TIMEOUT = 600.0


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _rank_reduce(xs: Sequence[torch.Tensor], op: str = ReduceOp.SUM) -> torch.Tensor:
    """The ranks' values folded in rank order by ``op`` (avg: the sum
    divided by K)."""
    enforce(len(xs) >= 1, "a collective needs at least one rank", InvalidArgumentError)
    fold = {ReduceOp.SUM: torch.add, ReduceOp.AVG: torch.add, ReduceOp.MAX: torch.maximum,
            ReduceOp.MIN: torch.minimum, ReduceOp.PROD: torch.mul}.get(op)
    enforce(fold is not None, f"unknown reduce op {op!r}", InvalidArgumentError)
    total = xs[0].clone()
    for x in xs[1:]:
        total = fold(total, x)
    return total / len(xs) if op == ReduceOp.AVG else total


# -- the list form -------------------------------------------------------------


def all_reduce(xs: Sequence[torch.Tensor], op: str = ReduceOp.SUM) -> List[torch.Tensor]:
    """``psum`` (``op="sum"``), ``pmean`` (``"avg"``: the rank-order sum
    divided by K), ``pmax``/``pmin`` or the product — every rank receives
    the result."""
    return [_rank_reduce(xs, op)] * len(xs)


def _tiled_all_gather(xs: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    return torch.cat(list(xs), dim=dim)


def all_gather(x, axis: Optional[AxisName] = None, concat_axis: int = 0):
    """Tiled ``all_gather``. List form (``all_gather(xs)``): every rank
    receives the ranks' tensors concatenated along the leading dimension
    in rank order. Axis form (``all_gather(x, axis, concat_axis)``):
    this rank receives its group's tensors concatenated along
    ``concat_axis`` in axis order (``axis`` one name or a tuple: the
    group spans them, in the mesh's order)."""
    if axis is None:
        full = _tiled_all_gather(x)
        return [full] * len(x)
    return _collective(x, axis, lambda xs: [_tiled_all_gather(xs, concat_axis)] * len(xs),
                       lambda g: transport.all_gather(g, x, concat_axis))


def reduce_scatter(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Tiled ``psum_scatter``: the rank-order sum, cut into K equal
    tiles along the leading dimension; rank r receives tile r."""
    K = len(xs)
    enforce(xs[0].shape[0] % K == 0,
            f"reduce_scatter: {xs[0].shape[0]} rows do not split over {K} ranks",
            InvalidArgumentError)
    return list(_rank_reduce(xs).chunk(K))


def _tiled_all_to_all(xs: Sequence[torch.Tensor], split: int, concat: int) -> List[torch.Tensor]:
    K = len(xs)
    enforce(all(x.shape[split] % K == 0 for x in xs),
            f"all_to_all: dimension {split} does not split over {K} ranks",
            InvalidArgumentError)
    tiles = [x.chunk(K, dim=split) for x in xs]
    return [torch.cat([tiles[r][s] for r in range(K)], dim=concat) for s in range(K)]


def all_to_all(x, axis: Optional[AxisName] = None, split_axis_: int = 0, concat_axis: int = 0):
    """Tiled ``all_to_all``. List form (``all_to_all(xs)``): rank r's
    tensor is cut into K equal tiles along the leading dimension; rank s
    receives tile s of every rank, concatenated in rank order (on a
    ``[K, …]`` bucket array, ``out_s[r] = x_r[s]``). Axis form
    (``all_to_all(x, axis, split_axis_, concat_axis)``, the JAX
    signature): the same along ``split_axis_``, the received tiles
    concatenated along ``concat_axis``."""
    if axis is None:
        return _tiled_all_to_all(x, 0, 0)
    return _collective(x, axis, lambda xs: _tiled_all_to_all(xs, split_axis_, concat_axis),
                       lambda g: transport.all_to_all(g, x, split_axis_, concat_axis))


# -- the rank context and the rendezvous ------------------------------------------


class _Aborted(RuntimeError):
    """Raised in a waiting rank when another rank failed."""


class _Slot:
    __slots__ = ("values", "arrived", "results", "taken", "done")

    def __init__(self, n: int) -> None:
        self.values: List[Any] = [None] * n
        self.arrived = 0
        self.results: Optional[List[Any]] = None
        self.taken = 0
        self.done = False


class _Rendezvous:
    """Where a run's ranks meet for their collectives. A call is keyed by
    its axes, its group (the coordinates on the other axes) and how many
    calls over those axes the rank has made before it: ranks that run
    the same program meet at the same key."""

    def __init__(self, mesh: Mesh, timeout: float) -> None:
        self.mesh = mesh
        self.timeout = timeout
        self.cond = threading.Condition()
        self.slots: Dict[tuple, _Slot] = {}
        self.calls: List[Dict[tuple, int]] = [{} for _ in range(mesh.size)]
        self.finished = set()
        self.error: Optional[BaseException] = None
        self._coords = [mesh.coords(r) for r in range(mesh.size)]
        self._groups: Dict[tuple, Tuple[tuple, List[int]]] = {}

    def group(self, rank: int, axes: Tuple[str, ...]) -> Tuple[tuple, List[int]]:
        """(group key, the group's ranks in rank order) of ``rank`` over ``axes``."""
        got = self._groups.get((rank, axes))
        if got is None:
            c = self._coords[rank]
            key = tuple((a, c[a]) for a in self.mesh.axis_names if a not in axes)
            ranks = [r for r in range(self.mesh.size)
                     if all(self._coords[r][a] == v for a, v in key)]
            got = self._groups[(rank, axes)] = (key, ranks)
        return got

    def exchange(self, rank: int, axes: Tuple[str, ...], value: Any,
                 fn: Callable[[List[Any]], List[Any]]) -> Any:
        gkey, ranks = self.group(rank, axes)
        pos = ranks.index(rank)
        with self.cond:
            n = self.calls[rank].get(axes, 0)
            self.calls[rank][axes] = n + 1
            key = (axes, gkey, n)
            slot = self.slots.get(key)
            if slot is None:
                slot = self.slots[key] = _Slot(len(ranks))
            slot.values[pos] = value
            slot.arrived += 1
            if slot.arrived == len(ranks):
                self.cond.notify_all()
            deadline = time.monotonic() + self.timeout
            while not slot.done:
                if pos == 0 and slot.arrived == len(ranks):
                    # the group's first rank performs it, whichever arrived
                    # last: the ops (and the autograd nodes they record)
                    # belong to the same thread from run to run
                    try:
                        slot.results = fn(slot.values)
                    except BaseException as e:
                        self._abort(e)
                        raise
                    slot.values = None
                    slot.done = True
                    self.cond.notify_all()
                    break
                if self.error is not None:
                    raise _Aborted(f"rank {rank}: another rank failed ({self.error!r})")
                gone = self.finished.intersection(ranks)
                if gone:
                    raise PreconditionNotMetError(
                        f"rank {rank}: collective over {axes} (call {n}) waits for rank(s) "
                        f"{sorted(gone)}, which returned without joining it")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise PreconditionNotMetError(
                        f"rank {rank}: collective over {axes} (call {n}) timed out after "
                        f"{self.timeout} s waiting for its group {ranks}")
                self.cond.wait(left)
            out = slot.results[pos]
            slot.taken += 1
            if slot.taken == len(ranks):
                del self.slots[key]
            return out

    def _abort(self, err: BaseException) -> None:
        if self.error is None:
            self.error = err
        self.cond.notify_all()

    def abort(self, err: BaseException) -> None:
        with self.cond:
            self._abort(err)

    def finish(self, rank: int) -> None:
        with self.cond:
            self.finished.add(rank)
            self.cond.notify_all()


class _RankContext:
    __slots__ = ("mesh", "rank", "coords", "rendezvous")

    def __init__(self, mesh: Mesh, rank: int, rendezvous: Optional[_Rendezvous]) -> None:
        self.mesh = mesh
        self.rank = rank
        self.coords = mesh.coords(rank)
        self.rendezvous = rendezvous


_LOCAL = threading.local()


def _context() -> Optional[_RankContext]:
    return getattr(_LOCAL, "ctx", None)


def run_ranks(mesh: Mesh, fn: Callable[[int], Any], timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """``fn(rank)`` for every rank of ``mesh`` that this process runs
    (``mesh.local_ranks``), each bound to its rank so the axis-form
    collectives and :func:`axis_index` answer for it, and the list of
    their results in rank order.

    The contract for callers: the result is the LOCAL ranks' results. On
    a mesh of logical ranks that is every rank's (one thread a rank, in
    lockstep; inline for a mesh of one rank); on a process mesh it is this
    process's own rank's alone (inline, one entry). So ``run_ranks(...)[0]``
    is a value every rank holds alike (a replicated result) on either
    mesh, and ``zip(mesh.local_ranks, run_ranks(...))`` pairs each result
    with its rank. The caller's grad mode carries into the ranks. If a
    rank raises, the others' collectives abort and the first rank's error
    is raised here (with its rank in the note); on a process mesh the
    other processes' collectives wait out the process group's timeout.

    A run repeats bit for bit: each rank's autograd nodes are recorded
    by its own thread, whose sequence numbers (thread-local in torch)
    order the one backward's gradient sums, and a collective's ops run
    on its group's first rank, not on whichever rank arrived last."""
    if mesh.is_process_mesh:
        prev = _context()
        _LOCAL.ctx = _RankContext(mesh, mesh.process_rank, None)
        try:
            return [fn(mesh.process_rank)]
        except BaseException as e:
            e.add_note(f"raised in rank {mesh.process_rank} of the process mesh "
                       f"{dict(mesh.shape)}")
            raise
        finally:
            _LOCAL.ctx = prev
    rv = _Rendezvous(mesh, timeout)
    n = mesh.size
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    grad = torch.is_grad_enabled()

    def body(r: int) -> None:
        prev = _context()
        _LOCAL.ctx = _RankContext(mesh, r, rv)
        try:
            with torch.set_grad_enabled(grad):
                results[r] = fn(r)
        except BaseException as e:  # re-raised below, in the caller
            errors[r] = e
            rv.abort(e)
        finally:
            _LOCAL.ctx = prev
            rv.finish(r)

    if n == 1:
        body(0)
    else:
        threads = [threading.Thread(target=body, args=(r,), name=f"rank{r}", daemon=True)
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    first = [e for e in errors if e is not None and not isinstance(e, _Aborted)]
    if first or any(errors):
        err = (first or [e for e in errors if e is not None])[0]
        err.add_note(f"raised in rank {errors.index(err)} of the mesh {dict(mesh.shape)}")
        raise err
    return results


def _axes(axis: AxisName) -> Tuple[str, ...]:
    ctx = _context()
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if ctx is None:
        raise InvalidArgumentError(
            f"collective over {names}: no mesh axis is bound here (call it inside run_ranks)")
    for a in names:
        enforce(a in ctx.mesh.shape,
                f"collective over {names}: the mesh {dict(ctx.mesh.shape)} has no axis {a!r}",
                InvalidArgumentError)
    # the group's order is the mesh's, whatever order the caller names them in
    return tuple(a for a in ctx.mesh.axis_names if a in names)


def _collective(x: Any, axes: AxisName, fn: Callable[[List[Any]], List[Any]],
                proc: Callable[[Any], Any]) -> Any:
    """This rank's result over its group along ``axes``: ``fn`` of the
    group's values on a mesh of logical ranks, ``proc(group)`` (an
    ``ops.transport`` op on the mesh's process group) on a process mesh."""
    axes = _axes(axes)
    ctx = _context()
    if ctx.mesh.is_process_mesh:
        return proc(ctx.mesh.group(axes))
    return ctx.rendezvous.exchange(ctx.rank, axes, x, fn)


# -- the axis form ------------------------------------------------------------------


def axis_active(axis: Optional[str]) -> bool:
    """True inside :func:`run_ranks` when the mesh has ``axis`` (of any
    size) — the JAX package's ``_axis_active``: an axis bound by the
    enclosing ``shard_map``."""
    ctx = _context()
    return axis is not None and ctx is not None and axis in ctx.mesh.shape


def axis_index(axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    _axes(axis)
    return _context().coords[axis]


def axis_size(axis: str) -> int:
    _axes(axis)
    return _context().mesh.shape[axis]


def psum(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """``lax.psum``: the group's rank-order sum, one tensor for all."""
    return _collective(x, axis, lambda xs: [_rank_reduce(xs)] * len(xs),
                       lambda g: transport.all_reduce(g, x, ReduceOp.SUM))


def _reduce_all(x: torch.Tensor, axis: AxisName, op: str = ReduceOp.SUM) -> torch.Tensor:
    """The group's reduction by ``op`` (sum, avg, max, min, prod), one
    tensor for all: the axis form of :func:`all_reduce`."""
    return _collective(x, axis, lambda xs: [_rank_reduce(xs, op)] * len(xs),
                       lambda g: transport.all_reduce(g, x, op))


def psum_scatter(x: torch.Tensor, axis: AxisName, dim: int = 0) -> torch.Tensor:
    """Tiled ``lax.psum_scatter``: the group's rank-order sum, cut into
    the group's size of equal tiles along ``dim``; the rank at position i
    of the group receives tile i (a view of the sum, which no other rank
    receives)."""
    def fn(xs):
        K = len(xs)
        enforce(xs[0].shape[dim] % K == 0,
                f"psum_scatter: dimension {dim} ({xs[0].shape[dim]}) does not split over {K} "
                "ranks", InvalidArgumentError)
        return list(_rank_reduce(xs).chunk(K, dim=dim))

    return _collective(x, axis, fn, lambda g: transport.reduce_scatter(g, x, dim))


def pmax(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over the group."""
    return _reduce_all(x, axis, ReduceOp.MAX)


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: for each pair (i, j), the rank at coordinate j
    on ``axis`` receives the tensor of the rank at coordinate i; a rank
    that no pair sends to receives zeros. A rank may send None (it has
    nothing to send, and its receiver reads nothing): None arrives. On a
    process mesh every rank passes a tensor (the receiver's buffer takes
    its shape)."""
    def fn(xs):
        out, sent = [None] * len(xs), [False] * len(xs)
        for i, j in perm:
            out[j], sent[j] = xs[i], True
        return [o if sent[j] else torch.zeros_like(xs[j]) for j, o in enumerate(out)]

    return _collective(x, axis, fn, lambda g: transport.ppermute(g, x, perm))


def shift(x: torch.Tensor, axis: str, offset: int = 1) -> torch.Tensor:
    """Ring rotation by ``offset`` hops: coordinate i's tensor goes to
    coordinate (i + offset) mod n."""
    n = axis_size(axis)
    return ppermute(x, axis, [(i, (i + offset) % n) for i in range(n)])


def broadcast(x: Optional[torch.Tensor], axis: str, root: int = 0) -> torch.Tensor:
    """``c_broadcast``: every rank of the group receives the tensor of the
    rank at coordinate ``root`` (the others may pass None). The JAX
    package masks and psums; here the root's tensor is handed over as it
    is, so nothing is computed for the other ranks' values. On a process
    mesh every rank passes a tensor of the root's shape."""
    return _collective(x, axis, lambda xs: [xs[root]] * len(xs),
                       lambda g: transport.broadcast(g, x, root))


def reduce(x: torch.Tensor, axis: str, root: int = 0, op: str = ReduceOp.SUM) -> torch.Tensor:
    """``c_reduce``: the rank at coordinate ``root`` receives the group's
    reduction by ``op`` (sum, max, min, prod or avg), the others zeros of
    its shape, as in the JAX package (whose SPMD body cannot give ranks
    different shapes)."""
    def fn(xs):
        total = _rank_reduce(xs, op)
        return [total if i == root else torch.zeros_like(total) for i in range(len(xs))]

    return _collective(x, axis, fn, lambda g: transport.reduce(g, x, root, op))


def split_axis(x: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
    """``c_split``: this rank's slice of dimension ``dim``, cut into the
    axis's size of equal pieces (the inverse of ``all_gather``); raises
    ``InvalidArgumentError`` when the dimension does not divide."""
    n = axis_size(axis)
    enforce(x.shape[dim] % n == 0,
            f"split_axis: dim {dim} (size {x.shape[dim]}) not divisible by axis {axis!r} "
            f"size {n}", InvalidArgumentError)
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(axis) * size, size)


def barrier(axis: AxisName) -> None:
    """Wait until every rank of the group along ``axis`` has arrived. The
    JAX package's is a no-op (any collective of a compiled program is a
    barrier); here the ranks are threads (a rendezvous) or processes
    (``torch.distributed.barrier`` on the group)."""
    _collective(None, axis, lambda xs: [None] * len(xs), transport.barrier)


class ProcessGroup:
    """The eager-API shape of the reference's ProcessGroup
    (ProcessGroup.h:53) bound to a mesh axis, as in the JAX package: its
    methods are the axis-form collectives over ``axis``, called from
    per-rank code under :func:`run_ranks` on either kind of mesh; results
    are returned (no Task futures)."""

    def __init__(self, axis: str) -> None:
        self.axis = axis

    def all_reduce(self, x: torch.Tensor, op: str = ReduceOp.SUM) -> torch.Tensor:
        return _reduce_all(x, self.axis, op)

    def all_gather(self, x: torch.Tensor, concat_axis: int = 0) -> torch.Tensor:
        return all_gather(x, self.axis, concat_axis)

    def reduce_scatter(self, x: torch.Tensor, scatter_axis: int = 0) -> torch.Tensor:
        return psum_scatter(x, self.axis, scatter_axis)

    def all_to_all(self, x: torch.Tensor, split_axis_: int = 0,
                   concat_axis: int = 0) -> torch.Tensor:
        return all_to_all(x, self.axis, split_axis_, concat_axis)

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        return broadcast(x, self.axis, root)

    def reduce(self, x: torch.Tensor, root: int = 0, op: str = ReduceOp.SUM) -> torch.Tensor:
        return reduce(x, self.axis, root, op)

    def rank(self) -> int:
        return axis_index(self.axis)

    def size(self) -> int:
        return axis_size(self.axis)

    def barrier(self) -> None:
        barrier(self.axis)
