"""The axis-form collectives over a process mesh: ``torch.distributed``.

``ops.collectives`` calls these for a rank of a mesh whose ranks are
processes (``core.mesh.make_process_mesh``); ``g`` is the rank's group
over the named axes, ``(process group, the group's ranks in rank
order)`` as ``Mesh.group`` gives it. Each function returns what the
thread mesh's form of the collective returns to this rank:

========================  ===========================================
axis form                 ``torch.distributed``
========================  ===========================================
``psum``, ``pmax``, …     ``all_reduce`` (SUM, MAX, MIN, PRODUCT)
``psum_scatter``          ``reduce_scatter_tensor``
``all_gather``            ``all_gather_into_tensor``
``all_to_all``            ``all_to_all_single``
``ppermute``/``shift``    ``batch_isend_irecv``
``broadcast``/``reduce``  themselves, with the group's global root
``barrier``               itself, on the group
========================  ===========================================

The average is the sum divided by K, as the thread mesh computes it
(``ReduceOp.AVG`` is NCCL's alone). A group of one rank that is not the
whole world moves nothing.

**Staging.** gloo's coverage of CUDA tensors varies from op to op, so
under gloo every CUDA tensor goes through a pinned host buffer, for every
op, in one code path (:func:`_to_wire` / :func:`_from_wire`), and
``stage_through_host.bytes`` counts the bytes staged both ways (and
``.calls`` the collectives that staged); a caller resets them to 0. No
op is tried on the card first. NCCL moves CUDA tensors as they are; the
backend is the job's choice (``distributed.collective.init_parallel_env``),
never switched here.

**Sum order.** The thread mesh sums in rank order; gloo and NCCL
associate their own (a ring). At K = 2 the two agree bit for bit (a sum
of two operands commutes); at K ≥ 3 they may differ in the last bits.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["all_gather", "all_reduce", "all_to_all", "barrier", "broadcast", "ppermute",
           "reduce", "reduce_scatter", "stage_through_host"]

Group = Tuple[Any, Tuple[int, ...]]


def _dist():
    import torch.distributed as dist

    return dist


def _staged(g: Group, x: torch.Tensor) -> bool:
    return x.is_cuda and _dist().get_backend(g[0]) == "gloo"


def stage_through_host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``x`` (counted)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    stage_through_host.bytes += x.numel() * x.element_size()
    return h


#: bytes staged through the host (both ways) and collectives that staged,
#: since import or since a caller reset them to 0
stage_through_host.bytes = 0
stage_through_host.calls = 0


def _to_wire(g: Group, x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous buffer holding ``x`` for an op that works in
    place: pinned host memory under gloo for a CUDA tensor, else a clone."""
    if _staged(g, x):
        stage_through_host.calls += 1
        return stage_through_host(x)
    return x.contiguous().clone()


def _empty(g: Group, shape, like: torch.Tensor) -> torch.Tensor:
    """An output buffer where the op writes (host memory when staged)."""
    if _staged(g, like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _from_wire(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The op's result on ``like``'s device (counted when it comes back
    from the host)."""
    if h.device == like.device:
        return h
    stage_through_host.bytes += h.numel() * h.element_size()
    return h.to(like.device, non_blocking=True)


def _moved(g: Group) -> bool:
    """False for a group of one rank that is not the world (nothing moves)."""
    return g[0] is not None


def _op(op: str):
    R = _dist().ReduceOp
    table = {"sum": R.SUM, "avg": R.SUM, "max": R.MAX, "min": R.MIN, "prod": R.PRODUCT}
    enforce(op in table, f"unknown reduce op {op!r}", InvalidArgumentError)
    return table[op]


def all_reduce(g: Group, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The group's reduction by ``op``; avg is the sum divided by K."""
    K = len(g[1])
    if _moved(g):
        buf = _to_wire(g, x)
        _dist().all_reduce(buf, op=_op(op), group=g[0])
        out = _from_wire(buf, x)
    else:
        _op(op)
        out = x.clone()
    return out / K if op == "avg" else out


def reduce_scatter(g: Group, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The group's sum cut into K tiles along ``dim``; this rank's tile."""
    K = len(g[1])
    enforce(x.shape[dim] % K == 0,
            f"psum_scatter: dimension {dim} ({x.shape[dim]}) does not split over {K} ranks",
            InvalidArgumentError)
    if not _moved(g):
        return x.clone()
    xt = x.movedim(dim, 0)
    buf = _to_wire(g, xt)
    out = _empty(g, (xt.shape[0] // K,) + tuple(xt.shape[1:]), x)
    _dist().reduce_scatter_tensor(out, buf, group=g[0])
    return _from_wire(out, x).movedim(0, dim)


def all_gather(g: Group, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    K = len(g[1])
    if not _moved(g):
        return x.clone()
    buf = _to_wire(g, x)
    out = _empty(g, (K * x.shape[0],) + tuple(x.shape[1:]), x)
    _dist().all_gather_into_tensor(out, buf, group=g[0])
    out = _from_wire(out, x)
    return out if dim == 0 else torch.cat(out.chunk(K, 0), dim=dim)


def all_to_all(g: Group, x: torch.Tensor, split: int = 0, concat: int = 0) -> torch.Tensor:
    """Tile s of this rank's tensor (K tiles along ``split``) goes to the
    group's rank s; the tiles received, in rank order, concatenated along
    ``concat``."""
    K = len(g[1])
    enforce(x.shape[split] % K == 0,
            f"all_to_all: dimension {split} does not split over {K} ranks",
            InvalidArgumentError)
    if not _moved(g):
        return x.clone()
    tiles = torch.stack(x.chunk(K, dim=split))
    buf = _to_wire(g, tiles)
    out = _empty(g, tuple(tiles.shape), x)
    _dist().all_to_all_single(out, buf, group=g[0])
    return torch.cat(_from_wire(out, x).unbind(0), dim=concat)


def ppermute(g: Group, x: torch.Tensor, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """For each pair (i, j) of group positions, position j receives
    position i's tensor; a rank that no pair sends to receives zeros. Every
    rank passes a tensor (a receiver takes its shape from its own)."""
    enforce(x is not None, "ppermute over processes: every rank passes a tensor (the "
            "receiver's buffer takes its shape)", InvalidArgumentError)
    dist = _dist()
    ranks, me = g[1], dist.get_rank()
    pos = ranks.index(me)
    if (pos, pos) in perm:       # to itself: a copy (gloo has no pair to itself)
        return x.clone()
    src = [i for i, j in perm if j == pos]
    dst = [j for i, j in perm if i == pos]
    if not (src or dst):
        return torch.zeros_like(x)
    send = _to_wire(g, x) if dst else None
    recv = _empty(g, tuple(x.shape), x) if src else None
    ops = [dist.P2POp(dist.isend, send, ranks[j], g[0]) for j in dst]
    ops += [dist.P2POp(dist.irecv, recv, ranks[i], g[0]) for i in src]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_wire(recv, x) if src else torch.zeros_like(x)


def broadcast(g: Group, x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """The tensor of the group's rank at position ``root``. Every rank
    passes a tensor of the root's shape (the others' values are unread)."""
    enforce(x is not None, "broadcast over processes: every rank passes a tensor of the "
            "root's shape", InvalidArgumentError)
    if not _moved(g):
        return x
    buf = _to_wire(g, x)
    _dist().broadcast(buf, src=g[1][root], group=g[0])
    return _from_wire(buf, x)


def reduce(g: Group, x: torch.Tensor, root: int = 0, op: str = "sum") -> torch.Tensor:
    """The group's reduction by ``op`` at position ``root``; zeros of its
    shape elsewhere."""
    K = len(g[1])
    if not _moved(g):
        return x.clone() / K if op == "avg" else x.clone()
    buf = _to_wire(g, x)
    _dist().reduce(buf, dst=g[1][root], op=_op(op), group=g[0])
    if _dist().get_rank() != g[1][root]:
        return torch.zeros_like(x)
    out = _from_wire(buf, x)
    return out / K if op == "avg" else out


def barrier(g: Group) -> None:
    """Wait for the group's ranks."""
    if _moved(g):
        _dist().barrier(group=g[0])
