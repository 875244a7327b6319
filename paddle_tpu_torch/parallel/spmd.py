"""Data parallel and ZeRO over a mesh of logical ranks: ``SpmdTrainer``.

Port of ``paddle_tpu.parallel.spmd`` (the reference's dygraph
``DataParallel`` + bucketed ``Reducer``, ``raw_program_optimizer`` and
the ZeRO ``sharding_optimizer`` / ShardingStage1-3). The JAX trainer is
one jitted step over a device mesh; here the mesh's ranks are logical,
all on one device (``core.mesh``), and the trainer takes one of three
paths:

- **GSPMD** (``comm=None``, stages 0, 1 and 3): what GSPMD's partition
  of the JAX step computes — the whole batch in one graph (as
  ``executor.Trainer`` and ``auto_parallel.Engine`` run it), one update.
  ZeRO ≥ 1 holds each optimizer-state tensor as per-rank slices
  (:class:`RankSlices`: 1/K of the rows on its largest dim divisible by
  the ``"sharding"`` axis, :func:`shard_largest_dim`); stage 3 holds each
  parameter so too, joined for the forward. The update runs on the joined
  tensors, so every optimizer computes what GSPMD's partition computes.
- **stage 2** (``comm=None``): JAX's explicit reduce-scatter step
  (``_build_stage2_step``), one thread a rank under
  ``ops.collectives.run_ranks``: each rank's gradients on its batch
  shard, a mean over the other batch axes, ``psum_scatter`` over
  ``"sharding"`` onto the rank's slice, the optimizer on that slice (so
  norm-based optimizers see a slice's norms, as in the reference's stage
  2), ``all_gather`` of the new params.
- **fused** (``comm=`` or ``strategy.fuse_all_reduce_ops``, stage ≤ 2):
  one thread a rank over the batch axes; each rank's PRE-reduction
  gradients go to the meta-optimizer chain, whose
  ``FusedAllReduceOptimizer`` runs the fused-bucket collectives of
  ``distributed.comm_fusion`` (fp32, bf16 or int8 with error feedback).
  ZeRO 1/2 update flat 1/K shards.

A rank of the threaded paths runs the forward through its own copy of
the model (``pipeline.meta_clone``) bound to its own leaves
(``p.detach().requires_grad_()``: no copy), and takes
``torch.autograd.grad`` of its own loss, so its gradients are its own
before any reduction (one graph over all ranks would sum them). Per-rank
state (``"local"`` in the chain's ``state_layout``, the error-feedback
residual among it) and the flat ZeRO shards are :class:`RankSlices`
too; state every rank holds alike is one tensor (rank 0's result).

Divergences from the JAX trainer: the ranks share one device, so a ZeRO
slice is a tensor of its own on that device and no byte crosses a link;
sums over ranks run in rank order (XLA associates its own: results can
differ in the last bits); BatchNorm takes per-rank batch statistics on
the threaded paths (as JAX's ``shard_map`` body does) and the whole
batch's on the GSPMD path; dropout draws from the trainer's generator
(per rank, seeded each step), not JAX's keys; the checkpoint holds the
port's own trees (``Linear`` weights ``[out, in]``) and its generator
state in the JAX trainer's schema, every per-rank value in the JAX
trainer's global layout (see :meth:`SpmdTrainer.save`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..core.enforce import InvalidArgumentError, enforce
from ..core.mesh import Mesh
from ..core.profiler import RecordEvent
from ..distributed.meta_optimizers import _tmap
from ..nn.layers import Dropout
from ..ops import collectives as coll
from .pipeline import bind, meta_clone

__all__ = ["DataParallel", "RankSlices", "SpmdTrainer", "make_sharding_rules",
           "shard_largest_dim"]

Tree = Dict[str, Any]
Layout = Tuple[Any, ...]
_FLOATS = (torch.float32, torch.bfloat16)


class RankSlices:
    """One tensor held as a part a rank: ``parts[r]`` is rank r's. ``dim``
    is the dimension the whole tensor is cut along (rank order), or None
    for a per-rank value (the whole is the parts stacked on a new leading
    dimension, the JAX trainer's layout for per-rank state)."""

    __slots__ = ("parts", "dim")

    def __init__(self, parts: Sequence[torch.Tensor], dim: Optional[int]) -> None:
        self.parts = list(parts)
        self.dim = dim

    @classmethod
    def cut(cls, whole: torch.Tensor, n: int, dim: Optional[int]) -> "RankSlices":
        """``whole`` cut into ``n`` slices along ``dim`` (each its own
        storage); ``dim=None``: ``whole`` is stacked per-rank values
        ([n, …])."""
        parts = whole.unbind(0) if dim is None else whole.chunk(n, dim)
        enforce(len(parts) == n, f"{tuple(whole.shape)} does not cut into {n} ranks on {dim}",
                InvalidArgumentError)
        return cls([p.clone() for p in parts], dim)

    def full(self) -> torch.Tensor:
        return torch.stack(self.parts) if self.dim is None else torch.cat(self.parts, self.dim)

    def __repr__(self) -> str:
        return f"RankSlices({len(self.parts)} x {tuple(self.parts[0].shape)}, dim={self.dim})"


def full_tree(tree: Any) -> Any:
    """Every :class:`RankSlices` of ``tree`` joined into its whole tensor."""
    return _tmap(lambda x: x.full() if isinstance(x, RankSlices) else x, tree)


def _place_like(template: Any, tree: Any) -> Any:
    """``tree``'s whole tensors cut as ``template``'s leaves are."""
    return _tmap(lambda t, x: RankSlices.cut(x, len(t.parts), t.dim)
                     if isinstance(t, RankSlices) else x, template, tree)


def _rank_view(tree: Any, r: int) -> Any:
    return _tmap(lambda x: x.parts[r] if isinstance(x, RankSlices) else x, tree)


def _choose_shard_dim(shape: Sequence[int], n: int) -> int:
    """The largest dim divisible by ``n`` (the first of equal ones), −1
    to keep the tensor whole: the one rule for the shard dim."""
    if n > 1 and shape:
        for dim in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[dim] % n == 0 and shape[dim] >= n:
                return dim
    return -1


def shard_largest_dim(x: Any, mesh: Mesh, axis: str) -> Layout:
    """The layout tuple placing ``axis`` on the largest dim of ``x``
    divisible by its size; the empty tuple (replicated) when none is."""
    shape = tuple(getattr(x, "shape", ()))
    dim = _choose_shard_dim(shape, mesh.shape[axis])
    if dim >= 0:
        spec: List[Optional[str]] = [None] * len(shape)
        spec[dim] = axis
        return tuple(spec)
    return ()


def make_sharding_rules(mesh: Mesh, params: Tree, opt_state: Tree, zero_stage: int = 0,
                        sharding_axis: str = "sharding") -> Tuple[Tree, Tree]:
    """(param layouts, optimizer-state layouts) for a ZeRO stage: params
    cut on their largest divisible dim from stage 3, every optimizer-state
    tensor of rank ≥ 1 from stage 1, the rest replicated (the empty
    tuple). Layout tuples name a mesh axis a dimension, as
    ``core.mesh.named_sharding`` gives them."""
    def param_rule(x):
        return shard_largest_dim(x, mesh, sharding_axis) if zero_stage >= 3 else ()

    def opt_rule(x):
        if zero_stage >= 1 and isinstance(x, torch.Tensor) and x.dim() > 0:
            return shard_largest_dim(x, mesh, sharding_axis)
        return ()

    return _tmap(param_rule, params), _tmap(opt_rule, opt_state)


def _cut_by_layout(x: Any, layout: Layout, mesh: Mesh) -> Any:
    """A tensor as :class:`RankSlices` over the one axis its layout names
    (whole when it names none)."""
    for dim, axis in enumerate(layout):
        if axis is not None:
            return RankSlices.cut(x, mesh.shape[axis], dim)
    return x


def _grads_or_zeros(got, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(leaves.items(), got)}


class SpmdTrainer:
    """Data-parallel and ZeRO (stages 0-3) training of any model over
    ``mesh``: the batch splits over ``batch_axes`` (those the mesh has at
    a size above 1), ZeRO slices over the ``"sharding"`` axis on the
    GSPMD and stage-2 paths and over the batch axes on the fused path.

    ``comm`` (a :class:`~paddle_tpu_torch.distributed.comm_fusion.
    CommFusionConfig` or its dict) or a ``strategy`` with
    ``fuse_all_reduce_ops`` selects the fused path (stage ≤ 2);
    ``strategy`` builds the meta-optimizer chain (``apply_strategy``,
    wired to the reducer there). ``train_step(inputs, labels)`` takes the
    global batch (leading dim divisible by the batch ranks on the threaded
    paths) and returns the mean loss (a 0-dim tensor). ``device`` (None:
    the card, raising without one) must be the mesh's device.
    """

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable[..., torch.Tensor],
                 mesh: Mesh, zero_stage: int = 0, batch_axes: Sequence[str] = ("dp", "sharding"),
                 seed: int = 0, comm=None, strategy=None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        enforce(0 <= zero_stage <= 3, "zero_stage in [0,3]", InvalidArgumentError)
        dev = resolve_device(device)
        enforce(dev.type == mesh.device.type,
                f"the mesh lives on {mesh.device}, the trainer on {dev}", InvalidArgumentError)
        self.device = dev
        self.model = model.to(dev)
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.zero_stage = zero_stage
        self.global_step = 0
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._dropout = any(isinstance(m, Dropout) and m.p > 0 for m in model.modules())
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = self._gen
        # the batch axes in the mesh's order (the collectives' group order)
        self._axes = tuple(a for a in mesh.axis_names
                           if a in batch_axes and mesh.shape[a] > 1)
        state = {"params": {k: p.detach() for k, p in self.model.named_parameters()},
                 "buffers": {k: b.detach() for k, b in self.model.named_buffers()}}

        comm_cfg = self._resolve_comm(comm, strategy)
        if comm_cfg is not None and self._axes and zero_stage <= 2:
            self._init_fused(optimizer, state, comm_cfg, strategy, zero_stage)
            return
        if strategy is not None:
            from ..distributed.meta_optimizers import apply_strategy

            optimizer = apply_strategy(optimizer, strategy)
        self.optimizer = optimizer
        opt_state = optimizer.init(state["params"])
        if zero_stage >= 1:
            enforce("sharding" in mesh.shape,
                    f"ZeRO stage {zero_stage} on the GSPMD path shards over the mesh's "
                    f"'sharding' axis; the mesh {dict(mesh.shape)} has none (the fused path, "
                    "comm=, shards over the batch axes)", InvalidArgumentError)
        param_lay, opt_lay = make_sharding_rules(mesh, state["params"], opt_state, zero_stage)
        self.state = {"params": _tmap(lambda x, l: _cut_by_layout(x, l, mesh),
                                          state["params"], param_lay),
                      "buffers": state["buffers"]}
        self.opt_state = _tmap(lambda x, l: _cut_by_layout(x, l, mesh), opt_state, opt_lay)
        self._path = "gspmd"
        if zero_stage == 2:
            self._init_stage2()
            self._path = "stage2"

    @staticmethod
    def _resolve_comm(comm, strategy):
        """An explicit ``comm`` wins; else a strategy with
        ``fuse_all_reduce_ops`` gives its ``comm_fusion_configs`` (and
        ``fuse_grad_size_in_MB``); else None (no fused path)."""
        from ..distributed.comm_fusion import CommFusionConfig

        if comm is not None:
            return comm if isinstance(comm, CommFusionConfig) else \
                CommFusionConfig.from_configs(dict(comm))
        if strategy is not None and getattr(strategy, "fuse_all_reduce_ops", False):
            cfg = dict(getattr(strategy, "comm_fusion_configs", {}) or {})
            cfg.setdefault("fuse_grad_size_in_MB", getattr(strategy, "fuse_grad_size_in_MB", 32))
            return CommFusionConfig.from_configs(cfg)
        return None

    # -- the threaded paths' common parts -----------------------------------------------

    def _rank_setup(self, axes: Sequence[str]) -> None:
        """A mesh of ``axes`` alone (ranks on other axes would compute the
        same) and a model copy a rank."""
        self._rank_mesh = Mesh({a: self.mesh.shape[a] for a in self.mesh.axis_names
                                if a in axes}, self.mesh.device)
        self._rank_models = [meta_clone(self.model) for _ in range(self._rank_mesh.size)]
        for m in self._rank_models:
            m.train()

    def _batch_shard(self, xs: Tuple[torch.Tensor, ...], rank: int) -> Tuple[torch.Tensor, ...]:
        """This rank's rows of the global batch: cut over the batch axes in
        the mesh's order (ranks on other axes get the same rows)."""
        c = self._rank_mesh.coords(rank)
        idx, n = 0, 1
        for a in self._axes:
            idx, n = idx * self._rank_mesh.shape[a] + c[a], n * self._rank_mesh.shape[a]
        out = []
        for x in xs:
            enforce(x.shape[0] % n == 0,
                    f"batch {x.shape[0]} does not split over {n} ranks of {self._axes}",
                    InvalidArgumentError)
            per = x.shape[0] // n
            out.append(x[idx * per:(idx + 1) * per])
        return tuple(out)

    def _rank_loss_grads(self, rank: int, params: Tree, buffers: Tree, inputs, labels,
                         step_seed: Optional[int], opt_local: Any):
        """One rank's forward on its batch shard through its own module and
        its own leaves: (loss, its gradients, its new buffers)."""
        mod = self._rank_models[rank]
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        bufs = {k: b.clone() for k, b in buffers.items()}
        bind(mod, {"params": leaves, "buffers": bufs})
        if step_seed is not None:
            g = torch.Generator(self.device).manual_seed(step_seed * 1_000_003 + rank)
            for d in mod.modules():
                if isinstance(d, Dropout):
                    d.generator = g
        xs, ys = self._batch_shard(inputs, rank), self._batch_shard(labels, rank)
        out = mod(*xs)
        loss = self.loss_fn(out, *ys)
        scaled = (self.optimizer.scale_loss(loss, opt_local)
                  if hasattr(self.optimizer, "scale_loss") else loss)
        got = torch.autograd.grad(scaled, list(leaves.values()), allow_unused=True)
        return loss.detach(), _grads_or_zeros(got, leaves), bufs

    @staticmethod
    def _pmean_buffers(bufs: Tree, axes: Sequence[str], n: int) -> Tree:
        return {k: coll.psum(b, tuple(axes)) / n if b.dtype in _FLOATS else b
                for k, b in bufs.items()}

    def _unbind(self) -> None:
        for mod in self._rank_models:
            for m in mod.modules():
                for slot in (m._parameters, m._buffers):
                    for k in slot:
                        slot[k] = None

    def _step_seed(self) -> Optional[int]:
        if not self._dropout:
            return None
        return int(torch.randint(0, 2**31 - 1, (), generator=self._gen, device=self.device))

    # -- the fused path -------------------------------------------------------------------

    def _init_fused(self, optimizer, state, comm_cfg, strategy, zero_stage) -> None:
        from ..distributed.comm_fusion import DpGradReducer
        from ..distributed.meta_optimizers import (FusedAllReduceOptimizer, LocalSGDOptimizer,
                                                   MetaOptimizerBase, apply_strategy)

        axes = self._axes
        reducer = DpGradReducer(axes, [self.mesh.shape[a] for a in axes], comm_cfg,
                                shard=zero_stage in (1, 2))
        if strategy is not None:
            optimizer = apply_strategy(optimizer, strategy, reducer=reducer)
        else:
            enforce(not isinstance(optimizer, MetaOptimizerBase),
                    "fused comm path: pass a plain optimizer (wrapped here) or a strategy= to "
                    "build the chain; a pre-built meta-optimizer chain has no reducer installed",
                    InvalidArgumentError)
            optimizer = FusedAllReduceOptimizer(optimizer, reducer)
        node = optimizer
        while isinstance(node, MetaOptimizerBase):
            enforce(not isinstance(node, LocalSGDOptimizer),
                    "localsgd keeps per-rank params between syncs, which this trainer's "
                    "replicated-param step cannot represent: run localsgd on the GSPMD path "
                    "(comm=None)", InvalidArgumentError)
            node = node.inner
        self.optimizer = optimizer
        self.reducer = reducer
        K = reducer.K
        opt_state = optimizer.init(state["params"])
        tags = optimizer.state_layout(opt_state)

        def place(x, tag):
            if tag == "local":
                return RankSlices([x.clone() for _ in range(K)], None)
            if tag == "shard":
                return RankSlices.cut(x, K, 0)
            return x

        self.state = state
        self.opt_state = _tmap(place, opt_state, tags)
        self._rank_setup(axes)
        self._path = "fused"

    def _fused_step(self, inputs, labels) -> torch.Tensor:
        axes, K = self._axes, self.reducer.K
        params, buffers = self.state["params"], self.state["buffers"]
        step_seed = self._step_seed()

        def rank_fn(r: int):
            opt_local = _rank_view(self.opt_state, r)
            loss, grads, bufs = self._rank_loss_grads(r, params, buffers, inputs, labels,
                                                      step_seed, opt_local)
            new_params, new_opt = self.optimizer.update(grads, opt_local, params)
            return (new_params, new_opt, coll.psum(loss, axes) / K,
                    self._pmean_buffers(bufs, axes, K))

        res = coll.run_ranks(self._rank_mesh, rank_fn)
        self._unbind()
        self.state = {"params": res[0][0], "buffers": res[0][3]}
        self.opt_state = _tmap(
            lambda old, *new: RankSlices(new, old.dim) if isinstance(old, RankSlices)
            else new[0], self.opt_state, *(r[1] for r in res))
        return res[0][2]

    # -- the stage-2 reduce-scatter path ----------------------------------------------------

    def _init_stage2(self) -> None:
        mesh = self.mesh
        K = mesh.shape["sharding"]
        self._dp_axes = tuple(a for a in self._axes if a != "sharding")
        self._all_axes = self._dp_axes + (("sharding",) if K > 1 else ())
        self._rank_setup(set(self._all_axes) | set(self._axes))
        self._dims = {k: _choose_shard_dim(tuple(p.shape), K)
                      for k, p in self.state["params"].items()}

    def _stage2_step(self, inputs, labels) -> torch.Tensor:
        K = self.mesh.shape["sharding"]
        dp_axes, all_axes, dims = self._dp_axes, self._all_axes, self._dims
        params, buffers = self.state["params"], self.state["buffers"]
        step_seed = self._step_seed()
        n_all = 1
        for a in all_axes:
            n_all *= self.mesh.shape[a]

        def rank_fn(r: int):
            c = self._rank_mesh.coords(r)
            j = c.get("sharding", 0)
            opt_local = _rank_view(self.opt_state, j)
            loss, grads, bufs = self._rank_loss_grads(r, params, buffers, inputs, labels,
                                                      step_seed, opt_local)

            def rs(g, d):
                for a in dp_axes:   # the mean over the batch shards of the other axes
                    g = coll.psum(g, a) / self.mesh.shape[a]
                if d < 0 or K == 1:
                    return coll.psum(g, "sharding") / K if K > 1 else g
                return coll.psum_scatter(g, "sharding", d) / K

            def my_slice(p, d):
                if d < 0 or K == 1:
                    return p
                size = p.shape[d] // K
                return p.narrow(d, j * size, size)

            with torch.no_grad():
                g_shard = {k: rs(g, dims[k]) for k, g in grads.items()}
            p_shard = {k: my_slice(p, dims[k]) for k, p in params.items()}
            new_p_shard, new_opt = self.optimizer.update(g_shard, opt_local, p_shard)
            new_params = {k: p if dims[k] < 0 or K == 1 else
                          coll.all_gather(p, "sharding", dims[k]) for k, p in new_p_shard.items()}
            if all_axes:
                loss = coll.psum(loss, all_axes) / n_all
                bufs = self._pmean_buffers(bufs, all_axes, n_all)
            return new_params, new_opt, loss, bufs

        res = coll.run_ranks(self._rank_mesh, rank_fn)
        self._unbind()
        # rank r's slice j: the first rank at sharding coordinate j holds it
        owner = {}
        for r in range(self._rank_mesh.size):
            owner.setdefault(self._rank_mesh.coords(r).get("sharding", 0), r)
        self.state = {"params": res[0][0], "buffers": res[0][3]}
        self.opt_state = _tmap(
            lambda old, *new: RankSlices([new[owner[j]] for j in range(len(old.parts))], old.dim)
            if isinstance(old, RankSlices) else new[0], self.opt_state, *(r[1] for r in res))
        return res[0][2]

    # -- the GSPMD path ---------------------------------------------------------------------

    def _gspmd_step(self, inputs, labels) -> torch.Tensor:
        params = full_tree(self.state["params"])
        opt_state = full_tree(self.opt_state)
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        buffers = {k: b.clone() for k, b in self.state["buffers"].items()}
        self.model.train()
        out = functional_call(self.model, {**leaves, **buffers}, inputs)
        loss = self.loss_fn(out, *labels)
        scaled = (self.optimizer.scale_loss(loss, opt_state)
                  if hasattr(self.optimizer, "scale_loss") else loss)
        got = torch.autograd.grad(scaled, list(leaves.values()), allow_unused=True)
        new_params, new_opt = self.optimizer.update(_grads_or_zeros(got, leaves), opt_state,
                                                    params)
        self.state = {"params": _place_like(self.state["params"], new_params),
                      "buffers": buffers}
        self.opt_state = _place_like(self.opt_state, new_opt)
        return loss.detach()

    # -- the public surface -----------------------------------------------------------------

    def train_step(self, inputs, labels) -> torch.Tensor:
        """One step on the global batch; returns the mean loss."""
        inputs = tuple(torch.as_tensor(x, device=self.device) for x in _as_tuple(inputs))
        labels = tuple(torch.as_tensor(y, device=self.device) for y in _as_tuple(labels))
        with RecordEvent("spmd_train_step"):
            # dispatch by name: a bound method kept on the instance would make a
            # reference cycle, and a dropped trainer's state would wait for the GC
            loss = getattr(self, f"_{self._path}_step")(inputs, labels)
        self.global_step += 1
        return loss

    def full_state(self) -> Tuple[Tree, Tree]:
        """(state, optimizer state) as whole tensors, in the JAX trainer's
        global layout: ZeRO slices joined, flat shards ``(K·seg_len,)``,
        per-rank values stacked ``[K, …]``."""
        return full_tree(self.state), full_tree(self.opt_state)

    def restore(self, state: Tree, opt_state: Tree, step: Optional[int] = None) -> None:
        """Install whole trees (as :meth:`full_state` gives them: from a
        snapshot, or converted from the JAX trainer by ``convert``) into the
        live ones by key path, cut as the live leaves are."""
        from ..io.checkpoint import graft_into

        cur_state, cur_opt = self.full_state()
        self.state = _place_like(self.state, graft_into(cur_state, state))
        self.opt_state = _place_like(self.opt_state, graft_into(cur_opt, opt_state))
        if step is not None:
            self.global_step = int(step)

    def save(self, path: str) -> None:
        """State, optimizer state (:meth:`full_state`'s global layout), the
        trainer's generator state and the step, in the JAX trainer's
        snapshot schema (the port's own trees)."""
        from ..io.checkpoint import save_train_state

        state, opt = self.full_state()
        save_train_state(path, state, opt_state=opt, rng=self._gen.get_state(),
                         step=self.global_step)

    def load(self, path: str) -> None:
        """Restore a snapshot written by :meth:`save`: the values re-cut by
        this trainer's layout (the file itself does not depend on it)."""
        from ..io.checkpoint import load_train_state

        snap = load_train_state(path)
        self.restore(snap["state"], snap["opt"], snap["step"])
        if snap["rng"] is not None:
            self._gen.set_state(torch.as_tensor(np.asarray(snap["rng"]), dtype=torch.uint8))

    def sync_model(self) -> nn.Module:
        """Write the live parameters and buffers back into the module."""
        state = full_tree(self.state)
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(state["params"][k])
            for k, b in self.model.named_buffers():
                b.copy_(state["buffers"][k])
        return self.model


def _as_tuple(x) -> Tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class DataParallel:
    """``paddle.DataParallel(model)``'s shape: carries the model into
    :class:`SpmdTrainer` (nothing to wrap at the layer level)."""

    def __init__(self, model: nn.Module) -> None:
        self.model = model

    def trainer(self, optimizer, loss_fn, mesh: Mesh, **kw) -> SpmdTrainer:
        return SpmdTrainer(self.model, optimizer, loss_fn, mesh, **kw)
