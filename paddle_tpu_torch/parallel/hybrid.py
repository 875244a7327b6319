"""Hybrid parallelism: ERNIE over a dp×pp×cp×mp mesh of logical ranks.

Port of ``paddle_tpu.parallel.hybrid.HybridParallelTrainer``. The JAX
trainer runs one ``shard_map``'d, jitted step over a device mesh; here
the mesh's ranks are logical, all on one device (``core.mesh``), and a
step runs the per-rank function of every rank in lockstep
(``ops.collectives.run_ranks``), the ranks meeting at each collective by
axis name.

Axes: ``dp`` batch; ``pp`` pipeline stages (``parallel.pipeline``);
``cp`` sequence shard (the ring over cp in every attention call);
``mp`` tensor parallel; ``ep`` rides ``dp`` when the model has experts
(the MoE all-to-all crosses the data-parallel group). The JAX trainer's
fifth axis ``sh`` (ZeRO: optimizer state sharded over an inner
data-parallel group) is not ported: a mesh with ``"sh" > 1`` raises
(ROADMAP item 7, with ``parallel/spmd.py`` and ``parallel/sharding.py``).

State keeps the JAX trainer's tree and names: ``params = {"stages":
{"params": {name: [pp, …]}, "buffers": {…}}, "aux": {"embed": {…},
"head": {…}}}``, every leaf at its GLOBAL shape (stage parameters
stacked on a leading pp dimension), so checkpoints do not depend on the
layout. A rank reads its shard as a VIEW of the global tensor, cut by
``models.ernie.partition_spec``; the ranks' forwards build one autograd
graph, so the one backward sums every rank's gradient of a replicated
parameter into its one global gradient. That is what the JAX trainer's
``spec_reduced_grads`` psums do explicitly. The update is the port's
functional ``optimizer.update`` on the global tensors (keys: the tree
paths joined by "/", :func:`flatten_tree`).

The loss is the mean token cross entropy over the dp×cp token grid:
each rank's mean over its shard, divided by dp·cp, psummed over dp and
cp. Rank 0's loss (every rank holds the same value) is the one the
backward starts from.

Dropout draws from a generator a rank, seeded each step from the
trainer's own ``torch.Generator`` and the rank's pp coordinate (the JAX
trainer folds the pp index into its step key), so ranks that hold the
same activation draw the same mask. The draws are not the JAX
package's: the two agree at dropout 0, the config's default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.enforce import InvalidArgumentError, UnavailableError, enforce
from ..core.mesh import Mesh
from ..models.ernie import (_ATTN_IMPLS, ErnieConfig, ErnieEmbedding, ErnieHead, ErnieStage,
                            parallel_cross_entropy, partition_spec)
from ..nn import Dropout
from ..ops import collectives as coll
from .pipeline import pipeline_spmd_fn

__all__ = ["HybridParallelTrainer", "flatten_tree", "unflatten_tree"]

Tree = Dict[str, Any]


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts → {"a/b/leaf.name": leaf} (the names inside a state
    dict hold dots, so the tree levels join with "/")."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Tree:
    """Inverse of :func:`flatten_tree` (an empty dict of the tree has no
    path, so it does not come back: :func:`_with_leaves` keeps it)."""
    tree: Tree = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def _with_leaves(tree: Tree, flat: Dict[str, Any], prefix: str = "") -> Tree:
    """``tree``'s structure with the leaves of ``flat`` (by path)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _with_leaves(v, flat, path) if isinstance(v, dict) else flat[path]
    return out


def _module_state(m: nn.Module) -> Tree:
    return {"params": dict(m.named_parameters()), "buffers": dict(m.named_buffers())}


def _bind(module: nn.Module, state: Tree) -> None:
    """Install ``state``'s tensors (this rank's views) as ``module``'s
    parameters and buffers, by name."""
    for group, slot in (("params", "_parameters"), ("buffers", "_buffers")):
        for name, t in state.get(group, {}).items():
            owner, _, leaf = name.rpartition(".")
            sub = module.get_submodule(owner) if owner else module
            getattr(sub, slot)[leaf] = t


def _shard(t: torch.Tensor, spec: Tuple[Optional[str], ...], coords: Dict[str, int],
           shape: Dict[str, int]) -> torch.Tensor:
    """This rank's view of the global ``t`` laid out by ``spec``: a
    leading "pp" keeps its stage as a dimension of 1 (the JAX shard's
    shape); every other named dimension is cut into the axis's size."""
    for dim, axis in enumerate(spec):
        if axis is None or axis not in shape:
            continue
        n, c = shape[axis], coords[axis]
        per = t.shape[dim] // n
        t = t.narrow(dim, c * per, per)
    return t


class HybridParallelTrainer:
    """dp×pp×cp×mp training of an ERNIE-family model over ``mesh``, a
    ``core.mesh`` with at least the axes dp, pp, cp and mp (and at most a
    size-1 ``sh``). ``optimizer`` is one of the port's functional
    optimizers; ``train_step(ids, labels)`` takes the global [batch, seq]
    batch (batch a multiple of ``num_micro``·dp, seq of cp) and returns
    the step's loss. ``device`` (None: the card, raising without one)
    must be the mesh's device."""

    def __init__(self, cfg: ErnieConfig, mesh: Mesh, optimizer, num_micro: int = 2,
                 seed: int = 0, device: Optional[Union[str, torch.device]] = None) -> None:
        dev = resolve_device(device)
        enforce(dev.type == mesh.device.type,
                f"the mesh lives on {mesh.device}, the trainer on {dev}", InvalidArgumentError)
        for ax in ("dp", "pp", "cp", "mp"):
            enforce(ax in mesh.shape, f"hybrid mesh lacks axis {ax!r}", InvalidArgumentError)
        enforce(mesh.shape.get("sh", 1) == 1,
                f"the sharding (ZeRO) axis sh={mesh.shape.get('sh')} is not ported: it comes "
                "with parallel/spmd.py and parallel/sharding.py (ROADMAP item 7)",
                UnavailableError)
        enforce(cfg.attn_impl in _ATTN_IMPLS,
                f"attn_impl must be one of {_ATTN_IMPLS}, got {cfg.attn_impl!r}",
                InvalidArgumentError)
        pp = mesh.shape["pp"]
        enforce(cfg.num_layers % pp == 0,
                f"num_layers ({cfg.num_layers}) must divide over pp ({pp})", InvalidArgumentError)
        if cfg.num_experts:
            # ep rides dp: the MoE all-to-all crosses the data-parallel group
            cfg = dataclasses.replace(cfg, ep_axis="dp")
        self.cfg = cfg
        self.mesh = mesh
        self.device = dev
        self.num_micro = num_micro
        self.optimizer = optimizer
        self.blocks_per_stage = cfg.num_layers // pp

        gen = torch.Generator().manual_seed(seed)
        stages = [_module_state(ErnieStage(cfg, self.blocks_per_stage, gen)) for _ in range(pp)]
        stacked = {g: {k: torch.stack([s[g][k] for s in stages]).detach().to(dev)
                       for k in stages[0][g]} for g in ("params", "buffers")}
        aux = {name: {g: {k: v.detach().to(dev) for k, v in st[g].items()}
                      for g in ("params", "buffers")}
               for name, st in (("embed", _module_state(ErnieEmbedding(cfg, gen))),
                                ("head", _module_state(ErnieHead(cfg, gen))))}
        self.params: Tree = {"stages": stacked, "aux": aux}
        self.opt_state = optimizer.init(flatten_tree(self.params))
        self._specs = self._spec_tree()

        # each rank's own modules (their storage on the meta device; a step
        # binds the rank's views into them), so no two threads share one
        with torch.device("meta"):
            self._rank_modules = [
                {"stage": ErnieStage(cfg, self.blocks_per_stage), "embed": ErnieEmbedding(cfg),
                 "head": ErnieHead(cfg)} for _ in range(mesh.size)]
        for mods in self._rank_modules:
            for m in mods.values():
                m.train()
        self._gen = torch.Generator().manual_seed(seed)
        self.global_step = 0
        self.last_aux_loss: Optional[float] = None

    # -- layout --------------------------------------------------------------

    def _spec_tree(self) -> Dict[str, Tuple[Optional[str], ...]]:
        specs = {}
        for path, t in flatten_tree(self.params).items():
            name = path.rsplit("/", 1)[-1]
            specs[path] = partition_spec(name, t, self.cfg,
                                         leading_pp=path.startswith("stages/"))
        return specs

    def _rank_view(self, flat: Dict[str, torch.Tensor], rank: int) -> Tree:
        coords = self.mesh.coords(rank)
        return unflatten_tree({p: _shard(t, self._specs[p], coords, self.mesh.shape)
                               for p, t in flat.items()})

    # -- the step ------------------------------------------------------------

    def _loss_fn(self, flat: Dict[str, torch.Tensor], ids_m: torch.Tensor,
                 labels_m: torch.Tensor, step_seed: Optional[int]):
        cfg, mesh = self.cfg, self.mesh
        dp, cp = mesh.shape["dp"], mesh.shape["cp"]
        M, B, L = ids_m.shape
        enforce(B % dp == 0 and L % cp == 0,
                f"micro-batch {B} x seq {L} does not split over dp={dp}, cp={cp}",
                InvalidArgumentError)
        Bl, Ll = B // dp, L // cp

        def rank_fn(rank: int):
            mods = self._rank_modules[rank]
            c = mesh.coords(rank)
            local = self._rank_view(flat, rank)
            _bind(mods["embed"], local["aux"]["embed"])
            _bind(mods["head"], local["aux"]["head"])
            if step_seed is not None:
                g = torch.Generator(self.device).manual_seed(step_seed * 1_000_003 + c["pp"])
                for m in mods.values():
                    for d in m.modules():
                        if isinstance(d, Dropout):
                            d.generator = g
            stage = mods["stage"]

            def stage_apply(state, x):
                _bind(stage, state)
                return stage(x)

            pipe = pipeline_spmd_fn(stage_apply, mesh.shape["pp"], self.num_micro, "pp",
                                    lambda st, x: mods["embed"](x),
                                    lambda st, y: mods["head"](y))
            sl = (slice(None), slice(c["dp"] * Bl, (c["dp"] + 1) * Bl),
                  slice(c["cp"] * Ll, (c["cp"] + 1) * Ll))
            logits = pipe(local["stages"], local["aux"], ids_m[sl])
            ce = parallel_cross_entropy(logits, labels_m[sl], cfg.vocab_size, cfg.mp_axis)
            return coll.psum(ce.mean() / (dp * cp), ("dp", "cp"))

        return coll.run_ranks(mesh, rank_fn)[0]

    def _aux_losses(self) -> Optional[float]:
        """The MoE blocks' load-balancing losses of each rank's last tick,
        averaged (logged only: the JAX trainer leaves them out of the
        loss, and so does this one)."""
        vals = [b.ffn.aux_loss.detach() for mods in self._rank_modules
                for b in mods["stage"].blocks if hasattr(b.ffn, "aux_loss")]
        return float(torch.stack(vals).mean()) if vals else None

    def _unbind(self) -> None:
        """Drop the ranks' bindings, so the step's old tensors go."""
        for mods in self._rank_modules:
            for mod in mods.values():
                for m in mod.modules():
                    for slot in (m._parameters, m._buffers):
                        for k in slot:
                            slot[k] = None

    def train_step(self, ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One step on the global batch ``ids``/``labels`` [batch, seq]
        (split into ``num_micro`` micro-batches, each over dp, the
        sequence over cp); returns the loss (a 0-dim tensor)."""
        B = ids.shape[0]
        M = self.num_micro
        enforce(B % M == 0, f"batch {B} must divide into num_micro={M}", InvalidArgumentError)
        ids_m = torch.as_tensor(ids, device=self.device).reshape(M, B // M, *ids.shape[1:])
        labels_m = torch.as_tensor(labels, device=self.device).reshape(M, B // M,
                                                                       *labels.shape[1:])
        step_seed = None
        if self.cfg.dropout > 0:
            step_seed = int(torch.randint(0, 2**31 - 1, (), generator=self._gen))
        flat = flatten_tree(self.params)
        leaves = {k: (t.detach().requires_grad_(True) if "/params/" in k else t)
                  for k, t in flat.items()}
        with torch.profiler.record_function("hybrid_forward"):
            loss = self._loss_fn(leaves, ids_m, labels_m, step_seed)
        wrt = [k for k in leaves if leaves[k].requires_grad]
        with torch.profiler.record_function("hybrid_backward"):
            got = torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True)
        grads = {k: torch.zeros_like(t) for k, t in flat.items()}
        for k, g in zip(wrt, got):
            if g is not None:
                grads[k] = g
        with torch.profiler.record_function("hybrid_update"):
            new_flat, self.opt_state = self.optimizer.update(grads, self.opt_state, flat)
        self.params = _with_leaves(self.params, new_flat)
        self.global_step += 1
        if self.cfg.num_experts:
            self.last_aux_loss = self._aux_losses()
        self._unbind()
        return loss.detach()

    # -- the serial model's view -------------------------------------------------

    def serial_state_dict(self) -> Dict[str, torch.Tensor]:
        """The params as the serial ``models.ernie.Ernie``'s state dict:
        stage s's block b is ``blocks.{s·blocks_per_stage + b}``."""
        out = {}
        for g in ("params", "buffers"):
            for name, arr in self.params["stages"][g].items():
                _, b, rest = name.split(".", 2)
                for s in range(arr.shape[0]):
                    out[f"blocks.{s * self.blocks_per_stage + int(b)}.{rest}"] = arr[s]
            for an in ("embed", "head"):
                for name, arr in self.params["aux"][an][g].items():
                    out[f"{an}.{name}"] = arr
        return out

    # -- checkpoints ----------------------------------------------------------------

    def save(self, path: str) -> None:
        """Params, optimizer state, the trainer's generator state and the
        step in the JAX trainer's snapshot schema (params at global
        shapes, so a snapshot restores onto any layout; the optimizer
        state in the JAX layout ``{"step", "slots": {...}}``). The rng
        entry is the port's generator state, not a JAX key."""
        from ..convert import opt_state_to_jax
        from ..io.checkpoint import save_train_state

        opt = opt_state_to_jax(self.opt_state, self.optimizer, params_to_jax=lambda flat:
                               unflatten_tree({p: t.detach().cpu().numpy()
                                               for p, t in flat.items()}))
        save_train_state(path, self.params, opt_state=opt, rng=self._gen.get_state(),
                         step=self.global_step)

    def load(self, path: str) -> None:
        """Restore a snapshot written by :meth:`save` into the live trees
        (by key path, each leaf on this trainer's device); training then
        continues the same step count and generator stream."""
        from ..convert import opt_state_from_jax
        from ..io.checkpoint import graft_into, load_train_state

        snap = load_train_state(path)
        self.params = graft_into(self.params, snap["state"])
        flat = flatten_tree(self.params)
        self.opt_state = opt_state_from_jax(
            snap["opt"], self.optimizer, self.device,
            params_from_jax=lambda tree, dev: graft_into(flat, flatten_tree(tree)))
        if snap["rng"] is not None:
            self._gen.set_state(torch.as_tensor(np.asarray(snap["rng"]), dtype=torch.uint8))
        self.global_step = snap["step"]
