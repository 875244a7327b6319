"""Pipeline parallelism: the layer container, the per-rank pipeline and
the pipeline trainer.

Port of ``paddle_tpu.parallel.pipeline`` (the reference's static
``pipeline_optimizer`` + ``SectionWorker`` schedules, the FleetExecutor
interceptors and dygraph ``PipelineParallel``). Stages live on the
``pp`` axis of a ``core.mesh`` of logical ranks and run in lockstep
under ``ops.collectives.run_ranks`` (a thread a rank, all on one
device); activations move between neighbouring stages by ``shift`` over
pp. Stages are structurally identical (transformer-block style), their
parameters stacked on a leading dimension.

:func:`pipeline_spmd_fn` is the F-then-B pipeline: micro-batches
advance through M + S − 1 ticks; at tick t stage 0 takes micro-batch t
(clamped to the last), every other stage what its left neighbour sent
at the tick before, and the last stage's outputs of ticks
[S − 1, S − 1 + M) are the micro-batches' results. Autograd through the
ticks and shifts gives the reverse pipeline. The JAX function replicates
the result over pp by a psum of every stage's output masked to the last
stage's; here the last stage's output is broadcast as it is, so no
backward runs for the bubbles' outputs. Only the last stage applies the
head.

:class:`PipelineTrainer` runs the three schedules of the JAX trainer:
``"f_then_b"`` (the function above, one autograd graph over the step),
``"1f1b"`` and ``"interleave"`` (``parallel.pipeline_1f1b``: each
rank's items with explicit gradients, a bounded stash, no graph across
ticks). With a ``dp`` axis each micro-batch is sharded over it and the
loss is the mean of the shards' means (``loss_fn`` must be a per-batch
mean). Divergences from the JAX trainer: dropout draws from a generator
a rank, seeded each step from the trainer's ``torch.Generator`` (and,
under 1F1B, the item), not JAX's keys, so the runs agree at dropout 0;
the checkpoint holds the port's own trees (``Linear`` weights
``[out, in]``) and its generator state in the JAX trainer's schema.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..core.enforce import InvalidArgumentError, enforce, enforce_eq
from ..core.mesh import Mesh
from ..ops import collectives as coll
from .pipeline_1f1b import pipeline_1f1b_fn

__all__ = ["LayerDesc", "PipelineLayer", "PipelineTrainer", "flatten_tree", "pipeline_spmd_fn",
           "unflatten_tree"]

Tree = Dict[str, Any]


# -- state trees ---------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
    path, so it does not come back: :func:`with_leaves` keeps it)."""
    tree: Tree = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def with_leaves(tree: Tree, flat: Dict[str, Any], prefix: str = "") -> Tree:
    """``tree``'s structure with the leaves of ``flat`` (by path)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = with_leaves(v, flat, path) if isinstance(v, dict) else flat[path]
    return out


def module_state(m: nn.Module) -> Tree:
    return {"params": dict(m.named_parameters()), "buffers": dict(m.named_buffers())}


def bind(module: nn.Module, state: Tree) -> None:
    """Install ``state``'s tensors as ``module``'s parameters and
    buffers, by name (each rank binds its own views into its own module,
    so no two threads share one)."""
    for group, slot in (("params", "_parameters"), ("buffers", "_buffers")):
        for name, t in state.get(group, {}).items():
            owner, _, leaf = name.rpartition(".")
            sub = module.get_submodule(owner) if owner else module
            getattr(sub, slot)[leaf] = t


def meta_clone(module: nn.Module) -> nn.Module:
    """A structural copy of ``module`` whose tensors are on the meta
    device (no data is copied) and whose dropout generators are unset: a
    rank's own module, into which a step binds the rank's tensors."""
    memo = {id(t): torch.empty_like(t, device="meta")
            for t in list(module.parameters()) + list(module.buffers())}
    for m in module.modules():
        if isinstance(getattr(m, "generator", None), torch.Generator):
            memo[id(m.generator)] = None
    return copy.deepcopy(module, memo)


def dropout_modules(module: nn.Module) -> List[nn.Module]:
    """The modules of ``module`` that draw from a ``generator`` (the
    port's ``Dropout``) with a positive rate."""
    return [m for m in module.modules() if hasattr(m, "generator") and getattr(m, "p", 0) > 0]


# -- the container ---------------------------------------------------------------------

class LayerDesc:
    """Deferred layer construction (pp_layers.py ``LayerDesc``): a stage is
    built where it is needed."""

    def __init__(self, layer_cls, *args, **kwargs) -> None:
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self) -> nn.Module:
        return self.layer_cls(*self.args, **self.kwargs)


class PipelineLayer(nn.Module):
    """S structurally identical stages plus an optional ``embed`` and
    ``head`` (pp_layers.py ``PipelineLayer``); ``forward`` is the serial
    model."""

    def __init__(self, stage_descs: Sequence[LayerDesc], embed: Optional[nn.Module] = None,
                 head: Optional[nn.Module] = None) -> None:
        super().__init__()
        self.num_stages = len(stage_descs)
        self.stages = nn.ModuleList([d.build() for d in stage_descs])
        self.embed = embed
        self.head = head

    def stage_stacked_state(self) -> Tree:
        """The stages' parameters and buffers stacked on a new leading
        dimension (detached)."""
        states = [module_state(s) for s in self.stages]
        return {g: {k: torch.stack([s[g][k].detach() for s in states]) for k in states[0][g]}
                for g in ("params", "buffers")}

    def aux_state(self) -> Tree:
        return {name: _tree_map(lambda t: t.detach(), module_state(m))
                for name, m in (("embed", self.embed), ("head", self.head)) if m is not None}

    def forward(self, x):
        if self.embed is not None:
            x = self.embed(x)
        for s in self.stages:
            x = s(x)
        if self.head is not None:
            x = self.head(x)
        return x


# -- the F-then-B pipeline ----------------------------------------------------------------

def pipeline_spmd_fn(stage_apply: Callable[[Any, torch.Tensor], torch.Tensor],
                     num_stages: int, num_micro: int, pp_axis: str = "pp",
                     embed_apply: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None,
                     head_apply: Optional[Callable[[Any, torch.Tensor], torch.Tensor]] = None):
    """The per-rank pipeline function ``fn(stacked_stage_state, aux_state,
    x_micro) -> y_micro``, called inside ``run_ranks`` with this rank's
    view of the stacked stage state (leading dimension 1: its stage) and
    ``x_micro`` [num_micro, micro_batch, ...] — the same on every pp rank
    (a caller may shard micro_batch over dp, as the trainers do). Returns
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


# -- the trainer ------------------------------------------------------------------------

_SCHEDULES = ("f_then_b", "1f1b", "interleave")


class PipelineTrainer:
    """Pipeline training over the pp axis of ``mesh`` (a ``core.mesh`` on
    the trainer's device; ``device`` None means the card and raises
    without one). ``optimizer`` is one of the port's functional
    optimizers (or a ``distributed.meta_optimizers`` chain) over the flat
    parameter dict (keys: the tree paths joined by "/"). ``loss_fn(pred,
    label)`` is a per-micro-batch mean.

    ``schedule``: ``"f_then_b"`` (all forwards, then autograd through
    them: activations O(M) a rank), ``"1f1b"`` (a bounded stash of 2·S
    inputs and a recomputed forward per backward item) or
    ``"interleave"`` (1F1B with ``num_virtual`` chunks a rank; the model
    has pp × num_virtual stages). Axes of the mesh other than pp and
    ``dp_axis`` replicate the work (their ranks compute the same
    values)."""

    def __init__(self, model: PipelineLayer, optimizer, loss_fn: Callable, mesh: Mesh,
                 num_micro: int, pp_axis: str = "pp", seed: int = 0,
                 schedule: str = "f_then_b", num_virtual: int = 1, dp_axis: str = "dp",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        dev = resolve_device(device)
        enforce(dev.type == mesh.device.type,
                f"the mesh lives on {mesh.device}, the trainer on {dev}", InvalidArgumentError)
        enforce(pp_axis in mesh.shape, f"mesh lacks {pp_axis!r} axis", InvalidArgumentError)
        enforce(schedule in _SCHEDULES, f"unknown schedule {schedule!r}", InvalidArgumentError)
        V = num_virtual if schedule == "interleave" else 1
        enforce_eq(mesh.shape[pp_axis] * V, model.num_stages,
                   "stages must equal pp size × num_virtual")
        self.model = model
        self.mesh = mesh
        self.device = dev
        self.num_micro = int(num_micro)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.schedule = schedule
        self.pp_axis = pp_axis
        self.num_virtual = V
        self.dp_axis = dp_axis if dp_axis in mesh.shape else None
        self._dp_n = mesh.shape[self.dp_axis] if self.dp_axis else 1

        to_dev = lambda t: t.detach().to(dev)   # noqa: E731
        self.params: Tree = {"stages": _tree_map(to_dev, model.stage_stacked_state()),
                             "aux": _tree_map(to_dev, model.aux_state())}
        self.opt_state = optimizer.init(self.flat_params())
        # each rank's own modules (meta tensors; a step binds the rank's views)
        self._rank_modules = []
        for _ in range(mesh.size):
            mods = {"stage": meta_clone(model.stages[0])}
            for name in ("embed", "head"):
                if getattr(model, name) is not None:
                    mods[name] = meta_clone(getattr(model, name))
            for m in mods.values():
                m.train()
            self._rank_modules.append(mods)
        self._dropout = bool(dropout_modules(model))
        self._gen = torch.Generator().manual_seed(seed)
        self.global_step = 0
        #: under 1F1B, the most stashed inputs a rank held at once in the last step
        self.last_max_stash = 0

    # -- the state ---------------------------------------------------------------------

    def flat_params(self) -> Dict[str, torch.Tensor]:
        """The parameters as the optimizer sees them: {tree path: tensor}
        (``"stages/params/<name>"`` stacked [stages, ...],
        ``"aux/<embed|head>/params/<name>"``)."""
        return {k: t for k, t in flatten_tree(self.params).items() if "/params/" in k}

    def _primary(self, rank: int) -> bool:
        """A rank whose coordinates off pp and dp are 0 (the replicas of
        other axes compute the same values)."""
        c = self.mesh.coords(rank)
        return all(v == 0 for a, v in c.items() if a not in (self.pp_axis, self.dp_axis))

    def _rank_seed(self, step_seed: Optional[int], rank: int, *item: int) -> Optional[int]:
        if step_seed is None:
            return None
        c = self.mesh.coords(rank)
        s = step_seed * 1_000_003 + c[self.pp_axis]
        for i in item:
            s = s * 1_000_033 + i + 1
        return s % (2 ** 63)

    def _rank_generator(self, mods) -> Optional[torch.Generator]:
        if not self._dropout:
            return None
        g = torch.Generator(self.device)
        for m in mods.values():
            for d in dropout_modules(m):
                d.generator = g
        return g

    def _unbind(self) -> None:
        """Drop the ranks' bindings, so the step's old tensors go."""
        for mods in self._rank_modules:
            for mod in mods.values():
                for m in mod.modules():
                    for slot in (m._parameters, m._buffers):
                        for k in slot:
                            slot[k] = None

    # -- the step ----------------------------------------------------------------------

    def _micro(self, t: torch.Tensor) -> torch.Tensor:
        B, M = t.shape[0], self.num_micro
        enforce_eq(B % M, 0, f"batch size {B} must be divisible by num_micro={M}")
        enforce_eq((B // M) % self._dp_n, 0, f"micro-batch {B // M} must divide over "
                   f"dp={self._dp_n}")
        return torch.as_tensor(t, device=self.device).reshape(M, B // M, *t.shape[1:])

    def _dp_slice(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        if self.dp_axis is None:
            return t
        n = t.shape[1] // self._dp_n
        d = self.mesh.coords(rank)[self.dp_axis]
        return t[:, d * n:(d + 1) * n]

    def _f_then_b_loss(self, leaves: Dict[str, torch.Tensor], xm, ym, step_seed):
        S, M, pp = self.mesh.shape[self.pp_axis], self.num_micro, self.pp_axis
        tree = unflatten_tree(leaves)

        def rank_fn(rank: int):
            mods = self._rank_modules[rank]
            r = self.mesh.coords(rank)[pp]
            g = self._rank_generator(mods)
            if g is not None:
                g.manual_seed(self._rank_seed(step_seed, rank))
            stage = mods["stage"]
            for name in ("embed", "head"):
                if name in mods:
                    bind(mods[name], tree["aux"][name])

            def stage_apply(state, x):
                bind(stage, state)
                return stage(x)

            pipe = pipeline_spmd_fn(
                stage_apply, S, M, pp,
                (lambda st, x: mods["embed"](x)) if "embed" in mods else None,
                (lambda st, y: mods["head"](y)) if "head" in mods else None)
            local = _tree_map(lambda t: t[r:r + 1], tree["stages"])
            preds = pipe(local, tree["aux"], self._dp_slice(rank, xm))
            y = self._dp_slice(rank, ym)
            loss = torch.stack([self.loss_fn(preds[m], y[m]) for m in range(M)]).mean()
            return coll.psum(loss / self._dp_n, self.dp_axis) if self.dp_axis else loss

        return coll.run_ranks(self.mesh, rank_fn)[0]

    def _f_then_b_grads(self, xm, ym, step_seed):
        flat = flatten_tree(self.params)
        leaves = {k: (t.detach().requires_grad_(True) if "/params/" in k else t)
                  for k, t in flat.items()}
        with torch.profiler.record_function("pipeline_forward"):
            loss = self._f_then_b_loss(leaves, xm, ym, step_seed)
        wrt = [k for k in leaves if leaves[k].requires_grad]
        with torch.profiler.record_function("pipeline_backward"):
            got = torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True)
        grads = {k: (torch.zeros_like(leaves[k]) if g is None else g) for k, g in zip(wrt, got)}
        return loss.detach(), grads

    def _1f1b_grads(self, xm, ym, step_seed):
        S, V, M = self.mesh.shape[self.pp_axis], self.num_virtual, self.num_micro
        tree = self.params
        stats = [0] * self.mesh.size

        def rank_fn(rank: int):
            mods = self._rank_modules[rank]
            r = self.mesh.coords(rank)[self.pp_axis]
            g = self._rank_generator(mods)

            def reseed(*item):
                if g is not None:
                    g.manual_seed(self._rank_seed(step_seed, rank, *item))

            def apply(name):
                def run(state, x):
                    bind(mods[name], state)
                    return mods[name](x)
                return run

            chunks = [_tree_map(lambda t, l=v * S + r: t[l], tree["stages"]) for v in range(V)]
            fn = pipeline_1f1b_fn(apply("stage"), S, V, M, self.loss_fn, self.pp_axis,
                                  apply("embed") if "embed" in mods else None,
                                  apply("head") if "head" in mods else None, reseed=reseed)
            loss, g_chunks, g_aux, max_stash = fn(chunks, tree["aux"], self._dp_slice(rank, xm),
                                                  self._dp_slice(rank, ym))
            stats[rank] = max_stash
            return loss, g_chunks, g_aux

        with torch.profiler.record_function("pipeline_1f1b"):
            results = coll.run_ranks(self.mesh, rank_fn)
        self.last_max_stash = max(stats)
        # the JAX step's psums: stage grads over dp, aux grads and the loss
        # over pp and dp, all / (M·dp); summed here in rank order
        scale = 1.0 / (M * self._dp_n)
        grads = {k: torch.zeros_like(t) for k, t in self.flat_params().items()}
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for rank, (l_r, g_chunks, g_aux) in enumerate(results):
            if not self._primary(rank):
                continue
            r = self.mesh.coords(rank)[self.pp_axis]
            loss = loss + l_r
            for v, gv in enumerate(g_chunks):
                for name, gt in gv.items():
                    grads[f"stages/params/{name}"][v * S + r] += gt
            for part, gp in g_aux.items():
                for name, gt in gp.items():
                    grads[f"aux/{part}/params/{name}"] += gt
        grads = {k: g * scale for k, g in grads.items()}
        return loss / self._dp_n, grads

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: [batch, ...], split into num_micro micro-batches on dim 0
        (each then sharded over the mesh's dp axis); returns the loss (a
        0-dim tensor)."""
        xm, ym = self._micro(x), self._micro(y)
        step_seed = None
        if self._dropout:
            step_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self._gen))
        if self.schedule == "f_then_b":
            loss, grads = self._f_then_b_grads(xm, ym, step_seed)
        else:
            loss, grads = self._1f1b_grads(xm, ym, step_seed)
        with torch.profiler.record_function("pipeline_update"):
            new_flat, self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                             self.flat_params())
        flat = flatten_tree(self.params)
        flat.update(new_flat)
        self.params = with_leaves(self.params, flat)
        self.global_step += 1
        self._unbind()
        return loss

    # -- checkpoints and the model -------------------------------------------------------

    def save(self, path: str) -> None:
        """Params, optimizer state, the trainer's generator state and the
        step, in the JAX trainer's snapshot schema (``io.checkpoint``)."""
        from ..io.checkpoint import save_train_state

        save_train_state(path, self.params, opt_state=self.opt_state,
                         rng=self._gen.get_state(), step=self.global_step)

    def load(self, path: str) -> None:
        """Restore a :meth:`save` snapshot into the live trees (by key path,
        on this trainer's device); training continues the same step count
        and generator stream."""
        from ..io.checkpoint import graft_into, load_train_state

        snap = load_train_state(path)
        self.params = graft_into(self.params, snap["state"])
        self.opt_state = graft_into(self.opt_state, snap["opt"])
        if snap["rng"] is not None:
            self._gen.set_state(torch.as_tensor(np.asarray(snap["rng"]), dtype=torch.uint8))
        self.global_step = snap["step"]

    @torch.no_grad()
    def sync_model(self) -> PipelineLayer:
        """Write the trained params and buffers back into ``model`` (each
        tensor on the model's own device) and return it."""
        for i, stage in enumerate(self.model.stages):
            for g, st in module_state(stage).items():
                for name, t in st.items():
                    t.copy_(self.params["stages"][g][name][i])
        for name, st in self.params["aux"].items():
            for g, group in module_state(getattr(self.model, name)).items():
                for k, t in group.items():
                    t.copy_(st[g][k])
        return self.model
