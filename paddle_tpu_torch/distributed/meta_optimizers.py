"""Fleet meta-optimizers: the dense strategy flags as optimizer wrappers.

Port of ``paddle_tpu.distributed.meta_optimizers`` (the reference's
``fleet/meta_optimizers/``, chained by ``StrategyCompiler``). Each
wrapper holds an ``inner`` optimizer and keeps the port's functional
contract, ``init(params)`` / ``update(grads, opt_state, params)`` over a
dict of tensors; its own state sits under its own keys beside
``"inner"``, so a chain checkpoints like any optimizer state.

``apply_strategy`` builds the chain a ``DistributedStrategy`` implies, in
the JAX package's order, innermost to outermost: the lars/lamb base swap
→ dgc → fp16_allreduce → asp → localsgd → gradient_merge → recompute →
amp.

The JAX wrappers branch with ``lax.cond`` inside a compiled step. Here a
step stays free of host syncs the same way: a wrapper that skips or
holds (AMP on a non-finite step, GradientMerge before its k-th step,
LocalSGD between averages) computes both branches and selects each
tensor with ``torch.where`` on the device, which gives the taken
branch's values exactly. One exception: a GradientMerge over a reducer
reads its counter on the host, so a held step enters no collective.

PRE-REDUCTION CONTRACT (``distributed.comm_fusion``): given a
``DpGradReducer``, ``apply_strategy`` builds the chain for gradients
that arrive UNREDUCED (each rank's own, from its thread under
``ops.collectives.run_ranks``), and exactly one wrapper,
:class:`FusedAllReduceOptimizer` (innermost), performs the fused-bucket
collective: FP16AllReduce routes its dtype onto that wire, DGC's
released tensor is what is reduced, GradientMerge's held steps enter no
collective, LocalSGD suspends the reducer (its every-k param average is
the only collective), and AMP makes its skip decision uniform across
the ranks. The state that is per rank under this contract (GradientMerge's
``acc``, DGC's ``u``/``v``, the error-feedback residual ``ef``) is
declared by ``local_state_keys`` and tagged by :meth:`state_layout`.
Without a reducer the chain behaves as the JAX chain without one:
gradients arrive reduced.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..amp import GradScaler, LossScaleState
from ..core.enforce import InvalidArgumentError, enforce
from ..ops import collectives as coll
from ..optimizer import SGD, Lamb, Lars, Momentum, Optimizer

__all__ = ["MetaOptimizerBase", "AMPOptimizer", "GradientMergeOptimizer", "LocalSGDOptimizer",
           "DGCMomentumOptimizer", "FP16AllReduceOptimizer", "FusedAllReduceOptimizer",
           "ASPOptimizer", "RecomputeOptimizer", "apply_strategy", "select_runtime"]


def _tmap(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _tmap(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tmap(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tmap(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _select(cond: torch.Tensor, a: Any, b: Any) -> Any:
    """Tree-wise ``torch.where(cond, a, b)``: ``a`` where the 0-dim bool
    ``cond`` holds, else ``b`` (exactly one side's values)."""
    return _tmap(lambda x, y: torch.where(cond, x, y), a, b)


def _device(params: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def _tag(tree: Any, tag: str) -> Any:
    return _tmap(lambda _: tag, tree)


def _tag_slots(state: Any, names: set) -> Any:
    """A base optimizer's state over flat shards, tagged: every dict keyed
    by the param names (a slot) "shard", everything else "rep"."""
    if isinstance(state, dict):
        if state and set(state) == names:
            return _tag(state, "shard")
        return {k: _tag_slots(v, names) for k, v in state.items()}
    return _tag(state, "rep")


class MetaOptimizerBase(Optimizer):
    """Wrapper base: delegates to ``inner`` and namespaces extra state."""

    #: extra-state keys holding PER-RANK values under the pre-reduction
    #: contract (accumulated or residual LOCAL gradients): the trainer keeps
    #: one value a rank
    local_state_keys: Tuple[str, ...] = ()

    def __init__(self, inner: Optimizer) -> None:
        self.inner = inner
        # the outermost wrapper exposes no grad_clip/weight decay of its own
        self.grad_clip = None
        self.weight_decay = 0.0

    def init(self, params):
        return {"inner": self.inner.init(params), **self._init_extra(params)}

    def _init_extra(self, params) -> Dict[str, Any]:
        return {}

    def state_layout(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """A tag tree like ``opt_state``: each leaf "rep" (the same on every
        rank), "local" (one value a rank) or "shard" (a rank's flat 1/K
        shard: ZeRO slots under a shard-mode reducer). ``SpmdTrainer``'s
        fused step keeps the state by these tags."""
        out: Dict[str, Any] = {}
        for k, sub in opt_state.items():
            if k == "inner":
                out[k] = (self.inner.state_layout(sub)
                          if isinstance(self.inner, MetaOptimizerBase) else _tag(sub, "rep"))
            else:
                out[k] = _tag(sub, "local" if k in self.local_state_keys else "rep")
        return out

    def update(self, grads, opt_state, params):
        raise NotImplementedError


class AMPOptimizer(MetaOptimizerBase):
    """Mixed precision with dynamic loss scaling (amp_optimizer.py,
    update_loss_scaling_op.h): the gradients are of the loss scaled by
    :meth:`scale_loss`; a step whose unscaled gradients are not all
    finite is skipped and the scale decays. With a ``reducer`` each rank
    checked only its own gradients, so the decision is made uniform
    (``sync_all_finite``): every rank skips if one saw a non-finite."""

    def __init__(self, inner: Optimizer, init_loss_scaling: float = 2.0 ** 15,
                 incr_every_n_steps: int = 1000, decr_every_n_nan_or_inf: int = 2,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 use_dynamic_loss_scaling: bool = True, reducer=None) -> None:
        super().__init__(inner)
        self.scaler = GradScaler(init_loss_scaling, incr_ratio, decr_ratio, incr_every_n_steps,
                                 decr_every_n_nan_or_inf, use_dynamic_loss_scaling)
        self.reducer = reducer

    def _init_extra(self, params):
        return {"scaler": self.scaler.init(_device(params))}

    def scale_loss(self, loss: torch.Tensor, opt_state) -> torch.Tensor:
        return self.scaler.scale(loss, opt_state["scaler"])

    def update(self, grads, opt_state, params):
        sstate: LossScaleState = opt_state["scaler"]
        grads, ok = self.scaler.unscale(grads, sstate)
        if self.reducer is not None:
            ok = self.reducer.sync_all_finite(ok)
        new_params, new_inner = self.inner.update(grads, opt_state["inner"], params)
        new_params = _select(ok, new_params, params)
        new_inner = _select(ok, new_inner, opt_state["inner"])
        return new_params, {"inner": new_inner, "scaler": self.scaler.update(ok, sstate)}


class GradientMergeOptimizer(MetaOptimizerBase):
    """Gradient accumulation over ``k_steps`` steps
    (gradient_merge_optimizer.py): the inner optimizer applies the
    accumulated gradient (averaged when ``avg``) every k-th step; the
    steps between leave the params and the inner state as they are.

    Under the pre-reduction contract ``acc`` holds a rank's LOCAL
    gradients (per-rank state) and the collective lives in the inner
    chain. ``reducer`` (set by ``apply_strategy``) makes the step read the
    counter on the host and run the inner chain only on an applying
    step, so a held step enters no collective (the JAX chain's
    ``lax.cond`` puts it inside the apply branch)."""

    local_state_keys = ("acc",)

    def __init__(self, inner: Optimizer, k_steps: int = 1, avg: bool = True,
                 reducer=None) -> None:
        super().__init__(inner)
        enforce(k_steps >= 1, "k_steps must be >= 1")
        self.k_steps = int(k_steps)
        self.avg = bool(avg)
        self.reducer = reducer

    def _init_extra(self, params):
        return {"acc": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(self, grads, opt_state, params):
        acc = {k: a + grads[k].to(torch.float32) for k, a in opt_state["acc"].items()}
        count = opt_state["count"] + 1
        ready = count >= self.k_steps
        scale = 1.0 / self.k_steps if self.avg else 1.0
        if self.reducer is not None and not bool(ready):
            return params, {"inner": opt_state["inner"], "acc": acc, "count": count}
        merged = {k: (a * scale).to(grads[k].dtype) for k, a in acc.items()}
        applied, inner = self.inner.update(merged, opt_state["inner"], params)
        return _select(ready, applied, params), {
            "inner": _select(ready, inner, opt_state["inner"]),
            "acc": _select(ready, _tmap(torch.zeros_like, acc), acc),
            "count": torch.where(ready, torch.zeros_like(count), count)}


class LocalSGDOptimizer(MetaOptimizerBase):
    """Local SGD (localsgd_optimizer.py): the inner optimizer steps every
    step on a rank's local gradients, and every ``k_steps`` the params are
    averaged over the data-parallel ``axis`` (one name or a tuple). The
    average is the port's axis ``psum`` / axis size, so ``update`` runs
    inside ``ops.collectives.run_ranks`` (every rank of the axis calls
    it, every step); ``sync_fn`` replaces the average. With a ``reducer``
    the inner chain steps with the reducer suspended: no gradient
    collective, only the param average communicates."""

    def __init__(self, inner: Optimizer, k_steps: int = 1, axis="dp",
                 sync_fn: Optional[Callable[[Any], Any]] = None, reducer=None) -> None:
        super().__init__(inner)
        self.k_steps = int(k_steps)
        self.axis = axis
        self.reducer = reducer
        self._sync = sync_fn or self._pmean

    def _pmean(self, tree):
        axes = (self.axis,) if isinstance(self.axis, str) else tuple(self.axis)
        n = 1
        for a in axes:
            n *= coll.axis_size(a)
        return _tmap(lambda x: coll.psum(x, axes) / n, tree)

    def _init_extra(self, params):
        return {"count": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(self, grads, opt_state, params):
        if self.reducer is not None:
            with self.reducer.suspended():
                new_params, new_inner = self.inner.update(grads, opt_state["inner"], params)
        else:
            new_params, new_inner = self.inner.update(grads, opt_state["inner"], params)
        count = opt_state["count"] + 1
        ready = count >= self.k_steps
        new_params = _select(ready, self._sync(new_params), new_params)
        return new_params, {"inner": new_inner,
                            "count": torch.where(ready, torch.zeros_like(count), count)}


def _quantile(flat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(flat, q)`` (method "linear") with a 0-dim f32 ``q``:
    the sorted values at floor and ceil of q·(n − 1), interpolated in f32."""
    s = torch.sort(flat).values
    n = s.shape[0]
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    lo_i = low.clamp(0, n - 1).to(torch.int64)
    hi_i = high.clamp(0, n - 1).to(torch.int64)
    return s[lo_i] * w_low + s[hi_i] * w_high


class DGCMomentumOptimizer(MetaOptimizerBase):
    """Deep Gradient Compression (dgc_optimizer.py, dgc_op.h): momentum
    correction ``u = m·u + g``, residual ``v += u``; only the entries of
    ``|v|`` at or above the ``sparsity`` quantile are released to the
    inner update this step, the rest stay in ``v`` (and their ``u``
    survives). Sparsity ramps along ``sparsity`` every ``rampup_step``
    steps from ``rampup_begin_step``; before it, everything is released.
    The threshold is ``jnp.quantile``'s linear interpolation, so on
    inputs without ties the same entries are released as in JAX. Under
    the pre-reduction contract the released tensor is what the inner
    chain's collective reduces, and ``u``/``v`` are per-rank state."""

    local_state_keys = ("u", "v")

    def __init__(self, inner: Optimizer, momentum: float = 0.9, rampup_begin_step: int = 0,
                 rampup_step: int = 1, sparsity: Sequence[float] = (0.999,)) -> None:
        super().__init__(inner)
        self.momentum = float(momentum)
        self.rampup_begin_step = int(rampup_begin_step)
        self.rampup_step = int(rampup_step)
        self.sparsity = [float(s) for s in sparsity]

    def _init_extra(self, params):
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for k, p in params.items()}
        return {"u": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(self, grads, opt_state, params):
        step = opt_state["step"]
        table = torch.tensor(self.sparsity, dtype=torch.float32, device=step.device)
        idx = torch.div(step - self.rampup_begin_step, max(self.rampup_step, 1),
                        rounding_mode="floor").clamp(0, len(self.sparsity) - 1)
        sp = table[idx.to(torch.int64)].clamp(0.0, 1.0)
        active = step >= self.rampup_begin_step
        released, new_u, new_v = {}, {}, {}
        for k, g in grads.items():
            gf = g.to(torch.float32)
            u = self.momentum * opt_state["u"][k] + gf
            v = opt_state["v"][k] + u
            thr = _quantile(v.abs().reshape(-1), sp)
            mask = v.abs() >= thr
            zero = torch.zeros((), dtype=torch.float32, device=gf.device)
            rel = torch.where(active, torch.where(mask, v, zero), v)
            new_v[k] = torch.where(active, torch.where(mask, zero, v), zero)
            new_u[k] = torch.where(active & mask, zero, u)
            released[k] = rel.to(g.dtype)
        new_params, new_inner = self.inner.update(released, opt_state["inner"], params)
        return new_params, {"inner": new_inner, "u": new_u, "v": new_v, "step": step + 1}


class FP16AllReduceOptimizer(MetaOptimizerBase):
    """fp16_allreduce (fp16_allreduce_optimizer.py): gradients cross the
    wire in half precision. With an active ``reducer`` the dtype is routed
    onto the bucket collectives themselves (the reducer's ``wire_dtype``).
    Without one no wire is narrowed here: the round-trip cast reproduces
    the wire's precision, as the JAX chain does without one."""

    def __init__(self, inner: Optimizer, dtype=torch.bfloat16, reducer=None) -> None:
        super().__init__(inner)
        self.dtype = dtype
        self.reducer = reducer

    def update(self, grads, opt_state, params):
        r = self.reducer
        if r is not None and r.active:
            with r.wire_dtype(self.dtype):
                new_params, new_inner = self.inner.update(grads, opt_state["inner"], params)
            return new_params, {"inner": new_inner}
        restored = {k: g.to(self.dtype).to(g.dtype) for k, g in grads.items()}
        new_params, new_inner = self.inner.update(restored, opt_state["inner"], params)
        return new_params, {"inner": new_inner}


class FusedAllReduceOptimizer(MetaOptimizerBase):
    """THE reduction point of the pre-reduction contract: mean-reduces the
    (maybe DGC-compressed, maybe wire-dtype-overridden) gradients over the
    dp axes with the reducer's fused-bucket collectives, then hands them
    to the base optimizer. ``apply_strategy`` puts it innermost. Holds the
    fp32 error-feedback residual (int8) as per-rank state ``ef``.

    Shard-mode reducer (ZeRO stage 1/2): the inner optimizer was
    initialized over flat 1/K shards (``global_shard_template``) and
    updates this rank's reduce-scattered segment; the updated params come
    back by one ``all_gather`` a bucket."""

    local_state_keys = ("ef",)

    def __init__(self, inner: Optimizer, reducer) -> None:
        super().__init__(inner)
        enforce(reducer is not None, "FusedAllReduceOptimizer needs a reducer",
                InvalidArgumentError)
        self.reducer = reducer
        self._param_names: Optional[set] = None

    def _sharded(self) -> bool:
        return self.reducer.shard and self.reducer.K > 1

    def init(self, params):
        self._param_names = set(params)
        inner_params = self.reducer.global_shard_template(params) if self._sharded() else params
        return {"inner": self.inner.init(inner_params), "ef": self.reducer.init_ef(params)}

    def state_layout(self, opt_state):
        inner_st = opt_state["inner"]
        if self._sharded():
            inner_tags = _tag_slots(inner_st, self._param_names)
        elif isinstance(self.inner, MetaOptimizerBase):
            inner_tags = self.inner.state_layout(inner_st)
        else:
            inner_tags = _tag(inner_st, "rep")
        return {"inner": inner_tags, "ef": _tag(opt_state["ef"], "local")}

    def update(self, grads, opt_state, params):
        r = self.reducer
        ef = opt_state["ef"]
        if self._sharded():
            if r.active:
                g_sh, new_ef = r.reduce_to_shards(grads, ef)
            else:  # suspended (LocalSGD): the local shard, no collective
                g_sh, new_ef = r.slice_local_shards(grads), ef
            p_sh = r.slice_local_shards(params)
            new_p_sh, new_inner = self.inner.update(g_sh, opt_state["inner"], p_sh)
            new_params = r.gather_params_from_shards(new_p_sh, params)
        else:
            red, new_ef = r.reduce(grads, ef)
            new_params, new_inner = self.inner.update(red, opt_state["inner"], params)
        return new_params, {"inner": new_inner, "ef": new_ef}


class ASPOptimizer(MetaOptimizerBase):
    """ASP n:m structured sparsity (the reference's ``asp`` + fleet ASP):
    masks computed at ``init`` from the initial params keep the n largest
    magnitudes of every m contiguous entries along a 2-D tensor's last
    dimension (ties by position); the update masks the gradients and the
    new params, so pruned weights stay zero. Tensors that are not 2-D or
    whose last dimension m does not divide stay dense. The groups run
    along the last dimension as stored: a port ``Linear`` weight is
    ``[out, in]`` (the JAX one ``[in, out]``), so the same layer groups
    along its input dimension here, its output dimension there."""

    def __init__(self, inner: Optimizer, n: int = 2, m: int = 4) -> None:
        super().__init__(inner)
        self.n, self.m = n, m

    @staticmethod
    def _make_mask(w: torch.Tensor, n: int, m: int) -> torch.Tensor:
        if w.dim() != 2 or w.shape[-1] % m != 0:
            return torch.ones_like(w, dtype=torch.bool)
        groups = w.abs().reshape(w.shape[0], -1, m)
        thresh = torch.sort(groups, dim=-1, descending=True, stable=True).values[..., n - 1:n]
        rank = torch.argsort(torch.argsort(-groups, dim=-1, stable=True), dim=-1, stable=True)
        return ((groups >= thresh) & (rank < n)).reshape(w.shape)

    def _init_extra(self, params):
        return {"asp_mask": {k: self._make_mask(w, self.n, self.m) for k, w in params.items()}}

    def update(self, grads, opt_state, params):
        masks = opt_state["asp_mask"]
        masked = {k: g * masks[k].to(g.dtype) for k, g in grads.items()}
        new_params, new_inner = self.inner.update(masked, opt_state["inner"], params)
        new_params = {k: p * masks[k].to(p.dtype) for k, p in new_params.items()}
        return new_params, {"inner": new_inner, "asp_mask": masks}


class RecomputeOptimizer(MetaOptimizerBase):
    """Recompute (recompute_optimizer.py) is a MODEL transform
    (``distributed.recompute.recompute`` on the model's blocks); this
    wrapper keeps the strategy chain's shape and passes updates through."""

    def update(self, grads, opt_state, params):
        new_params, new_inner = self.inner.update(grads, opt_state["inner"], params)
        return new_params, {"inner": new_inner}


def select_runtime(strategy) -> Dict[str, Any]:
    """The runtime-selecting half of the chain: the flags pick a trainer
    and its mesh axes (the reference's raw_program / tensor_parallel /
    pipeline / sharding / ps program rewriters). Returns {"runtime":
    name, "kwargs": {...}}, name one of "ps" (a_sync/geo), "hybrid"
    (pipeline, tensor parallel or hybrid axes), "spmd" (sharding or no
    graph optimization) and "single"."""
    if getattr(strategy, "a_sync", False) or getattr(strategy, "geo_sgd_mode", False):
        return {"runtime": "ps", "kwargs": {}}
    hc = dict(getattr(strategy, "hybrid_configs", {}) or {})
    pp = int(hc.get("pp_degree", 1))
    mp = int(hc.get("mp_degree", 1))
    cp = int(hc.get("cp_degree", 1))
    ep = int(hc.get("ep_degree", 1))
    if getattr(strategy, "pipeline", False):
        pp = max(pp, int((getattr(strategy, "pipeline_configs", {}) or {})
                         .get("pp_degree", 2)), 2)
    if getattr(strategy, "tensor_parallel", False):
        mp = max(mp, int((getattr(strategy, "tensor_parallel_configs", {}) or {})
                         .get("tensor_parallel_degree", 2)), 2)
    if pp > 1 or mp > 1 or cp > 1 or ep > 1:
        return {"runtime": "hybrid",
                "kwargs": {"dp": int(hc.get("dp_degree", 1)), "pp": pp, "mp": mp, "cp": cp,
                           "ep": ep}}
    zero = 0
    if getattr(strategy, "sharding", False):
        zero = int((getattr(strategy, "sharding_configs", {}) or {}).get("stage", 1))
    degree = int((getattr(strategy, "sharding_configs", {}) or {})
                 .get("sharding_degree", 1)) if zero else 1
    if zero or getattr(strategy, "without_graph_optimization", False):
        return {"runtime": "spmd", "kwargs": {"zero_stage": zero, "sharding_degree": degree}}
    return {"runtime": "single", "kwargs": {}}


def _rate(opt: Optimizer):
    return opt.schedule if opt.schedule is not None else opt.learning_rate


def apply_strategy(optimizer: Optimizer, strategy, reducer=None) -> Optimizer:
    """StrategyCompiler: the wrapper chain a ``DistributedStrategy``
    implies, with the reference's ``_can_apply`` rules: lars/lamb swap the
    base optimizer (keeping its grad clip); dgc needs an SGD/Momentum base,
    whose momentum it takes over (the inner applies the released gradient
    with plain SGD).

    ``reducer`` (``comm_fusion.DpGradReducer``) builds the chain on the
    pre-reduction contract: a :class:`FusedAllReduceOptimizer` innermost
    (inside DGC's compression), and FP16AllReduce, LocalSGD (averaging
    over the reducer's axes), GradientMerge and AMP wired to it."""
    opt = optimizer

    def synced(o: Optimizer) -> Optimizer:
        return FusedAllReduceOptimizer(o, reducer) if reducer is not None else o

    if getattr(strategy, "lars", False) and not isinstance(opt, Lars):
        cfg = getattr(strategy, "lars_configs", {}) or {}
        opt = Lars(learning_rate=_rate(opt), momentum=getattr(opt, "momentum", 0.9),
                   grad_clip=opt.grad_clip,
                   **{k: v for k, v in cfg.items()
                      if k in ("lars_coeff", "lars_weight_decay", "epsilon")})
    if getattr(strategy, "lamb", False) and not isinstance(opt, Lamb):
        cfg = getattr(strategy, "lamb_configs", {}) or {}
        opt = Lamb(learning_rate=_rate(opt), grad_clip=opt.grad_clip,
                   **{k: v for k, v in cfg.items() if k in ("lamb_weight_decay",)})

    if getattr(strategy, "dgc", False):
        enforce(isinstance(opt, (SGD, Momentum)), "dgc requires an SGD/Momentum base optimizer",
                InvalidArgumentError)
        cfg = getattr(strategy, "dgc_configs", {}) or {}
        inner = SGD(learning_rate=_rate(opt), grad_clip=opt.grad_clip,
                    weight_decay=opt.weight_decay)
        opt = DGCMomentumOptimizer(synced(inner), momentum=getattr(opt, "momentum", 0.0),
                                   rampup_begin_step=cfg.get("rampup_begin_step", 0),
                                   rampup_step=cfg.get("rampup_step", 1),
                                   sparsity=cfg.get("sparsity", [0.999]))
    else:
        opt = synced(opt)

    if getattr(strategy, "fp16_allreduce", False):
        opt = FP16AllReduceOptimizer(opt, reducer=reducer)

    if getattr(strategy, "asp", False):
        opt = ASPOptimizer(opt)

    if getattr(strategy, "localsgd", False):
        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        opt = LocalSGDOptimizer(opt, k_steps=cfg.get("k_steps", 1),
                                axis=reducer.axes if reducer is not None else "dp",
                                reducer=reducer)

    if getattr(strategy, "gradient_merge", False):
        cfg = getattr(strategy, "gradient_merge_configs", {}) or {}
        opt = GradientMergeOptimizer(opt, k_steps=cfg.get("k_steps", 1), avg=cfg.get("avg", True),
                                     reducer=reducer)

    if getattr(strategy, "recompute", False):
        opt = RecomputeOptimizer(opt)

    if getattr(strategy, "amp", False):
        cfg = getattr(strategy, "amp_configs", {}) or {}
        opt = AMPOptimizer(
            opt, init_loss_scaling=cfg.get("init_loss_scaling", 2.0 ** 15),
            incr_every_n_steps=cfg.get("incr_every_n_steps", 1000),
            decr_every_n_nan_or_inf=cfg.get("decr_every_n_nan_or_inf", 2),
            incr_ratio=cfg.get("incr_ratio", 2.0), decr_ratio=cfg.get("decr_ratio", 0.5),
            use_dynamic_loss_scaling=cfg.get("use_dynamic_loss_scaling", True), reducer=reducer)

    if reducer is not None:
        reducer.installed = True
    return opt
