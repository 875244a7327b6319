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
branch's values exactly.

Not ported: the pre-reduction contract (``reducer=``) and
``FusedAllReduceOptimizer``, which need ``distributed/comm_fusion.py``
(ROADMAP item 7); ``apply_strategy`` and the wrappers raise
``UnavailableError`` naming it when given a reducer. Without one the
chain behaves as the JAX chain without one: gradients arrive reduced.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..amp import GradScaler, LossScaleState
from ..core.enforce import InvalidArgumentError, UnavailableError, enforce
from ..ops import collectives as coll
from ..optimizer import SGD, Lamb, Lars, Momentum, Optimizer

__all__ = ["MetaOptimizerBase", "AMPOptimizer", "GradientMergeOptimizer", "LocalSGDOptimizer",
           "DGCMomentumOptimizer", "FP16AllReduceOptimizer", "ASPOptimizer",
           "RecomputeOptimizer", "apply_strategy", "select_runtime"]


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


def _no_reducer(reducer, what: str) -> None:
    enforce(reducer is None,
            f"{what}: reducer= (the pre-reduction contract over fused dp collectives) needs "
            "distributed/comm_fusion.py and FusedAllReduceOptimizer, which are not ported "
            "(ROADMAP item 7)", UnavailableError)


def _device(params: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


class MetaOptimizerBase(Optimizer):
    """Wrapper base: delegates to ``inner`` and namespaces extra state."""

    def __init__(self, inner: Optimizer) -> None:
        self.inner = inner
        # the outermost wrapper exposes no grad_clip/weight decay of its own
        self.grad_clip = None
        self.weight_decay = 0.0

    def init(self, params):
        return {"inner": self.inner.init(params), **self._init_extra(params)}

    def _init_extra(self, params) -> Dict[str, Any]:
        return {}

    def update(self, grads, opt_state, params):
        raise NotImplementedError


class AMPOptimizer(MetaOptimizerBase):
    """Mixed precision with dynamic loss scaling (amp_optimizer.py,
    update_loss_scaling_op.h): the gradients are of the loss scaled by
    :meth:`scale_loss`; a step whose unscaled gradients are not all
    finite is skipped and the scale decays."""

    def __init__(self, inner: Optimizer, init_loss_scaling: float = 2.0 ** 15,
                 incr_every_n_steps: int = 1000, decr_every_n_nan_or_inf: int = 2,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 use_dynamic_loss_scaling: bool = True, reducer=None) -> None:
        _no_reducer(reducer, "AMPOptimizer")
        super().__init__(inner)
        self.scaler = GradScaler(init_loss_scaling, incr_ratio, decr_ratio, incr_every_n_steps,
                                 decr_every_n_nan_or_inf, use_dynamic_loss_scaling)

    def _init_extra(self, params):
        return {"scaler": self.scaler.init(_device(params))}

    def scale_loss(self, loss: torch.Tensor, opt_state) -> torch.Tensor:
        return self.scaler.scale(loss, opt_state["scaler"])

    def update(self, grads, opt_state, params):
        sstate: LossScaleState = opt_state["scaler"]
        grads, ok = self.scaler.unscale(grads, sstate)
        new_params, new_inner = self.inner.update(grads, opt_state["inner"], params)
        new_params = _select(ok, new_params, params)
        new_inner = _select(ok, new_inner, opt_state["inner"])
        return new_params, {"inner": new_inner, "scaler": self.scaler.update(ok, sstate)}


class GradientMergeOptimizer(MetaOptimizerBase):
    """Gradient accumulation over ``k_steps`` steps
    (gradient_merge_optimizer.py): the inner optimizer applies the
    accumulated gradient (averaged when ``avg``) every k-th step; the
    steps between leave the params and the inner state as they are."""

    def __init__(self, inner: Optimizer, k_steps: int = 1, avg: bool = True) -> None:
        super().__init__(inner)
        enforce(k_steps >= 1, "k_steps must be >= 1")
        self.k_steps = int(k_steps)
        self.avg = bool(avg)

    def _init_extra(self, params):
        return {"acc": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(self, grads, opt_state, params):
        acc = {k: a + grads[k].to(torch.float32) for k, a in opt_state["acc"].items()}
        count = opt_state["count"] + 1
        ready = count >= self.k_steps
        scale = 1.0 / self.k_steps if self.avg else 1.0
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
    it, every step); ``sync_fn`` replaces the average."""

    def __init__(self, inner: Optimizer, k_steps: int = 1, axis="dp",
                 sync_fn: Optional[Callable[[Any], Any]] = None, reducer=None) -> None:
        _no_reducer(reducer, "LocalSGDOptimizer")
        super().__init__(inner)
        self.k_steps = int(k_steps)
        self.axis = axis
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
    inputs without ties the same entries are released as in JAX."""

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
    wire in half precision. Without a reducer (the port's only mode) no
    wire is narrowed here: the round-trip cast reproduces the wire's
    precision, as the JAX chain does without one."""

    def __init__(self, inner: Optimizer, dtype=torch.bfloat16, reducer=None) -> None:
        _no_reducer(reducer, "FP16AllReduceOptimizer")
        super().__init__(inner)
        self.dtype = dtype

    def update(self, grads, opt_state, params):
        restored = {k: g.to(self.dtype).to(g.dtype) for k, g in grads.items()}
        new_params, new_inner = self.inner.update(restored, opt_state["inner"], params)
        return new_params, {"inner": new_inner}


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
    with plain SGD). ``reducer`` raises (ROADMAP item 7)."""
    _no_reducer(reducer, "apply_strategy")
    opt = optimizer
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
        opt = DGCMomentumOptimizer(inner, momentum=getattr(opt, "momentum", 0.0),
                                   rampup_begin_step=cfg.get("rampup_begin_step", 0),
                                   rampup_step=cfg.get("rampup_step", 1),
                                   sparsity=cfg.get("sparsity", [0.999]))

    if getattr(strategy, "fp16_allreduce", False):
        opt = FP16AllReduceOptimizer(opt)

    if getattr(strategy, "asp", False):
        opt = ASPOptimizer(opt)

    if getattr(strategy, "localsgd", False):
        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        opt = LocalSGDOptimizer(opt, k_steps=cfg.get("k_steps", 1), axis="dp")

    if getattr(strategy, "gradient_merge", False):
        cfg = getattr(strategy, "gradient_merge_configs", {}) or {}
        opt = GradientMergeOptimizer(opt, k_steps=cfg.get("k_steps", 1), avg=cfg.get("avg", True))

    if getattr(strategy, "recompute", False):
        opt = RecomputeOptimizer(opt)

    if getattr(strategy, "amp", False):
        cfg = getattr(strategy, "amp_configs", {}) or {}
        opt = AMPOptimizer(
            opt, init_loss_scaling=cfg.get("init_loss_scaling", 2.0 ** 15),
            incr_every_n_steps=cfg.get("incr_every_n_steps", 1000),
            decr_every_n_nan_or_inf=cfg.get("decr_every_n_nan_or_inf", 2),
            incr_ratio=cfg.get("incr_ratio", 2.0), decr_ratio=cfg.get("decr_ratio", 0.5),
            use_dynamic_loss_scaling=cfg.get("use_dynamic_loss_scaling", True))
    return opt
