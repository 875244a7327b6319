"""Dense optimizers of the port, with the JAX package's algebra.

Port of ``paddle_tpu.optimizer`` (the base, ``SGD``, ``Momentum``,
``Adam``, ``AdamW``, ``Adagrad``, ``Adadelta``, ``Adamax``, ``RMSProp``,
``Lars``, ``Lamb``, the gradient clips, the ``lr`` schedules,
``MasterWeights`` and ``decorate_o2``). Each optimizer is functional
over a dict of tensors keyed by parameter name::

    opt_state = opt.init(params)
    new_params, new_opt_state = opt.update(grads, opt_state, params)

Inputs are not modified. The state is ``{"step": 0-dim int64, **slots}``
on the parameters' device, each slot a dict like the params, under the
JAX package's slot names where it has them (``Adam``: ``"m"``/``"v"``)
and ``jax_tree_slot`` where the JAX slot is one bare tree (``Momentum``
and ``Lars``: ``"velocity"``, ``Adagrad``: ``"moment"``); ``SGD`` has none; ``MasterWeights`` keeps ``"master"``
and the inner optimizer's slots under ``"inner"``. A constant learning
rate is a Python float; a schedule's is a 0-dim f32 tensor computed from
the step counter on the device, so a step needs no host sync either way.
These are not ``torch.optim``'s optimizers, whose algebra rounds
differently.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Lamb", "Lars", "MasterWeights", "Momentum", "Optimizer", "RMSProp", "SGD",
           "decorate_o2", "global_norm", "lr"]

Params = Dict[str, torch.Tensor]


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every tensor (in key order, as
    the JAX package's tree walk sums them)."""
    total = 0.0
    for k in sorted(tree):
        total = total + torch.sum(torch.square(tree[k].to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


class _GradClip:
    def __call__(self, grads: Params) -> Params:
        raise NotImplementedError


class ClipGradByGlobalNorm(_GradClip):
    """Scale every gradient so that their global L2 norm is at most
    ``clip_norm``."""

    def __init__(self, clip_norm: float) -> None:
        self.clip_norm = float(clip_norm)

    def __call__(self, grads: Params) -> Params:
        scale = torch.clamp(self.clip_norm / torch.clamp(global_norm(grads), min=1e-12),
                            max=1.0)
        return {k: (g.to(torch.float32) * scale).to(g.dtype) for k, g in grads.items()}


class ClipGradByNorm(_GradClip):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm: float) -> None:
        self.clip_norm = float(clip_norm)

    def __call__(self, grads: Params) -> Params:
        out = {}
        for k, g in grads.items():
            n = torch.sqrt(torch.sum(torch.square(g.to(torch.float32))))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12), max=1.0)
            out[k] = (g * scale).to(g.dtype)
        return out


class ClipGradByValue(_GradClip):
    def __init__(self, max_value: float, min_value: Optional[float] = None) -> None:
        self.max_value = float(max_value)
        self.min_value = float(min_value) if min_value is not None else -self.max_value

    def __call__(self, grads: Params) -> Params:
        return {k: torch.clamp(g, self.min_value, self.max_value) for k, g in grads.items()}


class _LRSchedule:
    """step (0-dim int tensor) → learning rate (0-dim f32 tensor)."""

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class _LambdaLR(_LRSchedule):
    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
        self.fn = fn

    def __call__(self, step):
        return torch.as_tensor(self.fn(step), dtype=torch.float32, device=step.device)


def _f32(step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32)


class lr:
    """The learning-rate schedules (``paddle.optimizer.lr``), each a
    function of the step counter."""

    @staticmethod
    def constant(value: float) -> _LRSchedule:
        return _LambdaLR(lambda step: torch.full((), float(value), device=step.device))

    @staticmethod
    def exponential_decay(base_lr: float, gamma: float) -> _LRSchedule:
        return _LambdaLR(lambda step: base_lr * torch.pow(gamma, _f32(step)))

    @staticmethod
    def cosine_decay(base_lr: float, t_max: int, eta_min: float = 0.0) -> _LRSchedule:
        def fn(step):
            t = torch.clamp(_f32(step), max=t_max)
            return eta_min + 0.5 * (base_lr - eta_min) * (1 + torch.cos(math.pi * t / t_max))

        return _LambdaLR(fn)

    @staticmethod
    def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int) -> _LRSchedule:
        def fn(step):
            s = _f32(step)
            warm = base_lr * s / max(warmup_steps, 1)
            decay = base_lr * torch.clamp((total_steps - s) / max(total_steps - warmup_steps, 1),
                                          min=0.0)
            return torch.where(s < warmup_steps, warm, decay)

        return _LambdaLR(fn)

    @staticmethod
    def piecewise_decay(boundaries: Sequence[int], values: Sequence[float]) -> _LRSchedule:
        """Constant segments: ``values[i]`` from ``boundaries[i-1]`` on."""
        def fn(step):
            bnd = torch.as_tensor(list(boundaries), dtype=step.dtype, device=step.device)
            val = torch.as_tensor(list(values), dtype=torch.float32, device=step.device)
            return val[(step >= bnd).sum()]

        return _LambdaLR(fn)

    @staticmethod
    def polynomial_decay(base_lr: float, decay_steps: int, end_lr: float = 0.0,
                         power: float = 1.0) -> _LRSchedule:
        def fn(step):
            t = torch.clamp(_f32(step), max=decay_steps) / decay_steps
            return (base_lr - end_lr) * torch.pow(1.0 - t, power) + end_lr

        return _LambdaLR(fn)

    @staticmethod
    def noam_decay(d_model: int, warmup_steps: int, base_lr: float = 1.0) -> _LRSchedule:
        def fn(step):
            s = torch.clamp(_f32(step), min=1.0)
            return base_lr * d_model ** -0.5 * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5)

        return _LambdaLR(fn)

    @staticmethod
    def step_decay(base_lr: float, step_size: int, gamma: float = 0.1) -> _LRSchedule:
        return _LambdaLR(
            lambda step: base_lr * torch.pow(gamma, _f32(torch.div(step, step_size,
                                                                   rounding_mode="floor"))))


class Optimizer:
    """The base: gradient clip, weight decay and the learning rate (a
    float or a schedule of :class:`lr`) around each subclass's
    ``_init_slots``/``_apply``."""

    def __init__(self, learning_rate=0.001, grad_clip: Optional[_GradClip] = None,
                 weight_decay: float = 0.0) -> None:
        # a float rate multiplies as a scalar: no device op a step
        self.schedule = learning_rate if isinstance(learning_rate, _LRSchedule) else None
        self.learning_rate = None if self.schedule is not None else float(learning_rate)
        self.grad_clip = grad_clip
        self.weight_decay = float(weight_decay)

    def init(self, params: Params) -> dict:
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int64, device=dev),
                **self._init_slots(params)}

    @torch.no_grad()
    def update(self, grads: Params, opt_state: dict, params: Params) -> Tuple[Params, dict]:
        """→ (new_params, new_opt_state); inputs are not modified."""
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        step = opt_state["step"]
        slots = {k: v for k, v in opt_state.items() if k != "step"}
        lr_t = self.learning_rate if self.schedule is None else self.schedule(step)
        new_params, new_slots = self._apply(grads, slots, params, lr_t, step)
        return new_params, {"step": step + 1, **new_slots}

    def _init_slots(self, params: Params) -> dict:
        raise NotImplementedError

    def _apply(self, grads, slots, params, lr_t, step):
        raise NotImplementedError

    def _decay_grad(self, g, p):
        if self.weight_decay:
            return g + self.weight_decay * p
        return g


class SGD(Optimizer):
    def _init_slots(self, params):
        return {}

    def _apply(self, grads, slots, params, lr_t, step):
        return {k: p - lr_t * self._decay_grad(grads[k], p) for k, p in params.items()}, {}


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(p) for k, p in params.items()}


class Momentum(Optimizer):
    """``v' = momentum * v + g``; ``p' = p - lr * v'``, or with Nesterov
    ``p' = p - lr * (g + momentum * v')`` (``g`` with coupled decay)."""

    jax_tree_slot = "velocity"

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 use_nesterov: bool = False, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.momentum = float(momentum)
        self.use_nesterov = use_nesterov

    def _init_slots(self, params):
        return {"velocity": _zeros(params)}

    def _apply(self, grads, slots, params, lr_t, step):
        new_p, new_v = {}, {}
        for k, p in params.items():
            g = self._decay_grad(grads[k], p)
            v = self.momentum * slots["velocity"][k] + g
            new_p[k] = p - lr_t * ((g + self.momentum * v) if self.use_nesterov else v)
            new_v[k] = v
        return new_p, {"velocity": new_v}


class Adam(Optimizer):
    """``m' = b1 m + (1-b1) g``; ``v' = b2 v + (1-b2) g²``;
    ``p' = p - lr (m'/bc1) / (sqrt(v'/bc2) + eps)``, ``bc = 1 - b**(step+1)``.
    The weight decay is coupled (added to ``g``) here and decoupled in
    :class:`AdamW`."""

    decoupled = False

    def __init__(self, learning_rate=0.001, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = float(beta1), float(beta2), float(epsilon)

    def _init_slots(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def _apply(self, grads, slots, params, lr_t, step):
        t = (step + 1).to(torch.float32)
        bc1 = 1 - torch.pow(self.beta1, t)
        bc2 = 1 - torch.pow(self.beta2, t)
        keep = 1 - lr_t * self.weight_decay if self.decoupled else None
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            if self.decoupled:
                p = p * keep
            else:
                g = self._decay_grad(g, p)
            m = self.beta1 * slots["m"][k] + (1 - self.beta1) * g
            v = self.beta2 * slots["v"][k] + (1 - self.beta2) * (g * g)
            new_p[k] = p - lr_t * (m / bc1) / (torch.sqrt(v / bc2) + self.epsilon)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v}


class AdamW(Adam):
    decoupled = True

    def __init__(self, learning_rate=0.001, weight_decay: float = 0.01, **kw) -> None:
        super().__init__(learning_rate, weight_decay=weight_decay, **kw)



class Adagrad(Optimizer):
    """``acc' = acc + g²``; ``p' = p - lr g / (sqrt(acc') + eps)``
    (``g`` with coupled decay); the accumulator starts at
    ``initial_accumulator_value``."""

    jax_tree_slot = "moment"

    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 initial_accumulator_value: float = 0.0, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.epsilon = float(epsilon)
        self.initial_accumulator_value = float(initial_accumulator_value)

    def _init_slots(self, params):
        return {"moment": {k: torch.full_like(p, self.initial_accumulator_value)
                           for k, p in params.items()}}

    def _apply(self, grads, slots, params, lr_t, step):
        new_p, new_acc = {}, {}
        for k, p in params.items():
            g = self._decay_grad(grads[k], p)
            acc = slots["moment"][k] + g * g
            new_p[k] = p - lr_t * g / (torch.sqrt(acc) + self.epsilon)
            new_acc[k] = acc
        return new_p, {"moment": new_acc}


class Adadelta(Optimizer):
    """``E[g²]' = rho E[g²] + (1-rho) g²``; ``u = sqrt(E[u²] + eps) /
    sqrt(E[g²]' + eps) · g``; ``E[u²]' = rho E[u²] + (1-rho) u²``;
    ``p' = p - lr u`` (phi adadelta_kernel)."""

    def __init__(self, learning_rate=0.001, rho: float = 0.95, epsilon: float = 1e-6,
                 **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = float(rho), float(epsilon)

    def _init_slots(self, params):
        return {"avg_sq_grad": _zeros(params), "avg_sq_update": _zeros(params)}

    def _apply(self, grads, slots, params, lr_t, step):
        new_p, new_g, new_u = {}, {}, {}
        for k, p in params.items():
            g = self._decay_grad(grads[k], p)
            ag = self.rho * slots["avg_sq_grad"][k] + (1 - self.rho) * (g * g)
            au = slots["avg_sq_update"][k]
            update = (torch.sqrt(au + self.epsilon) / torch.sqrt(ag + self.epsilon)) * g
            new_u[k] = self.rho * au + (1 - self.rho) * (update * update)
            new_p[k] = p - lr_t * update
            new_g[k] = ag
        return new_p, {"avg_sq_grad": new_g, "avg_sq_update": new_u}


class Adamax(Optimizer):
    """Adam with an infinity-norm second moment: ``u' = max(b2 u, |g|)``;
    ``p' = p - lr (m'/bc1) / (u' + eps)`` (phi adamax_kernel)."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = float(beta1), float(beta2), float(epsilon)

    def _init_slots(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def _apply(self, grads, slots, params, lr_t, step):
        bc1 = 1 - torch.pow(self.beta1, (step + 1).to(torch.float32))
        new_p, new_m, new_u = {}, {}, {}
        for k, p in params.items():
            g = self._decay_grad(grads[k], p)
            m = self.beta1 * slots["m"][k] + (1 - self.beta1) * g
            u = torch.maximum(self.beta2 * slots["u"][k], torch.abs(g))
            new_p[k] = p - lr_t * (m / bc1) / (u + self.epsilon)
            new_m[k], new_u[k] = m, u
        return new_p, {"m": new_m, "u": new_u}


class RMSProp(Optimizer):
    """Uncentered RMSProp with momentum (phi rmsprop_kernel):
    ``ms' = rho ms + (1-rho) g²``; ``mom' = momentum mom + lr g /
    sqrt(ms' + eps)``; ``p' = p - mom'``."""

    def __init__(self, learning_rate=0.001, rho: float = 0.95, epsilon: float = 1e-6,
                 momentum: float = 0.0, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon, self.momentum = float(rho), float(epsilon), float(momentum)

    def _init_slots(self, params):
        return {"mean_sq": _zeros(params), "mom": _zeros(params)}

    def _apply(self, grads, slots, params, lr_t, step):
        new_p, new_ms, new_mom = {}, {}, {}
        for k, p in params.items():
            g = self._decay_grad(grads[k], p)
            ms = self.rho * slots["mean_sq"][k] + (1 - self.rho) * (g * g)
            mom = self.momentum * slots["mom"][k] + lr_t * g / torch.sqrt(ms + self.epsilon)
            new_p[k] = p - mom
            new_ms[k], new_mom[k] = ms, mom
        return new_p, {"mean_sq": new_ms, "mom": new_mom}


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def _lr_tensor(lr_t, like: torch.Tensor) -> torch.Tensor:
    """The rate as a 0-dim f32 tensor: ``lr * coeff * norm`` then rounds
    each product to f32, as the JAX package's traced scalar does."""
    return torch.as_tensor(lr_t, dtype=torch.float32, device=like.device)


class Lars(Optimizer):
    """LARS momentum (lars_momentum_op): a tensor's trust ratio
    ``local_lr = lr · coeff · ||p|| / (||g|| + wd ||p|| + eps)`` (``lr``
    where either norm is 0), then ``v' = momentum v + local_lr (g + wd p)``,
    ``p' = p - v'``, all in f32 and cast back to the parameter's dtype."""

    jax_tree_slot = "velocity"

    def __init__(self, learning_rate=0.001, momentum: float = 0.9, lars_coeff: float = 0.001,
                 lars_weight_decay: float = 0.0005, epsilon: float = 0.0, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.momentum = float(momentum)
        self.lars_coeff = float(lars_coeff)
        self.lars_weight_decay = float(lars_weight_decay)
        self.epsilon = float(epsilon)

    def _init_slots(self, params):
        return {"velocity": _zeros(params)}

    def _apply(self, grads, slots, params, lr_t, step):
        new_p, new_v = {}, {}
        wd = self.lars_weight_decay
        for k, p in params.items():
            pf, gf = p.to(torch.float32), grads[k].to(torch.float32)
            lr = _lr_tensor(lr_t, pf)
            p_norm, g_norm = _norm(pf), _norm(gf)
            local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                                   lr * self.lars_coeff * p_norm
                                   / (g_norm + wd * p_norm + self.epsilon), lr)
            v = self.momentum * slots["velocity"][k] + local_lr * (gf + wd * pf)
            new_p[k] = (pf - v).to(p.dtype)
            new_v[k] = v
        return new_p, {"velocity": new_v}


class Lamb(Optimizer):
    """LAMB (lamb_op): Adam's moments, ``r = (m'/bc1) / (sqrt(v'/bc2) +
    eps) + wd p``, and a tensor's trust ratio ``||p|| / ||r||`` (1 where
    either norm is 0): ``p' = p - lr · trust · r``, in f32 and cast back
    to the parameter's dtype."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-6,
                 **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.lamb_weight_decay = float(lamb_weight_decay)
        self.beta1, self.beta2, self.epsilon = float(beta1), float(beta2), float(epsilon)

    def _init_slots(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def _apply(self, grads, slots, params, lr_t, step):
        t = (step + 1).to(torch.float32)
        bc1 = 1 - torch.pow(self.beta1, t)
        bc2 = 1 - torch.pow(self.beta2, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            pf, gf = p.to(torch.float32), grads[k].to(torch.float32)
            m = self.beta1 * slots["m"][k] + (1 - self.beta1) * gf
            v = self.beta2 * slots["v"][k] + (1 - self.beta2) * (gf * gf)
            r = (m / bc1) / (torch.sqrt(v / bc2) + self.epsilon) + self.lamb_weight_decay * pf
            p_norm, r_norm = _norm(pf), _norm(r)
            one = torch.ones((), dtype=torch.float32, device=pf.device)
            trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, one)
            new_p[k] = (pf - _lr_tensor(lr_t, pf) * trust * r).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v}


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


class MasterWeights:
    """O2 master weights (``paddle.amp.decorate(level='O2')`` with the
    ``multi_precision`` optimizers): the model's parameters are stored in
    a low dtype, the inner optimizer steps f32 masters, and each returned
    parameter is its master cast to the parameter's dtype, so the stored
    parameters never accumulate rounding. Non-float parameters pass
    through unchanged."""

    def __init__(self, inner: Optimizer) -> None:
        enforce(isinstance(inner, Optimizer),
                f"MasterWeights wraps an Optimizer, got {type(inner).__name__}",
                InvalidArgumentError)
        self.inner = inner

    @staticmethod
    def _to_master(p: torch.Tensor) -> torch.Tensor:
        return p.to(torch.float32) if _is_float(p) else p

    def init(self, params: Params) -> dict:
        master = {k: self._to_master(p) for k, p in params.items()}
        inner = self.inner.init(master)
        return {"step": inner.pop("step"), "master": master, "inner": inner}

    @torch.no_grad()
    def update(self, grads: Params, opt_state: dict, params: Params) -> Tuple[Params, dict]:
        g32 = {k: self._to_master(g) for k, g in grads.items()}
        new_master, new_inner = self.inner.update(
            g32, {"step": opt_state["step"], **opt_state["inner"]}, opt_state["master"])
        new_params = {k: new_master[k].to(p.dtype) if _is_float(p) else new_master[k]
                      for k, p in params.items()}
        return new_params, {"step": new_inner.pop("step"), "master": new_master,
                            "inner": new_inner}


def decorate_o2(optimizer, params: Params):
    """O2 decoration, shared by ``executor.Trainer(amp="O2")`` and
    ``hapi.Model.prepare``: wrap ``optimizer`` in :class:`MasterWeights`
    (unless it is one), take the masters from the f32 ``params``, and
    store the float parameters in bf16.

    Returns ``(optimizer, opt_state, bf16_params)``."""
    if not isinstance(optimizer, MasterWeights):
        optimizer = MasterWeights(optimizer)
    opt_state = optimizer.init(params)
    bf16 = {k: v.to(torch.bfloat16) if _is_float(v) else v for k, v in params.items()}
    return optimizer, opt_state, bf16
