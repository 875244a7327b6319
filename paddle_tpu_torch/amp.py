"""Automatic mixed precision, as the JAX package defines it.

Port of ``paddle_tpu.amp``. Under :func:`auto_cast` the two dense
contractions, ``nn.functional.linear`` and ``nn.functional.conv2d``,
read the state when they are called and compute in the amp dtype (bf16
by default) with f32 accumulation; parameters, their updates and every
other op stay f32. This is not PyTorch's autocast, which casts every
matmul and changes softmax and reductions too: here only those two ops
consult the state, as in the JAX package.

PyTorch runs eagerly, so the state is read at each call: the JAX
package's trace-time pitfall (a step traced outside the context stays
f32) does not exist here. :func:`step_ctx` is kept because the step
factories use it: disabled, it is a true no-op that leaves an enclosing
``auto_cast`` in force.

On the card the amp convolution is cuDNN's bf16 convolution, whose
output is rounded to bf16 once more before it is widened to f32 (no bf16
convolution of cuDNN gives an f32 result); the CPU path returns the f32
sums, as the JAX package does. :func:`card_conv_rounding` makes the CPU
path round its output as the card does: the CPU oracle that card-vs-CPU
checks of amp convolutions compare against.

Dynamic loss scaling (:class:`GradScaler`) keeps its state in 0-dim
device tensors and updates it without a host sync, step for step as
``update_loss_scaling_op`` does: grow the scale by ``incr_ratio`` after
``incr_every_n_steps`` finite steps in a row, shrink it by
``decr_ratio`` (never below 1) after ``decr_every_n_nan_or_inf``
non-finite steps in a row.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple, Tuple

import torch

from .core.device import resolve_device
from .core.enforce import InvalidArgumentError, enforce

__all__ = ["GradScaler", "LossScaleState", "all_finite", "amp_dtype", "amp_enabled",
           "amp_guard", "auto_cast", "card_conv_rounding", "cast_model_inputs",
           "conv_output_rounded", "step_ctx"]

_FLOAT_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)


class _AmpState(threading.local):
    def __init__(self) -> None:
        self.enabled = False
        self.dtype = torch.bfloat16
        self.round_conv = False


_amp_state = _AmpState()


def amp_enabled() -> bool:
    return _amp_state.enabled


def amp_dtype() -> torch.dtype:
    return _amp_state.dtype


@contextlib.contextmanager
def auto_cast(enable: bool = True, dtype: str = "bfloat16"):
    """Within the context, ``linear`` and ``conv2d`` on f32 inputs compute
    in ``dtype`` ("bfloat16"/"bf16", else float16) with f32 accumulation.
    The previous state comes back on exit; the state is per thread."""
    prev = (_amp_state.enabled, _amp_state.dtype)
    _amp_state.enabled = bool(enable)
    _amp_state.dtype = torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float16
    try:
        yield
    finally:
        _amp_state.enabled, _amp_state.dtype = prev


# the static-graph spelling in the reference
amp_guard = auto_cast


def conv_output_rounded() -> bool:
    """True inside :func:`card_conv_rounding`."""
    return _amp_state.round_conv


@contextlib.contextmanager
def card_conv_rounding():
    """Within the context, an amp ``conv2d`` on the CPU rounds its f32
    output to the amp dtype and widens it back, as cuDNN's amp convolution
    on the card does (the backward is unchanged, as on the card). A check
    oracle, not a training mode: the JAX package does not round. Per
    thread; the previous state comes back on exit."""
    prev = _amp_state.round_conv
    _amp_state.round_conv = True
    try:
        yield
    finally:
        _amp_state.round_conv = prev


def step_ctx(enable: bool, dtype: str = "bfloat16"):
    """The context every step factory runs its body in: ``auto_cast`` when
    ``enable``, else a ``nullcontext`` (entering ``auto_cast(False)``
    would switch off an amp state set by an enclosing call-site
    context; the two patterns compose)."""
    if enable:
        return auto_cast(enable=True, dtype=dtype)
    return contextlib.nullcontext()


def cast_model_inputs(tree: Any, dtype: torch.dtype = None) -> Any:
    """Floating tensors of a (nested dict/list/tuple) tree cast to the amp
    dtype (or ``dtype``); everything else unchanged."""
    dt = dtype or amp_dtype()
    if isinstance(tree, dict):
        return type(tree)((k, cast_model_inputs(v, dt)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_model_inputs(v, dt) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype in _FLOAT_DTYPES:
        return tree.to(dt)
    return tree


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class LossScaleState(NamedTuple):
    loss_scale: torch.Tensor     # 0-dim f32
    good_steps: torch.Tensor     # 0-dim int32: finite steps in a row
    bad_steps: torch.Tensor      # 0-dim int32: non-finite steps in a row


def all_finite(grads: Any) -> torch.Tensor:
    """0-dim bool tensor on the gradients' device: every element of every
    tensor of ``grads`` is finite (check_finite_and_unscale's test), with
    no host sync. Raises on a tree without tensors, which has no device."""
    ok = None
    for g in _leaves(grads):
        fin = torch.isfinite(g).all()
        ok = fin if ok is None else ok & fin
    enforce(ok is not None, "all_finite needs at least one tensor", InvalidArgumentError)
    return ok


class GradScaler:
    """``paddle.amp.GradScaler`` with a functional state::

        state = scaler.init()                       # on the card; init("cpu") on the CPU
        scaled = scaler.scale(loss, state)          # differentiate this
        grads, ok = scaler.unscale(grads, state)
        ... apply the update only where ok ...
        state = scaler.update(ok, state)
    """

    def __init__(self, init_loss_scaling: float = 2.0 ** 15, incr_ratio: float = 2.0,
                 decr_ratio: float = 0.5, incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True) -> None:
        self.init_loss_scaling = float(init_loss_scaling)
        self.incr_ratio = float(incr_ratio)
        self.decr_ratio = float(decr_ratio)
        self.incr_every_n_steps = int(incr_every_n_steps)
        self.decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self.dynamic = bool(use_dynamic_loss_scaling)

    def init(self, device=None) -> LossScaleState:
        """The state on ``device``: ``None`` means the card, and raises
        without one (``core.device.resolve_device``)."""
        device = resolve_device(device)
        return LossScaleState(
            loss_scale=torch.tensor(self.init_loss_scaling, dtype=torch.float32, device=device),
            good_steps=torch.zeros((), dtype=torch.int32, device=device),
            bad_steps=torch.zeros((), dtype=torch.int32, device=device))

    def scale(self, loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
        return loss * state.loss_scale.to(loss.dtype)

    def unscale(self, grads: Any, state: LossScaleState) -> Tuple[Any, torch.Tensor]:
        inv = 1.0 / state.loss_scale
        unscaled = _map(lambda g: (g.to(torch.float32) * inv).to(g.dtype), grads)
        return unscaled, all_finite(unscaled)

    def update(self, found_finite: torch.Tensor, state: LossScaleState) -> LossScaleState:
        if not self.dynamic:
            return state
        zero = torch.zeros_like(state.good_steps)
        good = torch.where(found_finite, state.good_steps + 1, zero)
        bad = torch.where(found_finite, zero, state.bad_steps + 1)
        grow = good >= self.incr_every_n_steps
        shrink = bad >= self.decr_every_n_nan_or_inf
        scale = state.loss_scale
        scale = torch.where(grow, scale * self.incr_ratio, scale)
        scale = torch.where(shrink, torch.clamp(scale * self.decr_ratio, min=1.0), scale)
        good = torch.where(grow, zero, good)
        bad = torch.where(shrink, zero, bad)
        return LossScaleState(scale, good, bad)

