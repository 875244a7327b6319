"""Dense train and eval steps, and the ``Trainer`` around them.

Port of ``paddle_tpu.executor``. A step is functional, as in the JAX
package: ``state = {"params": {name: tensor}, "buffers": {name: tensor}}``
and the optimizer state go in, new ones come out, and the module only
supplies the forward (``torch.func.functional_call``). Gradients come
from ``torch.autograd.grad`` over the params dict, and the port's
``optimizer`` (the JAX algebra) applies them. The forward runs on copies
of the buffers, into which BatchNorm writes its new running stats: the
step returns those copies as the new buffers and leaves its inputs as
they were. PyTorch runs eagerly, so there is no compiled step; the loss
comes back as a device tensor without a host sync.

``amp``: the step body runs under ``amp.step_ctx`` (linear and conv in
bf16 with f32 accumulation, everything else f32); ``Trainer(amp="O2")``
also stores the parameters in bf16 with f32 masters
(``optimizer.decorate_o2``).

Not in this slice: ``train_from_dataset`` (its data feed, ROADMAP A8)
raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from .amp import step_ctx
from .core.device import resolve_device
from .core.enforce import InvalidArgumentError, enforce
from .nn.layers import Dropout
from .optimizer import decorate_o2

__all__ = ["Trainer", "amp_level", "make_eval_step", "make_train_step"]

State = Dict[str, Dict[str, torch.Tensor]]


def amp_level(amp) -> str:
    """``amp`` as the JAX package reads it (``Trainer``'s ``amp`` and
    ``hapi.Model.prepare``'s ``amp_configs``): None/False/True,
    "O0"/"O1"/"O2", or a dict's ``"level"`` (O1 when it has none, as the
    reference defaults it) → the level."""
    if isinstance(amp, dict):
        amp = amp.get("level", "O1")
    if amp is None or isinstance(amp, bool):
        return "O1" if amp else "O0"
    enforce(amp in ("O0", "O1", "O2"), f"amp must be bool or O0/O1/O2, got {amp!r}",
            InvalidArgumentError)
    return amp


def make_train_step(model: nn.Module, optimizer, loss_fn: Callable[..., torch.Tensor],
                    amp: bool = False, amp_dtype: str = "bfloat16") -> Callable:
    """``step(state, opt_state, inputs, labels) -> (new_state, new_opt_state,
    loss)``, with ``loss_fn(outputs, *labels)`` and the model in training
    mode for the forward. ``amp=True``: the body runs under
    ``amp.step_ctx`` in ``amp_dtype``."""

    def step(state: State, opt_state: dict, inputs: Tuple, labels: Tuple):
        params = state["params"]
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        buffers = {k: b.clone() for k, b in state["buffers"].items()}
        was_training = model.training
        model.train()
        try:
            with step_ctx(amp, amp_dtype):
                out = functional_call(model, {**leaves, **buffers}, inputs)
                loss = loss_fn(out, *labels)
                grads = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            model.train(was_training)
        new_params, new_opt_state = optimizer.update(dict(zip(leaves, grads)), opt_state, params)
        return {"params": new_params, "buffers": buffers}, new_opt_state, loss.detach()

    return step


def make_eval_step(model: nn.Module, metric_fn: Optional[Callable[..., Any]] = None) -> Callable:
    """``step(state, inputs, labels)``: the outputs in eval mode, or
    ``metric_fn(outputs, *labels)``."""

    @torch.no_grad()
    def step(state: State, inputs: Tuple, labels: Tuple = ()):
        was_training = model.training
        model.eval()
        try:
            out = functional_call(model, {**state["params"], **state["buffers"]}, inputs)
        finally:
            model.train(was_training)
        return out if metric_fn is None else metric_fn(out, *labels)

    return step


def _as_tuple(x) -> Tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class Trainer:
    """Owns the model's state and the optimizer state across steps.

    ``device=None`` means ``"cuda"`` and raises without a GPU unless
    ``device="cpu"``. The model moves to the device; the live parameters
    and buffers are the trainer's ``state`` and go back into the module
    at :meth:`sync_model` / :meth:`state_dict`. Every ``Dropout`` of the
    model draws from the trainer's generator, seeded from ``seed``.
    ``amp``: False/"O0" f32; True/"O1" bf16 contractions; "O2" also bf16
    parameter storage, the optimizer wrapped in ``MasterWeights``.
    """

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable[..., torch.Tensor],
                 seed: int = 0, amp=False, amp_dtype: str = "bfloat16",
                 device: Optional[Union[str, torch.device]] = None) -> None:
        level = amp_level(amp)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.state: State = {
            "params": {k: p.detach() for k, p in model.named_parameters()},
            "buffers": {k: b.detach() for k, b in model.named_buffers()}}
        if level == "O2":
            optimizer, self.opt_state, self.state["params"] = decorate_o2(
                optimizer, self.state["params"])
        else:
            self.opt_state = optimizer.init(self.state["params"])
        self.optimizer = optimizer
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
        self._train_step = make_train_step(model, optimizer, loss_fn, amp=level != "O0",
                                           amp_dtype=amp_dtype)
        self._eval_step = make_eval_step(model)
        self.global_step = 0

    def _to_device(self, xs) -> Tuple:
        return tuple(torch.as_tensor(x, device=self.device) for x in _as_tuple(xs))

    def train_step(self, inputs, labels) -> torch.Tensor:
        """One step; returns the loss as a device tensor (no host sync)."""
        with torch.profiler.record_function("train_step"):
            self.state, self.opt_state, loss = self._train_step(
                self.state, self.opt_state, self._to_device(inputs), self._to_device(labels))
        self.global_step += 1
        return loss

    def predict(self, inputs) -> torch.Tensor:
        with torch.profiler.record_function("eval_step"):
            return self._eval_step(self.state, self._to_device(inputs))

    def train_from_dataset(self, *args, **kwargs):
        raise InvalidArgumentError("Trainer.train_from_dataset needs the dataset feed "
                                   "(data_feed, ROADMAP A8), which is not ported yet")

    def sync_model(self) -> nn.Module:
        """Write the live parameters and buffers back into the module."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.state["params"][k])
            for k, b in self.model.named_buffers():
                b.copy_(self.state["buffers"][k])
        return self.model

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.sync_model().state_dict()
