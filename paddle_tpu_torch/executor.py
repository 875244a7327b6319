"""Dense train and eval steps, and the ``Trainer`` around them.

Port of ``paddle_tpu.executor``. A step is functional, as in the JAX
package: ``state = {"params": {name: tensor}, "buffers": {name: tensor}}``
and the optimizer state go in, new ones come out, and the module only
supplies the forward (``torch.func.functional_call``). Gradients come
from ``torch.autograd.grad`` over the params dict, and the port's
``optimizer.Adam`` (the JAX algebra) applies them. PyTorch runs eagerly,
so there is no compiled step; the loss comes back as a device tensor
without a host sync.

Not in this slice: ``amp`` (bf16 autocast, ROADMAP A5) and
``train_from_dataset`` (its data feed, A8); both raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from .core.device import resolve_device
from .core.enforce import InvalidArgumentError, enforce
from .nn.layers import Dropout

__all__ = ["Trainer", "make_eval_step", "make_train_step"]

State = Dict[str, Dict[str, torch.Tensor]]


def _check_amp(amp) -> None:
    enforce(amp in (False, "O0"),
            f"amp={amp!r}: mixed precision (bf16 autocast) is not ported yet; "
            "pass amp=False", InvalidArgumentError)


def make_train_step(model: nn.Module, optimizer, loss_fn: Callable[..., torch.Tensor],
                    amp=False) -> Callable:
    """``step(state, opt_state, inputs, labels) -> (new_state, new_opt_state,
    loss)``, with ``loss_fn(outputs, *labels)`` and the model in training
    mode for the forward."""
    _check_amp(amp)

    def step(state: State, opt_state: dict, inputs: Tuple, labels: Tuple):
        params = state["params"]
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        was_training = model.training
        model.train()
        try:
            out = functional_call(model, {**leaves, **state["buffers"]}, inputs)
        finally:
            model.train(was_training)
        loss = loss_fn(out, *labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        new_params, new_opt_state = optimizer.update(dict(zip(leaves, grads)), opt_state, params)
        return {"params": new_params, "buffers": state["buffers"]}, new_opt_state, loss.detach()

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
    are the trainer's ``state`` and go back into the module at
    :meth:`sync_model` / :meth:`state_dict`. Every ``Dropout`` of the
    model draws from the trainer's generator, seeded from ``seed``.
    """

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable[..., torch.Tensor],
                 seed: int = 0, amp=False,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        _check_amp(amp)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.state: State = {
            "params": {k: p.detach() for k, p in model.named_parameters()},
            "buffers": {k: b.detach() for k, b in model.named_buffers()}}
        self.opt_state = optimizer.init(self.state["params"])
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
        self._train_step = make_train_step(model, optimizer, loss_fn, amp=amp)
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
        """Write the live parameters back into the module."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.state["params"][k])
        return self.model

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.sync_model().state_dict()
