"""High-level ``Model`` API (reference ``python/paddle/hapi/model.py``:
``prepare``, ``fit``, ``evaluate``, ``predict_batch``, callbacks).

Port of ``paddle_tpu.hapi``. ``Model`` wraps a module and trains it
through the port's ``executor.Trainer`` (the same step, optimizer and
amp handling), evaluating with ``executor.make_eval_step``. Batches are
numpy arrays or tensors; they move to ``device``, which defaults to the
card (``"cuda"``, raising without one unless ``device="cpu"``).

Not ported yet: ``save``/``load`` raise. They need only their glue over
``io/checkpoint.py`` (ROADMAP Queue A item 5); ``save(training=False)``
also needs ``io/inference.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from .core.device import resolve_device
from .core.enforce import InvalidArgumentError, PreconditionNotMetError, enforce
from .executor import Trainer, amp_level, make_eval_step

__all__ = ["Callback", "Model", "ProgBarLogger"]


class Callback:
    """Hooks around epochs and batches (hapi/callbacks.py)."""

    def on_train_begin(self, model: "Model") -> None: ...
    def on_train_end(self, model: "Model") -> None: ...
    def on_epoch_begin(self, model: "Model", epoch: int) -> None: ...
    def on_epoch_end(self, model: "Model", epoch: int, logs: Dict[str, float]) -> None: ...
    def on_batch_end(self, model: "Model", step: int, logs: Dict[str, float]) -> None: ...


class ProgBarLogger(Callback):
    def __init__(self, log_freq: int = 10, verbose: int = 1) -> None:
        self.log_freq = log_freq
        self.verbose = verbose

    def on_batch_end(self, model, step, logs):
        if self.verbose and step % self.log_freq == 0:
            print(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in logs.items()))

    def on_epoch_end(self, model, epoch, logs):
        if self.verbose:
            print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in logs.items()))


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


class Model:
    """``paddle.Model`` over the port's train and eval steps."""

    def __init__(self, network: nn.Module,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._trainer: Optional[Trainer] = None
        self._eval_state = None
        self._loss = None
        self._metrics: List[Any] = []
        self._eval_fwd = None
        self.stop_training = False

    # -- setup ------------------------------------------------------------

    def prepare(self, optimizer=None, loss=None, metrics: Optional[Sequence[Any]] = None,
                amp_configs=None) -> None:
        """``amp_configs`` (see ``executor.amp_level``): O1 runs linear and conv
        in bf16 with f32 accumulation; O2 also stores the parameters in
        bf16 with f32 masters (``optimizer.MasterWeights``), the masters
        taken from the f32 parameters before the cast."""
        level = amp_level(amp_configs)
        self._loss = loss
        self._metrics = list(metrics or [])
        if optimizer is not None:
            self._trainer = Trainer(self.network, optimizer, loss, amp=level,
                                    device=self.device)
            self._eval_state = None
        else:
            self._trainer = None
            net = self.network
            self._eval_state = {"params": {k: p.detach() for k, p in net.named_parameters()},
                                "buffers": {k: b.detach() for k, b in net.named_buffers()}}
        self._eval_fwd = make_eval_step(self.network)

    @property
    def state(self):
        """The live ``{"params", "buffers"}`` of the model."""
        return self._trainer.state if self._trainer is not None else self._eval_state

    def _check_prepared(self) -> None:
        enforce(self._eval_fwd is not None, "call prepare() first", PreconditionNotMetError)

    def _tensors(self, xs) -> tuple:
        return tuple(torch.as_tensor(x, device=self.device) for x in _as_tuple(xs))

    # -- training ---------------------------------------------------------

    def train_batch(self, inputs, labels) -> Dict[str, float]:
        self._check_prepared()
        enforce(self._trainer is not None, "prepare() was given no optimizer",
                PreconditionNotMetError)
        loss = self._trainer.train_step(self._tensors(inputs), self._tensors(labels))
        return {"loss": float(loss)}

    def fit(self, train_data: Iterable, eval_data: Optional[Iterable] = None, epochs: int = 1,
            callbacks: Optional[Sequence[Callback]] = None,
            verbose: int = 1) -> Dict[str, List[float]]:
        self._check_prepared()
        self.stop_training = False  # an early stop of an earlier fit ends there
        cbs = list(callbacks or [])
        if verbose:
            cbs.append(ProgBarLogger(verbose=verbose))
        history: Dict[str, List[float]] = {"loss": []}
        for cb in cbs:
            cb.on_train_begin(self)
        step = 0
        for epoch in range(epochs):
            for cb in cbs:
                cb.on_epoch_begin(self, epoch)
            losses = []
            for inputs, labels in train_data:
                logs = self.train_batch(inputs, labels)
                losses.append(logs["loss"])
                step += 1
                for cb in cbs:
                    cb.on_batch_end(self, step, logs)
                if self.stop_training:
                    break
            epoch_logs = {"loss": float(np.mean(losses))} if losses else {}
            if eval_data is not None:
                epoch_logs.update(self.evaluate(eval_data, verbose=0))
            history["loss"].append(epoch_logs.get("loss", float("nan")))
            for cb in cbs:
                cb.on_epoch_end(self, epoch, epoch_logs)
            if self.stop_training:
                break
        for cb in cbs:
            cb.on_train_end(self)
        return history

    # -- eval / predict ---------------------------------------------------

    def evaluate(self, eval_data: Iterable, verbose: int = 0) -> Dict[str, float]:
        """Mean loss over the batches (``eval_loss``) and each metric's
        ``accumulate()`` under its class name in lower case."""
        self._check_prepared()
        for m in self._metrics:
            m.reset()
        losses = []
        for inputs, labels in eval_data:
            out = self._eval_fwd(self.state, self._tensors(inputs))
            lbs = self._tensors(labels)
            if self._loss is not None:
                losses.append(float(self._loss(out, *lbs)))
            for m in self._metrics:
                m.update(out.cpu().numpy(), *(y.cpu().numpy() for y in lbs))
        logs = {}
        if losses:
            logs["eval_loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[type(m).__name__.lower()] = float(m.accumulate())
        if verbose:
            print(" ".join(f"{k}={v:.4f}" for k, v in logs.items()))
        return logs

    def predict_batch(self, inputs) -> torch.Tensor:
        self._check_prepared()
        return self._eval_fwd(self.state, self._tensors(inputs))

    # -- save/load --------------------------------------------------------

    def save(self, path: str, training: bool = True, example_inputs=None) -> None:
        raise InvalidArgumentError("Model.save is not ported yet: its glue over "
                                   "io/checkpoint.py (and, with training=False, "
                                   "io/inference.py; ROADMAP Queue A item 5)")

    def load(self, path: str) -> None:
        raise InvalidArgumentError("Model.load is not ported yet: its glue over "
                                   "io/checkpoint.py (ROADMAP Queue A item 5)")
