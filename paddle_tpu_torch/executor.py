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

``Trainer.train_from_dataset`` drives a dataset's batches through the
step with the batch's arrays moved to the device on the prefetcher's
thread (``data.prefetcher.device_prefetch``). ``Trainer.train_step``
runs in a ``train_step`` profiler scope (``core.profiler.RecordEvent``),
checks its loss for NaN/Inf while the ``check_nan_inf`` flag is set
(``core.nan_inf.check_numerics``; one host sync a step), and appends the
fields of :meth:`Trainer.set_dump_config` to its dump file.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.func import functional_call

from .amp import step_ctx
from .core.device import resolve_device
from .core.enforce import InvalidArgumentError, enforce
from .core.flags import flag
from .core.nan_inf import check_numerics
from .core.profiler import RecordEvent
from .data.prefetcher import device_prefetch
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
        self._dump_fh = None
        self._dump_fields: Tuple[str, ...] = ()

    def set_dump_config(self, dump_path: Optional[str], fields=("loss",),
                        trainer_id: int = 0) -> None:
        """Worker debug dumps (trainer.h ParseDumpConfig / DeviceWorker
        DumpField): after each step, append the selected values to
        ``{dump_path}/trainer-{trainer_id:03d}.dump``, one line a field:
        ``step<TAB>field<TAB>the first 16 values`` (``%.6g``, `` ...`` when
        there are more). Fields: "loss", "param:<name>", "buffer:<name>",
        "input:<i>", "label:<i>" (a param is the port's tensor, so a
        ``Linear`` weight dumps in its ``[out, in]`` order). ``dump_path=None``
        closes the file."""
        if self._dump_fh is not None:
            self._dump_fh.close()
            self._dump_fh = None
        self._dump_fields = tuple(fields)
        if dump_path:
            os.makedirs(dump_path, exist_ok=True)
            self._dump_fh = open(os.path.join(dump_path, f"trainer-{trainer_id:03d}.dump"), "a")

    def _dump(self, inputs, labels, loss) -> None:
        def fmt(v):
            a = v.detach().cpu().numpy().reshape(-1)
            head = " ".join(f"{x:.6g}" for x in a[:16])
            return f"{head}{' ...' if a.size > 16 else ''}"

        for f in self._dump_fields:
            if f == "loss":
                val = loss
            elif f.startswith("param:"):
                val = self.state["params"].get(f[6:])
            elif f.startswith("buffer:"):
                val = self.state["buffers"].get(f[7:])
            elif f.startswith("input:"):
                val = inputs[int(f[6:])]
            elif f.startswith("label:"):
                val = labels[int(f[6:])]
            else:
                val = None
            if val is not None:
                self._dump_fh.write(f"{self.global_step}\t{f}\t{fmt(val)}\n")
        self._dump_fh.flush()

    def _to_device(self, xs) -> Tuple:
        return tuple(torch.as_tensor(x, device=self.device) for x in _as_tuple(xs))

    def train_step(self, inputs, labels) -> torch.Tensor:
        """One step; returns the loss as a device tensor (no host sync
        unless ``check_nan_inf`` is set or a dump is configured)."""
        inputs, labels = self._to_device(inputs), self._to_device(labels)
        with RecordEvent("train_step"):
            self.state, self.opt_state, loss = self._train_step(
                self.state, self.opt_state, inputs, labels)
        self.global_step += 1
        if flag("check_nan_inf"):
            check_numerics({"loss": loss}, f"step {self.global_step}")
        if self._dump_fh is not None:
            self._dump(inputs, labels, loss)
        return loss

    def predict(self, inputs) -> torch.Tensor:
        with RecordEvent("eval_step"):
            return self._eval_step(self.state, self._to_device(inputs))

    def train_from_dataset(self, dataset, feed: Callable, batch_size: int = 256,
                           epochs: int = 1, prefetch_depth: int = 2,
                           drop_last: bool = True) -> List[float]:
        """The reference's ``Executor.train_from_dataset`` (executor.py:2389):
        every batch of ``dataset`` (an ``InMemoryDataset`` or
        ``QueueDataset``) through :meth:`train_step`, ``epochs`` times.
        ``feed(batch) -> (inputs, labels)`` adapts the {slot: (values,
        lengths)} columns to the model; its arrays reach the device on the
        prefetcher's thread. Returns each epoch's mean loss as a float
        (one host sync an epoch; NaN for an epoch with no batch).
        ``drop_last`` goes only to a ``batch_iter`` that takes it (a
        stream cannot know its tail)."""
        kw = ({"drop_last": drop_last}
              if "drop_last" in inspect.signature(dataset.batch_iter).parameters else {})
        epoch_losses = []
        for _ in range(int(epochs)):
            pf = device_prefetch((feed(b) for b in dataset.batch_iter(batch_size, **kw)),
                                 depth=prefetch_depth, device=self.device)
            losses = []
            try:
                for inputs, labels in pf:
                    losses.append(self.train_step(inputs, labels))
            finally:
                pf.close()
            epoch_losses.append(float(torch.stack(losses).mean()) if losses else float("nan"))
        return epoch_losses

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
