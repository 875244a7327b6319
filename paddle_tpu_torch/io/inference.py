"""Inference-model export and serving (``save_inference_model``).

Port of ``paddle_tpu.io.inference``. The reference exports a pruned
serving program and its persistables (``fleet.save_inference_model``,
fleet_base.py:787) for the Paddle Inference engine; the JAX package
serializes a ``jax.export`` of the jitted predict function. Here the
artifact is a ``torch.export`` program, ``torch.export.save``-d and
loaded by a fresh process with ``torch.export.load``.

Layout under ``dirname/``:

- ``model.pt2`` — the exported program (with the weights as its own
  buffers when ``freeze=True``, else the params tree is its first input);
- ``params.npz`` + ``params.meta.json`` — the params tree in
  ``io.checkpoint``'s format (unfrozen exports), so a newer checkpoint
  can be dropped in without re-exporting;
- ``manifest.json`` — freeze, the inputs' shapes (``"b"`` for the
  dynamic batch dimension) and dtypes, the device the program was traced
  on, and notes on the inputs' encoding.

Divergences from the JAX package:

- the program file is ``model.pt2``, not ``model.stablehlo``;
- the batch dimension of every input is dynamic (``torch.export.Dim``,
  as JAX's symbolic ``"b"``), and the example inputs are tensors: a
  traced batch of 1 is widened to 2 (export specializes sizes 0 and 1);
- an export traced on one device serves on that device: the device hash
  probe builds its constants with ``device=`` at trace time
  (``ps.device_hash``), so :class:`InferencePredictor` refuses another
  device instead of moving the program;
- keys are not uint32 tensors: the CTR exports take the uint32 halves as
  int64 in [0, 2^32), and numpy inputs are cast to the manifest's dtype;
- an exported function runs plain torch ops only: a kernel wrapper
  (ctypes) cannot be traced, and no serving path reaches one.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.enforce import InvalidArgumentError, PreconditionNotMetError, enforce
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["InferencePredictor", "load_inference_model", "refresh_inference_params",
           "save_inference_model"]

_PROGRAM = "model.pt2"
_DTYPES = {"torch.float32": torch.float32, "torch.float16": torch.float16,
           "torch.bfloat16": torch.bfloat16, "torch.int64": torch.int64,
           "torch.int32": torch.int32, "torch.int8": torch.int8, "torch.uint8": torch.uint8,
           "torch.bool": torch.bool}


def _plain(tree):
    """Containers normalized as the checkpoint stores them: dicts with
    string keys, in sorted order (the export pins its input tree; a
    reloaded tree comes back with string keys), lists and tuples kept."""
    if isinstance(tree, dict):
        return {str(k): _plain(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _static(tree):
    """A ``dynamic_shapes`` tree of None for a params tree."""
    if isinstance(tree, dict):
        return {k: _static(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_static(v) for v in tree)
    return None


class _Open(torch.nn.Module):
    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, params, *inputs):
        return self.fn(params, *inputs)


class _Frozen(torch.nn.Module):
    """``fn`` with the params tree baked in as the module's buffers."""

    def __init__(self, fn: Callable, params) -> None:
        super().__init__()
        self.fn = fn
        self.tree = params
        leaves = _leaves(params)
        for i, t in enumerate(leaves):
            self.register_buffer(f"p{i}", t)
        self.n = len(leaves)

    def forward(self, *inputs):
        params = _rebuild(self.tree, iter(getattr(self, f"p{i}") for i in range(self.n)))
        return self.fn(params, *inputs)


def _example(x) -> torch.Tensor:
    t = torch.as_tensor(x)
    enforce(t.dim() >= 1 and t.shape[0] >= 1, "example inputs need a batch of at least 1",
            InvalidArgumentError)
    if t.shape[0] == 1:  # export specializes sizes 0 and 1
        t = t.expand(2, *t.shape[1:]).contiguous()
    return t


def save_inference_model(dirname: str, fn: Callable, params: Any, example_inputs: Tuple,
                         freeze: bool = False, notes: Optional[dict] = None) -> None:
    """Export ``fn(params, *inputs)`` for serving, traced with
    ``torch.export`` on ``example_inputs`` (tensors; dimension 0 of each
    is the dynamic batch) on the device the tensors live on.

    ``freeze=True`` bakes the current params into the program (a single
    file to deploy); ``freeze=False`` (default) keeps them a call-time
    input and saves them beside it, so a newer checkpoint can be dropped
    in (:func:`refresh_inference_params`). ``notes`` go into the
    manifest (e.g. how the inputs are encoded)."""
    os.makedirs(dirname, exist_ok=True)
    params = _plain(params)
    inputs = tuple(_example(x) for x in example_inputs)
    batch = torch.export.Dim("b", min=1)
    in_shapes = tuple({0: batch} for _ in inputs)
    with torch.no_grad():
        # the forwards take the inputs as varargs: one tuple in dynamic_shapes
        if freeze:
            ep = torch.export.export(_Frozen(fn, params), inputs, dynamic_shapes=(in_shapes,))
        else:
            ep = torch.export.export(_Open(fn), (params, *inputs),
                                     dynamic_shapes=(_static(params), in_shapes))
    torch.export.save(ep, os.path.join(dirname, _PROGRAM))
    if not freeze:
        save_checkpoint(os.path.join(dirname, "params"), params)
    devices = {t.device.type for t in inputs}
    manifest = {
        "freeze": bool(freeze),
        "format": "torch.export",
        "device": devices.pop() if len(devices) == 1 else "mixed",
        "inputs": [{"shape": ["b"] + [str(d) for d in x.shape[1:]], "dtype": str(x.dtype)}
                   for x in inputs],
        "notes": dict(notes or {}),
    }
    with open(os.path.join(dirname, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def refresh_inference_params(dirname: str, params: Any) -> None:
    """Overwrite ONLY the params checkpoint of an existing unfrozen export
    (the online refresh: between serving updates only the values change,
    so the trace and the program file are skipped). Shapes must match
    the original export's."""
    manifest_path = os.path.join(dirname, "manifest.json")
    enforce(os.path.exists(os.path.join(dirname, _PROGRAM)) and os.path.exists(manifest_path),
            f"no existing export at {dirname} to refresh — call save_inference_model first",
            PreconditionNotMetError)
    with open(manifest_path) as f:
        manifest = json.load(f)
    enforce(not manifest["freeze"],
            "frozen exports bake params into the program — re-export instead of refreshing",
            PreconditionNotMetError)
    save_checkpoint(os.path.join(dirname, "params"), _plain(params))


class InferencePredictor:
    """A loaded serving handle (the Paddle Inference ``Predictor`` role):
    ``predictor(*inputs)`` runs the exported program on ``device``
    (default ``"cuda"``, raising without a GPU; pass ``device="cpu"`` for
    the CPU), which must be the device the program was traced on.
    Inputs may be numpy arrays (cast to the manifest's dtypes) or
    tensors; the result is a tensor on ``device``."""

    def __init__(self, dirname: str, device: Optional[Union[str, torch.device]] = None) -> None:
        self.dirname = dirname
        self.device = resolve_device(device)
        path = os.path.join(dirname, _PROGRAM)
        enforce(os.path.exists(path), f"no inference model at {dirname}",
                PreconditionNotMetError)
        with open(os.path.join(dirname, "manifest.json")) as f:
            self.manifest = json.load(f)
        enforce(self.manifest["device"] == self.device.type,
                f"the program at {dirname} was traced on {self.manifest['device']} and "
                f"serves there; asked to serve on {self.device}", InvalidArgumentError)
        self._module = torch.export.load(path).module()
        self._dtypes = [_DTYPES[x["dtype"]] for x in self.manifest["inputs"]]
        self._params = None
        if not self.manifest["freeze"]:
            self.reload_params()

    def set_params(self, params: Any) -> None:
        """Swap in newer params (unfrozen exports only)."""
        enforce(not self.manifest["freeze"], "frozen exports have no swappable params")
        self._params = _plain(params)

    def reload_params(self) -> None:
        """Re-read ONLY this export's params checkpoint (after a
        :func:`refresh_inference_params`): the loaded program keeps
        serving with the new values."""
        enforce(not self.manifest["freeze"], "frozen exports have no swappable params")
        self._params = _plain(load_checkpoint(os.path.join(self.dirname, "params"),
                                              device=self.device)["model"])

    def _input(self, x, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.from_numpy(np.ascontiguousarray(np.asarray(x).astype(
            str(dtype).replace("torch.", "")))).to(self.device)

    @torch.no_grad()
    def __call__(self, *inputs):
        enforce(len(inputs) == len(self._dtypes),
                f"the program takes {len(self._dtypes)} inputs, got {len(inputs)}",
                InvalidArgumentError)
        xs = [self._input(x, d) for x, d in zip(inputs, self._dtypes)]
        if self.manifest["freeze"]:
            return self._module(*xs)
        return self._module(self._params, *xs)


def load_inference_model(dirname: str,
                         device: Optional[Union[str, torch.device]] = None) -> InferencePredictor:
    return InferencePredictor(dirname, device)
