"""Checkpoint save/load in the JAX package's file format.

Port of ``save``/``load``/``save_checkpoint``/``load_checkpoint``/
``save_train_state``/``load_train_state``/``graft_into`` from
``paddle_tpu.io.checkpoint``. A tree of dicts, lists and tuples with
tensor, array or scalar leaves is written as one ``.npz`` (the arrays, by
position) and a ``.meta.json`` sidecar tagged ``paddle_tpu.v1`` (the
nesting, with leaf references), so dots inside dict keys are never
ambiguous and files cross-load between the packages. bf16 leaves are
stored as their ``uint16`` bits with ``"__dtype__": "bfloat16"``, as the
JAX package stores them (``np.savez`` has no bf16). Tensors are written
from the host; :func:`load` returns numpy arrays and
:func:`load_checkpoint` tensors on the device it is given.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.enforce import InvalidArgumentError, NotFoundError

__all__ = ["graft_into", "load", "load_checkpoint", "load_train_state", "save", "save_checkpoint",
           "save_train_state"]

_ARR = "__arr__"
_FORMAT = "paddle_tpu.v1"


def _encode(obj: Any, arrays: List[np.ndarray]) -> Any:
    """Array leaves → {"__arr__": index}; JSON scalars stay."""
    if isinstance(obj, dict):
        return {"__dict__": [[str(k), _encode(v, arrays)] for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        tag = "__list__" if isinstance(obj, list) else "__tuple__"
        return {tag: [_encode(v, arrays) for v in obj]}
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays.append(t.view(torch.int16).numpy().view(np.uint16))
            return {_ARR: len(arrays) - 1, "__dtype__": "bfloat16"}
        arrays.append(t.numpy())
        return {_ARR: len(arrays) - 1}
    if isinstance(obj, (np.ndarray, np.generic)):
        arrays.append(np.asarray(obj))
        return {_ARR: len(arrays) - 1}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise InvalidArgumentError(f"cannot checkpoint object of type {type(obj).__name__}")


def _decode(spec: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(spec, dict):
        if _ARR in spec:
            arr = arrays[f"a{spec[_ARR]}"]
            if "__dtype__" in spec:
                if spec["__dtype__"] != "bfloat16":
                    raise InvalidArgumentError(
                        f"checkpoint leaf of dtype {spec['__dtype__']!r}: the port reads "
                        "bfloat16 only")
                return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            return arr
        if "__dict__" in spec:
            return {k: _decode(v, arrays) for k, v in spec["__dict__"]}
        if "__list__" in spec:
            return [_decode(v, arrays) for v in spec["__list__"]]
        if "__tuple__" in spec:
            return tuple(_decode(v, arrays) for v in spec["__tuple__"])
    return spec


def _paths(path: str) -> Tuple[str, str]:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".npz", base + ".meta.json"


def save(obj: Any, path: str) -> Tuple[str, str]:
    """Save a tree; returns the two files written (npz, meta)."""
    arrays: List[np.ndarray] = []
    spec = _encode(obj, arrays)
    npz_path, meta_path = _paths(path)
    os.makedirs(os.path.dirname(os.path.abspath(npz_path)) or ".", exist_ok=True)
    np.savez(npz_path, **{f"a{i}": a for i, a in enumerate(arrays)})
    with open(meta_path, "w") as f:
        json.dump({"format": _FORMAT, "tree": spec}, f)
    return npz_path, meta_path


def load(path: str) -> Any:
    """The saved tree, its array leaves as numpy arrays (bf16 leaves as
    bf16 CPU tensors: numpy has no bf16)."""
    npz_path, meta_path = _paths(path)
    if not os.path.exists(npz_path) or not os.path.exists(meta_path):
        raise NotFoundError(f"checkpoint not found: {npz_path}")
    with open(meta_path) as f:
        meta = json.load(f)
    with np.load(npz_path) as data:
        arrays = {name: data[name] for name in data.files}
    return _decode(meta["tree"], arrays)


def _to_device(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(dev)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree


def save_checkpoint(path: str, state: Any, opt_state: Any = None,
                    step: int = 0) -> Tuple[str, str]:
    """Save a training snapshot as {"model", "opt", "step"}."""
    return save({"model": state, "opt": opt_state, "step": int(step)}, path)


def load_checkpoint(path: str, device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, Any]:
    """A :func:`save_checkpoint` snapshot (either package's) with its array
    leaves as tensors on ``device`` (``None``: the card, raising without
    one; pass ``"cpu"`` for the CPU)."""
    return _to_device(load(path), resolve_device(device))


def save_train_state(path: str, state: Any, opt_state: Any = None,
                     rng: Any = None, step: int = 0) -> Tuple[str, str]:
    """A trainer snapshot in the JAX package's schema: ``{"model":
    {"state": state[, "rng": rng]}, "opt": opt_state, "step": step}``.
    ``rng`` is a key's raw data (what ``jax.random.key_data`` gives the
    JAX package) or None. Trees go in as the caller gives them: a trainer
    whose files the JAX package should load passes its state in the JAX
    layout (``convert.ctr_params_to_jax``/``opt_state_to_jax``)."""
    payload = {"state": state}
    if rng is not None:
        payload["rng"] = rng
    return save_checkpoint(path, payload, opt_state=opt_state, step=step)


def load_train_state(path: str) -> Dict[str, Any]:
    """Inverse of :func:`save_train_state` (either package's file):
    ``{"state", "opt", "rng" (the key's raw data, or None), "step"}`` with
    numpy leaves (bf16 leaves as bf16 CPU tensors) and plain-dict
    containers."""
    snap = load(path)
    return {"state": snap["model"]["state"], "opt": snap["opt"],
            "rng": snap["model"].get("rng"), "step": int(snap.get("step", 0))}



def graft_into(template: Any, loaded: Any) -> Any:
    """``loaded``'s values restored INTO the structure of the live
    ``template`` by key path (loaded containers are plain dicts with
    string keys; a template key that is not a string is looked up in its
    string form): each leaf becomes a tensor with the template leaf's
    dtype on its device. A path the template has and ``loaded`` lacks
    raises ``NotFoundError``."""
    if isinstance(template, dict):
        out = {}
        for k, v in template.items():
            key = k if k in loaded else str(k)
            if key not in loaded:
                raise NotFoundError(f"graft_into: the loaded tree has no entry {k!r}")
            out[k] = graft_into(v, loaded[key])
        return out
    if isinstance(template, (list, tuple)):
        return type(template)(graft_into(v, loaded[i]) for i, v in enumerate(template))
    if isinstance(template, torch.Tensor):
        src = loaded if isinstance(loaded, torch.Tensor) else torch.from_numpy(np.array(loaded))
        return src.to(device=template.device, dtype=template.dtype)
    return loaded
