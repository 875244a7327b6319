"""Carry weights and state across from the JAX package, and back.

The ``*_from_jax`` functions take the JAX package's values as numpy
arrays (or anything ``np.asarray`` reads — a jax array converts without
this module importing jax) and return the port's tensors, so both
packages can compute the same step from the same start. The
``*_to_jax`` ones give the JAX package's trees as numpy arrays: what a
port trainer writes into a checkpoint the JAX package loads.

Layouts: the JAX ``Linear`` weight is ``[in, out]`` (paddle convention),
the port's ``[out, in]`` (torch's), so the CTR models' (DeepFM,
WideDeep) and the vision models' 2-D parameters are transposed, and conv weights (OIHW in both) are not; ERNIE
keeps the JAX layout (``x @ w``), so its parameters and Adam slots carry
over name for name with no transpose. Cache and tier
state keep the JAX layout (see ``ps.embedding_cache``); the static map's
uint32 hi/lo/seed widen to int64, the dynamic map's stay 32-bit patterns
in int32 tensors (``ps.device_hash``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Union

import numpy as np
import torch

from .optimizer import Adam, MasterWeights
from .ps.device_hash import dynamic_map_state_to_device, map_state_to_device

__all__ = ["adam_state_from_jax", "cache_state_from_jax", "ctr_params_from_jax",
           "ctr_params_to_jax", "opt_state_to_jax", "dynamic_map_state_from_jax",
           "ernie_params_from_jax", "map_state_from_jax", "opt_state_from_jax",
           "vision_params_from_jax"]

Device = Union[str, torch.device]


def ctr_params_from_jax(named_params: Mapping,
                           device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """JAX ``named_parameters()`` of a CTR model (``DeepFM``, ``WideDeep``)
    — or a trainer's ``{"params": ..., "buffers": {}}`` tree → the port's
    params dict (the model's ``state_dict``): same names, 2-D weights
    transposed to [out, in]."""
    out = {}
    for k, v in named_params.get("params", named_params).items():
        a = np.asarray(v, np.float32)
        out[k] = torch.from_numpy(np.array(a.T if a.ndim == 2 else a, order="C")).to(device)
    return out


def ctr_params_to_jax(params: Mapping) -> dict:
    """Inverse of :func:`ctr_params_from_jax`: the port's params dict →
    the JAX trainer's ``{"params": ..., "buffers": {}}`` tree of numpy
    arrays, 2-D weights transposed back to [in, out]."""
    out = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        out[k] = np.array(a.T if a.ndim == 2 else a, order="C")
    return {"params": out, "buffers": {}}


def ernie_params_from_jax(named_params: Mapping,
                          device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """JAX ``named_parameters()`` — or a trainer's ``{"params": ...,
    "buffers": {}}`` state — of an ``Ernie`` → the port's params dict:
    the same names and shapes, f32, no transpose."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in named_params.get("params", named_params).items()}


def adam_state_from_jax(opt_state: Mapping, device: Device = "cpu",
                        params_from_jax: Callable[..., Dict[str, torch.Tensor]]
                        = ctr_params_from_jax) -> dict:
    """JAX ``Adam.init``/``update`` state ({"step", "slots": {"m", "v"}},
    each slot a tree like the params) → the port's ``optimizer.Adam``
    state ({"step", "m", "v"}): :func:`opt_state_from_jax` with the CTR models'
    converter by default (pass :func:`ernie_params_from_jax` for ERNIE)."""
    return opt_state_from_jax(opt_state, Adam(), device, params_from_jax)


def vision_params_from_jax(state: Mapping, device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """A JAX vision model's ``{"params": ..., "buffers": ...}`` state (or a
    flat ``state_dict()``) → the port model's ``state_dict``, for
    ``load_state_dict``: the same names (BatchNorm's ``_mean`` and
    ``_variance`` included), f32, conv weights OIHW as they are and the
    ``Linear`` weights (the only 2-D tensors of the vision models)
    transposed to ``[out, in]``."""
    flat = {**state["params"], **state.get("buffers", {})} if "params" in state else state
    return ctr_params_from_jax(flat, device)


def opt_state_from_jax(opt_state: Mapping, optimizer, device: Device = "cpu",
                       params_from_jax: Callable[..., Dict[str, torch.Tensor]]
                       = vision_params_from_jax) -> dict:
    """The JAX state ({"step", "slots"}) of the optimizer that the port's
    ``optimizer`` mirrors (any of the port's optimizers, or
    ``MasterWeights`` around one) → the port's state: ``"step"`` and the
    slots under the port's names (the JAX slot names, or the optimizer's
    ``jax_tree_slot`` where the JAX slots are one bare tree), each tree
    converted like the model's params (``params_from_jax``)."""
    def slots(s, opt):
        if isinstance(opt, MasterWeights):
            return {"master": params_from_jax(s["master"], device),
                    "inner": slots(s["inner"], opt.inner)}
        if s is None:
            return {}
        name = getattr(opt, "jax_tree_slot", None)
        if name is not None:
            return {name: params_from_jax(s, device)}
        return {k: params_from_jax(v, device) for k, v in s.items()}

    return {"step": torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int64,
                                 device=device),
            **slots(opt_state["slots"], optimizer)}


def opt_state_to_jax(opt_state: Mapping, optimizer,
                     params_to_jax: Callable[[Mapping], dict] = ctr_params_to_jax) -> dict:
    """Inverse of :func:`opt_state_from_jax`: the port's optimizer state →
    the JAX package's ({"step": int32, "slots": ...}), each tree as
    ``params_to_jax`` gives it."""
    def slots(s, opt):
        if isinstance(opt, MasterWeights):
            return {"master": params_to_jax(s["master"]), "inner": slots(s["inner"], opt.inner)}
        name = getattr(opt, "jax_tree_slot", None)
        if name is not None:
            return params_to_jax(s[name])
        trees = {k: params_to_jax(v) for k, v in s.items() if k != "step"}
        return trees or None

    return {"step": np.asarray(int(opt_state["step"]), np.int32),
            "slots": slots(opt_state, optimizer)}


def cache_state_from_jax(state: Mapping[str, np.ndarray],
                         device: Device) -> Dict[str, torch.Tensor]:
    """Cache or hot-tier columns (show, click, embed_w, embed_state,
    embedx_w, embedx_state, has_embedx) → f32 tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in state.items()}


def map_state_from_jax(state: Mapping, device: Device) -> Dict[str, torch.Tensor]:
    """A ``DeviceKeyMap.state`` (hi, lo, row, seed) → the port's map."""
    return map_state_to_device(state, torch.device(device))


def dynamic_map_state_from_jax(arrays: Mapping, device: Device) -> Dict[str, torch.Tensor]:
    """A ``DynamicDeviceKeyMap``'s arrays (uint32 ``hi``/``lo`` and int32
    ``row`` [nbuckets, slots], uint32 ``seed``) → the port's map state
    (int32 bit patterns), ready for ``dynamic_map_lookup`` and
    ``hot_probe_gather``."""
    return dynamic_map_state_to_device(np.asarray(arrays["hi"]), np.asarray(arrays["lo"]),
                                       np.asarray(arrays["row"]), np.asarray(arrays["seed"]),
                                       torch.device(device))
