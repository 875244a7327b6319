"""Carry weights and state across from the JAX package.

The functions take the JAX package's values as numpy arrays (or anything
``np.asarray`` reads — a jax array converts without this module
importing jax) and return the port's tensors, so both packages can
compute the same step from the same start.

Layouts: the JAX ``Linear`` weight is ``[in, out]`` (paddle convention),
torch's ``[out, in]``, so DeepFM's 2-D parameters are transposed; ERNIE
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

from .ps.device_hash import dynamic_map_state_to_device, map_state_to_device

__all__ = ["adam_state_from_jax", "cache_state_from_jax",
           "deepfm_params_from_jax", "dynamic_map_state_from_jax",
           "ernie_params_from_jax", "map_state_from_jax"]

Device = Union[str, torch.device]


def deepfm_params_from_jax(named_params: Mapping,
                           device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """JAX ``named_parameters()`` — or a trainer's ``{"params": ...,
    "buffers": {}}`` tree (the stream trainer's ``params``) → the port's
    params dict (a DeepFM ``state_dict``): same names, 2-D weights
    transposed to [out, in]."""
    out = {}
    for k, v in named_params.get("params", named_params).items():
        a = np.asarray(v, np.float32)
        out[k] = torch.from_numpy(np.array(a.T if a.ndim == 2 else a, order="C")).to(device)
    return out


def ernie_params_from_jax(named_params: Mapping,
                          device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """JAX ``named_parameters()`` — or a trainer's ``{"params": ...,
    "buffers": {}}`` state — of an ``Ernie`` → the port's params dict:
    the same names and shapes, f32, no transpose."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in named_params.get("params", named_params).items()}


def adam_state_from_jax(opt_state: Mapping, device: Device = "cpu",
                        params_from_jax: Callable[..., Dict[str, torch.Tensor]]
                        = deepfm_params_from_jax) -> dict:
    """JAX ``Adam.init``/``update`` state ({"step", "slots": {"m", "v"}},
    each slot a tree like the params) → the port's ``optimizer.Adam``
    state ({"step", "m", "v"}). The slots convert like the model's
    params: ``params_from_jax`` is that model's converter (DeepFM's by
    default, which transposes; pass :func:`ernie_params_from_jax` for
    ERNIE)."""
    slots = opt_state["slots"]
    return {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int64, device=device),
            "m": params_from_jax(slots["m"], device),
            "v": params_from_jax(slots["v"], device)}


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
