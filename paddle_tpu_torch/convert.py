"""Carry weights and state across from the JAX package.

The functions take the JAX package's values as numpy arrays (or anything
``np.asarray`` reads — a jax array converts without this module
importing jax) and return the port's tensors, so both packages can
compute the same step from the same start.

Layouts: the JAX ``Linear`` weight is ``[in, out]`` (paddle convention),
torch's ``[out, in]``, so 2-D parameters are transposed. Cache and map
state keep the JAX layout (see ``ps.embedding_cache``); the map's uint32
hi/lo/seed widen to int64 (``ps.device_hash``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from .ps.device_hash import map_state_to_device

__all__ = ["adam_state_from_jax", "cache_state_from_jax",
           "deepfm_params_from_jax", "map_state_from_jax"]

Device = Union[str, torch.device]


def deepfm_params_from_jax(named_params: Mapping[str, np.ndarray],
                           device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """JAX ``named_parameters()`` → the port's params dict (a DeepFM
    ``state_dict``): same names, 2-D weights transposed to [out, in]."""
    out = {}
    for k, v in named_params.items():
        a = np.asarray(v, np.float32)
        out[k] = torch.from_numpy(np.array(a.T if a.ndim == 2 else a, order="C")).to(device)
    return out


def adam_state_from_jax(opt_state: Mapping, device: Device = "cpu") -> dict:
    """JAX ``Adam.init``/``update`` state ({"step", "slots": {"m", "v"}},
    each slot tree {"params": {...}, "buffers": {}}) → the port's
    ``optimizer.Adam`` state ({"step", "m", "v"})."""
    slots = opt_state["slots"]

    def tree(t):
        return deepfm_params_from_jax(t.get("params", t), device)

    return {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int64, device=device),
            "m": tree(slots["m"]), "v": tree(slots["v"])}


def cache_state_from_jax(state: Mapping[str, np.ndarray],
                         device: Device) -> Dict[str, torch.Tensor]:
    """Cache columns (show, click, embed_w, ...) → f32 tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in state.items()}


def map_state_from_jax(state: Mapping, device: Device) -> Dict[str, torch.Tensor]:
    """A ``DeviceKeyMap.state`` (hi, lo, row, seed) → the port's map."""
    return map_state_to_device(state, torch.device(device))
