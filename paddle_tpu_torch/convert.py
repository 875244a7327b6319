"""Carry weights and state across from the JAX package, and back.

The ``*_from_jax`` functions take the JAX package's values as numpy
arrays (or anything ``np.asarray`` reads — a jax array converts without
this module importing jax) and return the port's tensors, so both
packages can compute the same step from the same start. The
``*_to_jax`` ones give the JAX package's trees as numpy arrays: what a
port trainer writes into a checkpoint the JAX package loads.

Layouts: the JAX ``Linear`` weight is ``[in, out]`` (paddle convention),
the port's ``[out, in]`` (torch's), so the CTR models' (DeepFM,
WideDeep, DCN, xDeepFM, DIN, ESMM, MMoE), the recsys models' (GRU4Rec, DSSM, TDM) and the vision models'
2-D ``Linear`` weights are transposed, and conv weights (OIHW in both) and
the recurrent layers' ``w_ih_*``/``w_hh_*`` (``[in, gates*H]`` in both)
are not; ERNIE keeps the JAX layout (``x @ w``), so its parameters and
Adam slots carry over name for name with no transpose. Cache and tier
state keep the JAX layout (see ``ps.embedding_cache``); the static map's
uint32 hi/lo/seed widen to int64, the dynamic map's stay 32-bit patterns
in int32 tensors (``ps.device_hash``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Union

import numpy as np
import torch

from .core.enforce import enforce
from .optimizer import Adam, MasterWeights
from .ps.device_hash import dynamic_map_state_to_device, map_state_to_device

__all__ = ["adam_state_from_jax", "cache_state_from_jax", "ctr_params_from_jax",
           "ctr_params_to_jax", "opt_state_to_jax", "dynamic_map_state_from_jax",
           "ernie_params_from_jax", "hybrid_opt_state_from_jax", "hybrid_params_from_jax",
           "map_state_from_jax", "opt_state_from_jax",
           "ravel_tree", "recsys_params_from_jax", "recsys_params_to_jax",
           "vision_params_from_jax"]

Device = Union[str, torch.device]


def ctr_params_from_jax(named_params: Mapping,
                           device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """JAX ``named_parameters()`` of a CTR model (``DeepFM``, ``WideDeep``,
    ``DCN``: ``cross.i``/``combine``, ``XDeepFM``: ``cin.i``/``cin_out``,
    ``DIN``: ``att1``/``att2``/``dnn``/``dense_lin``, ``ESMM``:
    ``ctr_tower``/``cvr_tower``, ``MMoE``: ``experts.i``/``gates.i``/
    ``towers.i``) — or a trainer's ``{"params": ..., "buffers": {}}`` tree
    → the port's params dict (the model's ``state_dict``): same names, 2-D
    weights transposed to [out, in]."""
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


def _is_rnn_weight(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf.startswith(("w_ih_", "w_hh_"))


def recsys_params_from_jax(named_params: Mapping,
                           device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """JAX ``named_parameters()`` (or a ``{"params": ..., "buffers": {}}``
    tree) of a ``GRU4Rec``, ``DSSM`` or ``TDM`` → the port's params dict:
    the same names; ``Linear`` weights transposed to [out, in], the GRU's
    ``w_ih_*``/``w_hh_*`` kept in their ``[in, gates*H]`` layout."""
    out = {}
    for k, v in named_params.get("params", named_params).items():
        a = np.asarray(v, np.float32)
        if a.ndim == 2 and not _is_rnn_weight(k):
            a = a.T
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device)
    return out


def recsys_params_to_jax(params: Mapping) -> dict:
    """Inverse of :func:`recsys_params_from_jax`: the port's params dict →
    the JAX ``{"params": ..., "buffers": {}}`` tree of numpy arrays."""
    out = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        out[k] = np.array(a.T if a.ndim == 2 and not _is_rnn_weight(k) else a, order="C")
    return {"params": out, "buffers": {}}


def _tree_leaves(tree) -> list:
    """Leaves in the JAX package's tree order: dict keys sorted, lists and
    tuples in order, None empty."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [tree]


def _tree_rebuild(tree, leaves):
    if isinstance(tree, Mapping):
        out = {k: _tree_rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_rebuild(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def _leaf_array(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def ravel_tree(tree):
    """(flat [n] f32 numpy, unravel) of a tree of tensors or arrays (nested
    dicts, lists, tuples), in the order ``jax.flatten_util.ravel_pytree``
    gives the same tree: leaves by sorted dict key, each row-major. An f32
    tree's flat vector equals JAX's bit for bit. ``unravel(flat)`` gives the
    tree back with the same structure and shapes, as f32 CPU tensors."""
    leaves = [_leaf_array(v) for v in _tree_leaves(tree)]
    shapes, sizes = [a.shape for a in leaves], [a.size for a in leaves]
    flat = np.concatenate([a.reshape(-1) for a in leaves] or [np.zeros(0, np.float32)])

    def unravel(vec):
        vec = _leaf_array(vec)
        enforce(vec.shape == (sum(sizes),),
                f"unravel takes a flat [{sum(sizes)}] vector, got {vec.shape}")
        offs = np.cumsum([0] + sizes)
        return _tree_rebuild(tree, iter(
            torch.from_numpy(vec[o:o + n].reshape(s).copy())
            for o, n, s in zip(offs, sizes, shapes)))

    return flat, unravel


def ernie_params_from_jax(named_params: Mapping,
                          device: Device = "cpu") -> Dict[str, torch.Tensor]:
    """JAX ``named_parameters()`` — or a trainer's ``{"params": ...,
    "buffers": {}}`` state — of an ``Ernie`` → the port's params dict:
    the same names and shapes, f32, no transpose."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in named_params.get("params", named_params).items()}


def hybrid_params_from_jax(trainer_params: Mapping, device: Device = "cpu") -> dict:
    """The JAX ``HybridParallelTrainer.params`` — ``{"stages": {"params"/
    "buffers": {name: [pp, …]}}, "aux": {"embed"/"head": {"params"/
    "buffers": …}}}``, as numpy or anything ``np.asarray`` reads — → the
    port trainer's tree with the same names and shapes, f32 tensors on
    ``device`` (ERNIE keeps the JAX layout: nothing is transposed)."""
    def conv(tree):
        if isinstance(tree, Mapping):
            return {str(k): conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, np.float32)).to(device)

    return conv(trainer_params)


def hybrid_opt_state_from_jax(opt_state: Mapping, optimizer, device: Device = "cpu") -> dict:
    """The JAX hybrid trainer's optimizer state → the port trainer's
    (:func:`opt_state_from_jax`, each slot tree converted by
    :func:`hybrid_params_from_jax` and flattened to the trainer's keys,
    ``parallel.hybrid.flatten_tree``)."""
    from .parallel.hybrid import flatten_tree

    return opt_state_from_jax(
        opt_state, optimizer, device,
        lambda tree, dev: flatten_tree(hybrid_params_from_jax(tree, dev)))


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
    transposed to ``[out, in]``. Every family of ``models`` (LeNet,
    ResNet, VGG, AlexNet, SqueezeNet, MobileNet, ShuffleNetV2, GoogLeNet
    with its aux heads, DenseNet) keeps the JAX module names, so one
    rule carries them all."""
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
