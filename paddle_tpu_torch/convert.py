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

Data-parallel state (``parallel.spmd.SpmdTrainer``) crosses in its
global layout (:func:`spmd_state_from_jax`, :func:`spmd_opt_state_from_jax`,
then ``SpmdTrainer.restore``): ZeRO slices joined, per-rank values
stacked on a leading rank dimension, the flat ZeRO shard slots
(``DpGradReducer.global_shard_template``) re-laid leaf by leaf, and the
error-feedback residuals re-packed bucket by bucket when the port's leaf
shapes differ from JAX's (transposed ``Linear`` weights). The hybrid
trainer's sh-sliced slots cross whole and are cut by the trainer
(:func:`hybrid_opt_state_from_jax` with ``trainer=``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .core.enforce import InvalidArgumentError, enforce
from .optimizer import Adam, MasterWeights
from .ps.device_hash import dynamic_map_state_to_device, map_state_to_device

__all__ = ["adam_state_from_jax", "cache_state_from_jax", "ctr_params_from_jax",
           "ctr_params_to_jax", "opt_state_to_jax", "dynamic_map_state_from_jax",
           "ernie_params_from_jax", "hybrid_opt_state_from_jax", "hybrid_params_from_jax",
           "map_state_from_jax", "opt_state_from_jax",
           "ravel_tree", "recsys_params_from_jax", "recsys_params_to_jax",
           "spmd_opt_state_from_jax", "spmd_state_from_jax", "vision_params_from_jax"]

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


def hybrid_opt_state_from_jax(opt_state: Mapping, optimizer, device: Device = "cpu",
                              trainer=None) -> dict:
    """The JAX hybrid trainer's optimizer state → the port trainer's
    (:func:`opt_state_from_jax`, each slot tree converted by
    :func:`hybrid_params_from_jax` and flattened to the trainer's keys,
    ``parallel.hybrid.flatten_tree``). The JAX state holds each slot at
    its global shape whatever its sh sharding; given the port ``trainer``
    the slots come back cut over its sh as it holds them."""
    from .parallel.hybrid import flatten_tree

    out = opt_state_from_jax(
        opt_state, optimizer, device,
        lambda tree, dev: flatten_tree(hybrid_params_from_jax(tree, dev)))
    return trainer._slice_slots(out) if trainer is not None else out


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


def cache_state_from_jax(state: Mapping[str, np.ndarray], device: Device,
                         rank: Optional[int] = None, shards: int = 1) -> Dict[str, torch.Tensor]:
    """Cache or hot-tier columns (show, click, embed_w, embed_state,
    embedx_w, embedx_state, has_embedx) → f32 tensors on ``device``.
    ``rank`` of ``shards``: the row block ``[rank·C/shards, (rank+1)·C/shards)``
    alone, the state one process of a sharded path's process mesh holds."""
    if rank is None:
        return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                for k, v in state.items()}
    C = len(np.asarray(next(iter(state.values()))))
    enforce(C % shards == 0 and 0 <= rank < shards,
            f"cache_state_from_jax: {C} rows do not cut into {shards} blocks (rank {rank})",
            InvalidArgumentError)
    b = C // shards
    return {k: torch.from_numpy(np.array(np.asarray(v)[rank * b:(rank + 1) * b],
                                         np.float32)).to(device) for k, v in state.items()}


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


def _np_tree(tree, device: Device):
    """numpy (or jax) leaves → tensors; NamedTuples and dicts kept."""
    if isinstance(tree, Mapping):
        return {str(k): _np_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_np_tree(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):   # a NamedTuple read back from a file
        return type(tree)(_np_tree(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def spmd_state_from_jax(state: Mapping, device: Device = "cpu",
                        params_from_jax: Callable[..., Dict[str, torch.Tensor]]
                        = ctr_params_from_jax, rank: Optional[int] = None) -> dict:
    """The JAX ``SpmdTrainer.state`` (``{"params", "buffers"}``) → the port
    trainer's whole state: params by ``params_from_jax`` (the CTR/MLP
    rule by default: 2-D weights transposed; :func:`ernie_params_from_jax`
    for JAX-layout models), buffers as they are.

    ``rank``: the part one process of a process mesh holds, for
    ``SpmdTrainer.restore(..., local=True)``. The paths that run on a
    process mesh (fused, stage 2) replicate the params and buffers, so
    every rank's part is the whole state."""
    enforce(rank is None or rank >= 0, f"rank must be >= 0, got {rank}", InvalidArgumentError)
    return {"params": params_from_jax(dict(state["params"]), device),
            "buffers": {str(k): torch.from_numpy(np.array(v)).to(device)
                        for k, v in state.get("buffers", {}).items()}}


def spmd_opt_state_from_jax(opt_state: Mapping, trainer, jax_params: Mapping,
                            params_from_jax: Callable[..., Dict[str, torch.Tensor]]
                            = ctr_params_from_jax, rank: Optional[int] = None) -> dict:
    """The JAX ``SpmdTrainer.opt_state`` → the port ``trainer``'s whole
    optimizer state (``SpmdTrainer.full_state``'s layout, for
    ``trainer.restore``). ``jax_params`` are the JAX trainer's params (in
    its tree order: the bucket layout's leaf order and the leaves' JAX
    shapes), ``params_from_jax`` the rule that carries them (as for
    :func:`spmd_state_from_jax`). Walks the port trainer's optimizer
    chain: base optimizers by :func:`opt_state_from_jax`; per-rank state
    (``local_state_keys``) rank by rank; ZeRO's flat shard slots leaf by
    leaf (unpadded, carried, re-padded); the int8 error-feedback residuals
    rank by rank and bucket by bucket (unpacked with JAX's layout,
    carried, packed with the port's).

    ``rank``: the part the process of that rank holds on the ``trainer``'s
    process mesh (its own rank): each leaf the trainer holds cut across
    ranks (a ZeRO slice or flat shard, a per-rank value) comes back as
    that rank's part alone, the rest whole, for
    ``SpmdTrainer.restore(..., local=True)``."""
    from .distributed.comm_fusion import (_pack_bucket, _unpack_bucket, build_layout,
                                          dtype_name)
    from .distributed.meta_optimizers import (FusedAllReduceOptimizer, MetaOptimizerBase,
                                              _tmap)
    from .parallel.spmd import RankSlices, full_tree

    if rank is not None:
        enforce(trainer.mesh.is_process_mesh and rank == trainer.mesh.process_rank,
                f"rank={rank}: the part of a process mesh's own rank (the trainer's mesh "
                f"{dict(trainer.mesh.shape)}, process rank {trainer.mesh.process_rank})",
                InvalidArgumentError)
        from .io.checkpoint import graft_into

        # by key path into the live tree (a RankSlices leaf takes the whole
        # as it comes), then each cut leaf cut as the live one is
        whole = graft_into(trainer.opt_state, spmd_opt_state_from_jax(
            opt_state, trainer, jax_params, params_from_jax))
        return _tmap(lambda live, x: live.recut(x).parts[0] if isinstance(live, RankSlices)
                     else x, trainer.opt_state, whole)

    device = trainer.device
    jp = {str(k): np.asarray(v) for k, v in jax_params.items()}
    port = full_tree(trainer.state)["params"]

    def carry(tree):
        return params_from_jax({str(k): np.asarray(v) for k, v in tree.items()}, device)

    def flat_carry(tree, K):
        """JAX flat (K·seg_len,) slots → the port's, leaf by leaf."""
        out = {}
        for k, v in carry({n: np.asarray(tree[n])[:jp[n].size].reshape(jp[n].shape)
                           for n in tree}).items():
            flat = torch.zeros((np.asarray(tree[k]).shape[0],), dtype=v.dtype, device=device)
            flat[:v.numel()] = v.reshape(-1)
            out[k] = flat
        return out

    def ef_carry(ef, reducer):
        jmeta = tuple((tuple(a.shape), str(a.dtype)) for a in jp.values())
        pmeta = tuple((tuple(t.shape), dtype_name(t.dtype)) for t in port.values())
        K, cfg = reducer.K, reducer.config
        jl, pl = build_layout(jmeta, K, cfg), build_layout(pmeta, K, cfg)
        jnames, pnames = list(jp), list(port)
        rows = {f"b{i}": [] for i, b in enumerate(pl.buckets) if b.quantizable}
        for r in range(K):
            leaves = {}
            for i, b in enumerate(jl.buckets):
                if f"b{i}" not in ef:
                    continue
                buf = torch.from_numpy(np.array(ef[f"b{i}"])[r]).reshape(K, b.seg_total)
                for s, x in zip(b.slots, _unpack_bucket(buf, b, K)):
                    leaves[jnames[s.index]] = x.numpy()
            carried = carry(leaves)
            cl = [carried[n].detach().cpu() if n in carried else
                  torch.zeros(port[n].shape, dtype=port[n].dtype) for n in pnames]
            for i, b in enumerate(pl.buckets):
                if f"b{i}" in rows:
                    rows[f"b{i}"].append(_pack_bucket(cl, b, K).reshape(-1))
        return {k: torch.stack(v).to(device) for k, v in rows.items()}

    def conv(st, opt):
        if isinstance(opt, FusedAllReduceOptimizer):
            r = opt.reducer
            if r.shard and r.K > 1:
                inner = opt_state_from_jax(st["inner"], opt.inner, device,
                                           lambda tree, dev: flat_carry(tree, r.K))
            else:
                inner = conv(st["inner"], opt.inner)
            return {"inner": inner, "ef": ef_carry(st["ef"], r) if st["ef"] else {}}
        if isinstance(opt, MetaOptimizerBase):
            out = {"inner": conv(st["inner"], opt.inner)}
            for k, v in st.items():
                if k == "inner":
                    continue
                if k in opt.local_state_keys:
                    n = len(next(iter(v.values())))
                    ranks = [carry({m: np.asarray(a)[i] for m, a in v.items()}) for i in range(n)]
                    out[k] = {m: torch.stack([rk[m] for rk in ranks]) for m in ranks[0]}
                else:
                    out[k] = _np_tree(v, device)
            return out
        return opt_state_from_jax(st, opt, device, params_from_jax)

    return conv(opt_state, trainer.optimizer)
