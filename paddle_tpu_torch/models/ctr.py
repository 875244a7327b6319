"""DeepFM and Wide&Deep on the sparse PS path: the GPUPS pass-training step.

Port of the DeepFM and WideDeep part of ``paddle_tpu.models.ctr`` (DCN
and xDeepFM are not ported: ROADMAP Queue A). One step unpacks
one packed wire buffer (the ``pack_ctr_batch`` layout, byte-identical to
the JAX package), probes the pass's on-device key map
(``ps.device_hash``), pulls the rows from the device cache, runs the
model forward and backward (gradients for the dense parameters and for
the pulled embeddings through ``torch.autograd.grad``), applies the
dense optimizer, and pushes the CTR sparse update (``cache_push`` → the
``ctr_sparse_rows_at`` CUDA kernel on the card).

Steps are functional like the JAX package's: ``params`` is a dict of
tensors keyed by ``named_parameters()`` names, optimizer state a dict
(``optimizer.Adam``), and the module only supplies the forward
(``torch.func.functional_call``). The cache state is updated in place.
The slab step is a Python loop over its packed buffers (CUDA graphs are
later work).

Semantics kept for parity: show=1 per example-slot, click=label, the
first-order (wide) weight is embed_w (``emb[..., 0]``) and the FM/deep
embedding is embedx_w (``emb[..., 1:]``); the steps take any model with
``forward(emb [B, S, 1+dim], dense_x [B, D]) -> logits [B]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..core.enforce import InvalidArgumentError, enforce, enforce_eq
from ..amp import step_ctx
from ..nn import functional as F
from ..nn.layers import Linear
from ..ps.device_hash import device_hash_lookup
from ..ps.embedding_cache import CacheConfig, cache_pull, cache_push

__all__ = ["CtrConfig", "DeepFM", "WideDeep", "make_ctr_train_step",
           "make_ctr_train_step_packed", "make_ctr_train_step_slab",
           "make_random_packs", "pack_ctr_batch", "serving_pull"]

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass
class CtrConfig:
    num_sparse_slots: int = 26       # Criteo categorical slots
    num_dense: int = 13              # Criteo continuous features
    embedx_dim: int = 8
    dnn_hidden: Tuple[int, ...] = (400, 400, 400)


class _DNN(nn.Module):
    """ReLU MLP tower; ``out_dim=1`` squeezes to a logit."""

    def __init__(self, in_dim: int, hidden: Tuple[int, ...], out_dim: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        dims = (in_dim,) + tuple(hidden) + (out_dim,)
        self.out_dim = out_dim
        self.layers = nn.ModuleList(
            [Linear(dims[i], dims[i + 1], generator=generator) for i in range(len(dims) - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i + 1 < len(self.layers):
                x = F.relu(x)
        return x[..., 0] if self.out_dim == 1 else x


class DeepFM(nn.Module):
    """FM (first + second order over slot embeddings) + DNN tower.

    forward(emb, dense_x): ``emb`` is the pulled [B, S, 1+dim] block
    (embed_w ++ embedx_w per slot); the embedding table itself lives in
    the PS cache. Weights are drawn from ``generator`` (default: torch's
    global generator); parameter names match the JAX package's. The tower
    and ``dense_lin`` are the port's ``Linear`` (weights ``[out, in]``),
    so they consult ``amp``."""

    def __init__(self, cfg: CtrConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.dense_lin = Linear(cfg.num_dense, 1, generator=generator)
        self.dnn = _DNN(cfg.num_sparse_slots * cfg.embedx_dim + cfg.num_dense,
                        cfg.dnn_hidden, generator=generator)

    def forward(self, emb: torch.Tensor, dense_x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        w1 = emb[..., 0]                      # [B, S] first-order weights
        v = emb[..., 1:]                      # [B, S, dim]
        first = w1.sum(dim=-1)
        sum_v = v.sum(dim=1)                  # [B, dim]
        sum_sq = (v * v).sum(dim=1)
        second = 0.5 * (sum_v * sum_v - sum_sq).sum(dim=-1)
        deep_in = torch.cat(
            [v.reshape(v.shape[0], cfg.num_sparse_slots * cfg.embedx_dim), dense_x],
            dim=-1)
        return first + second + self.dnn(deep_in) + self.dense_lin(dense_x)[..., 0]


class WideDeep(nn.Module):
    """Wide (first-order sparse weights + a dense linear) & Deep (the DNN
    over the slot embeddings and the dense features), PaddleRec's
    wide_deep. forward(emb, dense_x) as :class:`DeepFM`; weights from
    ``generator``, parameter names the JAX package's (``wide``,
    ``dnn.layers.i``)."""

    def __init__(self, cfg: CtrConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.wide = Linear(cfg.num_dense, 1, generator=generator)
        self.dnn = _DNN(cfg.num_sparse_slots * cfg.embedx_dim + cfg.num_dense,
                        cfg.dnn_hidden, generator=generator)

    def forward(self, emb: torch.Tensor, dense_x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        wide = emb[..., 0].sum(dim=-1) + self.wide(dense_x)[..., 0]
        v = emb[..., 1:]
        deep_in = torch.cat(
            [v.reshape(v.shape[0], cfg.num_sparse_slots * cfg.embedx_dim), dense_x],
            dim=-1)
        return wide + self.dnn(deep_in)


def _weighted_mean(per: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of per-example losses under the optional [B] 0/1 padding mask."""
    if weights is None:
        return per.mean()
    w = weights.to(torch.float32)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def _make_loss_fn(model: nn.Module, dense_x, labels, weights):
    """Weighted BCE over the model's logits, as a function of
    (params, pulled embeddings)."""

    def loss_fn(params, emb):
        out = functional_call(model, params, (emb, dense_x))
        per = F.binary_cross_entropy_with_logits(out, labels.to(torch.float32),
                                                 reduction="none")
        return _weighted_mean(per, weights)

    return loss_fn


def _push_stats(labels, weights, n_cols):
    """Per-position (show, click): show=1 per real example-position,
    click=label (FleetWrapper::PushSparseFromTensorAsync semantics)."""
    if weights is None:
        shows = torch.ones(labels.shape[0] * n_cols, dtype=torch.float32,
                           device=labels.device)
    else:
        shows = torch.repeat_interleave(weights.to(torch.float32), n_cols)
    clicks = torch.repeat_interleave(labels.to(torch.float32), n_cols) * shows
    return shows, clicks


def _ctr_step_body(model, optimizer, cache_cfg, params, opt_state, cache_state,
                   flat_rows, B, S, dense_x, labels, weights=None):
    # the wire carries f16 dense features and int8 labels; compute is f32
    dense_x = dense_x.to(torch.float32)
    labels = labels.to(torch.int32)
    emb = cache_pull(cache_state, flat_rows).reshape(B, S, -1).requires_grad_(True)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = _make_loss_fn(model, dense_x, labels, weights)(leaves, emb)
    *g, emb_grad = torch.autograd.grad(loss, [*leaves.values(), emb])
    new_params, new_opt = optimizer.update(dict(zip(leaves, g)), opt_state, params)
    shows, clicks = _push_stats(labels, weights, S)
    with torch.no_grad():
        new_cache = cache_push(cache_state, flat_rows, emb_grad.reshape(B * S, -1),
                               shows, clicks, cache_cfg)
    return new_params, new_opt, new_cache, loss.detach()


def _check_device(t: torch.Tensor, dev: torch.device, what: str) -> None:
    enforce(t.device.type == dev.type,
            f"{what} is on {t.device}, the step was built for {dev}",
            InvalidArgumentError)


def make_ctr_train_step(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                        device: Device = None) -> Callable:
    """The row-fed GPUPS step:

    step(params, opt_state, cache_state, rows, dense_x, labels, weights=None)
      → (params, opt_state, cache_state, loss)

    ``rows``: [B, S] int64 cache rows from ``HbmEmbeddingCache.lookup``.
    ``device`` defaults to ``"cuda"`` (raises without a GPU)."""
    dev = resolve_device(device)

    def step(params, opt_state, cache_state, rows, dense_x, labels, weights=None):
        _check_device(rows, dev, "rows")
        B, S = rows.shape
        return _ctr_step_body(model, optimizer, cache_cfg, params, opt_state,
                              cache_state, rows.reshape(-1), B, S, dense_x, labels,
                              weights)

    return step


def pack_ctr_batch(lo32: np.ndarray, dense: np.ndarray, labels: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Host side: one contiguous uint8 buffer per step —
    [lo32 u32 | dense f16 | labels i8 | weights u8?] — byte-identical to
    the JAX package's wire. Shapes are checked: a transposed array would
    repack to the same byte count and silently scramble examples."""
    B = labels.shape[0]
    enforce(lo32.ndim == 2 and lo32.shape[0] == B,
            f"lo32 must be [B={B}, S], got {lo32.shape}")
    enforce(dense.ndim == 2 and dense.shape[0] == B,
            f"dense must be [B={B}, D], got {dense.shape}")
    with np.errstate(over="ignore"):  # overflow handled by the enforce
        dense16 = np.ascontiguousarray(dense, np.float16)
    enforce(bool(np.isfinite(dense16).all())
            or not bool(np.isfinite(np.asarray(dense)).all()),
            "dense features overflow the f16 wire format (|x| > 65504); "
            "normalize them or widen the wire")
    parts = [
        np.ascontiguousarray(lo32, np.uint32).view(np.uint8).ravel(),
        dense16.view(np.uint8).ravel(),
        np.ascontiguousarray(labels, np.int8).view(np.uint8).ravel(),
    ]
    if weights is not None:
        enforce(weights.shape == (B,), f"weights must be [B={B}]")
        w = np.asarray(weights)
        enforce(bool(((w == 0) | (w == 1)).all()),
                "packed weights must be a 0/1 padding mask")
        parts.append(np.ascontiguousarray(w, np.uint8).ravel())
    return np.concatenate(parts)


def make_random_packs(rng: np.random.Generator, pool: np.ndarray, batch: int,
                      num_dense: int, n: int, p_click: float = 0.3) -> list:
    """``n`` random packed wire buffers drawn from a slot-tagged key pool
    [rows, S] — the same recipe (and random stream) as the JAX package's."""
    packs = []
    for _ in range(n):
        idx = rng.integers(0, len(pool), size=batch)
        lo32 = (pool[idx] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        dense = rng.normal(size=(batch, num_dense)).astype(np.float16)
        labels = (rng.random(batch) < p_click).astype(np.int8)
        packs.append(pack_ctr_batch(lo32, dense, labels))
    return packs


def _packed_layout(B: int, S: int, D: int, with_weights: bool):
    o_dense = B * S * 4
    o_label = o_dense + B * D * 2
    o_weight = o_label + B
    total = o_weight + (B if with_weights else 0)
    return o_dense, o_label, o_weight, total


def _unpack_ctr(packed, B, S, D, o_dense, o_label, o_weight, with_weights):
    """Reinterpret ONE packed uint8 buffer as (lo32 as int64, dense f16,
    labels i8, weights f32?) — views at static offsets, no copies but the
    widening of lo32."""
    if packed.storage_offset() % 4:  # a slab row at an odd byte offset
        packed = packed.clone()
    lo = packed[:o_dense].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    dense_x = packed[o_dense:o_label].view(torch.float16).reshape(B, D)
    labels = packed[o_label:o_weight].view(torch.int8)
    weights = packed[o_weight:].to(torch.float32) if with_weights else None
    return lo, dense_x, labels, weights


def _lookup_rows(cache_state, map_state, hi, lo):
    """Key→row probe with the missing-key sentinel contract: keys outside
    the pass working set map to capacity C (zero pull, dropped push)."""
    rows = device_hash_lookup(map_state, hi, lo)
    C = cache_state["embed_w"].shape[0]
    return torch.where(rows >= 0, rows, C)


def _slot_hi(slot_ids, B: int, dev: torch.device) -> torch.Tensor:
    slot_hi = torch.as_tensor(np.asarray(slot_ids, np.int64), device=dev)
    return slot_hi[None, :].expand(B, slot_hi.shape[0]).reshape(-1)


def make_ctr_train_step_packed(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                               slot_ids, batch_size: int, num_dense: int,
                               with_weights: bool = False,
                               device: Device = None, amp: bool = False) -> Callable:
    """The key-fed GPUPS step over a SINGLE packed wire buffer
    (``pack_ctr_batch``); keys are slot-tagged (hi half = column slot).

    step(params, opt_state, cache_state, map_state, packed_u8)
      → (params, opt_state, cache_state, loss)

    ``device`` defaults to ``"cuda"`` (raises without a GPU). ``amp``: the
    step runs under ``amp.step_ctx``, so the dense tower's products are
    bf16 with f32 accumulation and the push receives the bf16-rounded
    embedding gradient of the tower's first layer."""
    dev = resolve_device(device)
    S = len(slot_ids)
    B, D = int(batch_size), int(num_dense)
    o_dense, o_label, o_weight, total = _packed_layout(B, S, D, with_weights)
    hi = _slot_hi(slot_ids, B, dev)

    def step(params, opt_state, cache_state, map_state, packed):
        _check_device(packed, dev, "packed batch")
        enforce_eq(tuple(packed.shape), (total,), "packed batch size")
        lo, dense_x, labels, weights = _unpack_ctr(
            packed, B, S, D, o_dense, o_label, o_weight, with_weights)
        rows = _lookup_rows(cache_state, map_state, hi, lo)
        with step_ctx(amp):
            return _ctr_step_body(model, optimizer, cache_cfg, params, opt_state,
                                  cache_state, rows, B, S, dense_x, labels, weights)

    return step


def make_ctr_train_step_slab(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                             slot_ids, batch_size: int, num_dense: int, slab: int,
                             with_weights: bool = False,
                             device: Device = None, amp: bool = False) -> Callable:
    """``slab`` packed steps per call over a device-resident
    [slab, total] stack of packed buffers — the same per-step math as
    the packed step (``amp`` included), run as a Python loop.

    step(params, opt_state, cache_state, map_state, packed_slab[slab, ·])
      → (params, opt_state, cache_state, losses [slab])"""
    slab = int(slab)
    enforce(slab >= 1, "slab >= 1")
    one = make_ctr_train_step_packed(model, optimizer, cache_cfg, slot_ids,
                                     batch_size, num_dense, with_weights, device, amp)
    total = _packed_layout(int(batch_size), len(slot_ids), int(num_dense),
                           with_weights)[3]

    def step(params, opt_state, cache_state, map_state, packed_slab):
        enforce_eq(tuple(packed_slab.shape), (slab, total), "packed slab shape")
        losses = []
        for i in range(slab):
            params, opt_state, cache_state, loss = one(
                params, opt_state, cache_state, map_state, packed_slab[i])
            losses.append(loss)
        return params, opt_state, cache_state, torch.stack(losses)

    return step


def serving_pull(tables: Dict[str, torch.Tensor], map_state: Dict[str, torch.Tensor],
                 slot_hi: torch.Tensor, lo32: torch.Tensor, with_real: bool = False):
    """The serving-side probe→pull ([B, S] lo32 keys → [B, S, 1+dim]
    embeddings), the same probe and sentinel-safe gather as training.
    ``tables`` needs ``embed_w`` and ``embedx_w``; ``slot_hi`` is the [S]
    per-column key high half. ``with_real`` also returns the [B, S] 0/1
    real-position mask."""
    B, S = lo32.shape
    C = tables["embed_w"].shape[0]
    hi = slot_hi.to(torch.int64)[None, :].expand(B, S).reshape(-1)
    rows = device_hash_lookup(map_state, hi,
                              lo32.reshape(-1).to(torch.int64) & 0xFFFFFFFF)
    rows = torch.where(rows >= 0, rows, C)
    emb = cache_pull(tables, rows).reshape(B, S, -1)
    if with_real:
        return emb, (rows < C).to(torch.float32).reshape(B, S)
    return emb
