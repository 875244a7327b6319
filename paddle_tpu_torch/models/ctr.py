"""The CTR model family on the sparse PS path: the GPUPS pass-training step.

Port of ``paddle_tpu.models.ctr``: ``DeepFM``, ``WideDeep``, ``DCN`` and
``XDeepFM``; the row-fed, packed, slab, from-keys and pooled
(multi-valued slots) steps; and ``export_ctr_inference``, the serving
export (``io.inference`` over ``torch.export``). One step unpacks
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

__all__ = ["CtrConfig", "DCN", "DeepFM", "WideDeep", "XDeepFM", "export_ctr_inference",
           "make_ctr_pooled_train_step", "make_ctr_train_step",
           "make_ctr_train_step_from_keys", "make_ctr_train_step_packed",
           "make_ctr_train_step_slab", "make_random_packs", "pack_ctr_batch", "serving_pull"]

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


class DCN(nn.Module):
    """Deep & Cross Network (PaddleRec's dcn): the cross tower
    ``x_{l+1} = x0 * (w_l · x_l) + b_l + x_l`` over ``x0`` = the slot
    embeddings ++ the dense features, beside the DNN over ``x0``,
    combined by a ``Linear`` over [x_L, deep], plus the first-order
    weights. forward(emb, dense_x) as :class:`DeepFM`; parameter names
    the JAX package's (``cross.i``, ``dnn.layers.i``, ``combine``)."""

    def __init__(self, cfg: CtrConfig, num_cross: int = 3,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.num_sparse_slots * cfg.embedx_dim + cfg.num_dense
        self.num_cross = num_cross
        self.cross = nn.ModuleList([Linear(d, 1, generator=generator)
                                    for _ in range(num_cross)])
        self.dnn = _DNN(d, cfg.dnn_hidden, generator=generator)
        self.combine = Linear(d + 1, 1, generator=generator)

    def forward(self, emb: torch.Tensor, dense_x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        v = emb[..., 1:]
        x0 = torch.cat([v.reshape(v.shape[0], cfg.num_sparse_slots * cfg.embedx_dim),
                        dense_x], dim=-1)
        x = x0
        for lin in self.cross:
            x = x0 * lin(x) + x       # x0 * (w·x) + b + x: the bias lives in the Linear
        deep = self.dnn(x0)
        out = self.combine(torch.cat([x, deep[:, None]], dim=-1))
        return out[..., 0] + emb[..., 0].sum(dim=-1)


class XDeepFM(nn.Module):
    """xDeepFM (PaddleRec's xdeepfm): the Compressed Interaction Network
    over the slot embeddings — each layer the pairwise products of x0's
    S rows and the previous layer's H_k rows, [B, S·H_k, D], taken by a
    ``Linear`` over the S·H_k channels for each embedding dim (a 1×1
    conv), sum-pooled over the dim — plus the DNN, a dense linear and the
    first-order weights. forward(emb, dense_x) as :class:`DeepFM`;
    parameter names the JAX package's (``cin.i``, ``cin_out``,
    ``dnn.layers.i``, ``dense_lin``)."""

    def __init__(self, cfg: CtrConfig, cin_layers: Tuple[int, ...] = (16, 16),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        g = generator
        self.cfg = cfg
        self.cin_sizes = tuple(cin_layers)
        S = cfg.num_sparse_slots
        prev = S
        self.cin = nn.ModuleList()
        for h in self.cin_sizes:
            self.cin.append(Linear(S * prev, h, bias_attr=False, generator=g))
            prev = h
        self.cin_out = Linear(sum(self.cin_sizes), 1, generator=g)
        self.dnn = _DNN(S * cfg.embedx_dim + cfg.num_dense, cfg.dnn_hidden, generator=g)
        self.dense_lin = Linear(cfg.num_dense, 1, generator=g)

    def forward(self, emb: torch.Tensor, dense_x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        S, D = cfg.num_sparse_slots, cfg.embedx_dim
        B = emb.shape[0]
        v = emb[..., 1:]                                        # [B, S, D]
        xk = v
        pooled = []
        for lin in self.cin:
            z = (v[:, :, None, :] * xk[:, None, :, :]).reshape(B, -1, D)  # [B, S·Hk, D]
            xk = lin(z.transpose(1, 2)).transpose(1, 2)          # [B, H, D]
            pooled.append(xk.sum(dim=-1))
        cin = self.cin_out(torch.cat(pooled, dim=-1))[..., 0]
        deep_in = torch.cat([v.reshape(B, S * D), dense_x], dim=-1)
        return (cin + self.dnn(deep_in) + self.dense_lin(dense_x)[..., 0]
                + emb[..., 0].sum(dim=-1))


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


def _push_stats(labels, weights, n_cols, real=None):
    """Per-position (show, click): show=1 per real example-position,
    click=label (FleetWrapper::PushSparseFromTensorAsync semantics);
    ``real`` ([B*n_cols] 0/1, optional) masks the padding positions of
    multi-valued slots."""
    if weights is None:
        shows = torch.ones(labels.shape[0] * n_cols, dtype=torch.float32,
                           device=labels.device)
    else:
        shows = torch.repeat_interleave(weights.to(torch.float32), n_cols)
    if real is not None:
        shows = shows * real
    clicks = torch.repeat_interleave(labels.to(torch.float32), n_cols) * shows
    return shows, clicks


def _ctr_step_body(model, optimizer, cache_cfg, params, opt_state, cache_state,
                   flat_rows, B, S, dense_x, labels, weights=None, loss_builder=None,
                   with_real=False):
    """One GPUPS step: pull, forward and backward, dense update, push.
    ``loss_builder(model, dense_x, labels, weights)`` (default: weighted
    BCE, :func:`_make_loss_fn`) lets a model family with its own objective
    reuse the body; the ``loss_fn(params, emb)`` it returns gives the loss
    alone (the JAX builders' auxiliary output is never read by the body).
    ``with_real``: the [B, S] real-position mask (1 where the row is below
    the capacity sentinel C) goes to ``loss_builder`` as its fifth argument
    (the attention family's models take it) and masks the padding positions out
    of the push's shows and clicks. Labels of several tasks ([B, T]) push
    the click task's, column 0."""
    # the wire carries f16 dense features and int8 labels; compute is f32
    dense_x = dense_x.to(torch.float32)
    labels = labels.to(torch.int32)
    emb = cache_pull(cache_state, flat_rows).reshape(B, S, -1).requires_grad_(True)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    make_loss = loss_builder or _make_loss_fn
    real = None
    if with_real:
        C = cache_state["embed_w"].shape[0]
        real = (flat_rows < C).to(torch.float32).reshape(B, S)
        loss = make_loss(model, dense_x, labels, weights, real)(leaves, emb)
    else:
        loss = make_loss(model, dense_x, labels, weights)(leaves, emb)
    *g, emb_grad = torch.autograd.grad(loss, [*leaves.values(), emb])
    new_params, new_opt = optimizer.update(dict(zip(leaves, g)), opt_state, params)
    click_labels = labels if labels.dim() == 1 else labels[:, 0]
    shows, clicks = _push_stats(click_labels, weights, S,
                                real=None if real is None else real.reshape(-1))
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


def make_ctr_pooled_train_step(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                                slot_of_column, device: Device = None,
                                amp: bool = False) -> Callable:
    """The GPUPS step for MULTI-VALUED sparse slots: each slot carries up
    to max_len feasigns an example, whose embeddings SUM-POOL into the
    slot (``FleetWrapper::PullSparseToTensorSync`` accumulates them into
    one slice); the push hands the slot's gradient to every contributing
    feasign with show=1 each (``PushSparseFromTensorAsync``).

    ``slot_of_column``: the [T] slot of each padded key column (T = the
    sum of the slots' max lengths, S slots). ``rows``: [B, T] int64 cache
    rows; padding positions hold the capacity sentinel C, pull zeros (the
    sum's identity) and push nothing (show 0).

    step(params, opt_state, cache_state, rows, dense_x, labels, weights=None)
      → (params, opt_state, cache_state, loss)

    ``device`` defaults to ``"cuda"`` (raises without a GPU); ``amp`` runs
    the step under ``amp.step_ctx``."""
    dev = resolve_device(device)
    cols = np.asarray(slot_of_column, np.int64)
    seg = torch.as_tensor(cols, device=dev)
    S = int(cols.max()) + 1

    def step(params, opt_state, cache_state, rows, dense_x, labels, weights=None):
        _check_device(rows, dev, "rows")
        with step_ctx(amp):
            dense_x = dense_x.to(torch.float32)
            labels = labels.to(torch.int32)
            B, T = rows.shape
            C = cache_state["embed_w"].shape[0]
            flat = rows.reshape(-1)
            emb_pos = cache_pull(cache_state, flat).reshape(B, T, -1)
            # sum-pool the columns into their slots: [B, T, 1+dim] → [B, S, 1+dim]
            pooled = torch.zeros((B, S, emb_pos.shape[-1]), dtype=emb_pos.dtype,
                                 device=emb_pos.device).index_add_(1, seg, emb_pos)
            pooled.requires_grad_(True)
            leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
            loss = _make_loss_fn(model, dense_x, labels, weights)(leaves, pooled)
            *g, pooled_grad = torch.autograd.grad(loss, [*leaves.values(), pooled])
            new_params, new_opt = optimizer.update(dict(zip(leaves, g)), opt_state, params)
            # sum-pool: every contributing position receives its slot's gradient
            pos_grad = pooled_grad[:, seg, :].reshape(B * T, -1)
            real = (flat < C).to(torch.float32)
            shows, clicks = _push_stats(labels, weights, T, real=real)
            with torch.no_grad():
                new_cache = cache_push(cache_state, flat, pos_grad, shows, clicks, cache_cfg)
        return new_params, new_opt, new_cache, loss.detach()

    return step


def make_ctr_train_step_from_keys(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                                  slot_ids=None, device: Device = None,
                                  amp: bool = False) -> Callable:
    """The GPUPS step with the key→row probe in the step (the reference's
    PSGPUWorker: CopyKeys, then the device ``HashTable::get``): the host
    ships the low 32 bits of the slot-tagged feasigns, the step probes the
    pass's key map (``ps.device_hash``), pulls, runs forward/backward and
    the dense update, and pushes. ``slot_ids``: the [S] static high halves
    of the columns (key = slot_id << 32 | lo32).

    step(params, opt_state, cache_state, map_state, keys_lo, dense_x,
         labels, weights=None) → (params, opt_state, cache_state, loss)

    ``keys_lo`` is [B, S] int64 (uint32 values) or int32 (their bit
    patterns). Keys missing from the pass probe to the capacity sentinel:
    zero pull, dropped push. ``slot_ids=None`` is the wide-key variant for
    feasigns whose high halves are not the column's slot: the step then
    takes ``(keys_hi, keys_lo)`` in place of ``keys_lo``.
    ``device`` defaults to ``"cuda"`` (raises without a GPU); ``amp`` runs
    the step under ``amp.step_ctx``."""
    dev = resolve_device(device)
    slot_hi = (torch.as_tensor(np.asarray(slot_ids, np.int64), device=dev)
               if slot_ids is not None else None)

    def _finish(params, opt_state, cache_state, map_state, hi, lo, B, S, dense_x, labels,
                weights):
        _check_device(lo, dev, "keys")
        lo = lo.to(torch.int64) & 0xFFFFFFFF
        hi = hi.to(torch.int64) & 0xFFFFFFFF
        with step_ctx(amp):
            rows = _lookup_rows(cache_state, map_state, hi, lo)
            return _ctr_step_body(model, optimizer, cache_cfg, params, opt_state,
                                  cache_state, rows, B, S, dense_x, labels, weights)

    if slot_ids is not None:
        def step(params, opt_state, cache_state, map_state, keys_lo, dense_x, labels,
                 weights=None):
            B, S = keys_lo.shape
            hi = slot_hi[None, :].expand(B, S).reshape(-1)
            return _finish(params, opt_state, cache_state, map_state, hi,
                           keys_lo.reshape(-1), B, S, dense_x, labels, weights)
    else:
        def step(params, opt_state, cache_state, map_state, keys_hi, keys_lo, dense_x,
                 labels, weights=None):
            B, S = keys_lo.shape
            return _finish(params, opt_state, cache_state, map_state, keys_hi.reshape(-1),
                           keys_lo.reshape(-1), B, S, dense_x, labels, weights)

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


def export_ctr_inference(dirname: str, model: nn.Module, cache, slot_ids, num_dense: int,
                         freeze: bool = False, with_real: bool = False, params=None,
                         refresh_only: bool = False) -> None:
    """``fleet.save_inference_model`` for the CTR serving path: probe →
    pull → forward → sigmoid exported as one program
    (``io.inference.save_inference_model``, ``torch.export``) with the
    dense params and the PRUNED serving tables (``embed_w``/``embedx_w``
    only; optimizer state and show/click are training-only) plus the
    pass's key map.

    Serving input: (lo32 [b, S] int64 holding the uint32 key halves,
    dense [b, D] float32) → pctr [b] float32, ``b`` dynamic. Keys outside
    the pass probe to the sentinel and pull zeros. The program is traced
    on the cache's device and serves there. ``params``: the trained
    params dict (default: the model's own parameters).

    ``refresh_only=True`` overwrites just the serving values (params,
    tables, key map) of an existing unfrozen export, skipping the trace.
    ``with_real=True`` feeds the model the [b, S] real-position mask as its
    second argument (the attention family's step contract: DIN), derived
    from the sentinel in the program. The output is the model's own
    ``predict`` of its logits where its class defines one (ESMM: pCTR and
    pCTCVR = pCTR·pCVR, the quantity its training scored), else a sigmoid
    on each output (a tuple for MMoE's tasks), as in the JAX package."""
    from ..io.inference import refresh_inference_params, save_inference_model

    enforce(cache.state is not None, "begin_pass first")
    enforce(cache.device_map is not None,
            "export_ctr_inference needs device_map=True on the cache "
            "(the serving program probes the pass's key map)")
    S, D = len(slot_ids), int(num_dense)
    dev = cache.state["embed_w"].device
    serving = {
        "model": {"params": {k: v.detach() for k, v in
                             (params if params is not None
                              else dict(model.named_parameters())).items()},
                  "buffers": {}},
        "tables": {"embed_w": cache.state["embed_w"], "embedx_w": cache.state["embedx_w"]},
        "map": dict(cache.device_map.state),
    }
    if refresh_only:
        enforce(not freeze, "refresh_only applies to unfrozen exports")
        refresh_inference_params(dirname, serving)
        return
    slot_hi = torch.as_tensor(np.asarray(slot_ids, np.int64), device=dev)

    predict = getattr(type(model), "predict", None)

    def serve_fn(p, lo32, dense_x):
        if with_real:
            emb, real = serving_pull(p["tables"], p["map"], slot_hi, lo32, with_real=True)
            args = (emb, real, dense_x.to(torch.float32))
        else:
            args = (serving_pull(p["tables"], p["map"], slot_hi, lo32),
                    dense_x.to(torch.float32))
        out = functional_call(model, {**p["model"]["params"], **p["model"]["buffers"]}, args)
        if predict is not None:
            return predict(out)
        return tuple(map(torch.sigmoid, out)) if isinstance(out, tuple) else torch.sigmoid(out)

    example = (torch.zeros((2, S), dtype=torch.int64, device=dev),
               torch.zeros((2, D), dtype=torch.float32, device=dev))
    save_inference_model(dirname, serve_fn, serving, example, freeze=freeze,
                         notes={"inputs": "lo32 [b, S]: the uint32 low halves of the "
                                          "slot-tagged keys, carried as int64 in [0, 2^32); "
                                          "dense [b, D] float32",
                                "output": "pctr [b] float32, or one [b] float32 per task "
                                          "(the model's predict)"})
