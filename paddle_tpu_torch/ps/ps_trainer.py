"""Dataset-driven streaming sparse training: the ``train_from_dataset`` role.

Port of ``CtrStreamTrainer`` from ``paddle_tpu.ps.ps_trainer`` (the
reference's non-GPUPS CTR worker loop, ``HogwildWorker::TrainFiles``,
hogwild_worker.cc:212). Two loops:

- **local table** — per batch: pull the rows from the host
  ``MemorySparseTable`` (insert-on-miss), run the dense forward/backward
  and Adam on the card, bring the embedding gradients back and push them
  into the host table. It is the oracle of the hot tier's parity
  contract.
- **hot tier** (``hot_tier=HotTierConfig(...)``) — the host ``ensure()``s
  residency per batch (a warm batch is pure mirror lookups), then ONE
  step on the card probes the dynamic key map, pulls, runs fwd/bwd and
  Adam, and applies the sparse CTR push in place
  (``ps.hot_tier.make_hot_ctr_train_step``). Misses fill from the cold
  table, evictions write dirty rows back. The loss stays a device scalar
  until the end of the pass, so the host's work on the next batch
  overlaps the step in front of it. With ``HotTierConfig.mesh`` the tier
  is row-sharded over K shards and the step is
  ``ps.hot_tier.make_sharded_hot_train_step``: the batch splits into K
  equal slices, the routing overflow accumulates as a device scalar and
  is checked once, at the end of the pass.

Slot-tagged keys: feasign = slot index << 32 | id (the column position
tags the key, as in FleetWrapper::PullSparseToTensorSync).

Not ported yet (ROADMAP A8, A14): the communicator / PS client / RPC
transport and its pull-ahead (``communicator=`` raises), measured
placement (``placement=`` raises), the job-checkpoint surface
(``train_state``, ``restore_train_state``, ``on_reshard``, cursors), the
step-time histogram and the flight recorder hook; ``CtrPassTrainer``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.enforce import UnavailableError, enforce
from ..data.prefetcher import DevicePrefetcher, host_tensors, to_device
from .hot_tier import (HotEmbeddingTier, HotTierConfig, make_hot_ctr_train_step,
                       make_sharded_hot_train_step, stream_loss_fn)
from .sharded_cache import check_route_overflow
from .table import MemorySparseTable

__all__ = ["CtrStreamTrainer"]


def _slot_tagged_keys(batch, sparse_slots) -> np.ndarray:
    """[B, S] slot-tagged feasigns (slot_id << 32 | lo32) from a dataset
    batch's sparse columns — THE key-layout definition."""
    cols = []
    for si, s in enumerate(sparse_slots):
        v = batch[s][0][:, 0].astype(np.uint64)
        cols.append((v & np.uint64(0xFFFFFFFF)) + (np.uint64(si) << np.uint64(32)))
    return np.stack(cols, axis=1)


def _dense_and_labels(batch, dense_slots, label_slot, n_rows: int):
    dense = (np.concatenate([batch[s][0] for s in dense_slots], axis=1).astype(np.float32)
             if dense_slots else np.zeros((n_rows, 0), np.float32))
    labels = batch[label_slot][0][:, 0].astype(np.int32)
    return dense, labels


@dataclasses.dataclass
class _PassStats:
    steps: int = 0
    samples: int = 0
    loss_sum: float = 0.0

    @property
    def mean_loss(self) -> float:
        return self.loss_sum / max(self.steps, 1)


class CtrStreamTrainer:
    """Streaming CTR trainer over a local host table, optionally through
    the persistent hot tier (see the module docstring).

    ``model`` is a port model (``models.ctr.DeepFM``); ``params`` is the
    dict of its parameters on ``device`` and ``opt_state`` the
    ``optimizer``'s state. ``device`` defaults to ``"cuda"`` and raises
    without a GPU unless the caller passes ``device="cpu"``."""

    def __init__(
        self,
        model,
        optimizer,
        table: Optional[MemorySparseTable],
        sparse_slots: Sequence[str],
        dense_slots: Sequence[str],
        label_slot: str,
        communicator=None,
        embedx_dim: Optional[int] = None,
        hot_tier=None,       # HotEmbeddingTier | HotTierConfig | None
        placement=None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        enforce(communicator is None,
                "CtrStreamTrainer: the communicator, PS client and RPC transport "
                "are not ported yet (ROADMAP A8); pass a local table", UnavailableError)
        enforce(placement is None,
                "CtrStreamTrainer: measured placement is not ported yet (it follows the "
                "rest of ROADMAP A8; distributed/placement.py is A14)",
                UnavailableError)
        enforce(table is not None, "need a local table")
        self.device = resolve_device(device)
        self.model = model
        self.table = table
        self.sparse_slots = list(sparse_slots)
        self.dense_slots = list(dense_slots)
        self.label_slot = label_slot
        self._dim = int(embedx_dim) if embedx_dim is not None else \
            table.accessor.config.embedx_dim
        self._pull_width = 1 + self._dim

        self.params = {k: v.detach().to(self.device) for k, v in model.named_parameters()}
        self.opt_state = optimizer.init(self.params)

        def step(params, opt_state, emb, dense_x, labels):
            emb = emb.requires_grad_(True)
            leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
            loss = stream_loss_fn(model, dense_x, labels)(leaves, emb)
            *g, emb_grad = torch.autograd.grad(loss, [*leaves.values(), emb])
            new_params, new_opt = optimizer.update(dict(zip(leaves, g)), opt_state, params)
            return new_params, new_opt, loss.detach(), emb_grad

        self._step = step
        #: completed-batch cursor of the last (or current) run
        self.batches_done = 0

        self.hot_tier: Optional[HotEmbeddingTier] = None
        self._hot_step = None
        if hot_tier is not None:
            if isinstance(hot_tier, HotTierConfig):
                hot_tier = HotEmbeddingTier(table, hot_tier, device=self.device)
            enforce(hot_tier.device == self.device,
                    f"hot tier lives on {hot_tier.device}, the trainer on {self.device}")
            enforce(hot_tier.cache_config.embedx_dim == self._dim,
                    "hot tier embedx_dim must match the trainer's")
            self.hot_tier = hot_tier
            dm, tc = hot_tier.device_map, hot_tier.config
            slot_ids = np.arange(len(self.sparse_slots))
            if tc.mesh is not None:
                self._hot_step = make_sharded_hot_train_step(
                    model, optimizer, hot_tier.cache_config, tc.mesh, slot_ids=slot_ids,
                    axis=tc.axis, routing=tc.routing, cap_factor=tc.cap_factor,
                    probe_buckets=dm.probe_buckets, banks=dm.banks, kernels=tc.kernels)
            else:
                self._hot_step = make_hot_ctr_train_step(
                    model, optimizer, hot_tier.cache_config, slot_ids=slot_ids,
                    probe_buckets=dm.probe_buckets, banks=dm.banks, kernels=tc.kernels,
                    device=self.device)

    # -- the stream loops -------------------------------------------------

    def train_from_dataset(self, dataset, batch_size: int = 512, drop_last: bool = True,
                           start_batch: int = 0) -> Dict[str, Any]:
        """One pass over ``dataset`` (an ``InMemoryDataset``) from batch
        ``start_batch``. Returns {loss (mean over steps), steps, samples,
        samples_per_sec} and, with a hot tier, its ``stats()`` under
        ``hot_tier``."""
        kw = dict(drop_last=drop_last, start_batch=start_batch)
        stats = _PassStats()
        self.batches_done = int(start_batch)
        if self.hot_tier is not None:
            return self._train_hot(dataset, batch_size, kw, stats)

        S = len(self.sparse_slots)
        slot_ids = np.tile(np.arange(S, dtype=np.int32), batch_size)
        dev = self.device
        t0 = time.perf_counter()
        for batch in dataset.batch_iter(batch_size, **kw):
            with torch.profiler.record_function("ctr_stream_step"):
                keys = _slot_tagged_keys(batch, self.sparse_slots)
                flat = keys.reshape(-1)
                dense, labels = _dense_and_labels(batch, self.dense_slots,
                                                  self.label_slot, keys.shape[0])
                pulled = self.table.pull_sparse(flat, slots=slot_ids[:len(flat)],
                                                create=True)
                emb = pulled[:, -self._pull_width:].reshape(keys.shape[0], S,
                                                            self._pull_width)
                self.params, self.opt_state, loss, emb_grad = self._step(
                    self.params, self.opt_state, torch.from_numpy(emb).to(dev),
                    torch.from_numpy(dense).to(dev), torch.from_numpy(labels).to(dev))
                g = emb_grad.reshape(-1, self._pull_width).cpu().numpy()
                push = np.empty((len(flat), 4 + self._dim), np.float32)
                push[:, 0] = slot_ids[:len(flat)]
                push[:, 1] = 1.0                        # show
                push[:, 2] = np.repeat(labels, S)       # click
                push[:, 3:] = g
                self.table.push_sparse(flat, push)
                stats.steps += 1
                stats.samples += int(labels.shape[0])
                stats.loss_sum += float(loss)
                self.batches_done += 1
        dt = time.perf_counter() - t0
        return {"loss": stats.mean_loss, "steps": float(stats.steps),
                "samples": float(stats.samples),
                "samples_per_sec": stats.samples / max(dt, 1e-9)}

    def _train_hot(self, dataset, batch_size: int, kw: Dict[str, Any],
                   stats: _PassStats) -> Dict[str, Any]:
        """The hot-tier loop: residency is ensured host-side per batch,
        then ONE step on the card does probe → pull → fwd/bwd → Adam →
        CTR push. Batch packing (column slicing, key tagging, pinning)
        runs on the prefetcher thread; tier mutations stay on this
        thread (the host mirror is not thread-safe, and creation order is
        part of the parity contract)."""
        tier = self.hot_tier
        dev = self.device
        pin = dev.type == "cuda"
        # deferred loss sync: device scalars, drained at the end with the
        # same per-item float() accumulation as a per-step sync
        losses: list = []
        overflow = None  # device scalar accumulator (sharded routing)

        def _packed_batches():
            for batch in dataset.batch_iter(batch_size, **kw):
                keys = _slot_tagged_keys(batch, self.sparse_slots)
                dense, labels = _dense_and_labels(batch, self.dense_slots,
                                                  self.label_slot, keys.shape[0])
                lo32 = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
                yield (keys.reshape(-1), *host_tensors((lo32, dense, labels), pin=pin),
                       int(labels.shape[0]))

        def _run(flat, lo32_h, dense_h, labels_h, n_real):
            nonlocal overflow
            # the host tensors stay referenced until the step that reads
            # their device copies has been enqueued (a pinned buffer freed
            # under a non_blocking copy would be silent corruption)
            with torch.profiler.record_function("ctr_hot_step"):
                lo32, dense, labels = to_device((lo32_h, dense_h, labels_h), dev)
                tier.ensure(flat)
                map_state = tier.device_map.device_state()
                out = self._hot_step(self.params, self.opt_state, tier.state, map_state,
                                     lo32, dense, labels)
                self.params, self.opt_state, tier.state, loss = out[:4]
                if len(out) == 5:
                    overflow = out[4] if overflow is None else overflow + out[4]
            losses.append(loss)  # device scalar — no sync here
            if len(losses) >= 4096:
                # bounded retention: these steps finished long ago
                for item in losses:
                    stats.loss_sum += float(item)
                losses.clear()
            stats.steps += 1
            stats.samples += n_real
            self.batches_done += 1

        t0 = time.perf_counter()
        pf = DevicePrefetcher(_packed_batches(), depth=2)
        try:
            for item in pf:
                _run(*item)
        finally:
            pf.close()
        # ONE host sync for the pass (per-item float() keeps the
        # accumulation association of a per-step sync)
        for item in losses:
            stats.loss_sum += float(item)
        if overflow is not None:
            check_route_overflow(overflow)
        dt = time.perf_counter() - t0
        return {"loss": stats.mean_loss, "steps": float(stats.steps),
                "samples": float(stats.samples),
                "samples_per_sec": stats.samples / max(dt, 1e-9),
                "hot_tier": tier.stats()}
