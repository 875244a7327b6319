"""Dataset-driven sparse training: the ``train_from_dataset`` role.

Port of ``CtrPassTrainer`` and ``CtrStreamTrainer`` from
``paddle_tpu.ps.ps_trainer``.

- **CtrPassTrainer** (the GPUPS pass lifecycle, ``PSGPUTrainer``): per
  pass, the host dedups the pass's slot-tagged keys and builds the key
  map (``cache.prepare_pass``), the rows are exported from the host
  table (insert-on-miss) and uploaded (``activate_pass``); then ONE step
  a batch on the card (probe, pull, forward/backward, dense update,
  sparse push: the merge and ``ctr_sparse_rows_at``), fed packed wire
  buffers through the prefetcher; ``end_pass`` flushes the rows back.
  ``train_passes`` builds the next day's pass on a background thread
  while the current one trains, with the same bits as sequential passes.
  The table may be a ``MemorySparseTable`` or an ``SsdSparseTable``.
- **CtrStreamTrainer** (the reference's non-GPUPS CTR worker loop,
  ``HogwildWorker::TrainFiles``, hogwild_worker.cc:212), two loops:

  - **RPC-only / local table** — per batch: pull the rows (insert-on-miss)
    from the host table, or with ``communicator=`` through its PS client
    (``ps.rpc.RpcPsClient`` against ``NativePsServer``s: the_one_ps mode),
    run the dense forward/backward and Adam on the card, bring the
    embedding gradients back and push them into the table or queue them on
    the communicator. With an Async/HalfAsync communicator batch N+k's
    pull is issued while batch N trains (``pull_ahead``, default
    ``FLAGS_communicator_pull_ahead``); the loop ends with the
    communicator's ``barrier()``. It is the oracle of the hot tier's parity
    contract.
  - **hot tier** (``hot_tier=HotTierConfig(...)``) — the host ``ensure()``s
    residency per batch (a warm batch is pure mirror lookups), then ONE
    step on the card probes the dynamic key map, pulls, runs fwd/bwd and
    Adam, and applies the sparse CTR push in place
    (``ps.hot_tier.make_hot_ctr_train_step``). Misses fill from the cold
    table — with a communicator, the PS table (``ps.rpc.RemoteSparseTable``),
    batch N+k's misses fetched on its pull workers — and evictions write
    dirty rows back: a warm batch makes no PS call. The loss stays a device scalar
    until the end of the pass, so the host's work on the next batch
    overlaps the step in front of it. With ``HotTierConfig.mesh`` the tier
    is row-sharded over K shards and the step is
    ``ps.hot_tier.make_sharded_hot_train_step``: the batch splits into K
    equal slices, the routing overflow accumulates as a device scalar and
    is checked once, at the end of the pass.

Slot-tagged keys: feasign = slot index << 32 | id (the column position
tags the key, as in FleetWrapper::PullSparseToTensorSync).

``CtrStreamTrainer``'s job-checkpoint surface (``io.job_checkpoint``):
``train_state()``/``restore_train_state()`` (the dense tier, as a host
copy in the JAX package's layout, so either package loads the other's
checkpoint; a restore drops the hot tier's resident set, which refills on
miss), ``checkpoint=``/``checkpoint_every=`` (quiesce the communicator,
flush the hot tier, save the cut with its stream cursor), ``start_batch``
as that cursor, and ``on_reshard()``. Its obs hooks: the
``trainer_step_time_s`` histogram (host time a step, no device sync) and
the flight recorder's ``trainer_exception`` notify.

Not ported yet (ROADMAP Queue A): measured placement (``placement=``
raises); ``CtrPassTrainer.save_inference_model`` (raises:
``io/inference.py``) and the pass-end ``check_nan_inf`` guard (a flag
that defaults to off in the JAX package; the port does not define it).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from ..amp import step_ctx
from ..convert import ctr_params_from_jax, ctr_params_to_jax, opt_state_from_jax, opt_state_to_jax
from ..core.device import resolve_device
from ..core.enforce import UnavailableError, enforce
from ..core.flags import flag
from ..data.prefetcher import DevicePrefetcher, host_tensors, to_device
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..metrics.auc import AUC
from ..metrics.basic import WuAUC
from ..models.ctr import make_ctr_train_step_packed, make_ctr_train_step_slab, pack_ctr_batch
from ..obs import flightrec as _flightrec
from ..obs import registry as _obs_registry
from .embedding_cache import CacheConfig, HbmEmbeddingCache
from .hot_tier import (HotEmbeddingTier, HotTierConfig, make_hot_ctr_train_step,
                       make_sharded_hot_train_step, stream_loss_fn)
from .communicator import SyncCommunicator
from .rpc import RemoteSparseTable
from .sharded_cache import check_route_overflow
from .table import MemorySparseTable

__all__ = ["CtrPassTrainer", "CtrStreamTrainer"]


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


_PREFETCH_DEPTH = 3  # packed batches the pass trainer's prefetcher holds
_PAD_LO32 = np.uint32(0xFFFFFFFF)  # padding key: in no pass, so it probes to the
#                                    sentinel row (zero pull, dropped push)


def _pad_tail(lo32, dense, labels, target_b: int):
    """Pad a short tail batch to ``target_b`` rows (a fixed step shape);
    the 0/1 weights mask the padding out of the loss and the pushes."""
    b = lo32.shape[0]
    weights = np.ones(target_b, np.float32)
    if b == target_b:
        return lo32, dense, labels, weights
    pad = target_b - b
    weights[b:] = 0.0
    lo32 = np.concatenate([lo32, np.full((pad, lo32.shape[1]), _PAD_LO32, np.uint32)])
    dense = np.concatenate([dense, np.zeros((pad, dense.shape[1]), np.float32)])
    labels = np.concatenate([labels, np.zeros(pad, np.int32)])
    return lo32, dense, labels, weights


@dataclasses.dataclass
class _PassStats:
    steps: int = 0
    samples: int = 0
    loss_sum: float = 0.0

    @property
    def mean_loss(self) -> float:
        return self.loss_sum / max(self.steps, 1)


class CtrPassTrainer:
    """The GPUPS pass trainer over (model, table, cache) (see the module
    docstring). ``sparse_slots``/``dense_slots``/``label_slot`` name the
    dataset's slots; a sparse slot holds one feasign per record.

    ``params`` is the dict of the model's parameters on ``device`` (the
    card by default: raises without a GPU unless ``device="cpu"``),
    ``opt_state`` the optimizer's state. ``slab`` > 1 runs that many
    steps per call (``make_ctr_train_step_slab``; the pass's tail runs
    single steps). The JAX trainer's ``amp`` and ``prefetch_depth``
    knobs are not taken: the steps run in f32 and the prefetcher holds
    ``_PREFETCH_DEPTH`` batches."""

    def __init__(self, model, optimizer, table: MemorySparseTable, cache_config: CacheConfig,
                 sparse_slots: Sequence[str], dense_slots: Sequence[str], label_slot: str,
                 slab: int = 1,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.table = table
        self.cache = HbmEmbeddingCache(table, cache_config, device=self.device,
                                       device_map=True)
        self.sparse_slots = list(sparse_slots)
        self.dense_slots = list(dense_slots)
        self.label_slot = label_slot
        self.slab = int(slab)
        self.params = {k: v.detach().to(self.device) for k, v in model.named_parameters()}
        self.opt_state = optimizer.init(self.params)
        # one step per (batch size, slab): the packed wire's offsets fix B
        self._packed_steps: Dict[Tuple[int, int], Any] = {}

    def _packed_step(self, batch_size: int, slab: int = 1):
        step = self._packed_steps.get((batch_size, slab))
        if step is None:
            kw = dict(slot_ids=np.arange(len(self.sparse_slots)), batch_size=batch_size,
                      num_dense=len(self.dense_slots), with_weights=True,
                      device=self.device)
            if slab > 1:
                step = make_ctr_train_step_slab(self.model, self.optimizer, self.cache.config,
                                                slab=slab, **kw)
            else:
                step = make_ctr_train_step_packed(self.model, self.optimizer,
                                                  self.cache.config, **kw)
            self._packed_steps[(batch_size, slab)] = step
        return step

    # -- batch packing ------------------------------------------------------

    def _pack(self, batch):
        """Dataset batch → (lo32 [B, S] u32, dense [B, D] f32, labels [B]
        i32); the slot tag is the column, so only the low halves travel."""
        tagged = _slot_tagged_keys(batch, self.sparse_slots)
        lo32 = (tagged & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        dense, labels = _dense_and_labels(batch, self.dense_slots, self.label_slot,
                                          lo32.shape[0])
        return lo32, dense, labels

    def _tagged_pass_keys(self, dataset) -> np.ndarray:
        """Every slot-tagged feasign of the pass (the dedup's input)."""
        out = [_slot_tagged_keys(b, self.sparse_slots).reshape(-1)
               for b in dataset.batch_iter(8192, drop_last=False)]
        return np.concatenate(out) if out else np.zeros(0, np.uint64)

    # -- checkpoint ---------------------------------------------------------

    def save(self, dirname: str, mode: int = 0) -> None:
        """At a pass boundary: the table's shard files (save ``mode``)
        under ``dirname/sparse`` and the dense params and optimizer state
        under ``dirname/dense``, in the JAX package's layout (weights
        [in, out], ``{"params", "buffers"}`` trees), so either package's
        trainer loads them."""
        enforce(self.cache.state is None, "save at a pass boundary (after end_pass)")
        os.makedirs(dirname, exist_ok=True)
        self.table.save(os.path.join(dirname, "sparse"), mode=mode)
        save_checkpoint(os.path.join(dirname, "dense"), ctr_params_to_jax(self.params),
                        opt_state_to_jax(self.opt_state, self.optimizer))

    def load(self, dirname: str) -> None:
        """Restore the table and the dense state of a :meth:`save`
        directory (either package's)."""
        self.table.load(os.path.join(dirname, "sparse"))
        snap = load_checkpoint(os.path.join(dirname, "dense"), device="cpu")
        self.params = ctr_params_from_jax(snap["model"], self.device)
        self.opt_state = opt_state_from_jax(snap["opt"], self.optimizer, self.device,
                                            ctr_params_from_jax)

    def save_inference_model(self, dirname: str, fused: bool = False, keys=None) -> None:
        raise UnavailableError("CtrPassTrainer.save_inference_model needs io/inference.py, "
                               "which is not ported yet (ROADMAP Queue A item 5)")

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, dataset, batch_size: int = 1024,
                 user_slot: Optional[str] = None) -> Dict[str, Any]:
        """AUC over ``dataset`` against the HOST table (pull with
        ``create=False``: unseen features contribute zeros), the model in
        f32. Returns {"auc", "auc_buckets" [2, B]} and, with ``user_slot``
        (a sparse slot holding the user id), "wuauc" and its mergeable
        "wuauc_state"."""
        if user_slot is not None:
            enforce(user_slot in self.sparse_slots,
                    f"user_slot {user_slot!r} must be a sparse slot (have {self.sparse_slots})")
        S = len(self.sparse_slots)
        dim = self.cache.config.embedx_dim
        dev = self.device
        metric = AUC()
        wu = WuAUC() if user_slot is not None else None
        for batch in dataset.batch_iter(batch_size, drop_last=False):
            lo32, dense, labels = self._pack(batch)
            keys = (lo32.astype(np.uint64)
                    + (np.arange(S, dtype=np.uint64) << np.uint64(32))).reshape(-1)
            pulled = self.table.pull_sparse(keys, create=False)
            # the trailing 1+dim columns are embed_w ++ embedx_w
            emb = np.ascontiguousarray(pulled[:, -(1 + dim):].reshape(-1, S, 1 + dim))
            with torch.no_grad():
                out = functional_call(self.model, self.params,
                                      (torch.from_numpy(emb).to(dev),
                                       torch.from_numpy(dense).to(dev)))
                probs = torch.sigmoid(out).cpu().numpy()
            metric.update(probs, labels)
            if wu is not None:
                wu.update(batch[user_slot][0][:, 0].astype(np.int64), probs, labels)
        out = {"auc": float(metric.accumulate()), "auc_buckets": metric.buckets.copy()}
        if wu is not None:
            st = wu.state
            out["wuauc"] = float(wu.accumulate(st))
            out["wuauc_state"] = st
        return out

    # -- the pass loop ----------------------------------------------------------

    def train_from_dataset(self, dataset, batch_size: int = 512,
                           drop_last: bool = True) -> Dict[str, float]:
        """One pass over ``dataset``: build, steps, flush. Returns {loss
        (mean step loss), steps, samples, samples_per_sec}."""
        return self._run_pass(dataset, None, batch_size, drop_last)

    def train_passes(self, datasets: Iterable, batch_size: int = 512,
                     drop_last: bool = True) -> list:
        """One pass per dataset, each next pass's host build
        (``cache.prepare_pass``: dedup, row assignment, key map) running
        on a background thread while the current pass trains (the
        reference's pre_build_thread); the table is read at the pass
        boundary, so the results are those of sequential
        :meth:`train_from_dataset` calls, bit for bit. The background
        task also draws the next dataset, so a lazy generator's loading
        overlaps training too."""
        end = object()
        it = iter(datasets)
        try:
            current = next(it)
        except StopIteration:
            return []
        prepared = self._prepare(current)
        results = []

        def _next():
            try:
                ds = next(it)
            except StopIteration:
                return end
            return ds, self._prepare(ds)

        with ThreadPoolExecutor(max_workers=1) as pool:
            while True:
                fut = pool.submit(_next)
                try:
                    results.append(self._run_pass(current, prepared, batch_size, drop_last))
                except BaseException:
                    # wait for the build before the training error goes up
                    # (it holds native calls), and keep that error primary
                    try:
                        fut.result()
                    except Exception:  # noqa: BLE001 — secondary to the raised one
                        pass
                    raise
                nxt = fut.result()
                if nxt is end:
                    return results
                current, prepared = nxt

    def _prepare(self, dataset) -> dict:
        with torch.profiler.record_function("ctr_pass_prepare"):
            keys = self._tagged_pass_keys(dataset)
            enforce(len(keys) > 0, "dataset has no sparse feasigns")
            return self.cache.prepare_pass(keys)

    def _run_pass(self, dataset, prepared: Optional[dict], batch_size: int,
                  drop_last: bool) -> Dict[str, float]:
        with torch.profiler.record_function("ctr_pass_build"):
            if prepared is None:
                prepared = self._prepare(dataset)
            self.cache.activate_pass(prepared)
        map_state = self.cache.device_map.state
        dev = self.device
        pin = dev.type == "cuda"
        step = self._packed_step(batch_size)
        slab = max(1, self.slab)
        slab_step = self._packed_step(batch_size, slab) if slab > 1 else None

        def host_batches():
            for batch in dataset.batch_iter(batch_size, drop_last=drop_last):
                lo32, dense, labels = self._pack(batch)
                n_real = lo32.shape[0]
                # a fixed step shape: the tail batch is padded, and its
                # 0/1 weights mask the padding out of the loss and pushes
                lo32, dense, labels, weights = _pad_tail(lo32, dense, labels, batch_size)
                yield pack_ctr_batch(lo32, dense, labels, weights=weights), n_real

        def host_items():
            # `slab` packed buffers a call; the pass's tail runs single steps
            buf, reals = [], []
            for packed, n_real in host_batches():
                if slab == 1:
                    yield host_tensors((packed,), pin=pin)[0], n_real, False
                    continue
                buf.append(packed)
                reals.append(n_real)
                if len(buf) == slab:
                    yield host_tensors((np.stack(buf),), pin=pin)[0], sum(reals), True
                    buf, reals = [], []
            for packed, n_real in zip(buf, reals):
                yield host_tensors((packed,), pin=pin)[0], n_real, False

        stats = _PassStats()
        losses = []  # device scalars: one host sync at the end of the pass
        t0 = time.perf_counter()
        pf = DevicePrefetcher(host_items(), depth=_PREFETCH_DEPTH)
        try:
            # the host tensor stays referenced until its step is enqueued
            for host, n_real, is_slab in pf:
                with torch.profiler.record_function("ctr_train_step"):
                    packed = to_device((host,), dev)[0]
                    if is_slab:
                        self.params, self.opt_state, self.cache.state, ls = slab_step(
                            self.params, self.opt_state, self.cache.state, map_state, packed)
                        losses.append(ls.sum())
                        stats.steps += slab
                    else:
                        self.params, self.opt_state, self.cache.state, loss = step(
                            self.params, self.opt_state, self.cache.state, map_state, packed)
                        losses.append(loss)
                        stats.steps += 1
                stats.samples += n_real
        finally:
            pf.close()
        if losses:
            stats.loss_sum = float(torch.stack(losses).sum())
        dt = time.perf_counter() - t0
        self.cache.end_pass()
        return {"loss": stats.mean_loss, "steps": float(stats.steps),
                "samples": float(stats.samples),
                "samples_per_sec": stats.samples / max(dt, 1e-9)}


class CtrStreamTrainer:
    """Streaming CTR trainer over a local host table or, with
    ``communicator``, a PS table, optionally through the persistent hot
    tier (see the module docstring).

    ``model`` is a port CTR model (``models.ctr.DeepFM``); ``params`` is the
    dict of its parameters on ``device`` and ``opt_state`` the
    ``optimizer``'s state. ``device`` defaults to ``"cuda"`` and raises
    without a GPU unless the caller passes ``device="cpu"``.

    With a ``communicator`` (``ps.communicator``), pulls go through its
    client and pushes through its queue under ``table_id``; ``table`` is
    then unused and may be None (pass ``embedx_dim``). ``pull_ahead`` is
    the pull prefetch depth: 0 for a ``SyncCommunicator`` and for a local
    table (exact pull-after-push order per batch), else the argument or
    ``FLAGS_communicator_pull_ahead``. A ``HotTierConfig`` over a
    communicator takes the client's table as its cold store
    (``LocalPsClient._sparse(table_id)``, or a ``RemoteSparseTable`` over
    an ``RpcPsClient``).

    ``amp=True`` runs every step under ``amp.step_ctx``: the dense tower's
    products in bf16 with f32 accumulation. The JAX package's stream
    trainer has no ``amp`` argument; its steps compute the same when first
    called inside ``amp.auto_cast``."""

    def __init__(
        self,
        model,
        optimizer,
        table: Optional[MemorySparseTable],
        sparse_slots: Sequence[str],
        dense_slots: Sequence[str],
        label_slot: str,
        communicator=None,
        table_id: int = 0,
        embedx_dim: Optional[int] = None,
        pull_ahead: Optional[int] = None,
        hot_tier=None,       # HotEmbeddingTier | HotTierConfig | None
        placement=None,
        device: Optional[Union[str, torch.device]] = None,
        amp: bool = False,
    ) -> None:
        enforce(placement is None,
                "CtrStreamTrainer: measured placement is not ported yet "
                "(distributed/placement.py, ROADMAP Queue A)", UnavailableError)
        enforce(table is not None or communicator is not None,
                "need a local table or a communicator-wrapped client")
        self.device = resolve_device(device)
        self.model = model
        self.table = table
        self.sparse_slots = list(sparse_slots)
        self.dense_slots = list(dense_slots)
        self.label_slot = label_slot
        self.communicator = communicator
        self.table_id = int(table_id)
        if communicator is None or isinstance(communicator, SyncCommunicator):
            self.pull_ahead = 0
        elif pull_ahead is None:
            self.pull_ahead = max(0, int(flag("communicator_pull_ahead")))
        else:
            self.pull_ahead = max(0, int(pull_ahead))
        self.amp = bool(amp)
        if embedx_dim is not None:
            self._dim = int(embedx_dim)
        else:
            enforce(table is not None, "pass embedx_dim when no local table is given")
            self._dim = table.accessor.config.embedx_dim
        self._pull_width = 1 + self._dim

        self.optimizer = optimizer
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
        #: completed-batch cursor of the last (or current) run: the stream
        #: position a job checkpoint records and a restarted job resumes from
        self.batches_done = 0
        # host seconds a step as a registry histogram, observed once a step
        # without a device sync (a sync would end the overlap of the host's
        # next batch with the step in front of it)
        self._h_step = _obs_registry.REGISTRY.histogram(
            "trainer_step_time_s", max_series=256, table=str(table_id))

        self.hot_tier: Optional[HotEmbeddingTier] = None
        self._hot_step = None
        if hot_tier is not None:
            if isinstance(hot_tier, HotTierConfig):
                cold = table
                if cold is None:
                    cli = communicator.client
                    if hasattr(cli, "_sparse"):  # LocalPsClient
                        cold = cli._sparse(self.table_id)
                    else:  # RpcPsClient: the full-row view over the wire
                        cold = RemoteSparseTable(cli, self.table_id,
                                                 cli.sparse_config(self.table_id))
                hot_tier = HotEmbeddingTier(cold, hot_tier, device=self.device)
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

    # -- job checkpoint surface (io/job_checkpoint.py) --------------------

    def train_state(self) -> Dict[str, Any]:
        """The dense tier of a job snapshot in the ``save_train_state``
        schema ({"state", "opt"}; no rng: the stream step is deterministic
        given the pulled rows), as the JAX trainer's trees: a host copy in
        the JAX layout (``convert.ctr_params_to_jax``/``opt_state_to_jax``),
        taken now, so later steps cannot change it and the JAX package
        loads what it becomes."""
        return {"state": ctr_params_to_jax(self.params),
                "opt": opt_state_to_jax(self.opt_state, self.optimizer)}

    def restore_train_state(self, dense: Dict[str, Any]) -> None:
        """Inverse of :meth:`train_state`: takes the dict that
        ``load_train_state``/``RestoredJob.dense`` returns (either
        package's). The hot tier's resident set is dropped: the cold table
        was (or is about to be) rebuilt from the checkpoint, so the tier
        restarts cold and refills on miss."""
        self.params = ctr_params_from_jax(dense["state"], self.device)
        self.opt_state = opt_state_from_jax(dense["opt"], self.optimizer, self.device,
                                            ctr_params_from_jax)
        if self.hot_tier is not None:
            self.hot_tier.drop()

    def on_reshard(self) -> None:
        """Trainer-side reshard participation, from the training thread at
        a batch boundary (optional: misrouted ops bounce and replay either
        way, this only narrows the window). The communicator quiesces (no
        queued push straddles the cutover), the hot tier flushes its dirty
        rows and KEEPS its resident set (``HotEmbeddingTier.on_reshard``),
        and the client re-resolves the routing at once instead of paying
        one bounced op. The JAX trainer then polls its placement manager,
        which is not ported (ROADMAP Queue A item 10)."""
        if self.communicator is not None:
            self.communicator.quiesce()
        if self.hot_tier is not None:
            self.hot_tier.on_reshard()
        if self.communicator is not None:
            refresh = getattr(self.communicator.client, "refresh_routing", None)
            if refresh is not None:
                refresh()

    def _maybe_checkpoint(self, checkpoint, every: int, batch_size: int) -> None:
        if checkpoint is None or every <= 0 or self.batches_done % every != 0:
            return
        if self.communicator is not None:
            # local quiesce, NOT barrier(): a sync barrier is a rendezvous
            # of every trainer, and the others are not at it
            self.communicator.quiesce()
        if self.hot_tier is not None:
            # flush-dirty-then-snapshot: every resident row's training is in
            # the cold table before the manager gates mutations and digests
            self.hot_tier.flush()
        checkpoint.save(step=self.batches_done,
                        cursor={"batch": self.batches_done, "batch_size": int(batch_size)},
                        dense=self.train_state())

    # -- the stream loops -------------------------------------------------

    def train_from_dataset(self, dataset, batch_size: int = 512, drop_last: bool = True,
                           start_batch: Union[int, Dict[str, Any]] = 0, checkpoint=None,
                           checkpoint_every: int = 0) -> Dict[str, Any]:
        """One pass over ``dataset`` (an ``InMemoryDataset`` or a
        ``QueueDataset``) from batch ``start_batch``. Returns {loss (mean
        over steps), steps, samples, samples_per_sec} and, with a hot tier,
        its ``stats()`` under ``hot_tier``. With a communicator the pass
        ends with its ``barrier()``, which raises a failure of its push
        thread. ``drop_last`` and ``start_batch`` go only to a
        ``batch_iter`` that takes them (a stream has no ``drop_last``); a
        resume cursor on a dataset without one raises.

        ``start_batch`` may be a saved cursor (``RestoredJob.cursor``): its
        ``batch_size`` must equal this call's, since a batch offset at
        another size is the wrong record offset. ``checkpoint`` (a
        ``JobCheckpointManager`` the trainer's table is registered with)
        saves the job every ``checkpoint_every`` completed batches:
        communicator quiesced, hot tier flushed, then tables + dense state
        + cursor as one cut. A resumed run is bit-identical to an
        uninterrupted one that checkpoints at the same batches with a
        local table or a ``SyncCommunicator`` (pull-ahead 0); async modes
        resume within their usual staleness.

        An exception that escapes the loop notifies the flight recorder
        (``trainer_exception``, with ``batches_done``) before it goes up."""
        try:
            return self._train_from_dataset(dataset, batch_size, drop_last, start_batch,
                                            checkpoint, checkpoint_every)
        except BaseException as e:
            _flightrec.notify("trainer_exception", error=f"{type(e).__name__}: {e}",
                              batches_done=self.batches_done)
            raise

    def _train_from_dataset(self, dataset, batch_size: int, drop_last: bool,
                            start_batch: Union[int, Dict[str, Any]], checkpoint,
                            checkpoint_every: int) -> Dict[str, Any]:
        if isinstance(start_batch, dict):
            saved_bs = start_batch.get("batch_size")
            enforce(saved_bs is None or int(saved_bs) == int(batch_size),
                    f"cursor was recorded at batch_size={saved_bs}; resuming at "
                    f"batch_size={batch_size} re-enters the stream at the wrong record "
                    "offset — resume with the saved batch_size")
            start_batch = int(start_batch.get("batch", 0))
        params = inspect.signature(dataset.batch_iter).parameters
        kw = {k: v for k, v in (("drop_last", drop_last), ("start_batch", start_batch))
              if k in params}
        enforce(start_batch == 0 or "start_batch" in params,
                f"{type(dataset).__name__}.batch_iter has no start_batch cursor: cannot "
                "resume mid-stream")
        stats = _PassStats()
        self.batches_done = int(start_batch)
        if self.hot_tier is not None:
            return self._train_hot(dataset, batch_size, kw, stats, checkpoint, checkpoint_every)

        S = len(self.sparse_slots)
        slot_ids = np.tile(np.arange(S, dtype=np.int32), batch_size)
        dev = self.device
        depth = self.pull_ahead
        comm = self.communicator

        def _prep(batch):
            keys = _slot_tagged_keys(batch, self.sparse_slots)
            flat = keys.reshape(-1)
            dense, labels = _dense_and_labels(batch, self.dense_slots, self.label_slot,
                                              keys.shape[0])
            # pull-ahead: batch N+depth's pull is issued now, so it overlaps
            # the steps in front of it
            fut = (comm.pull_sparse_async(self.table_id, flat, create=True,
                                          slots=slot_ids[:len(flat)])
                   if depth > 0 else None)
            return keys, flat, dense, labels, fut

        def _run(keys, flat, dense, labels, fut):
            t_step = time.perf_counter()
            with torch.profiler.record_function("ctr_stream_step"):
                if fut is not None:
                    pulled = fut.result()
                elif comm is not None:
                    pulled = comm.client.pull_sparse(self.table_id, flat, create=True,
                                                     slots=slot_ids[:len(flat)])
                else:
                    pulled = self.table.pull_sparse(flat, slots=slot_ids[:len(flat)],
                                                    create=True)
                emb = pulled[:, -self._pull_width:].reshape(keys.shape[0], S,
                                                            self._pull_width)
                with step_ctx(self.amp):
                    self.params, self.opt_state, loss, emb_grad = self._step(
                        self.params, self.opt_state, torch.from_numpy(emb).to(dev),
                        torch.from_numpy(dense).to(dev), torch.from_numpy(labels).to(dev))
                g = emb_grad.reshape(-1, self._pull_width).cpu().numpy()
                push = np.empty((len(flat), 4 + self._dim), np.float32)
                push[:, 0] = slot_ids[:len(flat)]
                push[:, 1] = 1.0                        # show
                push[:, 2] = np.repeat(labels, S)       # click
                push[:, 3:] = g
                if comm is not None:
                    comm.send_sparse(self.table_id, flat, push)
                else:
                    self.table.push_sparse(flat, push)
                stats.steps += 1
                stats.samples += int(labels.shape[0])
                stats.loss_sum += float(loss)
                self.batches_done += 1
            self._h_step.observe(time.perf_counter() - t_step)
            self._maybe_checkpoint(checkpoint, checkpoint_every, batch_size)

        t0 = time.perf_counter()
        window: deque = deque()  # batches whose pull is issued (or due)
        try:
            for batch in dataset.batch_iter(batch_size, **kw):
                window.append(_prep(batch))
                if len(window) > depth:
                    _run(*window.popleft())
            while window:
                _run(*window.popleft())
        finally:
            # no prefetched pull may outlive the pass (its worker would race
            # the caller's recovery)
            if depth > 0:
                comm._drain_pulls()
        dt = time.perf_counter() - t0
        if comm is not None:
            comm.barrier()
        return {"loss": stats.mean_loss, "steps": float(stats.steps),
                "samples": float(stats.samples),
                "samples_per_sec": stats.samples / max(dt, 1e-9)}

    def _train_hot(self, dataset, batch_size: int, kw: Dict[str, Any], stats: _PassStats,
                   checkpoint, checkpoint_every: int) -> Dict[str, Any]:
        """The hot-tier loop: residency is ensured host-side per batch,
        then ONE step on the card does probe → pull → fwd/bwd → Adam →
        CTR push. Batch packing (column slicing, key tagging, pinning)
        runs on the prefetcher thread; tier mutations stay on this
        thread (the host mirror is not thread-safe, and creation order is
        part of the parity contract). With pull-ahead, batch N+depth's
        cold fetch is issued on the communicator's pull workers before
        batch N's step."""
        tier = self.hot_tier
        dev = self.device
        pin = dev.type == "cuda"
        depth = self.pull_ahead
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
            t_step = time.perf_counter()
            with torch.profiler.record_function("ctr_hot_step"):
                lo32, dense, labels = to_device((lo32_h, dense_h, labels_h), dev)
                tier.ensure(flat)
                map_state = tier.device_map.device_state()
                with step_ctx(self.amp):
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
            self._h_step.observe(time.perf_counter() - t_step)
            self._maybe_checkpoint(checkpoint, checkpoint_every, batch_size)

        t0 = time.perf_counter()
        window: deque = deque()
        pf = DevicePrefetcher(_packed_batches(), depth=max(depth, 2))
        try:
            for item in pf:
                if depth > 0:
                    # batch N+depth's cold fetch now; a warm batch fetches
                    # nothing
                    tier.prefetch(item[0], self.communicator)
                window.append(item)
                if len(window) > depth:
                    _run(*window.popleft())
            while window:
                _run(*window.popleft())
        finally:
            pf.close()
            if depth > 0:
                self.communicator._drain_pulls()
        # ONE host sync for the pass (per-item float() keeps the
        # accumulation association of a per-step sync)
        for item in losses:
            stats.loss_sum += float(item)
        if overflow is not None:
            check_route_overflow(overflow)
        dt = time.perf_counter() - t0
        if self.communicator is not None:
            self.communicator.barrier()
        return {"loss": stats.mean_loss, "steps": float(stats.steps),
                "samples": float(stats.samples),
                "samples_per_sec": stats.samples / max(dt, 1e-9),
                "hot_tier": tier.stats()}
