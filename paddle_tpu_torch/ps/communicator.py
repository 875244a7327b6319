"""Trainer-side gradient communicator.

The port's own copy of ``paddle_tpu.ps.communicator`` (the reference
Communicator, ``ps/service/communicator/communicator.h``: Async :402,
HalfAsync :492, Sync :537, Geo :566; the MainThread loop
communicator.cc:554). The train loop queues gradients; a background
thread merges up to ``max_merge_var_num`` queued batches a table (sparse:
concatenated, the client merges duplicate keys; dense: summed, averaged
when ``is_sgd_optimizer``) and pushes them through the PS client.

- :class:`AsyncCommunicator`: free-running background merge and push.
- :class:`HalfAsyncCommunicator`: the same queue; ``barrier()`` drains it
  and every in-flight pull, and raises a failure of the push thread.
- :class:`SyncCommunicator`: pushes inline on send; ``barrier()`` is the
  client's all-trainer barrier; a prefetched pull raises.
- :class:`GeoCommunicator`: GEO-SGD deltas, merged by mean and pushed
  every ``geo_step`` sends.

Pulls issued ahead (:meth:`_BaseCommunicator.pull_sparse_async`) and
other fetches (:meth:`_BaseCommunicator.fetch_async`, the hot tier's
cold-row prefetch) run on two pull workers and are tracked, so
``quiesce()``/``barrier()`` wait for them too. A prefetched pull that
dies on a transport failure refreshes the client's routing (``ps.ha``
failover) and replays once on the promoted backup. A prefetched pull
carries the submitting thread's trace span (``obs.trace``), so its wire
frames carry the span's context and a replay marks that span retried.
``quiesce()`` and ``stop()`` drain the client's int8 error-feedback residuals
(``RpcPsClient.drain_push_residuals``): after a quiesce no training
signal lives on the client side. A push that fails on the background
thread is stored and raised at the next ``barrier()`` or ``stop()``;
after that the communicator stays failed. Plain ``threading`` and
``queue`` carry it; the obs counters are plain integers.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.enforce import PreconditionNotMetError
from ..core.flags import define_flag, flag
from ..obs import trace as _trace
from .client import PSClient

__all__ = ["AsyncCommunicator", "CommunicatorConfig", "GeoCommunicator",
           "HalfAsyncCommunicator", "SyncCommunicator"]

define_flag("communicator_max_merge_var_num", 20,
            "gradient batches merged per push (communicator.h:412)")
define_flag("communicator_send_queue_size", 20, "per-table send queue depth")
define_flag("communicator_is_sgd_optimizer", True,
            "sum (False) vs average (True) on merge (communicator.h:54)")
define_flag("communicator_pull_ahead", 1,
            "sparse pull prefetch depth for stream trainers: batch N+k's pull issues "
            "while batch N computes; Sync mode and local tables ignore it; 0 disables")


class CommunicatorConfig:
    """The merge and queue knobs, read from their flags at construction."""

    def __init__(self) -> None:
        self.max_merge_var_num = int(flag("communicator_max_merge_var_num"))
        self.send_queue_size = int(flag("communicator_send_queue_size"))
        self.is_sgd_optimizer = bool(flag("communicator_is_sgd_optimizer"))


#: the merge loop's sleep when it finds nothing to push
_IDLE_S = 0.002


class _BaseCommunicator:
    """Send queues, the merge loop and the tracked pull workers (see the
    module docstring). The knobs come from the flags at construction."""

    def __init__(self, client: PSClient) -> None:
        self.client = client
        self.config = CommunicatorConfig()
        self._queues: Dict[int, queue.Queue] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # batches sent and not yet pushed (queued, or taken by the merge
        # loop and on their way): quiesce() waits for 0
        self._unpushed = 0
        self._unpushed_cv = threading.Condition()
        self._error: Optional[BaseException] = None
        self._push_thread_dead = False  # sticky: _error is raised once
        self._pull_pool: Optional[ThreadPoolExecutor] = None
        self._pull_mu = threading.Lock()
        self._inflight_pulls: set = set()
        #: merged batches pushed, and pushes made (plain counters)
        self.merged_batches = 0
        self.pushes = 0

    # -- train-loop API -----------------------------------------------------

    def send_sparse(self, table_id: int, keys: np.ndarray, values: np.ndarray) -> None:
        self._enqueue(table_id, ("sparse", keys, values))

    def send_dense(self, table_id: int, grad: np.ndarray) -> None:
        self._enqueue(table_id, ("dense", None, grad))

    def _enqueue(self, table_id: int, item) -> None:
        with self._unpushed_cv:
            self._unpushed += 1
        self._queue_for(table_id).put(item)

    def _landed(self, n: int) -> None:
        with self._unpushed_cv:
            self._unpushed -= n
            self._unpushed_cv.notify_all()

    def _submit(self, fn, *args) -> Future:
        with self._pull_mu:
            if self._pull_pool is None:
                self._pull_pool = ThreadPoolExecutor(max_workers=2,
                                                     thread_name_prefix="communicator-pull")
            fut = self._pull_pool.submit(fn, *args)
            self._inflight_pulls.add(fut)
        fut.add_done_callback(self._pull_done)
        return fut

    def pull_sparse_async(self, table_id: int, keys: np.ndarray, create: bool = True,
                          slots=None) -> Future:
        """Issue a pull on a pull worker; the future's result is the
        pulled values. It sees the pushes that have already reached the PS
        (stale by up to the queue depth: the async-PS contract)."""
        # the worker adopts the submitting thread's sampled span (usually
        # the train step's)
        return self._submit(self._pull_traced, _trace.current_span(), table_id, keys,
                            create, slots)

    def _pull_traced(self, ctx, table_id, keys, create, slots):
        with _trace.with_span(ctx):
            return self._pull_with_replay(table_id, keys, create, slots)

    def _pull_with_replay(self, table_id, keys, create, slots):
        try:
            return self.client.pull_sparse(table_id, keys, create, slots)
        except Exception:
            # the client's own failover may have timed out mid-promotion:
            # one refresh and replay covers the window
            refresh = getattr(self.client, "refresh_routing", None)
            if refresh is None or not refresh():
                raise
            _trace.mark_retried()  # the same span: a replay, not a new op
            return self.client.pull_sparse(table_id, keys, create, slots)

    def fetch_async(self, fn) -> Future:
        """Run a zero-arg PS fetch on the pull workers, tracked like a
        prefetched pull (``quiesce()``/``barrier()`` wait for it)."""
        return self._submit(fn)

    def _pull_done(self, fut) -> None:
        with self._pull_mu:
            self._inflight_pulls.discard(fut)

    def _drain_pulls(self) -> None:
        """Wait until no pull is in flight (their results and errors stay
        with their futures' owners)."""
        while True:
            with self._pull_mu:
                futs = list(self._inflight_pulls)
            if not futs:
                return
            wait(futs)

    def _queue_for(self, table_id: int) -> queue.Queue:
        if table_id not in self._queues:
            self._queues[table_id] = queue.Queue(maxsize=self.config.send_queue_size)
        return self._queues[table_id]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._main_loop, daemon=True,
                                        name="communicator-main")
        self._thread.start()

    def stop(self) -> None:
        """Stop the push thread, push what is queued, wait for the pull
        workers, and raise a failure of the push thread."""
        if not self._running:
            return
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
        if not self._push_thread_dead:
            self._drain_all()
        self._shutdown_pull_pool()
        if not self._push_thread_dead:
            self._drain_residuals()
        self.check_error()

    def _drain_residuals(self) -> None:
        """Push the client's error-feedback residuals (int8 push wire)."""
        drain = getattr(self.client, "drain_push_residuals", None)
        if drain is not None:
            drain()

    def _shutdown_pull_pool(self) -> None:
        self._drain_pulls()
        with self._pull_mu:
            pool, self._pull_pool = self._pull_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def check_error(self) -> None:
        """Raise a failure of the push thread: the error itself once, then,
        while gradients stay queued, that the thread is dead."""
        err, self._error = self._error, None
        if err is not None:
            raise err
        if self._push_thread_dead and self._unpushed > 0:
            raise PreconditionNotMetError(
                "communicator push thread died earlier; queued gradients remain "
                "undrained — restart the communicator")

    def quiesce(self) -> None:
        """Local traffic barrier: this trainer's queued sends and its
        error-feedback residuals have reached the PS and its pulls are done
        (no other trainer takes part): the checkpoint cut."""
        with self._unpushed_cv:
            self._unpushed_cv.wait_for(lambda: self._unpushed == 0 or self._push_thread_dead)
        self._drain_pulls()
        self._drain_residuals()
        self.check_error()

    def barrier(self) -> None:
        """Queued sends on the PS and no pull in flight (the HalfAsync
        join); raises a failure of the push thread."""
        self.quiesce()

    # -- background merge and push ------------------------------------------

    def _main_loop(self) -> None:
        while self._running:
            try:
                if not self._drain_once():
                    time.sleep(_IDLE_S)
            except BaseException as e:  # noqa: BLE001 — raised at barrier()/stop()
                self._error = e
                with self._unpushed_cv:
                    self._push_thread_dead = True   # nothing more will drain
                    self._unpushed_cv.notify_all()
                return

    def _drain_once(self) -> bool:
        did_work = False
        for table_id, q in list(self._queues.items()):
            sparse: List[Tuple[np.ndarray, np.ndarray]] = []
            dense: List[np.ndarray] = []
            for _ in range(self.config.max_merge_var_num):
                try:
                    kind, keys, values = q.get_nowait()
                except queue.Empty:
                    break
                if kind == "sparse":
                    sparse.append((keys, values))
                else:
                    dense.append(values)
            if sparse:
                self.client.push_sparse(table_id, np.concatenate([k for k, _ in sparse]),
                                        np.concatenate([v for _, v in sparse]))
                did_work = True
                self.merged_batches += len(sparse)
                self.pushes += 1
                self._landed(len(sparse))
            if dense:
                acc = np.sum(dense, axis=0)
                if self.config.is_sgd_optimizer:
                    acc = acc / len(dense)  # average on merge
                self.client.push_dense(table_id, acc)
                did_work = True
                self.merged_batches += len(dense)
                self.pushes += 1
                self._landed(len(dense))
        return did_work

    def _drain_all(self) -> None:
        while self._drain_once():
            pass


class AsyncCommunicator(_BaseCommunicator):
    """Free-running async push (a_sync=True mode)."""


class HalfAsyncCommunicator(_BaseCommunicator):
    """Async push; the trainer joins with ``barrier()`` (drain + wait)."""


class SyncCommunicator(_BaseCommunicator):
    """Inline push on send, no background staleness. A prefetched pull
    raises (it would miss the current batch's inline push); the stream
    trainer runs pull-ahead 0 here."""

    def pull_sparse_async(self, table_id, keys, create=True, slots=None):
        raise RuntimeError(
            "SyncCommunicator is strictly ordered: a prefetched pull would miss the current "
            "batch's inline push — pull through client.pull_sparse, or use Async/HalfAsync "
            "for pull-ahead")

    def start(self) -> None:  # no background thread
        self._running = True

    def stop(self) -> None:
        self._running = False
        self._drain_all()
        self._shutdown_pull_pool()
        self._drain_residuals()

    def send_sparse(self, table_id, keys, values):
        self.client.push_sparse(table_id, keys, values)
        self.merged_batches += 1
        self.pushes += 1

    def send_dense(self, table_id, grad):
        self.client.push_dense(table_id, grad)
        self.merged_batches += 1
        self.pushes += 1

    def barrier(self) -> None:
        self._drain_pulls()  # no pull may straddle the barrier
        self.client.barrier()


class GeoCommunicator(_BaseCommunicator):
    """GEO-SGD: the train loop applies its updates locally and records
    each key's delta against the last synced value; every ``geo_step``
    sends the deltas merge by mean per key and go to the PS
    (communicator.cc SendSparse :1208)."""

    def __init__(self, client: PSClient, geo_step: int = 100) -> None:
        super().__init__(client)
        self.geo_step = geo_step
        self._send_count = 0
        self._pending: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
        self._lock = threading.Lock()

    def send_sparse_delta(self, table_id: int, keys: np.ndarray, delta: np.ndarray) -> None:
        """``delta``: local minus last-synced rows of ``keys``."""
        with self._lock:
            self._pending.setdefault(table_id, []).append((keys, delta))
            self._send_count += 1
            ready = self._send_count % self.geo_step == 0
        if ready:
            self.flush_geo()

    def flush_geo(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
        for table_id, entries in pending.items():
            keys = np.concatenate([k for k, _ in entries])
            deltas = np.concatenate([d for _, d in entries])
            uniq, inverse = np.unique(keys, return_inverse=True)
            acc = np.zeros((len(uniq), deltas.shape[1]), np.float32)
            cnt = np.zeros(len(uniq), np.int64)
            np.add.at(acc, inverse, deltas)
            np.add.at(cnt, inverse, 1)
            acc /= np.maximum(cnt, 1)[:, None]
            self.client.push_geo(table_id, uniq, acc)
