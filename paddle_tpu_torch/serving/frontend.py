"""ServingFrontend: micro-batched, deadline-aware, load-shedding serve
loop (the port's own copy of ``paddle_tpu.serving.frontend``).

Request flow: ``submit()`` enqueues into a BOUNDED admission queue
(full ⇒ :class:`RequestRejected` with a retry-after hint — the frontend
sheds instead of growing memory and latency without bound); the worker
thread coalesces up to ``max_batch`` requests or ``max_delay_us`` of
waiting — whichever comes first — into ONE embedding lookup + ONE
inference call, then scatters results.

Two priority classes share the frontend (the multi-tenant cloud's
serve-plane mirror of the PS-side admission classes): ``serve``
requests land in the primary queue and are always popped first;
``batch`` requests (offline scoring, backfills) land in a SEPARATE
bounded queue that only fills micro-batch slots serve traffic left
over, and is shed independently — a batch flood fills its own queue
and sheds batch, never a serve request, while serve overload sheds
serve without being widened by the batch backlog. Requests whose deadline expired
while queued are dropped before paying any lookup (their slot in the
batch goes to live traffic); a result that completes past its deadline
is still delivered but counted (``deadline_misses``) so the SLO monitor
sees it.

The lookup source is one of :mod:`~paddle_tpu_torch.serving.lookup`'s warm
paths over a :class:`~paddle_tpu_torch.serving.replica.ServingReplica`; both
perform ZERO training-PS RPCs, so a serving brown-out cannot back-
pressure the training cluster (and the serve-QoS transport class keeps
the reverse from wedging serve reads behind long training calls).
"""

from __future__ import annotations

import dataclasses
import queue
# lock discipline (the JAX module's): `_mu` fences the admission counters
# and the stopping flag and is a leaf; queue ops under it are the _nowait
# forms only, and result delivery and failure callbacks run with no lock held
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import sync as _sync
from ..core.enforce import enforce
from ..obs import flightrec as _flightrec
from ..obs.registry import CounterGroup
from .metrics import LatencyRecorder

_FRONTEND_SEQ = iter(range(1, 1 << 30))  # per-process frontend tag

__all__ = ["FrontendConfig", "ServingFrontend", "PendingResult",
           "RequestRejected", "DeadlineExceeded"]


@dataclasses.dataclass
class FrontendConfig:
    #: micro-batch cap: the worker serves at most this many requests in
    #: one lookup+infer round
    max_batch: int = 256
    #: coalesce window: after the first request of a round arrives, wait
    #: at most this long for more before serving (latency floor vs
    #: batching efficiency knob)
    max_delay_us: int = 1000
    #: admission-queue bound — the load-shedding threshold. Never
    #: unbounded: an overloaded frontend must reject fast, not queue
    #: requests it will serve seconds too late
    queue_cap: int = 1024
    #: per-request deadline when submit() doesn't pass one
    default_deadline_ms: float = 50.0
    #: retry-after FLOOR for shed requests. The quoted hint is derived
    #: from the measured queue drain rate (backlog ÷ requests-per-second
    #: the worker is actually clearing) so a backlogged frontend quotes
    #: a genuinely useful backoff — this floor is what an idle frontend
    #: (or one that has not served a batch yet) answers
    retry_after_ms: float = 20.0
    #: ceiling on the derived retry-after (a wedged worker must not
    #: quote minutes)
    retry_after_max_ms: float = 5000.0
    #: latency-recorder window (bounded observability state)
    latency_window: int = 4096


class RequestRejected(RuntimeError):
    """Admission control shed this request; retry after
    ``retry_after_ms`` (the 429-with-Retry-After of this transport)."""

    def __init__(self, msg: str, retry_after_ms: float = 0.0) -> None:
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it was still queued."""


class _Request:
    __slots__ = ("keys", "dense", "deadline", "t_submit", "event", "value",
                 "error", "cb_mu", "cbs")

    def __init__(self, keys, dense, deadline) -> None:
        self.keys = keys
        self.dense = dense
        self.deadline = deadline
        self.t_submit = time.perf_counter()
        self.event = _sync.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        # completion callbacks (the router's hedge/retry scatter-back
        # path) — registered under cb_mu so a callback added while the
        # worker delivers fires exactly once
        self.cb_mu = _sync.Lock()
        self.cbs: List[Callable] = []

    def _finish(self) -> None:
        self.event.set()
        with self.cb_mu:
            cbs, self.cbs = self.cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — callback owns its errors
                pass

    def deliver(self, value) -> None:
        self.value = value
        self._finish()

    def fail(self, err: BaseException) -> None:
        self.error = err
        self._finish()


class PendingResult:
    """Handle returned by :meth:`ServingFrontend.submit`."""

    def __init__(self, req: _Request) -> None:
        self._req = req

    def result(self, timeout: Optional[float] = None):
        enforce(self._req.event.wait(timeout),
                "serve request still pending at timeout")
        if self._req.error is not None:
            raise self._req.error
        return self._req.value

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block up to ``timeout``; True once the result (or error) is
        in. Unlike :meth:`result`, never raises — the router's hedge
        path probes completion without consuming it."""
        return self._req.event.wait(timeout)

    def exception(self) -> Optional[BaseException]:
        """The failure, if the request is done and failed (None while
        pending or on success) — the non-raising twin of result()."""
        return self._req.error if self._req.event.is_set() else None

    def value(self):
        """The delivered value (only meaningful once done() and
        exception() is None)."""
        return self._req.value

    def add_done_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn()`` when the request completes (delivered OR
        failed); fires immediately if already done. Callbacks run on
        the frontend worker thread — keep them cheap (the router's
        scatter-back bookkeeping is the intended shape)."""
        with self._req.cb_mu:
            if not self._req.event.is_set():
                self._req.cbs.append(fn)
                return
        fn()

    def done(self) -> bool:
        return self._req.event.is_set()


class ServingFrontend:
    """``lookup``: a :mod:`~paddle_tpu_torch.serving.lookup` source.
    ``infer``: optional ``infer(emb [B,S,d], dense [B,D]) -> [B]``
    (typically a model's forward); None serves raw embedding rows.
    Every request carries the same number of keys S (one sample); the
    worker stacks them to [B,S]."""

    def __init__(self, lookup, infer: Optional[Callable] = None,
                 config: Optional[FrontendConfig] = None,
                 idle_pop_s: float = 0.02,
                 replica_label: str = "-") -> None:
        self.lookup = lookup
        self.infer = infer
        self.config = config or FrontendConfig()
        #: per-replica identity on every obs family this frontend emits
        #: (serving_latency_s / serving_frontend_events) — the fleet
        #: router aggregates across these; cardinality stays bounded by
        #: the registry's max_series overflow rule
        self.replica_label = str(replica_label)
        #: worker's idle queue-pop timeout — bounds stop() latency and
        #: is constructor-injectable (the batching cadence itself lives in
        #: FrontendConfig)
        self.idle_pop_s = float(idle_pop_s)
        cfg = self.config
        enforce(cfg.max_batch > 0 and cfg.queue_cap > 0,
                "FrontendConfig max_batch/queue_cap must be positive")
        self._q: "queue.Queue[_Request]" = _sync.Queue(maxsize=cfg.queue_cap)
        # batch-class admission queue: same bound, popped only when the
        # serve queue is empty / has slack in the micro-batch. Separate
        # bounded queues (not one priority heap) keep the shed decision
        # per-class: a batch flood can only fill — and shed — batch
        self._bq: "queue.Queue[_Request]" = _sync.Queue(maxsize=cfg.queue_cap)
        self._keys_per_req: Optional[int] = None
        self._mu = _sync.Lock()
        # registry-backed (obs/registry.py CounterGroup): the dict
        # increments below are unchanged, the job-wide snapshot sees
        # the admission/shedding counters under serving_frontend_events
        self.counters: CounterGroup = CounterGroup(
            "serving_frontend_events",
            ("accepted", "served", "shed", "deadline_dropped",
             "deadline_misses", "batches", "errors",
             "accepted_batch", "shed_batch"),
            max_series=1024, frontend=str(next(_FRONTEND_SEQ)),
            replica=self.replica_label)
        #: end-to-end request latency (submit → result delivered)
        self.request_latency = LatencyRecorder(cfg.latency_window,
                                               name="frontend_request",
                                               replica=self.replica_label)
        #: lookup+infer time per micro-batch (the serving compute floor)
        self.serve_latency = LatencyRecorder(cfg.latency_window,
                                             name="frontend_serve",
                                             replica=self.replica_label)
        #: measured drain rate (requests the worker cleared per second,
        #: EWMA — guarded by _mu) feeding the shed retry-after hint
        self._drain_rate = 0.0
        self._last_batch_t: Optional[float] = None
        #: worker-is-serving flag: drain ("finish in-flight") waits for
        #: queue empty AND this clear (plain bool — single writer, the
        #: worker; readers tolerate one-batch staleness)
        self._busy = False
        self._stopping = _sync.Event()
        self._thread = _sync.Thread(target=self._loop, daemon=True,
                                        name="serving-frontend")
        self._thread.start()

    # -- admission ---------------------------------------------------------

    def submit(self, keys, dense=None,
               deadline_ms: Optional[float] = None,
               priority: str = "serve") -> PendingResult:
        cfg = self.config
        enforce(priority in ("serve", "batch"),
                f"priority must be 'serve' or 'batch' (got {priority!r})")
        if self._stopping.is_set():
            raise RequestRejected("frontend stopped")
        keys = np.ascontiguousarray(keys, np.uint64).reshape(-1)
        with self._mu:
            if self._keys_per_req is None:
                self._keys_per_req = len(keys)
        enforce(len(keys) == self._keys_per_req,
                f"every request must carry {self._keys_per_req} keys "
                f"(got {len(keys)}) — one sample per submit")
        dl_ms = (deadline_ms if deadline_ms is not None
                 else cfg.default_deadline_ms)
        req = _Request(keys,
                       None if dense is None
                       else np.ascontiguousarray(dense, np.float32),
                       time.perf_counter() + dl_ms / 1e3)
        q = self._q if priority == "serve" else self._bq
        acc = "accepted" if priority == "serve" else "accepted_batch"
        try:
            with self._mu:
                # stopping-check + put are atomic with stop()'s
                # set-under-lock: a put can never land AFTER stop()
                # drained the queue (which would strand the caller on a
                # result() that nobody will ever deliver)
                if self._stopping.is_set():
                    raise RequestRejected("frontend stopped")
                q.put_nowait(req)
                self.counters[acc] += 1
        except queue.Full:
            hint = self.retry_after_hint_ms()
            with self._mu:
                self.counters["shed" if priority == "serve"
                              else "shed_batch"] += 1
            raise RequestRejected(
                f"{priority} admission queue full ({cfg.queue_cap}) — "
                f"retry after {hint:.0f} ms",
                retry_after_ms=hint)
        return PendingResult(req)

    def retry_after_hint_ms(self) -> float:
        """Shed backoff derived from the measured queue drain rate:
        time to clear the CURRENT backlog at the rate the worker is
        actually serving, clamped to [retry_after_ms,
        retry_after_max_ms]. An idle frontend (or one that has not
        served a batch yet) quotes the floor — a backlogged one quotes
        how long the backlog genuinely takes to drain, so shed clients
        back off proportionally instead of hammering a constant."""
        cfg = self.config
        backlog = self._q.qsize() + self._bq.qsize()
        with self._mu:
            rate = self._drain_rate
        if rate <= 0.0 or backlog <= 0:
            return cfg.retry_after_ms
        return float(min(max(cfg.retry_after_ms, 1e3 * backlog / rate),
                         cfg.retry_after_max_ms))

    def __call__(self, keys, dense=None, deadline_ms=None,
                 timeout: float = 10.0, priority: str = "serve"):
        """Synchronous convenience: submit + wait."""
        return self.submit(keys, dense, deadline_ms,
                           priority=priority).result(timeout)

    # -- worker ------------------------------------------------------------

    def _loop(self) -> None:
        cfg = self.config
        while True:
            try:
                # batch work pending shortens the serve-pop timeout to a
                # sliver: serve still wins any race (it is checked
                # first), but an idle serve plane doesn't starve batch
                # for idle_pop_s per round
                first = self._q.get(timeout=(0.001 if self._bq.qsize()
                                             else self.idle_pop_s))
            except queue.Empty:
                try:
                    first = self._bq.get_nowait()
                except queue.Empty:
                    if self._stopping.is_set():
                        return
                    continue
            self._busy = True
            try:
                batch = [first]
                coalesce_until = time.perf_counter() + cfg.max_delay_us / 1e6
                while len(batch) < cfg.max_batch:
                    rem = coalesce_until - time.perf_counter()
                    if rem <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=rem))
                    except queue.Empty:
                        break
                # leftover micro-batch slots go to batch-class — no
                # waiting (batch has no latency target); serve traffic
                # filled first so a full serve round ships untouched
                while len(batch) < cfg.max_batch:
                    try:
                        batch.append(self._bq.get_nowait())
                    except queue.Empty:
                        break
                self._serve(batch)
                self._note_drained(len(batch))
            finally:
                self._busy = False

    def _note_drained(self, n: int) -> None:
        """EWMA the worker's clearing rate (requests/s) off the
        inter-batch cadence — dropped-deadline requests count too, they
        left the queue."""
        now = time.perf_counter()
        with self._mu:
            if self._last_batch_t is not None:
                dt = now - self._last_batch_t
                if dt > 0:
                    sample = n / dt
                    self._drain_rate = (sample if self._drain_rate == 0.0
                                        else 0.8 * self._drain_rate
                                        + 0.2 * sample)
            self._last_batch_t = now

    def _serve(self, batch: List[_Request]) -> None:
        now = time.perf_counter()
        live: List[_Request] = []
        for r in batch:
            if r.deadline <= now:
                # expired while queued: fail WITHOUT paying lookup —
                # the slot goes to requests that can still make it
                with self._mu:
                    self.counters["deadline_dropped"] += 1
                r.fail(DeadlineExceeded(
                    "deadline passed while queued (frontend overloaded "
                    "or deadline tighter than the coalesce window)"))
                continue
            live.append(r)
        if not live:
            return
        t0 = time.perf_counter()
        try:
            B, S = len(live), len(live[0].keys)
            flat = np.concatenate([r.keys for r in live])
            emb = self.lookup.lookup(flat)
            if self.infer is not None:
                dense = (np.stack([r.dense for r in live])
                         if live[0].dense is not None else None)
                out = np.asarray(self.infer(
                    emb.reshape(B, S, -1), dense))
            else:
                out = emb.reshape(B, S, -1)
        except BaseException as e:  # noqa: BLE001 — delivered per-request
            with self._mu:
                self.counters["errors"] += 1
            # a lookup/infer failure on the serve path is a flight-
            # recorder trigger: the bundle holds the spans and latency
            # curves of the requests that led here
            _flightrec.notify("serving_exception",
                              error=f"{type(e).__name__}: {e}",
                              batch=len(live))
            for r in live:
                r.fail(e)
            return
        t_done = time.perf_counter()
        self.serve_latency.record(t_done - t0)
        with self._mu:
            self.counters["batches"] += 1
            self.counters["served"] += len(live)
        for i, r in enumerate(live):
            if r.deadline <= t_done:
                with self._mu:
                    self.counters["deadline_misses"] += 1
            r.deliver(out[i])
            self.request_latency.record(t_done - r.t_submit)

    # -- observability / lifecycle ----------------------------------------

    def reset_stats(self) -> None:
        """Zero counters and latency windows (benches: measure steady
        state after a priming burst). Call only while quiesced — a
        reset racing live traffic just smears the first window."""
        with self._mu:
            for k in self.counters:
                self.counters[k] = 0
        self.request_latency.reset()
        self.serve_latency.reset()

    @property
    def queue_depth(self) -> int:
        """Live admission-queue depth, both classes (the router's P2C
        load signal)."""
        return self._q.qsize() + self._bq.qsize()

    @property
    def stopped(self) -> bool:
        return self._stopping.is_set()

    def idle(self) -> bool:
        """True when nothing is queued and the worker is between
        batches — the fleet's draining-restart predicate ("finish
        in-flight" is: stop admitting at the router, then wait for
        this)."""
        return (self._q.qsize() == 0 and self._bq.qsize() == 0
                and not self._busy)

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            out: Dict[str, Any] = dict(self.counters)
            out["drain_rate_rps"] = round(self._drain_rate, 1)
        out["queue_depth"] = self._q.qsize()
        out["retry_after_hint_ms"] = round(self.retry_after_hint_ms(), 1)
        out["request"] = self.request_latency.percentiles()
        out["serve_batch"] = self.serve_latency.percentiles()
        if out["batches"]:
            out["avg_batch"] = round(out["served"] / out["batches"], 2)
        return out

    def stop(self) -> None:
        """Stop accepting, serve nothing further, fail what's queued."""
        with self._mu:   # fences concurrent submit()s' check-and-put
            self._stopping.set()
        self._thread.join(timeout=10)
        for q in (self._q, self._bq):
            while True:
                try:
                    req = q.get_nowait()
                except queue.Empty:
                    break
                req.fail(RequestRejected("frontend stopped"))

    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
