"""PipelineFrontend: retrieval→ranking behind ONE deadline, the port's own
copy of ``paddle_tpu.serving.pipeline``.

The recsys serve path is two stages with very different shapes:

1. **retrieval**, the candidate fan-out: the request's candidate keys
   split into ``fanout`` affinity-routed sub-requests over the fleet
   (:class:`~.router.ServingRouter`: bounded-load consistent hashing keeps
   each candidate block on the member whose cached lookup holds it
   resident; hedges and reroutes inherit the measured remaining budget).
   The stage ends at the **early top-K cut**: once ``ceil(early_cut_frac
   × fanout)`` fans have answered, their candidates' scores (``emb ·
   user_vec``) rank the pool, the top-K advance, and the fans still out
   are abandoned and counted (``stragglers_abandoned``; one that answers
   after the cut is ``stragglers_late``).
2. **ranking**, micro-batches coalesced ACROSS requests: the top-K
   candidates and the user's history keys of many concurrent requests go
   through ONE :class:`~.lookup.CachedLookup` gather and ONE stacked
   ranker call (``models.make_gru4rec_ranker`` / ``make_dssm_ranker``),
   scattered back per request. ``stats()["coalesce_factor"]`` is the
   requests per ranking batch.

The ranker contract is numpy: ``ranker(hist_emb [B, H, d], lengths [B],
cand_emb [B, K, d]) → [B, K]``. The cached lookup returns host arrays, so
a ranking batch's rows come to the host and the ranker copies them to
its device (a copy each way a batch; measured by ``chip_smoke.py``).

**Budget carving**: the caller gives ONE deadline. Retrieval's
sub-requests carry ``retrieval_frac`` of the budget remaining at stage
entry; ranking inherits the absolute deadline and drops entries that
expired while coalescing (``rank_deadline_dropped``). Per-stage latencies
land in the ``serving_stage_latency_s{stage=retrieval|ranking}`` histogram
family, the end-to-end time in ``serving_latency_s{recorder=recsys_e2e}``.
"""

from __future__ import annotations

import dataclasses
import queue
# lock discipline (the JAX module's): `_mu` fences the pipeline counters and
# is a leaf; each request's `_RetrievalState.mu` fences that request's fan
# ledger only and is a leaf too (the cut's scoring, enqueue and delivery run
# outside it, on the completing frontend's worker thread)
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import sync as _sync
from ..core.enforce import enforce
from ..obs.registry import CounterGroup
from .frontend import (DeadlineExceeded, PendingResult, RequestRejected,
                       _Request)
from .metrics import LatencyRecorder

__all__ = ["PipelineConfig", "PipelineFrontend"]

_PIPE_SEQ = iter(range(1, 1 << 30))  # per-process pipeline tag


@dataclasses.dataclass
class PipelineConfig:
    #: per-request end-to-end budget when submit() doesn't pass one
    default_deadline_ms: float = 250.0
    #: retrieval's share of the budget REMAINING at stage entry — the
    #: sub-request deadline the fan-out carries into the fleet (the
    #: rest is the ranking stage's headroom)
    retrieval_frac: float = 0.6
    #: candidate sub-requests per request (each routed by its own
    #: block for CachedLookup affinity)
    fanout: int = 4
    #: keys per sub-request. UNIFORM fleet-wide: member frontends pin
    #: one keys-per-request count on first submit, so every router
    #: submission in the job must carry exactly this many keys
    fan_width: int = 8
    #: early top-K cut: finalize retrieval once ceil(frac × fanout)
    #: fans have answered; the rest are abandoned and metered
    early_cut_frac: float = 0.75
    #: candidates that advance to (and return from) ranking
    topk: int = 8
    #: ranking coalescer: max requests per stacked infer round
    rank_max_batch: int = 64
    #: coalesce window after the round's first entry arrives (µs)
    rank_max_delay_us: int = 2000
    #: ranking admission bound (load-shedding threshold — NEVER
    #: unbounded, the repo-wide queue discipline)
    queue_cap: int = 4096
    #: latency-recorder windows (bounded observability state)
    latency_window: int = 4096


class _RetrievalState:
    """One request's fan ledger: which fans answered, with what, and
    whether the early cut already fired."""

    __slots__ = ("req", "t0", "deadline_abs", "user_vec", "hist_keys",
                 "mu", "values", "done", "failed", "cut", "last_error",
                 "t_rank_enq")

    def __init__(self, req: _Request, t0: float, deadline_abs: float,
                 user_vec: np.ndarray, hist_keys: np.ndarray,
                 fanout: int) -> None:
        self.req = req
        self.t0 = t0
        self.deadline_abs = deadline_abs
        self.user_vec = user_vec
        self.hist_keys = hist_keys
        self.mu = _sync.Lock()
        #: per-fan (keys, rows) results, index = fan ordinal
        self.values: List[Optional[tuple]] = [None] * fanout
        self.done = 0
        self.failed = 0
        self.cut = False
        self.last_error: Optional[BaseException] = None
        self.t_rank_enq = 0.0


class PipelineFrontend:
    """``router``: the fleet :class:`~.router.ServingRouter` (members
    serve raw embedding rows — ``infer=None`` frontends). ``lookup``:
    the ranking-side embedding source (a :class:`~.lookup.CachedLookup`
    over the pipeline host's own read replica: its gather is the
    coalesced ranking pull). ``ranker``: optional
    ``ranker(hist_emb [B,H,d], lengths [B], cand_emb [B,K,d]) → [B,K]``
    (a stacked two-tower scorer, e.g.
    ``models.make_gru4rec_ranker``); None scores by masked-mean history
    dot candidate — the dependency-free default.

    ``submit(user_vec, history_keys, candidate_keys)`` returns a
    :class:`~.frontend.PendingResult` whose value is
    ``(keys [topk], scores [topk])``, best first."""

    def __init__(self, router, lookup, ranker: Optional[Callable] = None,
                 config: Optional[PipelineConfig] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 idle_pop_s: float = 0.02,
                 name: Optional[str] = None) -> None:
        self.router = router
        self.lookup = lookup
        self.ranker = ranker
        self.config = config or PipelineConfig()
        cfg = self.config
        enforce(cfg.fanout >= 1 and cfg.fan_width >= 1 and cfg.topk >= 1,
                "PipelineConfig fanout/fan_width/topk must be positive")
        enforce(0.0 < cfg.early_cut_frac <= 1.0,
                "early_cut_frac must be in (0, 1]")
        enforce(0.0 < cfg.retrieval_frac < 1.0,
                "retrieval_frac must leave ranking a budget share")
        self._clock = clock
        self.idle_pop_s = float(idle_pop_s)
        self.name = name if name is not None else f"pipe{next(_PIPE_SEQ)}"
        #: fans needed before the early cut may fire
        self._need = max(1, int(np.ceil(cfg.early_cut_frac * cfg.fanout)))
        #: uniform history length, pinned on first submit (the stacked
        #: ranker needs one [B, H] shape — same contract as the member
        #: frontends' keys-per-request pin)
        self._hist_len: Optional[int] = None
        self._mu = _sync.Lock()
        self.counters = CounterGroup(
            "serving_pipeline_events",
            ("accepted", "served", "errors", "shed", "early_cuts",
             "retrieval_deadline", "rank_deadline_dropped",
             "deadline_misses", "stragglers_abandoned", "stragglers_late",
             "fan_failures", "rank_batches", "coalesced"),
            max_series=256, pipeline=self.name)
        #: per-stage latency — the serving_stage_latency_s family the
        #: recsys_stage_retrieval_p99 rule triages on
        self.stage_retrieval = LatencyRecorder(
            cfg.latency_window, name="pipeline_stage",
            family="serving_stage_latency_s", stage="retrieval")
        self.stage_ranking = LatencyRecorder(
            cfg.latency_window, name="pipeline_stage",
            family="serving_stage_latency_s", stage="ranking")
        #: end-to-end (submit → ranked top-K delivered) — the
        #: recsys_e2e_p99 rule reads this series
        self.e2e_latency = LatencyRecorder(cfg.latency_window,
                                           name="recsys_e2e")
        self._q: "queue.Queue[_RetrievalState]" = _sync.Queue(
            maxsize=cfg.queue_cap)
        self._stopping = _sync.Event()
        self._thread = _sync.Thread(target=self._rank_loop, daemon=True,
                                        name=f"serving-pipeline:{self.name}")
        self._thread.start()

    # -- stage 1: retrieval fan-out ---------------------------------------

    def submit(self, user_vec, history_keys, candidate_keys,
               deadline_ms: Optional[float] = None) -> PendingResult:
        """Fan ``candidate_keys`` (``fanout × fan_width`` u64) over the
        fleet, early-cut to top-K, rank against ``history_keys`` (u64,
        uniform length) under ONE ``deadline_ms``."""
        cfg = self.config
        if self._stopping.is_set():
            raise RequestRejected("pipeline stopped")
        cand = np.ascontiguousarray(candidate_keys, np.uint64).reshape(-1)
        hist = np.ascontiguousarray(history_keys, np.uint64).reshape(-1)
        user_vec = np.ascontiguousarray(user_vec, np.float32).reshape(-1)
        enforce(len(cand) == cfg.fanout * cfg.fan_width,
                f"candidate_keys must be fanout×fan_width "
                f"= {cfg.fanout * cfg.fan_width} keys (got {len(cand)})")
        with self._mu:
            if self._hist_len is None:
                self._hist_len = len(hist)
        enforce(len(hist) == self._hist_len,
                f"every request must carry {self._hist_len} history keys "
                f"(got {len(hist)}) — one stacked ranker shape")
        t0 = self._clock()
        dl_ms = (deadline_ms if deadline_ms is not None
                 else cfg.default_deadline_ms)
        deadline_abs = t0 + dl_ms / 1e3
        req = _Request(None, None, deadline_abs)
        st = _RetrievalState(req, t0, deadline_abs, user_vec, hist,
                             cfg.fanout)
        with self._mu:
            self.counters["accepted"] += 1
        # budget carved from what REMAINS at stage entry: the fan-out's
        # sub-deadline is retrieval's share; hedges/reroutes inside the
        # router then inherit whatever of IT remains when they launch
        retr_ms = (deadline_abs - self._clock()) * 1e3 * cfg.retrieval_frac
        for g in range(cfg.fanout):
            keys_g = cand[g * cfg.fan_width:(g + 1) * cfg.fan_width]
            try:
                rr = self.router.submit(keys_g, deadline_ms=retr_ms)
            except BaseException as e:  # noqa: BLE001 — per-fan failure
                self._fan_settled(st, g, None, None, e)
                continue
            rr.add_done_callback(
                lambda rr, st=st, g=g, k=keys_g:
                self._fan_settled(st, g, k, rr.value, rr.error))
        return PendingResult(req)

    def _fan_settled(self, st: _RetrievalState, g: int, keys,
                     value, error: Optional[BaseException]) -> None:
        """One fan answered (or failed). Ledger under ``st.mu``; the
        cut itself — scoring, enqueue, delivery — outside it. Exactly
        one caller observes the cut transition and finalizes."""
        fire = False
        late = False
        with st.mu:
            if st.cut:
                late = error is None
            else:
                if error is not None:
                    st.failed += 1
                    st.last_error = error
                else:
                    st.values[g] = (keys, np.asarray(value))
                    st.done += 1
                if (st.done >= self._need
                        or st.done + st.failed >= self.config.fanout):
                    st.cut = True
                    fire = True
        if late:
            self._count("stragglers_late")
            return
        if error is not None:
            self._count("fan_failures")
        if fire:
            self._finalize_retrieval(st)

    def _finalize_retrieval(self, st: _RetrievalState) -> None:
        cfg = self.config
        now = self._clock()
        with st.mu:
            done, failed = st.done, st.failed
            vals = [v for v in st.values if v is not None]
        # fans still in flight at the cut are abandoned: their answers
        # (if any) arrive as stragglers_late; the router's sub-requests
        # run out their (remaining-budget) deadlines on their own
        abandoned = cfg.fanout - done - failed
        if abandoned > 0:
            self._count("stragglers_abandoned", abandoned)
        self.stage_retrieval.record(now - st.t0)
        if not vals:
            self._fail(st.req, st.last_error
                       or RequestRejected("every retrieval fan failed"))
            return
        self._count("early_cuts")
        keys = np.concatenate([k for k, _ in vals])
        emb = np.concatenate([v for _, v in vals])     # [n, 1+xd]
        enforce(emb.shape[1] == len(st.user_vec) + 1,
                f"user_vec dim {len(st.user_vec)} must match embedding "
                f"width {emb.shape[1]} - 1 (show column first)")
        scores = emb[:, 1:] @ st.user_vec
        order = np.argsort(-scores)[:cfg.topk]
        topk_keys = keys[order]
        if len(topk_keys) < cfg.topk:
            # degenerate fan loss: pad with the best key so the ranking
            # batch stays rectangular (duplicates rank identically)
            topk_keys = np.concatenate(
                [topk_keys, np.full(cfg.topk - len(topk_keys),
                                    topk_keys[0], np.uint64)])
        # stage hand-off: whatever budget remains belongs to ranking
        if st.deadline_abs - now <= 0:
            self._count("retrieval_deadline")
            self._fail(st.req, DeadlineExceeded(
                "budget spent in retrieval (fan-out slower than "
                "retrieval_frac × deadline)"))
            return
        st.t_rank_enq = now
        st.values = [(topk_keys, None)]   # carry only the top-K forward
        try:
            self._q.put_nowait(st)
        except queue.Full:
            with self._mu:
                self.counters["shed"] += 1
            self._fail(st.req, RequestRejected(
                f"ranking queue full ({cfg.queue_cap})"), count=False)

    # -- stage 2: cross-request ranking coalescer --------------------------

    def _rank_loop(self) -> None:
        cfg = self.config
        while True:
            try:
                first = self._q.get(timeout=self.idle_pop_s)
            except queue.Empty:
                if self._stopping.is_set():
                    return
                continue
            batch = [first]
            coalesce_until = (time.perf_counter()
                              + cfg.rank_max_delay_us / 1e6)
            while len(batch) < cfg.rank_max_batch:
                rem = coalesce_until - time.perf_counter()
                if rem <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=rem))
                except queue.Empty:
                    break
            self._rank(batch)

    def _rank(self, batch: List[_RetrievalState]) -> None:
        cfg = self.config
        now = self._clock()
        live: List[_RetrievalState] = []
        for st in batch:
            if st.deadline_abs <= now:
                # expired while coalescing: dropped before paying the
                # gather — the frontend's expired-while-queued rule
                self._count("rank_deadline_dropped")
                st.req.fail(DeadlineExceeded(
                    "deadline passed in the ranking queue"))
                continue
            live.append(st)
        if not live:
            return
        B, K, H = len(live), cfg.topk, self._hist_len or 0
        try:
            # ONE gather for every request's history + candidates
            flat = np.concatenate(
                [st.hist_keys for st in live]
                + [st.values[0][0] for st in live])
            rows = self.lookup.lookup(flat)
            d = rows.shape[1]
            hist_emb = rows[:B * H].reshape(B, H, d)
            cand_emb = rows[B * H:].reshape(B, K, d)
            if self.ranker is not None:
                lengths = np.full(B, H, np.int32)
                scores = np.asarray(self.ranker(hist_emb, lengths,
                                                cand_emb), np.float32)
            else:
                # dependency-free default: masked-mean history vector
                # dot each candidate (zero rows — missing keys — drop
                # out of the mean)
                w = (np.abs(hist_emb).sum(axis=2) > 0).astype(np.float32)
                denom = np.maximum(w.sum(axis=1), 1.0)[:, None]
                user = (hist_emb * w[:, :, None]).sum(axis=1) / denom
                scores = np.einsum("bd,bkd->bk", user, cand_emb)
            enforce(scores.shape == (B, K),
                    f"ranker must return [B, K] = {(B, K)} scores "
                    f"(got {scores.shape})")
        except BaseException as e:  # noqa: BLE001 — delivered per request
            self._count("errors", len(live))
            for st in live:
                st.req.fail(e)
            return
        t_done = self._clock()
        with self._mu:
            self.counters["rank_batches"] += 1
            self.counters["coalesced"] += B
            self.counters["served"] += B
        for i, st in enumerate(live):
            order = np.argsort(-scores[i])
            keys_i = st.values[0][0][order]
            if st.deadline_abs <= t_done:
                self._count("deadline_misses")
            self.stage_ranking.record(t_done - st.t_rank_enq)
            self.e2e_latency.record(t_done - st.t0)
            st.req.deliver((keys_i, scores[i][order]))

    # -- shared ------------------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._mu:
            self.counters[key] += n

    def _fail(self, req: _Request, err: BaseException,
              count: bool = True) -> None:
        if count:
            self._count("errors")
        req.fail(err)

    # -- observability / lifecycle ----------------------------------------

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    @property
    def stopped(self) -> bool:
        return self._stopping.is_set()

    def reset_stats(self) -> None:
        """Zero counters and latency windows (benches: steady state
        after priming). Call only while quiesced."""
        with self._mu:
            for k in self.counters:
                self.counters[k] = 0
        self.stage_retrieval.reset()
        self.stage_ranking.reset()
        self.e2e_latency.reset()

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            out: Dict[str, Any] = dict(self.counters)
        out["queue_depth"] = self._q.qsize()
        out["e2e_ms"] = self.e2e_latency.percentiles()
        out["stage_retrieval_ms"] = self.stage_retrieval.percentiles()
        out["stage_ranking_ms"] = self.stage_ranking.percentiles()
        if out["rank_batches"]:
            out["coalesce_factor"] = round(
                out["coalesced"] / out["rank_batches"], 3)
        return out

    def stop(self) -> None:
        """Stop accepting, fail whatever is still queued for ranking."""
        self._stopping.set()
        self._thread.join(timeout=10)
        while True:
            try:
                st = self._q.get_nowait()
            except queue.Empty:
                break
            st.req.fail(RequestRejected("pipeline stopped"))

    def __enter__(self) -> "PipelineFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
