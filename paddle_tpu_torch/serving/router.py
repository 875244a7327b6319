"""ServingRouter: tail-tolerant load balancing over a replica fleet.

The port's own copy of ``paddle_tpu.serving.router``; its ring and band
hashes (``_splitmix64``, ``_stable_str_hash``) are the JAX module's bit for
bit, so the same members and the same seeded ``rng`` give the same ring
and the same block owners in either package.

One replica's warm path lives or dies by CachedLookup residency, so the
balancer's FIRST job is affinity: requests hash by their **sparse
key-block** onto a consistent-hash ring (virtual nodes per member) with
the classic *bounded-load* refinement — a member already carrying more
than ``load_factor ×`` its fair share of in-flight requests is skipped
and the walk continues around the ring, so a hot block spills to the
next member instead of queueing behind itself. A random spray would
shred the per-member resident sets (every member ends up caching every
block at 1/N the hit rate); plain consistent hashing would let one hot
block brown out its member. Bounded-load CH is the standard middle.

Dense-only requests (no sparse keys — no affinity to protect) balance
by **power-of-two-choices** on an EWMA of admission-queue depth: two
random members, take the shallower queue. P2C's "2 random probes beat
d probes" property holds under stale load info, which queue-depth EWMA
is by construction.

Tail tolerance is two mechanisms with one scatter-back path:

- **hedging** — when a request has waited past its target member's
  measured p95 (per-member, windowed; clamped to
  ``[hedge_floor_ms, hedge_max_ms]``), a duplicate goes to the next
  ring choice. First completion wins; the loser is counted
  (``serving_hedges{outcome=...}``), never delivered — dedupe lives in
  the completion callback, not the caller.
- **failure reroute** — a sub-request that FAILS (member crashed,
  frontend stopped, admission shed) resubmits to the next choice with
  the remaining deadline, up to ``max_attempts`` members; the dead
  member is ejected from routing immediately (the fleet's lease watch
  re-admits it only while its TTL lease is live AND it reports
  healthy). A deadline that expired is final — rerouting a late
  request wastes fleet capacity on an answer nobody is waiting for.

Determinism under test: the only randomness (P2C probes, dense-request
canary banding) draws from a constructor-injected ``rng`` and every
time read goes through the injected ``clock``. The sparse path is fully
deterministic: same block, same membership, same loads ⇒ same member.

Canary routing (serving/rollout.py): ``set_canary`` pins a
deterministic percentage band of the block-hash space to the canary
member set; every routed request is counted per model version so a
split is *verified*, not assumed.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import random
# lock discipline (the JAX module's): `_mu` fences membership, ring, load
# and canary state and is a leaf (no submit, RPC or callback runs under
# it); the hedge timer's condition `_hcv` wraps its own lock and never
# nests inside `_mu`
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import sync as _sync
from ..core.enforce import enforce
from ..obs import registry as _obs_registry
from ..obs.registry import CounterGroup
from .frontend import DeadlineExceeded, PendingResult, RequestRejected
from .metrics import LatencyRecorder

__all__ = ["RouterConfig", "ServingRouter", "RoutedRequest"]

_ROUTER_SEQ = iter(range(1, 1 << 30))


def _splitmix64(x: int) -> int:
    """Scalar splitmix64 — the ring/band hash (python-int domain)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _stable_str_hash(s: str) -> int:
    """FNV-1a over the utf-8 bytes → splitmix64: the ring placement
    hash. Python's builtin ``hash(str)`` is PYTHONHASHSEED-salted per
    process — a ring built on it would route the same block to
    different members in different processes, breaking the module's
    replayability contract."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return _splitmix64(h)


_BAND_SALT = 0xC0FFEE  # canary band draws from a different hash stream
_BAND_SPACE = 1 << 20  # band resolution: fractions quantize to ~1e-6


@dataclasses.dataclass
class RouterConfig:
    #: virtual nodes per member on the consistent-hash ring (more =
    #: smoother block spread, slower rebuild; rebuilds are
    #: membership-change-rate cold)
    vnodes: int = 64
    #: bounded-load factor c: a member is skipped while its in-flight
    #: count exceeds ceil(c × mean in-flight) — 1.25 is the classic
    #: "consistent hashing with bounded loads" operating point
    load_factor: float = 1.25
    #: floor under the bound: at low concurrency ceil(c × mean) sits at
    #: 1-2 and ordinary arrival bursts constantly divert requests OFF
    #: their affinity member — each diversion is a resident-set miss on
    #: the receiving member (diversion thrash at a few requests in
    #: flight fleet-wide collapses warm throughput). The bound only needs
    #: to bite when a member is genuinely backed up.
    min_load_bound: int = 8
    #: sparse key-block granularity: requests whose keys share
    #: key >> block_shift route together (0 = every distinct first key
    #: is its own block)
    block_shift: int = 6
    #: hedge budget clamp + cold-start default (used until a member has
    #: hedge_min_samples latency observations to measure a p95 from)
    hedge_floor_ms: float = 2.0
    hedge_max_ms: float = 200.0
    hedge_default_ms: float = 25.0
    hedge_min_samples: int = 32
    #: hedging on/off (the timer thread still runs; maybe_hedge no-ops)
    hedge: bool = True
    #: total members tried per request (first choice + reroutes/hedges)
    max_attempts: int = 3
    #: minimum MEASURED remaining budget (ms) a hedge/reroute must have
    #: to launch, and the floor a sub-request's deadline header may
    #: carry. A late-life duplicate below this cannot possibly answer
    #: in time — launching it burns a member slot on a request whose
    #: caller has already given up (an EXPIRED request's sub-deadline is
    #: never floored at a fabricated budget, and expiry is checked
    #: against a fresh clock read, not a stale batch timestamp)
    min_sub_budget_ms: float = 1.0
    #: EWMA weight for the P2C queue-depth signal
    ewma_alpha: float = 0.3
    #: per-member latency window backing the p95 hedge budget
    latency_window: int = 2048


class _MemberState:
    """Router-side bookkeeping for one fleet member."""

    __slots__ = ("member", "inflight", "ewma_q", "latency", "_p95_ms",
                 "_p95_at")

    def __init__(self, member, window: int) -> None:
        self.member = member
        self.inflight = 0
        self.ewma_q = 0.0
        self.latency = LatencyRecorder(window, name="router_member",
                                       replica=member.endpoint)
        self._p95_ms = 0.0
        self._p95_at = 0

    @property
    def endpoint(self) -> str:
        return self.member.endpoint

    def budget_ms(self, cfg: RouterConfig) -> float:
        """Measured p95 hedge budget, recomputed every 32 samples (a
        quantile over the ring per submit would dominate the routing
        cost)."""
        n = self.latency.count
        if n < cfg.hedge_min_samples:
            return cfg.hedge_default_ms
        if n - self._p95_at >= 32 or self._p95_ms <= 0.0:
            self._p95_ms = self.latency.percentiles()["p95_ms"]
            self._p95_at = n
        return float(min(max(self._p95_ms, cfg.hedge_floor_ms),
                         cfg.hedge_max_ms))


class RoutedRequest:
    """Handle returned by :meth:`ServingRouter.submit` — one logical
    request fanned over up to ``max_attempts`` member sub-requests
    (reroutes and hedges). Exactly ONE completion is delivered."""

    __slots__ = ("router", "keys", "dense", "deadline_ms", "block",
                 "version", "t0", "event", "value", "error", "mu",
                 "tried", "hedged", "hedge_at", "claimed", "subs",
                 "sparse", "submitted", "outstanding", "last_error",
                 "cbs")

    def __init__(self, router: "ServingRouter", keys, dense,
                 deadline_ms: float, block: Optional[int],
                 version: str) -> None:
        self.router = router
        self.keys = keys
        self.dense = dense
        self.deadline_ms = float(deadline_ms)
        self.block = block
        self.sparse = block is not None
        self.version = version
        self.t0 = router._clock()
        self.event = _sync.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.mu = _sync.Lock()
        self.tried: List[str] = []
        self.hedged = False
        self.hedge_at: Optional[float] = None
        self.claimed = False
        self.subs: List[Tuple[str, PendingResult]] = []
        #: attempt ledger (guarded by mu): `submitted` caps TOTAL
        #: member submissions at max_attempts (reserved under mu before
        #: a reroute/hedge launches, so two concurrently-failing subs
        #: cannot both spend the last slot), `outstanding` counts subs
        #: in flight — a failure only finalizes the request when no
        #: sibling (hedge or reroute) is still out and may yet win
        self.submitted = 0
        self.outstanding = 0
        self.last_error: Optional[BaseException] = None
        #: completion callbacks (guarded by mu until fired) — the
        #: pipeline's scatter-back hook; fired once, outside mu, on the
        #: delivering frontend's worker thread
        self.cbs: List[Callable[["RoutedRequest"], None]] = []

    # -- caller surface ----------------------------------------------------

    def result(self, timeout: Optional[float] = None):
        enforce(self.event.wait(timeout),
                "routed request still pending at timeout")
        if self.error is not None:
            raise self.error
        return self.value

    def done(self) -> bool:
        return self.event.is_set()

    def add_done_callback(self, fn: Callable[["RoutedRequest"], None]
                          ) -> None:
        """Run ``fn(self)`` when the routed request completes (won OR
        errored); fires immediately if already done. Callbacks run on
        the completing frontend's worker thread — keep them cheap (the
        pipeline stage hand-off is the intended shape)."""
        with self.mu:
            if not self.event.is_set():
                self.cbs.append(fn)
                return
        fn(self)

    def _fire_callbacks(self) -> None:
        with self.mu:
            cbs, self.cbs = self.cbs, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — callback owns its errors
                pass

    def remaining_ms(self, now: Optional[float] = None) -> float:
        now = self.router._clock() if now is None else now
        return self.deadline_ms - (now - self.t0) * 1e3

    # -- hedge (timer thread / tests drive this) ---------------------------

    def maybe_hedge(self, now: Optional[float] = None) -> bool:
        """Launch the duplicate if the primary has out-waited its
        member's budget. Idempotent; returns True when a hedge was
        actually sent."""
        now = self.router._clock() if now is None else now
        with self.mu:
            if self.claimed or self.hedged or self.hedge_at is None \
                    or now < self.hedge_at \
                    or self.submitted >= self.router.config.max_attempts:
                return False
            self.hedged = True
            self.submitted += 1          # reserve the attempt slot
        # expiry check against a FRESH clock read, never the (possibly
        # stale) batch timestamp the hedge loop captured before firing
        # a whole batch of due hedges: with a stale `now` an already-
        # expired request would still hedge with a fabricated budget.
        # A hedge below min_sub_budget_ms cannot answer in time either.
        if self.remaining_ms() <= self.router.config.min_sub_budget_ms:
            with self.mu:
                self.submitted -= 1
                self.hedged = False     # aborted, not launched — a
            return False                # re-armed hedge may still fire
        state = self.router._pick(self, exclude=self.tried)
        if state is None:
            with self.mu:
                self.submitted -= 1
                self.hedged = False
            return False
        self.router._meter_hedge("launched")
        self.router._count("hedges")
        self.router._submit_to(self, state, hedge=True, reserved=True)
        return True

    # -- scatter-back ------------------------------------------------------

    def _on_sub_done(self, endpoint: str, pending: PendingResult) -> None:
        """Completion callback (frontend worker thread): dedupe, claim
        or reroute. Decisions under ``mu``; actions (resubmit, registry
        notes) outside it."""
        err = pending.exception()
        self.router._note_done(endpoint, ok=err is None)
        if err is None:
            with self.mu:
                self.outstanding -= 1
                if self.claimed:
                    late = True
                else:
                    self.claimed = True
                    self.value = pending.value()
                    late = False
            if late:
                # the hedge pair's loser: answered correctly, after the
                # winner — counted, never delivered twice
                self.router._meter_hedge("lost")
                self.router._count("hedge_lost")
                return
            dt = self.router._clock() - self.t0
            self.router._record_win(self, endpoint, dt)
            self.event.set()
            self._fire_callbacks()
            return
        # failure: reroute while a member, an attempt slot, and deadline
        # budget remain. DeadlineExceeded is final — the caller's budget
        # is spent and a reroute would burn capacity on an unread answer.
        final = isinstance(err, DeadlineExceeded)
        retry = False
        with self.mu:
            self.outstanding -= 1
            self.last_error = err
            if not self.claimed and not final \
                    and self.submitted < self.router.config.max_attempts \
                    and self.remaining_ms() \
                    > self.router.config.min_sub_budget_ms:
                retry = True
                self.submitted += 1      # reserve the attempt slot
        if retry:
            state = self.router._pick(self, exclude=self.tried)
            if state is not None:
                self.router._count("reroutes")
                self.router._submit_to(self, state, reserved=True)
                return
            with self.mu:
                self.submitted -= 1      # nobody to reroute to
        # finalize ONLY when no sibling sub-request is still in flight —
        # a hedge/reroute that is out may yet deliver a good answer (it
        # claims normally; this failure is then just its dedupe shadow)
        with self.mu:
            if self.claimed or self.outstanding > 0:
                return
            self.claimed = True
            self.error = self.last_error or err
        self.router._count("errors")
        self.event.set()
        self._fire_callbacks()


class ServingRouter:
    """See the module docstring. Members attach via :meth:`attach`
    (the :class:`~.fleet.ServingFleet` lease watcher is the intended
    caller); each must expose ``endpoint``, ``frontend`` (submit /
    queue_depth) and ``healthy``."""

    def __init__(self, config: Optional[RouterConfig] = None,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep,
                 hedge_poll_s: float = 0.001,
                 name: Optional[str] = None) -> None:
        self.config = config or RouterConfig()
        enforce(self.config.vnodes > 0 and self.config.max_attempts >= 1,
                "RouterConfig vnodes/max_attempts must be positive")
        #: injected randomness — the P2C probes and dense-request canary
        #: band are reproducible under a seeded Random
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        self._sleep = sleep
        self._hedge_poll_s = float(hedge_poll_s)
        self._mu = _sync.Lock()
        self._members: Dict[str, _MemberState] = {}
        self._ejected: set = set()
        self._ring: List[Tuple[int, str]] = []
        #: canary state: (band_fraction, frozenset(endpoints),
        #: canary_version, stable_version) or None
        self._canary: Optional[Tuple[float, frozenset, str, str]] = None
        #: requests actually routed, per model version tag — the
        #: "counted per version" half of the canary acceptance
        self.version_counts: Dict[str, int] = {}
        tag = name if name is not None else f"router{next(_ROUTER_SEQ)}"
        self.name = tag
        self.counters = CounterGroup(
            "serving_router_events",
            ("routed", "sparse_ch", "dense_p2c", "spilled", "hedges",
             "hedge_wins", "hedge_lost", "reroutes", "rejected", "errors"),
            max_series=256, router=tag)
        #: fleet-level end-to-end latency (submit → first win) — what a
        #: `fleet_serving_p99` SLO rule reads
        self.latency = LatencyRecorder(self.config.latency_window,
                                       name="router_request")
        self._g_size = _obs_registry.REGISTRY.gauge(
            "serving_fleet_size", router=tag)
        self._h_launched = _obs_registry.REGISTRY.counter(
            "serving_hedges", max_series=64, outcome="launched", router=tag)
        self._h_won = _obs_registry.REGISTRY.counter(
            "serving_hedges", max_series=64, outcome="won", router=tag)
        self._h_lost = _obs_registry.REGISTRY.counter(
            "serving_hedges", max_series=64, outcome="lost", router=tag)
        # hedge timer: a heap of (fire_t, request); fires maybe_hedge.
        # Condition-based so an earlier deadline pushed mid-wait wakes
        # the timer instead of sleeping past it.
        self._hcv = _sync.Condition()
        self._hheap: List[Tuple[float, int, RoutedRequest]] = []
        self._hseq = 0
        self._stop = _sync.Event()
        self._timer = _sync.Thread(target=self._hedge_loop, daemon=True,
                                       name=f"serving-router-hedge:{tag}")
        self._timer.start()

    # -- membership --------------------------------------------------------

    def attach(self, member) -> None:
        """Add (or re-add) a member to routing."""
        with self._mu:
            ep = member.endpoint
            if ep not in self._members:
                self._members[ep] = _MemberState(
                    member, self.config.latency_window)
            self._ejected.discard(ep)
            self._rebuild_ring_locked()

    def remove(self, endpoint: str) -> None:
        with self._mu:
            self._members.pop(endpoint, None)
            self._ejected.discard(endpoint)
            self._rebuild_ring_locked()

    def eject(self, endpoint: str) -> None:
        """Stop routing to a member WITHOUT forgetting it — the drain
        first half ("stop admitting") and the instant reaction to a
        failed sub-request. The fleet watcher re-admits (attach) when
        the lease is live and the member reports healthy, or removes it
        for good when the lease expires."""
        with self._mu:
            if endpoint in self._members:
                self._ejected.add(endpoint)
                self._rebuild_ring_locked()

    def inflight(self, endpoint: str) -> int:
        """Router-tracked in-flight sub-requests on one member (the
        fleet's drain predicate reads this next to frontend.idle())."""
        with self._mu:
            state = self._members.get(endpoint)
            return state.inflight if state is not None else 0

    def endpoints(self, live_only: bool = True) -> List[str]:
        with self._mu:
            if live_only:
                return sorted(set(self._members) - self._ejected)
            return sorted(self._members)

    def _rebuild_ring_locked(self) -> None:
        ring = []
        for ep in self._members:
            if ep in self._ejected:
                continue
            h = _stable_str_hash(ep)
            for v in range(self.config.vnodes):
                ring.append((_splitmix64(h ^ v), ep))
        ring.sort()
        self._ring = ring
        self._g_size.set(float(len(set(ep for _, ep in ring))))

    # -- canary band -------------------------------------------------------

    def set_canary(self, endpoints, fraction: float,
                   canary_version: str, stable_version: str) -> None:
        """Pin ``fraction`` of the block-hash space to ``endpoints``
        (the members holding ``canary_version``); everything else
        routes to the rest of the fleet (``stable_version``). Resets
        the per-version routed counts — a canary window's split starts
        from zero."""
        enforce(0.0 <= fraction <= 1.0, "canary fraction must be in [0,1]")
        with self._mu:
            self._canary = (float(fraction), frozenset(endpoints),
                            str(canary_version), str(stable_version))
            self.version_counts = {str(canary_version): 0,
                                   str(stable_version): 0}

    def clear_canary(self) -> None:
        with self._mu:
            self._canary = None

    def in_canary_band(self, block: int, fraction: Optional[float] = None
                       ) -> bool:
        """Deterministic band membership for a sparse key-block — the
        exactness contract: tests recompute the expected split with
        this same predicate."""
        if fraction is None:
            with self._mu:
                if self._canary is None:
                    return False
                fraction = self._canary[0]
        return (_splitmix64((int(block) ^ _BAND_SALT))
                % _BAND_SPACE) < int(fraction * _BAND_SPACE)

    # -- picking -----------------------------------------------------------

    @staticmethod
    def route_block(keys, block_shift: int,
                    route_key: Optional[int] = None) -> Optional[int]:
        """The request's affinity block: an explicit ``route_key``
        (user/session id — the recsys-correct choice) or the first
        sparse key's block. None for dense-only requests."""
        if route_key is not None:
            return int(route_key) >> block_shift
        if keys is None or len(keys) == 0:
            return None
        return int(keys[0]) >> block_shift

    def _candidates_locked(self, rr: RoutedRequest) -> List[str]:
        live = [ep for ep in self._members if ep not in self._ejected]
        if self._canary is None:
            return live
        fraction, canary_set, cv, sv = self._canary
        if rr.sparse:
            in_band = self.in_canary_band(rr.block, fraction)
        else:
            in_band = self._rng.random() < fraction
        want = [ep for ep in live if (ep in canary_set) == in_band]
        if want:
            rr.version = cv if in_band else sv
            return want
        # the wanted side is empty (canary members all dead/draining):
        # availability beats canary purity — spill to whatever is live
        self.counters["spilled"] += 1
        rr.version = sv if in_band else cv
        return live

    def _pick(self, rr: RoutedRequest,
              exclude: Optional[List[str]] = None) -> Optional[_MemberState]:
        """One routing decision (first choice, reroute, or hedge
        target). Sparse → bounded-load CH walk from the block's ring
        point; dense → P2C on queue-depth EWMA."""
        exclude = exclude or []
        with self._mu:
            cands = [ep for ep in self._candidates_locked(rr)
                     if ep not in exclude]
            if not cands:
                return None
            if rr.sparse:
                ep = self._pick_sparse_locked(rr.block, set(cands))
            else:
                ep = self._pick_dense_locked(cands)
            return self._members[ep]

    def _pick_sparse_locked(self, block: int, cands: set) -> str:
        total = sum(self._members[ep].inflight for ep in cands)
        # ceil(c × (total+1)/n): +1 counts the request being placed —
        # with an idle fleet every member's bound is ≥ 1; floored so a
        # near-idle fleet keeps affinity through arrival bursts
        bound = max(int(np.ceil(self.config.load_factor
                                * (total + 1) / max(len(cands), 1))),
                    self.config.min_load_bound)
        h = _splitmix64(int(block))
        i = bisect.bisect_left(self._ring, (h, ""))
        n = len(self._ring)
        seen = 0
        for off in range(n):
            _, ep = self._ring[(i + off) % n]
            if ep not in cands:
                continue
            if self._members[ep].inflight < bound:
                return ep
            seen += 1
            if seen >= len(cands) * 2:
                break
        # every candidate at the bound (burst): fall back to least
        # loaded — never refuse a pick the admission queue can absorb
        return min(cands, key=lambda e: (self._members[e].inflight, e))

    def _pick_dense_locked(self, cands: List[str]) -> str:
        if len(cands) == 1:
            return cands[0]
        a, b = self._rng.sample(cands, 2)
        sa, sb = self._members[a], self._members[b]
        alpha = self.config.ewma_alpha
        for s in (sa, sb):
            q = s.member.frontend.queue_depth + s.inflight
            s.ewma_q = (1 - alpha) * s.ewma_q + alpha * q
        return a if (sa.ewma_q, a) <= (sb.ewma_q, b) else b

    # -- submit ------------------------------------------------------------

    def submit(self, keys=None, dense=None,
               deadline_ms: Optional[float] = None,
               route_key: Optional[int] = None,
               affinity: bool = True) -> RoutedRequest:
        """Route one request into the fleet. ``keys``/``dense`` follow
        the frontend contract; ``route_key`` overrides the affinity
        block (hash a stable user/session id for real traffic);
        ``affinity=False`` forces the P2C path — the right call for
        requests whose keys carry no reuse (one-off backfills,
        dense-dominated traffic). ``keys=None`` normalizes to an empty
        key vector and routes P2C; note the stock ServingFrontend
        serves ≥1 key per request — a dense-only fleet supplies its
        own frontend/lookup that accepts zero-key requests (frontends
        pin a uniform keys-per-request count on first submit)."""
        if keys is None:
            keys = np.zeros(0, np.uint64)
        block = (self.route_block(keys, self.config.block_shift, route_key)
                 if affinity else None)
        if deadline_ms is None:
            deadline_ms = 1000.0
        rr = RoutedRequest(self, keys, dense, deadline_ms, block,
                           version="-")
        state = self._pick(rr)
        if state is None:
            self._count("rejected")
            raise RequestRejected("no live serving replicas")
        with self._mu:
            self.counters["routed"] += 1
            self.counters["sparse_ch" if rr.sparse else "dense_p2c"] += 1
            if rr.version in self.version_counts:
                self.version_counts[rr.version] += 1
        self._submit_to(rr, state)
        return rr

    def _submit_to(self, rr: RoutedRequest, state: _MemberState,
                   hedge: bool = False, reserved: bool = False) -> None:
        ep = state.endpoint
        with self._mu:
            state.inflight += 1
        with rr.mu:
            if not reserved:
                rr.submitted += 1
            rr.outstanding += 1
            rr.tried.append(ep)
        if self.config.hedge and not hedge:
            with rr.mu:
                rr.hedge_at = self._clock() + state.budget_ms(
                    self.config) / 1e3
            self._arm_hedge(rr)
        try:
            # the sub-request header carries the MEASURED remaining
            # budget — a hedge/reroute launched late in the request's
            # life inherits what is actually left, never the original
            # full deadline (and never a fabricated floor: an expired
            # request's sub-deadline goes out non-positive, so the
            # member drops it pre-lookup as DeadlineExceeded — final)
            pending = state.member.frontend.submit(
                rr.keys, dense=rr.dense,
                deadline_ms=rr.remaining_ms())
        except BaseException as e:  # noqa: BLE001 — rerouted like a fail
            # _sub_failed → _note_done balances the inflight increment
            self._sub_failed(rr, ep, e)
            return
        pending.add_done_callback(
            lambda rr=rr, ep=ep, p=pending: rr._on_sub_done(ep, p))

    def _sub_failed(self, rr: RoutedRequest, endpoint: str,
                    err: BaseException) -> None:
        """A submit that could not even enqueue (stopped frontend,
        crashed member): same reroute path as an async failure."""

        class _Failed:
            def exception(self_):  # noqa: N805
                return err

            def value(self_):  # noqa: N805
                return None
        rr._on_sub_done(endpoint, _Failed())

    # -- completion notes --------------------------------------------------

    def _note_done(self, endpoint: str, ok: bool) -> None:
        with self._mu:
            state = self._members.get(endpoint)
            if state is not None:
                state.inflight = max(state.inflight - 1, 0)
        if not ok and state is not None and not state.member.healthy:
            # the member itself says it is gone (crashed frontend /
            # stopped replica) — stop routing NOW; the lease watcher
            # owns permanent removal vs re-admission
            self.eject(endpoint)

    def _record_win(self, rr: RoutedRequest, endpoint: str,
                    dt_s: float) -> None:
        self.latency.record(dt_s)
        with self._mu:
            state = self._members.get(endpoint)
        if state is not None:
            state.latency.record(dt_s)
        if rr.hedged and rr.tried and endpoint != rr.tried[0]:
            self._count("hedge_wins")
            self._meter_hedge("won")

    def _count(self, key: str, n: int = 1) -> None:
        """CounterGroup increments are read-modify-write — serialize
        them under _mu (completion callbacks run on every member's
        frontend worker thread; unserialized increments lose counts
        and understate hedge/error rates the SLO rules read)."""
        with self._mu:
            self.counters[key] += n

    def _meter_hedge(self, outcome: str) -> None:
        {"launched": self._h_launched, "won": self._h_won,
         "lost": self._h_lost}[outcome].inc()

    # -- hedge timer -------------------------------------------------------

    def _arm_hedge(self, rr: RoutedRequest) -> None:
        with self._hcv:
            self._hseq += 1
            heapq.heappush(self._hheap, (rr.hedge_at, self._hseq, rr))
            # wake the timer only when this entry becomes the new HEAD:
            # a notify per submit turns the timer into a per-request
            # context switch on the hot path (wakeups that steal the GIL
            # from the serve workers)
            if self._hheap[0][2] is rr:
                self._hcv.notify()

    def _hedge_loop(self) -> None:
        while not self._stop.is_set():
            due: List[RoutedRequest] = []
            with self._hcv:
                now = self._clock()
                while self._hheap and (self._hheap[0][0] <= now
                                       or self._hheap[0][2].done()):
                    _, _, rr = heapq.heappop(self._hheap)
                    if not rr.done():
                        due.append(rr)
                if not due:
                    wait = 0.5
                    if self._hheap:
                        wait = min(max(self._hheap[0][0] - self._clock(),
                                       1e-3), 0.5)
                    self._hcv.wait(wait)
            # fire OUTSIDE the condition: maybe_hedge submits into a
            # frontend (queue put) — never under _hcv
            for rr in due:
                rr.maybe_hedge(now)

    # -- observability / lifecycle ----------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            out: Dict[str, Any] = dict(self.counters)
            out["members"] = {
                ep: {"inflight": s.inflight,
                     "ewma_q": round(s.ewma_q, 2),
                     "hedge_budget_ms": round(s.budget_ms(self.config), 3),
                     "ejected": ep in self._ejected}
                for ep, s in self._members.items()}
            out["version_counts"] = dict(self.version_counts)
            canary = self._canary
        out["request"] = self.latency.percentiles()
        if canary is not None:
            out["canary"] = {"fraction": canary[0],
                             "endpoints": sorted(canary[1]),
                             "canary_version": canary[2],
                             "stable_version": canary[3]}
        if out["routed"]:
            out["hedge_rate"] = round(out["hedges"] / out["routed"], 4)
        return out

    def stop(self) -> None:
        self._stop.set()
        with self._hcv:
            self._hcv.notify()
        self._timer.join(timeout=5)

    def __enter__(self) -> "ServingRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
