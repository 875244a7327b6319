"""ServingFleet: one replica becomes a tier.

The port's own copy of ``paddle_tpu.serving.fleet``. The serving plane's
unit is a single :class:`~.replica.ServingReplica` behind one frontend;
this module runs N of them as ONE load-balanced unit behind a
:class:`~.router.ServingRouter`:

- **membership = the observer leases.** Every replica already holds a
  TTL'd lease under ``ps/<job>/obs/<shard>/<endpoint>`` — the
  exact crash-correct registry the primary's shipper uses. The fleet's
  lease watcher polls that prefix: lease present + member healthy ⇒
  routed; lease expired ⇒ the member crashed, remove it for good. No
  second membership protocol, no router-side heartbeats.
- **draining restarts.** ``drain(endpoint)`` ejects the member from
  routing (no NEW requests), waits for its admission queue and
  in-flight batches to finish, then detaches gracefully (lease
  released — the shipper drops it on the next poll). A restart is
  drain + join; requests never see it.
- **warm handoff.** A JOINING member's ``CachedLookup`` starts empty —
  cold-fetching its working set one request-miss at a time is exactly
  the storm the hot tier exists to avoid ("memory-efficient array
  redistribution": move state in bulk, not on demand). ``warm_from``
  replays a live PEER's resident-set manifest
  (:meth:`~paddle_tpu_torch.ps.hot_tier.HotEmbeddingTier.resident_keys`)
  through chunked bulk admits against the joiner's own feed-converged
  replica table, and stamps the rows fresh so the staleness predicate
  does not immediately re-drop them. The handoff is bounded-stale by
  construction: the joiner's replica finished its snapshot+tail
  catch-up BEFORE the admits, and the feed keeps running after — the
  manifest transfers *residency*, the oplog owns *values*.
- **elasticity: replica count as an autoscaler's lever.**
  :meth:`controller` returns a grow/shrink adapter in the shape of
  ``ps.autoscale.Autoscaler``'s lever, so the autoscaler grows and
  shrinks the fleet on its SLO rules.
"""

from __future__ import annotations

import dataclasses
# lock discipline (read by testing.sched.load_lock_order): `_mu` guards
# the member map and the join-order bookkeeping and is a leaf; member
# construction, warm handoff, router and rollout calls all run outside it
# LOCK LEAF: _mu
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core import sync as _sync
from ..core.enforce import enforce
from ..obs import registry as _obs_registry
from ..obs import trace as _obs_trace
from .lookup import CachedLookup

__all__ = ["FleetConfig", "FleetMember", "ServingFleet", "FleetController"]


class FleetMember:
    """One fleet slot: a serving replica + its warm lookup + frontend +
    live dense model. The pieces are built by the caller's factory
    (shapes, infer, tier sizing are workload decisions); this class
    owns their LIFECYCLE as a unit."""

    def __init__(self, replica, lookup, frontend, model=None,
                 extra_close: Optional[Callable] = None) -> None:
        self.replica = replica
        self.lookup = lookup
        self.frontend = frontend
        self.model = model
        self._extra_close = extra_close
        self.joined_t = _obs_trace.wall_s()

    @property
    def endpoint(self) -> str:
        return self.replica.endpoint

    @property
    def healthy(self) -> bool:
        return not self.frontend.stopped and not self.replica.server.stopped

    # -- warm handoff ------------------------------------------------------

    def resident_keys(self) -> np.ndarray:
        if isinstance(self.lookup, CachedLookup):
            return self.lookup.tier.resident_keys()
        return np.zeros(0, np.uint64)

    def warm_from(self, peer: "FleetMember", chunk: int = 4096
                  ) -> Dict[str, Any]:
        """Bulk-admit the peer's resident set (see module docstring).
        Returns {rows, chunks, seconds}."""
        enforce(isinstance(self.lookup, CachedLookup),
                "warm handoff needs a CachedLookup joiner")
        keys = peer.resident_keys()
        t0 = time.perf_counter()
        rows = 0
        for lo in range(0, len(keys), int(chunk)):
            rows += self.lookup.admit(keys[lo:lo + int(chunk)])
        return {"rows": int(rows),
                "chunks": int(np.ceil(len(keys) / max(chunk, 1))),
                "seconds": round(time.perf_counter() - t0, 4)}

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        """Graceful retirement (the drain's second half): frontend
        first (nothing new is routed here — the router ejected us), then
        the replica releases its lease and detaches."""
        self.frontend.stop()
        self.replica.close()
        if self._extra_close is not None:
            self._extra_close()

    def crash(self) -> None:
        """Chaos: die like a SIGKILL. Queued requests fail loudly (the
        router reroutes them), the lease expires by TTL — the fleet
        discovers the death the same way it would a real one."""
        self.frontend.stop()
        self.replica.kill()
        if self._extra_close is not None:
            self._extra_close()


@dataclasses.dataclass
class FleetConfig:
    #: lease-watch cadence (the discovery/heal tick)
    poll_s: float = 0.05
    #: bulk-admit chunk for warm handoff
    warm_chunk: int = 4096
    #: warm-handoff on join (off = cold join, the baseline a warm join is
    #: measured against)
    warm_handoff: bool = True
    #: drain: max wait for in-flight work to finish before detaching
    drain_timeout_s: float = 30.0
    #: autoscaler lever bounds (FleetController's grow and shrink clamp
    #: to them; recorded here so the knobs travel with the fleet)
    min_replicas: int = 1
    max_replicas: int = 8
    #: consecutive tick lease-misses before crash-removal. Removal is
    #: violent (router.remove + SIGKILL the member), so one stale
    #: list_prefix read — or a member whose heartbeat thread got starved
    #: for a beat on an oversubscribed host — must not execute a healthy
    #: member. Two misses poll_s apart means the lease stayed expired
    #: across a full re-read, the same double-confirmation the HA
    #: coordinator applies before declaring a primary dead.
    evict_misses: int = 2


class ServingFleet:
    """``member_factory()`` builds ONE ready member (replica subscribed
    and caught up, frontend live); the fleet owns membership, the
    router owns balancing, :class:`~.rollout.RolloutManager` (attach
    via ``fleet.rollout = mgr``) owns model versions."""

    def __init__(self, store, job_id: str,
                 member_factory: Callable[[], FleetMember],
                 router,
                 config: Optional[FleetConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.store = store
        self.job_id = str(job_id)
        self._factory = member_factory
        self.router = router
        self.config = config or FleetConfig()
        self._clock = clock
        self._sleep = sleep
        self._mu = _sync.Lock()
        self._members: Dict[str, FleetMember] = {}
        self._join_order: List[str] = []
        #: endpoints mid-drain: the watcher must NOT re-admit these
        #: (they are ejected on purpose — healthy, leased, and leaving)
        self._draining: set = set()
        #: per-endpoint consecutive lease-miss counts (tick-only state;
        #: guarded by _mu alongside _members)
        self._lease_misses: Dict[str, int] = {}
        self.rollout = None           # optional RolloutManager
        self.events: deque = deque(maxlen=512)
        self.counters = _obs_registry.CounterGroup(
            "serving_fleet_events",
            ("joins", "drains", "crashes_removed", "warm_rows",
             "heals", "ticks"),
            max_series=64, job=self.job_id)
        self._stop = _sync.Event()
        self._thread: Optional[threading.Thread] = None

    # -- membership --------------------------------------------------------

    def members(self, live_only: bool = True) -> List[FleetMember]:
        with self._mu:
            out = [self._members[ep] for ep in self._join_order
                   if ep in self._members]
        if live_only:
            out = [m for m in out if m.healthy]
        return out

    def member(self, endpoint: str) -> Optional[FleetMember]:
        with self._mu:
            return self._members.get(endpoint)

    def size(self) -> int:
        return len(self.members())

    def _leased_endpoints(self) -> set:
        """Endpoints with a live observer lease (any shard)."""
        out = set()
        for key in self.store.list_prefix(f"ps/{self.job_id}/obs/"):
            out.add(key.rsplit("/", 1)[-1])
        return out

    # -- join / drain ------------------------------------------------------

    def add(self, count: int = 1,
            warm: Optional[bool] = None) -> List[FleetMember]:
        """Build ``count`` members, warm-handoff each from the best
        live peer (largest resident set), and route them."""
        warm = self.config.warm_handoff if warm is None else bool(warm)
        joined: List[FleetMember] = []
        for _ in range(int(count)):
            member = self._factory()
            handoff = None
            peer = self._warm_peer()
            if warm and peer is not None \
                    and isinstance(member.lookup, CachedLookup):
                handoff = member.warm_from(peer,
                                           chunk=self.config.warm_chunk)
                self.counters["warm_rows"] += handoff["rows"]
            with self._mu:
                self._members[member.endpoint] = member
                self._join_order.append(member.endpoint)
                self.counters["joins"] += 1
            if self.rollout is not None:
                self.rollout.assert_assignments()
            self.router.attach(member)
            self._journal("join", endpoint=member.endpoint,
                          warm=handoff is not None, handoff=handoff)
            joined.append(member)
        return joined

    def _warm_peer(self) -> Optional[FleetMember]:
        best, best_occ = None, 0
        for m in self.members():
            if not isinstance(m.lookup, CachedLookup):
                continue
            occ = int(m.lookup.tier.stats()["occupancy"])
            if occ > best_occ:
                best, best_occ = m, occ
        return best

    def drain(self, endpoint: str,
              timeout_s: Optional[float] = None) -> bool:
        """Draining retirement: stop admitting → finish in-flight →
        graceful detach (lease released now). Returns True when the
        member went out clean; False = timeout (it is STILL detached —
        a member that cannot drain inside the budget is wedged, and
        holding the restart hostage to it helps nobody; its unfinished
        requests fail loudly and the router reroutes the retryable
        ones)."""
        member = self.member(endpoint)
        if member is None:
            return True
        budget = (self.config.drain_timeout_s if timeout_s is None
                  else float(timeout_s))
        with self._mu:
            # marked BEFORE the eject: a watcher tick between eject and
            # stop would otherwise see a healthy leased member missing
            # from routing and re-admit it mid-drain
            self._draining.add(endpoint)
        self.router.eject(endpoint)
        try:
            deadline = self._clock() + budget
            clean = True
            while not (member.frontend.idle()
                       and self.router.inflight(endpoint) == 0):
                if self._clock() >= deadline:
                    clean = False
                    break
                self._sleep(min(self.config.poll_s, 0.01))
            member.stop()
            with self._mu:
                self._members.pop(endpoint, None)
                self.counters["drains"] += 1
            self.router.remove(endpoint)
        finally:
            with self._mu:
                self._draining.discard(endpoint)
        self._journal("drain", endpoint=endpoint, clean=clean)
        return clean

    # -- the lease watch ---------------------------------------------------

    def tick(self) -> Dict[str, Any]:
        """One discovery/heal pass (the watcher thread loops this;
        public + deterministic for tests): expire members whose lease
        lapsed, re-admit healthy leased members the router ejected on a
        transient error, re-pin rollout assignments."""
        leased = self._leased_endpoints()
        with self._mu:
            known = list(self._members.items())
            draining = set(self._draining)
        removed, readmitted = [], []
        for ep, member in known:
            if ep in draining:
                continue     # leaving on purpose — drain() owns it
            if ep in leased:
                with self._mu:
                    # a hit resets the grace window — only CONSECUTIVE
                    # misses count toward eviction
                    self._lease_misses.pop(ep, None)
            if ep not in leased:
                # crash path: the lease expired — the same signal that
                # detaches it from the primary's shipper. Tolerate
                # evict_misses-1 transient misses (stale store read,
                # starved heartbeat) before the violent removal; a
                # member whose child PROCESS is verifiably gone skips
                # the grace — there is nothing left to spare.
                with self._mu:
                    misses = self._lease_misses.get(ep, 0) + 1
                    self._lease_misses[ep] = misses
                if misses < self.config.evict_misses and member.healthy:
                    continue
                self.router.remove(ep)
                with self._mu:
                    self._members.pop(ep, None)
                    self._lease_misses.pop(ep, None)
                    self.counters["crashes_removed"] += 1
                removed.append(ep)
                try:
                    member.crash()     # idempotent resource reap
                except Exception:  # noqa: BLE001 — already dead
                    pass
            elif member.healthy and ep not in self.router.endpoints():
                with self._mu:
                    # fast path: a drain() that started after this
                    # tick's snapshot has marked and ejected the member
                    # — re-admitting it would route fresh traffic onto
                    # a leaving member and stall its drain loop
                    if ep in self._draining or ep not in self._members:
                        continue
                self.router.attach(member)
                with self._mu:
                    # close the attach race: a drain can mark + eject
                    # BETWEEN the check above and the attach — re-eject
                    # here so every interleaving ends with the leaving
                    # member out of routing (drain's own eject covers
                    # the drain-marked-after-this-recheck ordering).
                    # The membership test matters too: a drain that runs
                    # to COMPLETION inside the attach window has already
                    # discarded its draining mark, and only the popped
                    # member betrays it (drain pops under _mu before it
                    # discards, so one of the two is always visible)
                    raced = (ep in self._draining
                             or ep not in self._members)
                if raced:
                    self.router.eject(ep)
                    continue
                readmitted.append(ep)
        healed = 0
        if self.rollout is not None:
            healed = self.rollout.assert_assignments()
            if healed:
                self.counters["heals"] += healed
        with self._mu:
            self.counters["ticks"] += 1
        if removed or readmitted:
            self._journal("tick", removed=removed, readmitted=readmitted,
                          healed=healed)
        return {"removed": removed, "readmitted": readmitted,
                "healed": healed}

    def start(self) -> "ServingFleet":
        if self._thread is None:
            self._stop.clear()
            self._thread = _sync.Thread(
                target=self._watch, daemon=True,
                name=f"serving-fleet:{self.job_id}")
            self._thread.start()
        return self

    def _watch(self) -> None:
        while not self._stop.wait(self.config.poll_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — one bad tick, not a dead watch
                pass

    def stop(self, stop_members: bool = True) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)
        if stop_members:
            for m in self.members(live_only=False):
                try:
                    m.stop()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            with self._mu:
                self._members.clear()

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- autoscaler lever --------------------------------------------------

    def controller(self) -> "FleetController":
        """The grow/shrink adapter an autoscaler drives, replica count
        as the lever (its journal namespace is ``ps/<job>/serving``)."""
        return FleetController(self)

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        members = {}
        for m in self.members(live_only=False):
            rec = {"healthy": m.healthy,
                   "replica": m.replica.status(),
                   "frontend": m.frontend.stats()}
            if isinstance(m.lookup, CachedLookup):
                rec["lookup"] = m.lookup.stats()
            if m.model is not None:
                v, dg = m.model.identity()
                rec["model"] = {"version": v, "digest": dg}
            members[m.endpoint] = rec
        with self._mu:
            counters = dict(self.counters)
        return {"size": self.size(), "counters": counters,
                "members": members}

    def _journal(self, kind: str, **kw) -> None:
        self.events.append({"kind": kind, "t": _obs_trace.wall_s(), **kw})


class _FleetLever:
    """Duck-typed `cluster` for an autoscaler: replica count is the
    shard count, the journal namespace is the serving sub-tree."""

    def __init__(self, fleet: ServingFleet) -> None:
        self._fleet = fleet
        self.store = fleet.store
        self.job_id = f"{fleet.job_id}/serving"

    @property
    def num_shards(self) -> int:
        return self._fleet.size()


class FleetController:
    """grow/shrink in the ReshardController shape: ``grow(factor)``
    multiplies the replica count, ``shrink(factor)`` divides it by
    draining the newest members first (the seasoned resident sets
    stay)."""

    def __init__(self, fleet: ServingFleet) -> None:
        self.fleet = fleet
        self.cluster = _FleetLever(fleet)

    def grow(self, factor: int) -> Dict[str, Any]:
        n = self.fleet.size()
        target = min(n * int(factor), self.fleet.config.max_replicas)
        enforce(target > n, f"fleet grow {n}→{target} is not a grow")
        t0 = time.perf_counter()
        joined = self.fleet.add(target - n)
        return {"joined": [m.endpoint for m in joined],
                "bootstrap_s": round(time.perf_counter() - t0, 3),
                "cutover_pause_ms": 0.0}

    def shrink(self, factor: int) -> Dict[str, Any]:
        n = self.fleet.size()
        target = max(n // int(factor), self.fleet.config.min_replicas)
        enforce(target < n, f"fleet shrink {n}→{target} is not a shrink")
        with self.fleet._mu:
            order = [ep for ep in self.fleet._join_order
                     if ep in self.fleet._members]
        victims = order[::-1][:n - target]
        t0 = time.perf_counter()
        drained = {ep: self.fleet.drain(ep) for ep in victims}
        return {"drained": drained,
                "bootstrap_s": round(time.perf_counter() - t0, 3),
                "cutover_pause_ms": 0.0}
