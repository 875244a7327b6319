"""PS high availability: shard replication, failure detection, failover.

The port's own copy of ``paddle_tpu.ps.ha``. Without it one dead PS shard
loses its slice of the feature table and kills the job; the transport's
retry and backoff (``FLAGS_pserver_*``) ride out transient faults only.

- **Replication**: each shard runs R replicas. The primary taps every
  mutating request frame into a sequence-numbered oplog ring (the C++
  service's ``log_op``); a :class:`ReplicationManager` shipper thread
  forwards each entry to the backups as a ``kReplicate`` frame (the lag is
  bounded by the ring), with a full snapshot (pause, catalog replay,
  kSaveAll into kInsertFull, dense snapshot, seq rebase, resume) for a
  late joiner or a ring overflow. With ``sync=True``,
  :meth:`ReplicationManager.drain` is a barrier after which primary ≡
  backup, checkable bitwise by ``kDigest``.
- **Failure detection**: every replica heartbeats a TTL'd
  :class:`~paddle_tpu_torch.distributed.elastic.Lease` into the elastic
  store (``MemoryStore`` or ``FileStore``); the client wraps each endpoint
  in a :class:`CircuitBreaker` (N consecutive transport failures open it,
  a cooldown half-opens it for one probe, a success closes it).
- **Failover**: a :class:`FailoverCoordinator` watches the leases. When a
  primary's lease has been gone past the grace window and a live backup
  exists, it bumps the routing epoch, fences the promoted server first
  (``kEpoch``: the demoted primary's replication stream now bounces with
  ``kErrStaleEpoch``), then publishes the epoch-stamped routing table.
  ``RpcPsClient._shard_op`` asks an :class:`HARouter` after a transport
  failure and replays the op on the promoted backup; the communicator's
  in-flight prefetched pulls ride the same path. A restarted server
  rejoins as a backup through catalog replay, snapshot and oplog tail.
- **Chaos**: every path is driven deterministically through
  ``ps.faultpoints`` (client sites ``rpc.call``, ``repl.ship``,
  ``ha.heartbeat``) and ``NativePsServer.arm_fault`` (server faults
  counted per command, fired before any state change).

Ordering caveat (as in the JAX package): the oplog records mutations in
the order the server's tap admits them, which with several client
connections can differ from the engines' apply order for racing
same-key pushes; the sync-mode bitwise guarantee assumes serialized
pushes (one trainer connection per server).

Live reshard (``ps.reshard``) rides the same machinery: a migration target
registers under the source shard's :func:`observer_key` with the value
``{"mode": "migrate"}``, and the source's shipper snapshots sparse rows
into it on a thread of its own (no dense state, no step top-up) and ships
the tail; ``HACluster.spawn_shard``/``retire_shard`` grow and shrink the
server rows, and a snapshot carries the primary's ownership predicate to a
backup. Read-only observers (serving replicas) attach by their TTL'd
registration under :func:`observer_key`, as in JAX.

Not ported (each raises ``UnavailableError`` naming its ROADMAP entry):
``HACluster.client(qos="serve")`` (Queue A item 3, entry 5) and
``HACluster.obs_probe`` (entry 6).
"""

from __future__ import annotations

import contextlib
import json
import random
import struct
# lock discipline (the JAX module's): every mutex here is a LEAF
# (breaker/router/shipper `_mu`, the coordinator's `_step_mu` and
# `_susp_mu`), taken for small in-memory state and never across a nested
# lock or a block. The cluster-wide `control_mu` (RLock) is the control
# plane's innermost non-leaf lock: reshard cutovers and checkpoint gates
# serialize under it, always through HACluster.begin_actuation/
# end_actuation, which pair it with coordinator suspension. Order:
# control_mu < _mu.
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import sync as _sync
from ..core.enforce import PreconditionNotMetError, PsTransportError, UnavailableError, enforce
from ..core.flags import define_flag, flag
from ..distributed.elastic import Lease, MemoryStore
from ..obs import flightrec as _flightrec
from ..obs import registry as _obs_registry
from . import rpc as _rpc
from .faultpoints import FaultInjected, arm_faultpoint, disarm_faultpoints, faultpoint
from .rpc import NativePsServer, RpcPsClient, make_conn, send_replicate

__all__ = [
    "CheckpointGate",
    "CircuitBreaker",
    "FailoverCoordinator",
    "FaultInjected",
    "HACluster",
    "HARouter",
    "HAServer",
    "MemoryStore",
    "ReplicationManager",
    "RoutingTable",
    "arm_faultpoint",
    "disarm_faultpoints",
    "drain_remote",
    "faultpoint",
    "observer_key",
]

define_flag("ps_replication_factor", 2,
            "replicas per PS shard (1 = replication off; ha.HACluster default topology)")
define_flag("ps_ha_oplog_cap", 1 << 16,
            "oplog ring entries a primary buffers per shard: the bounded replication lag; "
            "an overflow drops the oldest entry and the shipper resyncs by snapshot")
define_flag("ps_ha_heartbeat_ms", 200, "PS shard heartbeat refresh interval")
define_flag("ps_ha_lease_ttl_ms", 1000,
            "PS shard lease TTL: a dead shard is detectable after at most ttl + grace")
define_flag("ps_ha_failover_grace_ms", 300,
            "extra wait after a lease expires before promoting (rides out store blips)")
define_flag("ps_breaker_failures", 3,
            "consecutive transport failures before a client opens an endpoint's circuit "
            "breaker (fail fast instead of paying timeout*retries per call)")
define_flag("ps_breaker_cooldown_ms", 3000, "open-breaker cooldown before one half-open probe")
define_flag("ps_ha_failover_timeout_ms", 10000,
            "how long a failed client call waits for the coordinator to publish a "
            "promoted replacement before giving up")

# the request header: payload_len cmd table_id n aux trace_id span_id (44
# bytes packed, csrc ReqHeader)
_HDR = struct.Struct("<QIIqiQQ")

_ERR_STALE_EPOCH = -5  # ps_service.cc kErrStaleEpoch
_ERR_SEQ_GAP = -6      # kErrSeqGap


def _route_key(job_id: str) -> str:
    return f"ps/{job_id}/route"


def _hb_key(job_id: str, endpoint: str) -> str:
    return f"ps/{job_id}/hb/{endpoint}"


def _hb_prefix(job_id: str) -> str:
    return f"ps/{job_id}/hb/"


def _obs_prefix(job_id: str, shard: int) -> str:
    """Observer registrations of one shard: read-only oplog subscribers
    (serving replicas). They ship like backups (snapshot, tail, epoch
    fence) but live outside the routing document: the coordinator never
    promotes one, and their TTL'd leases decide attachment."""
    return f"ps/{job_id}/obs/{shard}/"


def observer_key(job_id: str, shard: int, endpoint: str) -> str:
    return _obs_prefix(job_id, shard) + endpoint


# -- client-side failure detection ------------------------------------------------


class CircuitBreaker:
    """Per-endpoint breaker: CLOSED → (N consecutive failures) → OPEN →
    (cooldown) → HALF_OPEN (one probe) → CLOSED on success, OPEN again on
    failure. ``clock`` is injectable for tests. Each opening counts in the
    ``ps_breaker_open`` counter (label ``endpoint=name``) and notifies the
    flight recorder."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failures: Optional[int] = None, cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic, name: str = "-") -> None:
        self.failures = failures if failures is not None else int(flag("ps_breaker_failures"))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else int(flag("ps_breaker_cooldown_ms")) / 1000.0)
        self._clock = clock
        self._mu = _sync.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self.name = str(name)
        self.opens = 0
        self._c_open = _obs_registry.REGISTRY.counter("ps_breaker_open", max_series=1024,
                                                      endpoint=self.name)

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def allow(self) -> bool:
        """May a call be attempted now? OPEN fails fast; after the cooldown
        exactly one caller gets the half-open probe."""
        with self._mu:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self._state = self.HALF_OPEN
                self._probing = True
                return True
            if self._probing:  # HALF_OPEN: only the probe is in flight
                return False
            self._probing = True
            return True

    def record(self, ok: bool) -> None:
        opened = False
        with self._mu:
            if ok:
                self._state = self.CLOSED
                self._consecutive = 0
                self._probing = False
                return
            self._consecutive += 1
            self._probing = False
            if self._state == self.HALF_OPEN or self._consecutive >= self.failures:
                opened = self._state != self.OPEN
                self._state = self.OPEN
                self._opened_at = self._clock()
                if opened:
                    self.opens += 1
        if opened:  # outside _mu: the notify may write a bundle
            self._c_open.inc()
            _flightrec.notify("breaker_open", endpoint=self.name,
                              consecutive_failures=self._consecutive)


class RoutingTable:
    """The epoch-stamped routing document in the elastic store:
    ``{"epoch": E, "shards": [{"primary": ep, "backups": [...],
    "replicas": [...]}, ...]}``. The coordinator is its only writer;
    epochs only move forward."""

    def __init__(self, store, job_id: str) -> None:
        self.store = store
        self.job_id = job_id
        self.key = _route_key(job_id)

    def publish(self, epoch: int, shards: List[dict]) -> None:
        self.store.put(self.key, json.dumps({"epoch": int(epoch), "shards": shards}))

    def read(self) -> Tuple[int, List[dict]]:
        raw = self.store.get(self.key)
        if raw is None:
            return 0, []
        doc = json.loads(raw)
        return int(doc.get("epoch", 0)), list(doc.get("shards", []))

    def primaries(self) -> List[str]:
        _, shards = self.read()
        return [sh["primary"] for sh in shards]


class HARouter:
    """The client's view of the HA control plane: resolves the routing
    table, breaker-gates endpoints, and answers ``failover()`` ("my call to
    this primary died; who replaced it?") by polling the store, with
    jittered backoff, until the coordinator publishes another primary for
    the shard or the failover timeout passes. Plugs into
    ``RpcPsClient(endpoints, router=...)``. ``clock``, ``sleep`` and
    ``jitter_seed`` are injectable so tests pin the schedule."""

    def __init__(self, store, job_id: str, failures: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 failover_timeout_s: Optional[float] = None, poll_s: float = 0.02,
                 qos: str = "train", clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 jitter_seed: Optional[int] = None) -> None:
        if qos != "train":
            raise UnavailableError(
                f"HARouter(qos={qos!r}): the serve QoS class is not ported yet (ROADMAP "
                "Queue A item 3, entry 5)")
        self.qos = qos
        self.routing_table = RoutingTable(store, job_id)
        self._clock = clock
        self._sleep = sleep
        self._jitter = random.Random(jitter_seed if jitter_seed is not None
                                     else id(self) & 0xFFFFFFFF)
        self._failures = failures
        self._cooldown_s = cooldown_s
        self.failover_timeout_s = (failover_timeout_s if failover_timeout_s is not None
                                   else int(flag("ps_ha_failover_timeout_ms")) / 1000.0)
        self.poll_s = poll_s
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._mu = _sync.Lock()

    def breaker(self, endpoint: str) -> CircuitBreaker:
        with self._mu:
            b = self._breakers.get(endpoint)
            if b is None:
                b = self._breakers[endpoint] = CircuitBreaker(self._failures,
                                                              self._cooldown_s,
                                                              name=endpoint)
            return b

    # -- the RpcPsClient protocol --------------------------------------------

    def routing(self) -> Tuple[int, List[str]]:
        epoch, shards = self.routing_table.read()
        return epoch, [sh["primary"] for sh in shards]

    def allow(self, endpoint: str) -> bool:
        return self.breaker(endpoint).allow()

    def record(self, endpoint: str, ok: bool) -> None:
        self.breaker(endpoint).record(ok)

    def failover(self, shard: int, bad_endpoint: str) -> Optional[str]:
        """Block until a primary other than ``bad_endpoint`` is published
        for ``shard``; None when the timeout passes with no promotion (the
        caller re-raises its transport error)."""
        return self.wait_for_primary(shard, bad_endpoint)

    def wait_for_primary(self, shard: int, bad_endpoint: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> Optional[str]:
        """Poll the routing table until it names a primary for ``shard``
        (other than ``bad_endpoint`` when given), with exponential backoff
        jittered per router, so clients that re-resolve at the same
        instant do not poll the shared store in lockstep."""
        deadline = self._clock() + (timeout_s if timeout_s is not None
                                    else self.failover_timeout_s)
        wait = self.poll_s
        while True:
            _, eps = self.routing()
            ep = eps[shard] if shard < len(eps) else None
            if ep and ep != bad_endpoint:
                return ep
            now = self._clock()
            if now >= deadline:
                return None
            # jittered backoff in [0.5, 1.5)·wait, clipped to the deadline
            self._sleep(min(wait * (0.5 + self._jitter.random()), max(deadline - now, 0.0)))
            wait = min(wait * 2, 0.25)


# -- replication (the primary's side) ---------------------------------------------


class ReplicationManager:
    """The primary's oplog shipper. One daemon thread pops entries from the
    server's ring (``oplog_next``) and forwards each to every attached
    backup (and read-only observer) as a ``kReplicate`` frame stamped with
    the routing epoch. Late joiners and ring overflows take the snapshot
    path (:meth:`_full_sync`); the tail then ships from the ring. A backup
    that answers ``kErrStaleEpoch`` means this primary is fenced (demoted):
    shipping stops and ``fenced`` is set."""

    _SNAP_CHUNK = 1 << 16  # rows per kInsertFull frame during a snapshot

    def __init__(self, server: NativePsServer, endpoint: str, shard: int,
                 routing: RoutingTable, sync: bool = False, oplog_cap: Optional[int] = None,
                 epoch: int = 0, route_poll_s: float = 0.1, pop_timeout_ms: int = 50,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.server = server
        self.endpoint = endpoint
        self.shard = shard
        self.routing = routing
        self.sync = sync
        self.epoch = int(epoch)
        self.fenced = False
        self._route_poll_s = float(route_poll_s)
        self._pop_timeout_ms = int(pop_timeout_ms)
        self._clock = clock
        self._cap = oplog_cap if oplog_cap is not None else int(flag("ps_ha_oplog_cap"))
        self._backups: Dict[str, dict] = {}  # ep -> {"conn", "acked"}
        self._mu = _sync.Lock()
        self._stop = _sync.Event()
        self._thread: Optional[threading.Thread] = None
        self._bg_syncs: List[threading.Thread] = []  # migrate snapshots in flight
        self._self_conn = None
        self._last_route_poll = 0.0
        # per-backup lag gauges bind at the first export (backups attach at
        # run time); the pending gauge is one per shard
        self._lag_gauges: Dict[str, object] = {}
        self._g_pending = _obs_registry.REGISTRY.gauge("ps_replication_pending_entries",
                                                       shard=str(shard))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicationManager":
        self.server.set_replication(True, self._cap)
        self._thread = _sync.Thread(target=self._loop, daemon=True, name=f"ps-repl:{self.shard}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        # a migrate snapshot still running would touch the server handle
        # after its owner frees it; the server's stop wakes its gate waits
        for t in self._bg_syncs:
            t.join(timeout=10)
        self._bg_syncs.clear()
        with self._mu:
            for st in self._backups.values():
                st["conn"].close()
            self._backups.clear()
        if self._self_conn is not None:
            self._self_conn.close()
            self._self_conn = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    # -- observability -----------------------------------------------------

    def lag(self) -> dict:
        seq = self.server.oplog_seq()
        with self._mu:
            acked = {ep: st["acked"] for ep, st in self._backups.items()}
        return {"seq": seq, "pending": self.server.oplog_pending(),
                "dropped": self.server.oplog_dropped(), "acked": acked}

    def export_metrics(self) -> None:
        """Publish each attached backup's acked-cursor gap as a
        ``ps_replication_lag_entries`` gauge (label ``backup``), and the
        ring's pending entries; a detached backup's gauge reads 0. Migrate
        subscribers (reshard targets) are left out: mid-copy their cursor
        trails by the whole history, and a replication-lag alert on it
        would ask for more shards in answer to the reshard itself."""
        with self._mu:
            migrate = {ep for ep, st in self._backups.items() if st.get("migrate")}
        lg = self.lag()
        lg["acked"] = {ep: a for ep, a in lg["acked"].items() if ep not in migrate}
        self._lag_gauges.update({
            ep: _obs_registry.REGISTRY.gauge("ps_replication_lag_entries", max_series=1024,
                                             shard=str(self.shard), backup=ep)
            for ep in lg["acked"] if ep not in self._lag_gauges})
        for ep, g in self._lag_gauges.items():
            g.set(max(0, lg["seq"] - lg["acked"][ep]) if ep in lg["acked"] else 0)
        self._g_pending.set(lg["pending"])

    def drain(self, timeout: float = 30.0) -> None:
        """Sync-replication barrier: block until every attached backup and
        observer has acked the newest oplog seq (primary ≡ backup for every
        op before the call). Migrate subscribers are left out: their copy
        may land on a server a checkpoint gate holds, and a drain that
        waited on them could deadlock against the gate that called it (the
        reshard cutover drains them itself)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._mu:
                acked = {ep: st["acked"] for ep, st in self._backups.items()
                         if not st.get("migrate")}
            seq = self.server.oplog_seq()
            if not self.fenced and self.server.oplog_pending() == 0 and \
                    all(a >= seq for a in acked.values()):
                return
            enforce(time.monotonic() < deadline,
                    f"replication drain timed out: seq {seq}, acked {acked}")
            time.sleep(0.005)

    # -- the shipper ---------------------------------------------------------

    def _poll_routing(self) -> None:
        now = self._clock()
        if now - self._last_route_poll < self._route_poll_s:
            return
        self._last_route_poll = now
        epoch, shards = self.routing.read()
        if not shards or self.shard >= len(shards):
            return
        self.epoch = max(self.epoch, epoch)
        sh = shards[self.shard]
        if sh["primary"] != self.endpoint:
            return  # demoted; the HAServer stops us
        want = [ep for ep in sh.get("backups", []) if ep != self.endpoint]
        # observers (TTL'd registrations outside the routing): a value of
        # {"mode": "migrate"} is a reshard target, which takes sparse rows
        # only (it is, or feeds, a live server with its own dense state)
        pref = _obs_prefix(self.routing.job_id, self.shard)
        migrate = set()
        for key, val in self.routing.store.list_prefix(pref).items():
            ep = key[len(pref):]
            if ep == self.endpoint or ep in want:
                continue
            want.append(ep)
            try:
                if val and json.loads(val).get("mode") == "migrate":
                    migrate.add(ep)
            except (ValueError, AttributeError):
                pass  # a value of another shape: a plain observer
        with self._mu:
            have = set(self._backups)
        for ep in want:
            if ep not in have:
                self._attach(ep, migrate=ep in migrate)
        for ep in have - set(want):
            self._drop_backup(ep)

    def _attach(self, ep: str, migrate: bool = False) -> None:
        """Adopt ``ep``: read its applied seq and epoch; the gap logic then
        chooses between the ring's tail and a full snapshot (always the
        snapshot for a migrate target)."""
        try:
            conn = make_conn(ep)
            _, resp = conn.check(_rpc._REPL_STATE, n=-1, retries=0)
            st = np.frombuffer(resp, np.int64)
            applied, remote_epoch = int(st[0]), int(st[1])
        except PreconditionNotMetError:
            return  # not reachable yet; the next routing poll retries
        if remote_epoch > self.epoch:
            # the "backup" outranks us: we are a demoted primary on a stale
            # routing read; fence now
            conn.close()
            self.fenced = True
            return
        if remote_epoch < self.epoch:
            # fence the subscriber up to our epoch before the first ship:
            # the coordinator fences only the promoted server, and a
            # surviving backup would otherwise still take a demoted
            # primary's stream
            try:
                conn.check(_rpc._EPOCH, n=self.epoch, retries=0)
            except PreconditionNotMetError:
                conn.close()
                return
        if applied > self.server.oplog_seq():
            # a cursor numbered by another primary's oplog (a promotion
            # chain): comparing it with our seqs would skip every ship, so
            # take the snapshot path, which rebases it
            applied = -1
        if migrate:
            # a reshard target never takes the ring's tail from birth: the
            # ring holds frames that are poison out of context (our own
            # bootstrap's kInsertFull of stale rows, past kRetain frames
            # that would erase the target's classes); the snapshot copies
            # current rows and rebases the cursor past all of it
            applied = -1
        with self._mu:
            self._backups[ep] = {"conn": conn, "acked": applied, "migrate": migrate}

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._poll_routing()
            if self.fenced:
                return
            seq, frame = self.server.oplog_next(timeout_ms=self._pop_timeout_ms)
            if seq == -2:
                return  # the server stopped
            if seq == -1:
                # idle: a backup that attached after its entries were popped
                # would otherwise wait for the next mutation forever
                self._catch_up_idle()
                continue
            self._ship(seq, frame)

    def _catch_up_idle(self) -> None:
        if self.server.oplog_pending() != 0:
            return  # the ring's tail covers the lag
        top = self.server.oplog_seq()
        with self._mu:
            lagging = [(ep, st) for ep, st in self._backups.items() if st["acked"] < top]
        for ep, st in lagging:
            self._snapshot(ep, st)

    def _snapshot(self, ep: str, st: dict) -> None:
        """Snapshot one subscriber: inline for a backup, on a thread of its
        own for a migrate target; nothing while that thread runs."""
        if st.get("syncing"):
            return
        if st.get("migrate"):
            self._sync_migrate_bg(ep, st)
        else:
            self._full_sync(ep, st)

    def _sync_migrate_bg(self, ep: str, st: dict) -> None:
        """A migrate target's snapshot on its own thread. The shipper must
        not block behind it: the target is a live routed server whose
        mutation gate a checkpoint capture may hold, and a shipper stuck
        there starves the shard's backups, whose drain that capture waits
        on. While ``syncing`` the shipper skips this cursor; the rebase
        covers what lands meanwhile."""
        st["syncing"] = True

        def run():
            try:
                with self._mu:
                    if self._backups.get(ep) is not st:
                        return  # detached while queued
                if not self._stop.is_set():
                    self._full_sync(ep, st)
            finally:
                st["syncing"] = False

        t = _sync.Thread(target=run, daemon=True, name=f"ps-migrate:{self.shard}->{ep}")
        self._bg_syncs = [x for x in self._bg_syncs if x.is_alive()]
        self._bg_syncs.append(t)
        t.start()

    def _ship(self, seq: int, frame: bytes) -> None:
        with self._mu:
            backups = list(self._backups.items())
        for ep, st in backups:
            if st.get("syncing"):
                continue  # a migrate snapshot owns this cursor
            if st["acked"] >= seq:
                continue  # a snapshot rebase already covers this entry
            if st["acked"] + 1 != seq:
                # the ring dropped entries before this backup consumed them
                # (overflow or a late attach): snapshot, which makes this
                # frame redundant
                self._snapshot(ep, st)
                continue
            try:
                status = send_replicate(st["conn"], frame, seq, self.epoch, retries=0)
            except PsTransportError:
                self._drop_backup(ep)  # a dead backup; its rejoin re-attaches
                continue
            if status == seq:
                st["acked"] = seq
            elif status == _ERR_SEQ_GAP:
                self._snapshot(ep, st)
            elif status == _ERR_STALE_EPOCH:
                self.fenced = True  # the backup outranks us
                return
            else:
                self._drop_backup(ep)

    def _drop_backup(self, ep: str) -> None:
        with self._mu:
            st = self._backups.pop(ep, None)
        if st is not None:
            st["conn"].close()

    # -- the snapshot ----------------------------------------------------------

    def _catalog_tables(self) -> Tuple[List[int], List[int]]:
        sparse, dense = [], []
        for frame in self.server.catalog():
            _, cmd, tid, _, _, _, _ = _HDR.unpack_from(frame, 0)
            if cmd == _rpc._CREATE_SPARSE and tid not in sparse:
                sparse.append(tid)
            elif cmd == _rpc._CREATE_DENSE and tid not in dense:
                dense.append(tid)
        return sparse, dense

    def _self(self):
        """A connection to this primary itself, made lazily: the TCP
        connect happens outside ``_mu`` and the loser of a racing pair
        closes its stray."""
        with self._mu:
            conn = self._self_conn
        if conn is not None:
            return conn
        conn = make_conn(self.endpoint)
        with self._mu:
            if self._self_conn is None:
                self._self_conn = conn
                return conn
            stray, conn = conn, self._self_conn
        stray.close()
        return conn

    def _full_sync(self, ep: str, st: dict) -> None:
        """Snapshot and rebase one backup. Mutations pause throughout
        (writers block within their IO deadline), so the cut is consistent
        and the tail replays exactly once. Covers sparse tables (full rows),
        dense tables (values, optimizer moments, step) and the global step;
        GEO accumulators are not snapshotted (reading them drains them, and
        losing at most one un-pulled delta round on a rejoin is within
        GEO-SGD's staleness; live geo pushes do replicate). A backup also
        gets the primary's ownership predicate; a migrate target gets the
        sparse rows only (the reshard installs its predicate at the
        cutover)."""
        conn = st["conn"]
        self.server.pause_mutations(True)
        try:
            # 1. catalog replay (idempotent creates, seq -1: untracked)
            for frame in self.server.catalog():
                status = send_replicate(conn, frame, -1, self.epoch, retries=0)
                if status == _ERR_STALE_EPOCH:
                    self.fenced = True
                    return
                enforce(status >= 0, f"catalog replay to {ep} failed with {status}")
            # the ownership predicate is replicated state too: a backup
            # attached after a reshard must bounce stale-topology traffic
            # once promoted. Shipped replicate-wrapped at seq -1, like the
            # catalog, so a read-only observer takes it as well
            if not st.get("migrate"):
                _, own_resp = self._self().check(_rpc._RETAIN, n=0, retries=0)
                own = np.frombuffer(own_resp, np.int64)
                if int(own[0]) > 0:
                    frame = _HDR.pack(0, _rpc._RETAIN, 0, int(own[0]), int(own[1]), 0, 0)
                    status = send_replicate(conn, frame, -1, self.epoch, retries=0)
                    if status == _ERR_STALE_EPOCH:
                        self.fenced = True
                        return
                    enforce(status >= 0, f"ownership replay to {ep} failed with {status}")
            cut = self.server.oplog_seq()
            sparse, dense = self._catalog_tables()
            me = self._self()
            # 2. sparse tables: a full snapshot of ourselves, chunked into the
            # backup (row for row; a fresh backup ends bit-identical)
            for tid in sparse:
                cnt, resp = me.check(_rpc._SAVE_ALL, tid, aux=0, timeout_ms=_rpc._long_ms(),
                                     retries=0)
                if not cnt:
                    continue
                keys = np.frombuffer(resp[:cnt * 8], np.uint64)
                fdim = (len(resp) - cnt * 8) // 4 // cnt
                vals = np.frombuffer(resp[cnt * 8:], np.float32).reshape(cnt, fdim)
                for lo in range(0, cnt, self._SNAP_CHUNK):
                    kp = np.ascontiguousarray(keys[lo:lo + self._SNAP_CHUNK])
                    vp = np.ascontiguousarray(vals[lo:lo + self._SNAP_CHUNK])
                    # replicate-wrapped at seq -1: the ownership fence does
                    # not filter it, and a migrate target's fence may not
                    # cover these keys yet (a shrink's survivor owns the
                    # retiree's class only from the cutover on)
                    frame = _HDR.pack(kp.nbytes + vp.nbytes, _rpc._INSERT_FULL, tid, len(kp),
                                      0, 0, 0) + kp.tobytes() + vp.tobytes()
                    status = send_replicate(conn, frame, -1, self.epoch, retries=0)
                    if status == _ERR_STALE_EPOCH:
                        self.fenced = True
                        return
                    enforce(status >= 0, f"snapshot rows to {ep} failed with {status}")
            # 3. dense tables, with their optimizer state and step, and 4. the
            # shared step counter (a delta: the backup starts lower). Not for
            # a migrate target: a live server with its own dense state and
            # step, which may out-count us
            if not st.get("migrate"):
                for tid in dense:
                    _, blob = me.check(_rpc._DENSE_SNAP, tid, timeout_ms=_rpc._long_ms(),
                                       retries=0)
                    conn.check(_rpc._DENSE_RESTORE, tid, payload=bytes(blob),
                               timeout_ms=_rpc._long_ms(), retries=0)
                cur_p, _ = me.check(_rpc._GLOBAL_STEP, n=0, retries=0)
                cur_b, _ = conn.check(_rpc._GLOBAL_STEP, n=0, retries=0)
                if cur_p != cur_b:
                    conn.check(_rpc._GLOBAL_STEP, n=cur_p - cur_b, retries=0)
            # 5. rebase: the backup now holds everything up to `cut`
            conn.check(_rpc._REPL_STATE, n=cut, retries=0)
            st["acked"] = cut
        except PreconditionNotMetError:
            self._drop_backup(ep)
        finally:
            self.server.pause_mutations(False)


def drain_remote(primary_ep: str, backup_eps: List[str], timeout: float = 30.0) -> None:
    """Cross-process sync-replication barrier over the wire (no shared
    store, no in-process handles): poll kReplState until every backup's
    applied seq has caught the primary's oplog seq and the primary's ring
    is empty; the analogue of :meth:`ReplicationManager.drain`."""
    conns = {ep: make_conn(ep) for ep in [primary_ep] + list(backup_eps)}

    def state(ep):
        _, resp = conns[ep].check(_rpc._REPL_STATE, n=-1, retries=0)
        st = np.frombuffer(resp, np.int64)
        return int(st[0]), int(st[2]), int(st[3])  # applied, oplog seq, pending

    try:
        deadline = time.monotonic() + timeout
        while True:
            _, oseq, pending = state(primary_ep)
            if pending == 0 and all(state(ep)[0] >= oseq for ep in backup_eps):
                return
            enforce(time.monotonic() < deadline,
                    f"drain_remote({primary_ep}) timed out at seq {oseq}")
            time.sleep(0.005)
    finally:
        for c in conns.values():
            c.close()


# -- the consistent cut of a job checkpoint ----------------------------------------


class CheckpointGate:
    """Mutation gate for a consistent job snapshot
    (``io.job_checkpoint.JobCheckpointManager``): on entry every shard
    primary pauses mutations (``NativePsServer.pause_mutations``: writers
    block within their IO deadline, the pause nests with a rejoin's own),
    and for a ``sync`` cluster replication drains first, so the cut is
    also primary ≡ backup. Reads (kSaveAll, kDigest, kDenseSnap, the
    global step's n=0) go on: the capture streams them off the paused
    primaries. Exit resumes mutations even when the capture raised.

    Construct from an :class:`HACluster` (``cluster.checkpoint_gate()``:
    the routed primaries, under the cluster's actuation section, so no
    promotion lands mid-capture) or from a list of in-process
    ``NativePsServer`` handles (a plain deployment)."""

    def __init__(self, cluster: Optional["HACluster"] = None, servers: Optional[list] = None,
                 drain: bool = True, drain_timeout: float = 30.0) -> None:
        enforce((cluster is None) != (servers is None),
                "CheckpointGate needs exactly one of cluster= / servers=")
        self.cluster = cluster
        self.servers = list(servers) if servers is not None else None
        self.drain = drain
        self.drain_timeout = drain_timeout
        self._paused: list = []
        self._in_actuation = False

    def _targets(self) -> list:
        if self.servers is not None:
            return self.servers
        _, shards = self.cluster.routing.read()
        return [self.cluster.primary(si).server for si in range(len(shards))]

    def __enter__(self) -> "CheckpointGate":
        if self.cluster is not None:
            # suspend failover scans, then control_mu: a promotion landing
            # mid-capture would route the shard onto an unpaused backup
            self.cluster.begin_actuation()
            self._in_actuation = True
        paused = []
        try:
            for srv in self._targets():
                srv.pause_mutations(True)
                paused.append(srv)
            if self.drain and self.cluster is not None and self.cluster.sync:
                # kReplicate applies on the backups, which the gate does not
                # pause: after the drain they hold exactly the cut
                self.cluster.drain(self.drain_timeout)
        except BaseException:
            for srv in reversed(paused):
                srv.pause_mutations(False)
            self._end_actuation()
            raise
        self._paused = paused
        return self

    def _end_actuation(self) -> None:
        if self._in_actuation:
            self._in_actuation = False
            self.cluster.end_actuation()

    def __exit__(self, *exc) -> None:
        paused, self._paused = self._paused, []
        for srv in reversed(paused):
            srv.pause_mutations(False)
        self._end_actuation()


# -- the server wrapper and the coordinator ----------------------------------------


class HAServer:
    """One shard replica: a :class:`NativePsServer` plus the HA duties, a
    heartbeat lease in the elastic store and (while the routing table names
    it primary) a :class:`ReplicationManager`. Roles follow the routing
    table: a promoted backup starts shipping to the remaining replicas, a
    demoted primary stops. ``kill()`` emulates host death (the server stops,
    the lease is left to expire); ``stop()`` deregisters gracefully."""

    def __init__(self, store, job_id: str, shard: int, host: str = "127.0.0.1",
                 port: int = 0, n_trainers: int = 1, sync: bool = False,
                 hb_interval: Optional[float] = None, hb_ttl: Optional[float] = None,
                 oplog_cap: Optional[int] = None) -> None:
        self.store = store
        self.job_id = job_id
        self.shard = int(shard)
        self.sync = sync
        self.server = NativePsServer(port=port, n_trainers=n_trainers, host=host)
        self.endpoint = f"{host}:{self.server.port}"
        self.routing = RoutingTable(store, job_id)
        self._hb_interval = (hb_interval if hb_interval is not None
                             else int(flag("ps_ha_heartbeat_ms")) / 1000.0)
        self._hb_ttl = hb_ttl if hb_ttl is not None else int(flag("ps_ha_lease_ttl_ms")) / 1000.0
        self._oplog_cap = oplog_cap
        self.rm: Optional[ReplicationManager] = None
        self._stop = _sync.Event()
        self._graceful = False
        self._thread: Optional[threading.Thread] = None
        self._lease = Lease(store, _hb_key(job_id, self.endpoint),
                            json.dumps({"shard": self.shard}), ttl=self._hb_ttl,
                            interval=self._hb_interval)

    def start(self) -> "HAServer":
        # record from birth: creates and pushes that land before a backup
        # attaches replay from the ring (no snapshot at bring-up)
        self.server.set_replication(True, self._oplog_cap or int(flag("ps_ha_oplog_cap")))
        self._lease.refresh()
        self._thread = _sync.Thread(target=self._hb_loop, daemon=True,
                                    name=f"ps-ha:{self.endpoint}")
        self._thread.start()
        return self

    def _hb_loop(self) -> None:
        while not self._stop.is_set():
            if self.server.stopped:
                break
            # chaos site: a kill-shard here schedules a death by heartbeat
            # count (the server's arm_fault schedules by op count)
            faultpoint("ha.heartbeat", kill=self.kill)
            if self.server.stopped:
                break
            self._lease.refresh()
            self._sync_role()
            self._stop.wait(self._hb_interval)
        if self._graceful:
            self.store.delete(self._lease.key)
        # else crash semantics: the lease expires on its TTL
        if self.rm is not None:
            self.rm.stop()
            self.rm = None

    def _sync_role(self) -> None:
        epoch, shards = self.routing.read()
        if not shards or self.shard >= len(shards):
            return
        if shards[self.shard]["primary"] == self.endpoint:
            if self.rm is None:
                self.rm = ReplicationManager(
                    self.server, self.endpoint, self.shard, self.routing, sync=self.sync,
                    oplog_cap=self._oplog_cap, epoch=max(epoch, self.server.epoch)).start()
            else:
                self.rm.set_epoch(max(epoch, self.server.epoch))
        elif self.rm is not None:
            self.rm.stop()
            self.rm = None

    def kill(self) -> None:
        """Host death now: the server stops mid-traffic and the lease is
        left to expire, as the failure detector must see it."""
        self._stop.set()
        self.server.stop()

    def stop(self) -> None:
        """Graceful shutdown: deregister the lease at once."""
        self._graceful = True
        self._stop.set()
        self.server.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.rm is not None:
            self.rm.stop()
            self.rm = None
        self.store.delete(self._lease.key)

    def close(self) -> None:
        self.stop()
        self.server.close()


class FailoverCoordinator:
    """The control loop that turns expired leases into promotions; one per
    job. Each scan:

    - a shard whose primary lease has been gone past the grace window and
      which has a live backup: fence the backup first (``kEpoch`` = the new
      epoch), then publish the bumped routing table;
    - a live replica-set member missing from the routing entry (a restarted
      server): re-add it as a backup once it is fresh (no applied history,
      an empty oplog); the primary's shipper attaches it by snapshot and
      tail.
    """

    def __init__(self, store, job_id: str, grace_s: Optional[float] = None,
                 poll_s: float = 0.05) -> None:
        self.store = store
        self.job_id = job_id
        self.routing = RoutingTable(store, job_id)
        self.grace_s = (grace_s if grace_s is not None
                        else int(flag("ps_ha_failover_grace_ms")) / 1000.0)
        self.poll_s = poll_s
        self.promotions = 0
        self._missing_since: Dict[str, float] = {}
        self._stop = _sync.Event()
        self._suspended = _sync.Event()
        self._step_mu = _sync.Lock()  # one scan at a time; suspend() waits on it
        self._susp_mu = _sync.Lock()  # guards _susp_depth
        self._susp_depth = 0
        self._thread: Optional[threading.Thread] = None
        self._c_promotions = _obs_registry.REGISTRY.counter("ha_promotions", max_series=64,
                                                            job=str(job_id))

    def _alive(self) -> set:
        pref = _hb_prefix(self.job_id)
        return {k[len(pref):] for k in self.store.list_prefix(pref)}

    def _is_fresh(self, ep: str) -> bool:
        """A rejoin candidate must be a fresh restart: no applied history
        and an empty oplog (a stale ex-primary holds rows an insert-only
        snapshot cannot delete)."""
        try:
            conn = make_conn(ep)
            try:
                _, resp = conn.check(_rpc._REPL_STATE, n=-1, retries=0)
            finally:
                conn.close()
        except PreconditionNotMetError:
            return False
        st = np.frombuffer(resp, np.int64)
        return int(st[0]) == 0 and int(st[2]) == 0  # applied, oplog seq

    def step(self) -> int:
        """One scan; returns the promotions made (the thread loops it)."""
        with self._step_mu:
            # re-checked under the lock: suspend() may have landed since the
            # loop's unlocked check
            if self._suspended.is_set():
                return 0
            return self._step_locked()

    def _step_locked(self) -> int:
        epoch, shards = self.routing.read()
        if not shards:
            return 0
        alive = self._alive()
        now = time.monotonic()
        changed = False
        promoted = 0
        for si, sh in enumerate(shards):
            prim = sh["primary"]
            if prim in alive:
                self._missing_since.pop(prim, None)
                for ep in sh.get("replicas", []):
                    if ep != prim and ep in alive and ep not in sh.get("backups", []) \
                            and self._is_fresh(ep):
                        sh.setdefault("backups", []).append(ep)
                        changed = True
                continue
            first = self._missing_since.setdefault(prim, now)
            if now - first < self.grace_s:
                continue
            cands = [b for b in sh.get("backups", []) if b in alive]
            if not cands:
                continue  # nothing to promote
            new_prim = cands[0]
            new_epoch = epoch + 1
            try:
                # fence before publishing: from now on the old primary's
                # kReplicate stream is rejected
                conn = make_conn(new_prim)
                conn.check(_rpc._EPOCH, n=new_epoch, retries=0)
                conn.close()
            except PreconditionNotMetError:
                continue  # cannot fence: no promotion this scan
            sh["primary"] = new_prim
            sh["backups"] = [b for b in sh["backups"] if b != new_prim]
            epoch = new_epoch
            changed = True
            promoted += 1
            self.promotions += 1
            self._c_promotions.inc()
            _flightrec.notify("failover_promotion", shard=si, old_primary=prim,
                              new_primary=new_prim, epoch=new_epoch)
        if changed:
            self.routing.publish(epoch, shards)
        return promoted

    def start(self) -> "FailoverCoordinator":
        self._thread = _sync.Thread(target=self._loop, daemon=True,
                                    name=f"ps-ha-coord:{self.job_id}")
        self._thread.start()
        return self

    def suspend(self) -> None:
        """Pause scans (no promotion, no publish) until the matching
        :meth:`resume_scans`; depth-counted, so nested holders (a gate
        inside another actuation) keep scans off until the last resumes.
        Returns once any in-flight scan has finished."""
        with self._susp_mu:
            self._susp_depth += 1
            self._suspended.set()
        with self._step_mu:
            pass

    def resume_scans(self) -> None:
        with self._susp_mu:
            self._susp_depth -= 1
            if self._susp_depth <= 0:
                self._susp_depth = 0
                self._suspended.clear()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._suspended.is_set():
                continue
            try:
                self.step()
            except PreconditionNotMetError:
                continue  # a store or endpoint blip; the next scan retries

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


# -- the in-process harness --------------------------------------------------------


class HACluster:
    """S shards × R replicas of in-process servers and a coordinator. It
    publishes the first routing (epoch 0: replica 0 of each shard is
    primary), starts the heartbeats and the coordinator, and hands out
    router-wired clients. ``sync=True`` makes :meth:`drain` a barrier after
    which primary ≡ backups (:meth:`digests`)."""

    def __init__(self, num_shards: int = 2, replication: Optional[int] = None, store=None,
                 job_id: str = "ps-ha", sync: bool = True, n_trainers: int = 1,
                 hb_interval: float = 0.05, hb_ttl: float = 0.4, grace_s: float = 0.1,
                 coordinator_poll_s: float = 0.05) -> None:
        self.store = store if store is not None else MemoryStore()
        self.job_id = job_id
        self.replication = (replication if replication is not None
                            else int(flag("ps_replication_factor")))
        self.sync = sync
        self.routing = RoutingTable(self.store, job_id)
        self.servers: List[List[HAServer]] = []
        self._n_trainers = n_trainers
        self._hb_interval = hb_interval
        self._hb_ttl = hb_ttl
        #: the control plane's mutex: a reshard cutover and a checkpoint
        #: capture hold it (through begin_actuation), so a capture never
        #: reads a half-migrated key set
        self.control_mu = _sync.RLock()
        self._clients: List[RpcPsClient] = []
        self.coordinator: Optional[FailoverCoordinator] = None
        try:
            shards_doc = []
            for si in range(num_shards):
                row: List[HAServer] = []
                self.servers.append(row)
                for _ in range(self.replication):
                    row.append(HAServer(self.store, job_id, si, n_trainers=n_trainers,
                                        sync=sync, hb_interval=hb_interval, hb_ttl=hb_ttl))
                eps = [r.endpoint for r in row]
                shards_doc.append({"primary": eps[0], "backups": eps[1:], "replicas": eps})
            self.routing.publish(0, shards_doc)
            for row in self.servers:
                for r in row:
                    r.start()
            self.coordinator = FailoverCoordinator(self.store, job_id, grace_s=grace_s,
                                                   poll_s=coordinator_poll_s).start()
        except BaseException:
            self.stop()
            raise

    # -- the actuation section ---------------------------------------------

    def begin_actuation(self) -> None:
        """Enter the cluster-wide actuation section: suspend failover scans,
        then take ``control_mu`` (both reentrant, so nesting is safe)."""
        coord = self.coordinator
        if coord is not None:
            coord.suspend()
        try:
            self.control_mu.acquire()
        except BaseException:
            if coord is not None:
                coord.resume_scans()
            raise

    def end_actuation(self) -> None:
        """Leave it: release ``control_mu``, then resume the scans."""
        self.control_mu.release()
        if self.coordinator is not None:
            self.coordinator.resume_scans()

    @contextlib.contextmanager
    def actuation(self):
        """:meth:`begin_actuation` ... :meth:`end_actuation` as a context."""
        self.begin_actuation()
        try:
            yield self
        finally:
            self.end_actuation()

    # -- topology --------------------------------------------------------------

    @property
    def num_shards(self) -> int:
        """The live shard count: a reshard grows and shrinks
        ``self.servers`` at its cutover."""
        return len(self.servers)

    def spawn_shard(self, shard: int, replication: Optional[int] = None) -> List[HAServer]:
        """Bring up one new shard row (a full replica set) outside the
        routing table, a grow's raw material: its servers heartbeat but own
        no keys and take no traffic until the cutover publishes them."""
        enforce(shard == len(self.servers),
                f"spawn_shard({shard}): shards are routing positions, the next new row is "
                f"{len(self.servers)}")
        n = replication if replication is not None else self.replication
        row: List[HAServer] = []
        try:
            for _ in range(n):
                row.append(HAServer(self.store, self.job_id, shard, n_trainers=self._n_trainers,
                                    sync=self.sync, hb_interval=self._hb_interval,
                                    hb_ttl=self._hb_ttl))
        except BaseException:
            for r in row:
                r.close()
            raise
        self.servers.append(row)
        for r in row:
            r.start()
        return row

    def retire_shard(self, shard: int) -> List[HAServer]:
        """Drop the trailing shard row from the topology (after a shrink's
        cutover) and return it; stopping its fenced servers is the caller's
        job once stale clients have re-resolved."""
        enforce(shard == len(self.servers) - 1,
                f"retire_shard({shard}): only the trailing shard ({len(self.servers) - 1}) can "
                "retire; shard indices are routing positions")
        return self.servers.pop()

    def replica(self, shard: int, endpoint: str) -> HAServer:
        for r in self.servers[shard]:
            if r.endpoint == endpoint:
                return r
        raise KeyError(endpoint)

    def primary(self, shard: int) -> HAServer:
        _, shards = self.routing.read()
        return self.replica(shard, shards[shard]["primary"])

    def backups(self, shard: int) -> List[HAServer]:
        _, shards = self.routing.read()
        return [self.replica(shard, ep) for ep in shards[shard].get("backups", [])]

    # -- clients and chaos -----------------------------------------------------

    def router(self, **kw) -> HARouter:
        return HARouter(self.store, self.job_id, **kw)

    def checkpoint_gate(self, **kw) -> CheckpointGate:
        """The consistent-cut gate a ``JobCheckpointManager`` holds while
        it captures this cluster's tables."""
        return CheckpointGate(cluster=self, **kw)

    def client(self, with_router: bool = True, qos: str = "train", **router_kw) -> RpcPsClient:
        """A router-wired client (``qos="serve"`` raises: entry 5)."""
        if qos != "train":
            raise UnavailableError(
                f"HACluster.client(qos={qos!r}): the serve QoS class is not ported yet "
                "(ROADMAP Queue A item 3, entry 5)")
        cli = RpcPsClient(self.routing.primaries(),
                          router=self.router(**router_kw) if with_router else None)
        self._clients.append(cli)
        return cli

    def obs_probe(self) -> None:
        raise UnavailableError("HACluster.obs_probe feeds obs/timeseries.py's sampler, which "
                               "is not ported yet (ROADMAP Queue A item 3, entry 6)")

    def kill_primary(self, shard: int) -> str:
        """Host-death the shard's current primary now; returns its
        endpoint."""
        p = self.primary(shard)
        p.kill()
        return p.endpoint

    def restart_replica(self, shard: int, endpoint: str) -> HAServer:
        """Bring a fresh server back on a dead replica's endpoint: its
        heartbeat reappears, the coordinator re-adds it as a backup, and the
        shard's primary attaches it (catalog replay, snapshot, tail)."""
        old = self.replica(shard, endpoint)
        enforce(old.server.stopped, f"{endpoint} is still alive")
        old.close()
        host, port = endpoint.rsplit(":", 1)
        fresh = HAServer(self.store, self.job_id, shard, host=host, port=int(port),
                         n_trainers=self._n_trainers, sync=self.sync,
                         hb_interval=self._hb_interval, hb_ttl=self._hb_ttl).start()
        row = self.servers[shard]
        row[row.index(old)] = fresh
        return fresh

    def wait_promoted(self, shard: int, old_primary: str, timeout: float = 10.0) -> str:
        deadline = time.monotonic() + timeout
        while True:
            _, shards = self.routing.read()
            ep = shards[shard]["primary"]
            if ep != old_primary:
                return ep
            enforce(time.monotonic() < deadline,
                    f"no promotion for shard {shard} within {timeout}s")
            time.sleep(0.01)

    def drain(self, timeout: float = 30.0) -> None:
        """Sync-replication barrier across the cluster: every live backup in
        the routing table is attached to its primary's shipper and has acked
        every oplog entry. It waits through the shipper's start and attach
        (role changes ride the heartbeat tick), so a drain right after
        bring-up or a promotion is safe. Only the routed shards drain: a
        grow's targets drain through their source's shipper until the
        cutover routes them."""
        deadline = time.monotonic() + timeout
        for si in range(len(self.routing.read()[1])):
            while True:
                _, shards = self.routing.read()
                if si >= len(shards):
                    break  # a concurrent shrink retired this index
                sh = shards[si]
                prim = self.replica(si, sh["primary"])
                alive = {ep for ep in sh.get("backups", [])
                         if not self.replica(si, ep).server.stopped}
                rm = prim.rm
                if not prim.server.stopped and rm is not None and \
                        alive <= set(rm.lag()["acked"]):
                    rm.drain(max(0.01, deadline - time.monotonic()))
                    break
                enforce(time.monotonic() < deadline,
                        f"drain: shard {si} shipper not attached to {alive} within {timeout}s")
                time.sleep(0.01)

    def digests(self, table_id: int, shard: int) -> Dict[str, int]:
        """Per-replica content digests of one shard (live replicas only)."""
        out = {}
        for r in self.servers[shard]:
            if r.server.stopped:
                continue
            conn = make_conn(r.endpoint)
            try:
                _, resp = conn.check(_rpc._DIGEST, table_id)
                out[r.endpoint] = int(np.frombuffer(resp, np.uint64)[0])
            finally:
                conn.close()
        return out

    def stop(self) -> None:
        if self.coordinator is not None:
            self.coordinator.stop()
        for cli in self._clients:
            try:
                cli.close()
            except Exception:  # noqa: BLE001 — teardown goes on
                pass
        for row in self.servers:
            for r in row:
                try:
                    r.close()
                except Exception:  # noqa: BLE001
                    pass

    def __enter__(self) -> "HACluster":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
