"""Live resharding: grow or shrink a running ``HACluster``'s shard set while
trainers keep streaming.

The port's own copy of ``paddle_tpu.ps.reshard``. It composes what the PS
already has (the shipper's snapshot and tail, the ownership fence of the
C++ service, the epoch-stamped routing table) into a
:class:`ReshardController`:

- **plan**: routing is ``key % num_servers``, so a key range is a residue
  class under the new modulus. Growing S to m·S splits each shard's keys
  into m classes; class ``s + j·S`` moves to the new shard of that index,
  from one source. Shrinking 2S to S drains each retiring shard ``r`` onto
  survivor ``r % S``; a shrink halves only, since two retirees draining
  into one survivor would interleave their replication seq spaces.
- **bootstrap**: the new shard's primary registers under the source
  shard's observer prefix with ``{"mode": "migrate"}``; the source's
  ``ReplicationManager`` attaches it by snapshot (catalog replay, kSaveAll
  into kInsertFull, seq rebase) and then ships the tail. Training goes on;
  the source pauses mutations for the snapshot only. A source primary
  killed mid-migration is survivable: the registration is a TTL'd lease
  this controller refreshes, so the promoted primary re-attaches it and
  the bootstrap restarts from its own (sync, bit-identical) copy.
- **cutover**, the only window that holds writers (``pause_ms``): pause the
  source primaries, drain the tail, verify every moving class with the
  filtered content digests (digests are wrapping sums of row hashes, so no
  row lost or doubled is one equality a class), detach the migration,
  ``kRetain`` the new shards down to their class, publish the routing with
  the epoch bumped, ``kRetain`` the sources (drops the moved classes and
  installs their fence; tapped, so backups converge), resume. The
  failover coordinator's scans are suspended and ``cluster.control_mu`` is
  held throughout (``HACluster.actuation``), which also serializes the
  cutover against a ``CheckpointGate`` capture.
- **client re-route**: nothing is broadcast. A client on the old topology
  gets a whole-frame ``kErrWrongShard`` bounce from the fence, re-resolves
  the routing, rebuilds its connection set and replays exactly the bounced
  keys (``RpcPsClient`` misroute replay); the trainer sees no error.
- **shrink**: the retiring shards are fenced out (``kRetain`` residue -1:
  every keyed op bounces) and kept as lame ducks until stale clients have
  re-resolved; then they stop.

Scope, checked before anything moves: sparse RAM tables only. SSD tables,
PS-side dense tables and GEO accumulators are refused. ``clock`` and
``sleep`` are injectable; every operation appends to ``events``, is
mirrored into the elastic store under ``ps/<job>/reshard/<n>`` and notifies
the flight recorder.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import sync as _sync
from ..core.enforce import PreconditionNotMetError, enforce
from ..obs import flightrec as _flightrec
from ..obs import registry as _obs_registry
from ..obs import trace as _obs_trace
from . import rpc as _rpc
from .faultpoints import faultpoint
from .ha import _HDR, HACluster, Lease, make_conn, observer_key

__all__ = ["Migration", "ReshardPlan", "ReshardError", "plan_grow", "plan_shrink",
           "ReshardController"]


class ReshardError(PreconditionNotMetError):
    """A reshard step failed verification (digest mismatch, bootstrap
    timeout, a table class it cannot move). The controller resumes the
    paused primaries before raising: the cluster keeps serving on the old
    topology, and no routing flip is published."""


@dataclasses.dataclass(frozen=True)
class Migration:
    """One moving residue class: keys with ``key % modulus == residue``
    leave shard ``src`` for shard ``dst``."""

    src: int
    dst: int
    modulus: int
    residue: int


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    direction: str  # "grow" | "shrink"
    old_n: int
    new_n: int
    migrations: tuple


def plan_grow(old_n: int, factor: int = 2) -> ReshardPlan:
    """S to factor·S. Every key of new shard ``d`` lives on ``d % S`` today
    (k ≡ d (mod m·S) implies k ≡ d (mod S)): one source a migration, and
    the kept classes do not move."""
    enforce(old_n >= 1 and factor >= 2,
            f"plan_grow needs old_n >= 1 and factor >= 2, got {old_n}, {factor}")
    new_n = old_n * factor
    migs = tuple(Migration(src=d % old_n, dst=d, modulus=new_n, residue=d)
                 for d in range(old_n, new_n))
    return ReshardPlan("grow", old_n, new_n, migs)


def plan_shrink(old_n: int, divisor: int = 2) -> ReshardPlan:
    """2S to S: each retiring shard ``r`` drains onto survivor ``r % S``.
    Halving only (chain halvings for more)."""
    enforce(divisor == 2,
            f"plan_shrink supports divisor=2 per step (chain halvings for more), got {divisor}")
    enforce(old_n % divisor == 0 and old_n // divisor >= 1,
            f"cannot shrink {old_n} shards by {divisor}")
    new_n = old_n // divisor
    migs = tuple(Migration(src=r, dst=r % new_n, modulus=old_n, residue=r)
                 for r in range(new_n, old_n))
    return ReshardPlan("shrink", old_n, new_n, migs)


class ReshardController:
    """Grow or shrink a live :class:`~paddle_tpu_torch.ps.ha.HACluster`.
    One a job; operations serialize on an internal lock. Every wait
    re-resolves the current source primary from the routing table, so a
    failover mid-migration costs a re-bootstrap, not the operation."""

    def __init__(self, cluster: HACluster, catchup_lag: int = 64,
                 catchup_timeout_s: float = 60.0, cutover_timeout_s: float = 30.0,
                 detach_timeout_s: float = 10.0, lame_duck_s: float = 0.5,
                 poll_s: float = 0.01, clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.cluster = cluster
        self.catchup_lag = int(catchup_lag)
        self.catchup_timeout_s = float(catchup_timeout_s)
        self.cutover_timeout_s = float(cutover_timeout_s)
        self.detach_timeout_s = float(detach_timeout_s)
        self.lame_duck_s = float(lame_duck_s)
        self.poll_s = float(poll_s)
        self._clock = clock
        self._sleep = sleep
        # lock discipline (the JAX module's): `_op_mu` serializes whole
        # operations; the client's `_conns_mu` and the cluster's
        # `control_mu` order under it. Order: _op_mu < control_mu.
        self._op_mu = _sync.Lock()
        self._ctrl_conns: Dict[str, object] = {}
        #: cutover gate-hold milliseconds, one an operation
        self.pause_ms: deque = deque(maxlen=512)
        #: bootstrap (copy and catch-up) seconds, one an operation
        self.bootstrap_s: deque = deque(maxlen=512)
        #: the scale-event journal (mirrored into the elastic store)
        self.events: List[dict] = []
        self._pre_cutover: List[Callable[[ReshardPlan], None]] = []
        self._g_shards = _obs_registry.REGISTRY.gauge("ps_shard_count", max_series=64,
                                                      job=str(cluster.job_id))
        self._c_reshards = _obs_registry.REGISTRY.counter("ps_reshards", max_series=64,
                                                          job=str(cluster.job_id))
        self._g_shards.set(cluster.num_shards)

    # -- wiring ------------------------------------------------------------

    def on_pre_cutover(self, fn: Callable[[ReshardPlan], None]) -> None:
        """Call ``fn(plan)`` right before each cutover gate, on the
        controller's thread (keep it bounded): a hot tier's owner flushes
        its dirty rows there, tests inject checkpoints."""
        self._pre_cutover.append(fn)

    # -- introspection -----------------------------------------------------

    def _journal(self, event: dict) -> None:
        event = dict(event, t=_obs_trace.wall_s())
        self.events.append(event)
        self.cluster.store.put(f"ps/{self.cluster.job_id}/reshard/{len(self.events)}",
                               json.dumps(event))
        _flightrec.notify("reshard", **{k: v for k, v in event.items() if k not in ("t", "kind")})

    def stats(self) -> dict:
        return {"num_shards": self.cluster.num_shards, "events": list(self.events),
                "pause_ms": list(self.pause_ms), "bootstrap_s": list(self.bootstrap_s)}

    # -- shared plumbing ---------------------------------------------------

    def _primary_server(self, shard: int):
        """The current primary ``HAServer`` of ``shard``, re-resolved each
        call (failovers move it)."""
        return self.cluster.primary(shard)

    def _conn(self, endpoint: str):
        """A control connection cached for the operation: the digests,
        retains and epoch fences run inside the cutover gate, and a connect
        a call would add handshakes to the pause. Closed at the operation's
        end (:meth:`_close_conns`)."""
        c = self._ctrl_conns.get(endpoint)
        if c is None:
            c = self._ctrl_conns[endpoint] = make_conn(endpoint)
        return c

    def _close_conns(self) -> None:
        conns, self._ctrl_conns = self._ctrl_conns, {}
        for c in conns.values():
            try:
                c.close()
            except Exception:  # noqa: BLE001 — teardown goes on
                pass

    def _check(self, endpoint: str, cmd: int, table_id: int = 0, n: int = 0, aux: int = 0):
        return self._conn(endpoint).check(cmd, table_id, n=n, aux=aux,
                                          timeout_ms=_rpc._long_ms(), retries=0)

    def _digest(self, endpoint: str, table_id: int, modulus: int = 0, residue: int = 0) -> int:
        _, resp = self._check(endpoint, _rpc._DIGEST, table_id, n=modulus, aux=residue)
        return int(np.frombuffer(resp, np.uint64)[0])

    def _retain(self, endpoint: str, modulus: int, residue: int) -> int:
        status, _ = self._check(endpoint, _rpc._RETAIN, n=modulus, aux=residue)
        return int(status)

    def _catalog(self, server) -> List[int]:
        """The sparse table ids of the catalog; refuses what this module
        cannot move (SSD tables, PS dense tables, GEO accumulators) before
        anything moves."""
        sparse: List[int] = []
        base = 6 * 4 + 17 * 4  # a sparse create's iparams + fparams payload
        for frame in server.catalog():
            plen, cmd, tid, _, _, _, _ = _HDR.unpack_from(frame, 0)
            if cmd == _rpc._CREATE_SPARSE:
                enforce(plen <= base,
                        "reshard: SSD-backed sparse tables cannot be retained (the cold "
                        "tier has no key filter); restore through save/load instead",
                        ReshardError)
                if tid not in sparse:
                    sparse.append(tid)
            else:
                enforce(cmd not in (_rpc._CREATE_DENSE, _rpc._CREATE_GEO),
                        "reshard: PS-side dense and GEO tables pin the server count (dense "
                        "slices re-split, GEO drains on read); they cannot move",
                        ReshardError)
        enforce(sparse, "reshard: no sparse tables to migrate", ReshardError)
        return sparse

    def _register_migration(self, mig: Migration, target_ep: str) -> Lease:
        """The TTL'd migrate-mode observer registration: the source shard's
        shipper attaches ``target_ep``; the lease, refreshed here, survives
        a source failover (the promoted primary re-attaches it)."""
        return Lease(self.cluster.store, observer_key(self.cluster.job_id, mig.src, target_ep),
                     json.dumps({"mode": "migrate", "dst_shard": mig.dst}),
                     ttl=4 * self.cluster._hb_ttl, interval=self.cluster._hb_ttl).start()

    def _acked(self, src_shard: int, target_ep: str) -> int:
        """The source shipper's acked cursor for ``target_ep``, the only
        cursor in the source's own seq space (a survivor promoted from a
        backup carries a cursor of another primary's numbering). -1: not
        attached or not synced yet."""
        rm = self._primary_server(src_shard).rm
        if rm is None:
            return -1
        return rm.lag()["acked"].get(target_ep, -1)

    def _wait_catchup(self, migs: List[Migration], targets: Dict[int, object]) -> None:
        """Until every target has the source's stream within
        ``catchup_lag`` entries (the bounded tail the cutover drains)."""
        deadline = self._clock() + self.catchup_timeout_s
        pending = list(migs)
        while pending:
            faultpoint("reshard.bootstrap")
            still = []
            for m in pending:
                seq = self._primary_server(m.src).server.oplog_seq()
                acked = self._acked(m.src, targets[m.dst].endpoint)
                if not (acked >= 0 and seq - acked <= self.catchup_lag):
                    still.append(m)
            pending = still
            if not pending:
                return
            enforce(self._clock() < deadline,
                    f"reshard bootstrap: {len(pending)} migration(s) not caught up within "
                    f"{self.catchup_timeout_s}s (first: {pending[0]})", ReshardError)
            self._sleep(self.poll_s)

    def _drain_into(self, migs: List[Migration], targets: Dict[int, object]) -> None:
        """Under the gate (sources paused, seq frozen): until each source's
        shipper has its target's ack for the final seq."""
        deadline = self._clock() + self.cutover_timeout_s
        for m in migs:
            ep = targets[m.dst].endpoint
            while True:
                src = self._primary_server(m.src).server
                seq = src.oplog_seq()
                acked = self._acked(m.src, ep)
                if acked >= seq and src.oplog_pending() == 0:
                    break
                enforce(self._clock() < deadline,
                        f"reshard cutover drain timed out ({m}: acked {acked} < seq {seq})",
                        ReshardError)
                self._sleep(self.poll_s / 2)

    def _wait_detached(self, migs: List[Migration], targets: Dict[int, object]) -> None:
        """After the registrations are released: until each source's
        shipper has dropped its target, so nothing logged after the cutover
        (the source's own kRetain included) ships to a shard that now owns
        another key set. All migrations poll in one loop: this wait is
        inside the gate."""
        deadline = self._clock() + self.detach_timeout_s
        pending = {(m.src, targets[m.dst].endpoint) for m in migs}
        while pending:
            done = set()
            for src, ep in pending:
                rm = self._primary_server(src).rm
                if rm is None or ep not in rm.lag()["acked"]:
                    done.add((src, ep))
                else:
                    # nudge: the shipper's next loop re-reads the store at once
                    rm._last_route_poll = 0.0
            pending -= done
            if not pending:
                return
            enforce(self._clock() < deadline,
                    f"reshard cutover: source shippers still attached to {sorted(pending)}",
                    ReshardError)
            self._sleep(self.poll_s / 2)

    def _drain_sync_backups(self, shards: List[int]) -> None:
        """Sync clusters: the shards' backups ack everything, the tapped
        kRetain included, before the gate opens."""
        if not self.cluster.sync:
            return
        for s in shards:
            rm = self._primary_server(s).rm
            if rm is not None:
                rm.drain(self.cutover_timeout_s)

    # -- grow --------------------------------------------------------------

    def grow(self, factor: int = 2, replication: Optional[int] = None) -> dict:
        """S to factor·S live. Returns the operation's record (also
        appended to ``events``)."""
        with self._op_mu:
            try:
                return self._grow(factor, replication)
            finally:
                self._close_conns()

    def _grow(self, factor: int, replication: Optional[int]) -> dict:
        cluster = self.cluster
        plan = plan_grow(cluster.num_shards, factor)
        self._catalog(self._primary_server(0).server)
        t0 = self._clock()
        # 1. the new rows: leased and heartbeating, outside the routing
        for d in range(plan.old_n, plan.new_n):
            cluster.spawn_shard(d, replication)
        targets = {d: cluster.servers[d][0] for d in range(plan.old_n, plan.new_n)}
        # 2. bootstrap: snapshot and tail through the sources' shippers
        leases = [self._register_migration(m, targets[m.dst].endpoint)
                  for m in plan.migrations]
        try:
            self._wait_catchup(list(plan.migrations), targets)
            boot_s = self._clock() - t0
            # 3. cutover
            pause_ms, moved = self._cutover_grow(plan, targets, leases)
        except BaseException:
            for lease in leases:
                lease.release()
            if len(cluster.routing.read()[1]) == plan.old_n:
                # no flip was published: the new rows leave again, so the
                # cluster is back on the old topology and a retry plans
                # from it
                for d in reversed(range(plan.old_n, plan.new_n)):
                    for srv in cluster.retire_shard(d):
                        srv.close()
            raise
        self.bootstrap_s.append(boot_s)
        self.pause_ms.append(pause_ms)
        self._g_shards.set(cluster.num_shards)
        self._c_reshards.inc()
        rec = {"kind": "reshard", "direction": "grow", "from_shards": plan.old_n,
               "to_shards": plan.new_n, "bootstrap_s": round(boot_s, 6),
               "cutover_pause_ms": round(pause_ms, 3), "rows_moved": int(moved)}
        self._journal(rec)
        return rec

    def _cutover_grow(self, plan: ReshardPlan, targets: Dict[int, object],
                      leases: List[Lease]) -> tuple:
        cluster = self.cluster
        migs = list(plan.migrations)
        srcs = sorted({m.src for m in migs})
        tables = self._catalog(self._primary_server(0).server)
        for fn in self._pre_cutover:
            fn(plan)
        faultpoint("reshard.cutover")
        paused = []
        t0 = time.perf_counter()
        with cluster.actuation():
            try:
                # pause the sources (depth-counted: nests with a checkpoint
                # gate) and drain the tails; the moving classes are frozen
                for s in srcs:
                    srv = self._primary_server(s).server
                    srv.pause_mutations(True)
                    paused.append(srv)
                self._drain_into(migs, targets)
                # every moving class arrived bit-identically (filtered
                # digests add: a lost or doubled row cannot hide); the kept
                # classes are recorded for the check after the retain
                keep = {}
                for s in srcs:
                    src_ep = self._primary_server(s).endpoint
                    for tid in tables:
                        keep[(s, tid)] = self._digest(src_ep, tid, plan.new_n, s)
                for m in migs:
                    src_ep = self._primary_server(m.src).endpoint
                    for tid in tables:
                        want = self._digest(src_ep, tid, m.modulus, m.residue)
                        got = self._digest(targets[m.dst].endpoint, tid, m.modulus, m.residue)
                        enforce(got == want,
                                f"reshard grow: migrated class digest mismatch (table {tid}, "
                                f"{m}: {got:#x} != {want:#x}); aborting before the flip",
                                ReshardError)
                # detach before any retain: the source's tapped kRetain must
                # not ship to the new shard (it would drop what it received)
                for lease in leases:
                    lease.release()
                self._wait_detached(migs, targets)
                # the new shards keep only their class and bounce the rest
                for m in migs:
                    self._retain(targets[m.dst].endpoint, m.modulus, m.residue)
                # flip: fence the new primaries' epoch, then publish the
                # widened routing (the coordinator's scans are suspended)
                epoch, shards_doc = cluster.routing.read()
                new_epoch = epoch + 1
                for d in range(plan.old_n, plan.new_n):
                    self._check(targets[d].endpoint, _rpc._EPOCH, n=new_epoch)
                    eps = [r.endpoint for r in cluster.servers[d]]
                    shards_doc.append({"primary": eps[0], "backups": eps[1:], "replicas": eps})
                cluster.routing.publish(new_epoch, shards_doc)
                # the sources drop the moved classes and install their fence
                # (pause-exempt and tapped: their backups converge)
                moved = 0
                for s in srcs:
                    moved += self._retain(self._primary_server(s).endpoint, plan.new_n, s)
                    for tid in tables:
                        got = self._digest(self._primary_server(s).endpoint, tid)
                        enforce(got == keep[(s, tid)],
                                f"reshard grow: source {s} kept-class digest mismatch on "
                                f"table {tid}", ReshardError)
                self._drain_sync_backups(srcs)
            finally:
                for srv in reversed(paused):
                    srv.pause_mutations(False)
        return (time.perf_counter() - t0) * 1000.0, moved

    # -- shrink ------------------------------------------------------------

    def shrink(self, divisor: int = 2) -> dict:
        """2S to S live. The retiring shards stay up, fenced out, for
        ``lame_duck_s`` so that stale clients bounce and re-resolve instead
        of meeting dead sockets; then they stop."""
        with self._op_mu:
            try:
                return self._shrink(divisor)
            finally:
                self._close_conns()

    def _shrink(self, divisor: int) -> dict:
        cluster = self.cluster
        plan = plan_shrink(cluster.num_shards, divisor)
        self._catalog(self._primary_server(0).server)
        t0 = self._clock()
        targets = {m.dst: self._primary_server(m.dst) for m in plan.migrations}
        # the survivors keep their pre-shrink fence through the bootstrap
        # (the migration's rows and tail arrive replicate-wrapped, which the
        # fence does not filter): a client that never re-resolved after an
        # earlier grow routes the retirees' classes to the survivors, and a
        # survivor widened this early would take those writes while the
        # retiree takes the re-resolved clients'. They widen at the cutover.
        # bootstrap one migration at a time: a survivor's applied-seq cursor
        # follows one retiree's stream
        leases = []
        try:
            for m in plan.migrations:
                leases.append(self._register_migration(m, targets[m.dst].endpoint))
                self._wait_catchup([m], {m.dst: targets[m.dst]})
            boot_s = self._clock() - t0
            pause_ms = self._cutover_shrink(plan, targets, leases)
        except BaseException:
            for lease in leases:
                lease.release()
            raise
        # the lame duck: the fenced retirees answer (with bounces) while
        # stale clients re-resolve, then leave
        self._sleep(self.lame_duck_s)
        retired = []
        for r in reversed(range(plan.new_n, plan.old_n)):
            retired.extend(cluster.retire_shard(r))
        for srv in retired:
            try:
                srv.close()
            except Exception:  # noqa: BLE001 — teardown goes on
                pass
        self.bootstrap_s.append(boot_s)
        self.pause_ms.append(pause_ms)
        self._g_shards.set(cluster.num_shards)
        self._c_reshards.inc()
        rec = {"kind": "reshard", "direction": "shrink", "from_shards": plan.old_n,
               "to_shards": plan.new_n, "bootstrap_s": round(boot_s, 6),
               "cutover_pause_ms": round(pause_ms, 3)}
        self._journal(rec)
        return rec

    def _cutover_shrink(self, plan: ReshardPlan, targets: Dict[int, object],
                        leases: List[Lease]) -> float:
        cluster = self.cluster
        migs = list(plan.migrations)
        tables = self._catalog(self._primary_server(0).server)
        for fn in self._pre_cutover:
            fn(plan)
        faultpoint("reshard.cutover")
        paused = []
        t0 = time.perf_counter()
        with cluster.actuation():
            try:
                # pause the retirees only: the survivors keep their own
                # traffic, the retirees' classes freeze
                for m in migs:
                    srv = self._primary_server(m.src).server
                    srv.pause_mutations(True)
                    paused.append(srv)
                self._drain_into(migs, targets)
                # every retiree row sits bit-identical in its survivor (the
                # survivor's class digest equals the retiree's whole digest)
                for m in migs:
                    src_ep = self._primary_server(m.src).endpoint
                    for tid in tables:
                        want = self._digest(src_ep, tid)
                        got = self._digest(targets[m.dst].endpoint, tid, m.modulus, m.residue)
                        enforce(got == want,
                                f"reshard shrink: drained class digest mismatch (table {tid}, "
                                f"{m}: {got:#x} != {want:#x}); aborting before the flip",
                                ReshardError)
                for lease in leases:
                    lease.release()
                self._wait_detached(migs, targets)
                # the retirees fence out (they own nothing and keep their
                # rows for the lame-duck window), then the survivors widen
                # to the post-shrink predicate (no row changes: k ≡ t (mod
                # 2S) implies k ≡ t (mod S))
                for m in migs:
                    self._retain(self._primary_server(m.src).endpoint, plan.new_n, -1)
                for t_shard in range(plan.new_n):
                    self._retain(self._primary_server(t_shard).endpoint, plan.new_n, t_shard)
                epoch, shards_doc = cluster.routing.read()
                cluster.routing.publish(epoch + 1, shards_doc[:plan.new_n])
                # the survivors' backups only: the retirees left the routing
                self._drain_sync_backups(sorted({m.dst for m in migs}))
            finally:
                for srv in reversed(paused):
                    srv.pause_mutations(False)
        return (time.perf_counter() - t0) * 1000.0
