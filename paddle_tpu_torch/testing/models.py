"""Model harnesses for the control-plane protocols the explorer
(:mod:`.sched`) runs: the port's own copy of the JAX repo's harness
models.

Five harnesses, over the protocols whose interlocks were each added
reactively:

* ``three_way_model`` — checkpoint-gate × reshard-cutover ×
  failover-``suspend()``: a faithful miniature of the ps/ha.py +
  ps/reshard.py protocol steps using the REAL lock names
  (``control_mu``, ``_step_mu``, ``_op_mu``, ``_pause_mu``,
  ``_susp_mu``), so the dynamic lock-order checker validates the same
  ``# LOCK ORDER:`` declarations the sources carry.  Two knobs
  replay the protocol's history: ``gate_suspends=False`` reproduces
  the pre-fix CheckpointGate (no ``coordinator.suspend()`` — a
  mid-capture promotion routes the capture to an unpaused backup: the
  torn-cut bug this explorer surfaced), and ``depth_counted=False``
  reproduces the naive single-Event suspend (a reshard overlapping a
  gate clears the GATE's suspension from its ``finally`` — the
  second-order bug that makes the fix need nesting).  Defaults mirror
  the fixed production protocol and must explore clean.

* ``fleet_drain_tick_model`` — drives the port's REAL
  serving.fleet.ServingFleet (stub router/store/members) through
  ``drain()`` racing watcher ``tick()``s: the three seeded re-admit
  races fixed in its history must stay closed in EVERY interleaving.

* ``ssd_compact_model`` — the SSD tier's two-phase background
  compactor (``csrc/ssd_table.cc``) in miniature, under that file's
  ``// LOCK ORDER:`` lock names.

* ``ckpt_writer_model`` — drives the port's REAL
  io.job_checkpoint.JobCheckpointManager (``_write`` stubbed) through
  two ``save()``s racing ``stop()``: every admitted snapshot must land
  ahead of the shutdown sentinel, and stop() must terminate.

* ``reconciler_model`` — ps/reconcile.py's single serialized actuator
  against proposers and a lease-expiry failover, in miniature.

Nothing on a production path imports this module.
"""

from __future__ import annotations

import os
import shutil
import tempfile

from ..core import sync as _sync

#: sources whose `# LOCK ORDER:` / `# LOCK LEAF:` declarations the
#: dynamic checker loads (testing.sched.load_lock_order), relative to the
#: checkout's root — the models use these exact lock names
DECL_FILES = (
    "paddle_tpu_torch/ps/ha.py",
    "paddle_tpu_torch/ps/rpc.py",
    "paddle_tpu_torch/ps/reshard.py",
    "paddle_tpu_torch/ps/reconcile.py",
    "paddle_tpu_torch/ps/spec.py",
    "paddle_tpu_torch/serving/fleet.py",
    "paddle_tpu_torch/io/job_checkpoint.py",
    "paddle_tpu_torch/csrc/ssd_table.cc",   # `//` grammar — load_lock_order
)                                           # dispatches on extension


# ---------------------------------------------------------------------------
# 1. checkpoint-gate × reshard-cutover × failover three-way
# ---------------------------------------------------------------------------

class _ModelServer:
    """One shard replica: pause depth + a data version (a write bumps
    it; the capture must see a frozen version)."""

    def __init__(self, ep: str) -> None:
        self.ep = ep
        self.pause_mu = _sync.Lock(name="_pause_mu")
        self.pause_depth = 0
        self.data = 0


class _ThreeWay:
    """ps/ha.py + ps/reshard.py control-plane protocol in miniature."""

    def __init__(self, sched, gate_suspends: bool,
                 depth_counted: bool) -> None:
        self.sched = sched
        self.gate_suspends = gate_suspends
        self.depth_counted = depth_counted
        # the real primitives, real names (HACluster / FailoverCoordinator
        # / ReshardController)
        self.control_mu = _sync.RLock(name="control_mu")
        self.step_mu = _sync.Lock(name="_step_mu")
        self.op_mu = _sync.Lock(name="_op_mu")
        self.susp_mu = _sync.Lock(name="_susp_mu")
        self.suspended = _sync.Event(name="suspended")
        self.susp_depth = 0
        self.servers = {"s0a": _ModelServer("s0a"),
                        "s0b": _ModelServer("s0b")}
        self.routing = {"epoch": 0,
                        "shards": [{"primary": "s0a", "backups": ["s0b"]}]}
        # the failure-detector's view: s0a's lease has expired (the
        # gate's drain delayed its heartbeats past the TTL) — the
        # coordinator WILL promote s0b if allowed to scan
        self.alive = {"s0b"}

    # routing store (read-modify-write; publish must be single-writer)
    def read_routing(self):
        self.sched.yield_point("routing.read")
        shards = [dict(sh, backups=list(sh["backups"]))
                  for sh in self.routing["shards"]]
        return self.routing["epoch"], shards

    def publish(self, epoch, shards):
        self.sched.yield_point("routing.publish")
        self.sched.check(
            epoch == self.routing["epoch"] + 1,
            f"routing clobbered: publish(epoch={epoch}) over live epoch "
            f"{self.routing['epoch']} — a stale read-modify-write won the "
            "race (suspend() exists to keep the routing table single-"
            "writer)")
        self.routing = {"epoch": epoch, "shards": shards}

    def pause(self, ep: str, on: bool) -> None:
        srv = self.servers[ep]
        with srv.pause_mu:
            srv.pause_depth += 1 if on else -1

    # FailoverCoordinator.suspend()/resume_scans()
    def suspend(self) -> None:
        if self.depth_counted:
            with self.susp_mu:
                self.susp_depth += 1
                self.suspended.set()
        else:
            self.suspended.set()
        with self.step_mu:
            pass            # barrier: in-flight scan finishes

    def resume_scans(self) -> None:
        if self.depth_counted:
            with self.susp_mu:
                self.susp_depth = max(0, self.susp_depth - 1)
                if self.susp_depth == 0:
                    self.suspended.clear()
        else:
            self.suspended.clear()

    # -- tasks ------------------------------------------------------------

    def failover_step(self) -> None:
        """FailoverCoordinator.step(): promote the backup of a
        lease-expired primary, fence, publish."""
        with self.step_mu:
            if self.suspended.is_set():
                return
            epoch, shards = self.read_routing()
            sh = shards[0]
            if sh["primary"] in self.alive:
                return
            cands = [b for b in sh["backups"] if b in self.alive]
            if not cands:
                return
            new_prim = cands[0]
            self.sched.yield_point("fence")     # epoch fence RPC
            sh["primary"] = new_prim
            sh["backups"] = [b for b in sh["backups"] if b != new_prim]
            self.publish(epoch + 1, shards)

    def gate_capture(self) -> None:
        """CheckpointGate + the capture loop of JobCheckpointManager.
        _capture: pause the routed primaries under control_mu, then
        stream each table off the (re-resolved) routed primary."""
        if self.gate_suspends:
            self.suspend()
        self.control_mu.acquire()
        targets = []
        try:
            _, shards = self.read_routing()
            targets = [sh["primary"] for sh in shards]
            for ep in targets:
                self.pause(ep, True)
            # two registered tables; each read re-resolves the topology
            # (RemoteSparseTable.refresh_routing under the gate)
            captured = []
            for tbl in range(2):
                _, now = self.read_routing()
                ep = now[0]["primary"]
                srv = self.servers[ep]
                with srv.pause_mu:
                    self.sched.check(
                        srv.pause_depth > 0,
                        f"torn cut: capture streamed table{tbl} from "
                        f"UNPAUSED {ep} — a mid-capture promotion routed "
                        "the capture (and the writers) to a backup the "
                        "gate never paused")
                    captured.append(srv.data)
            self.sched.check(
                captured[0] == captured[1],
                f"torn cut: tables captured at different data versions "
                f"{captured} — mutations landed between table streams")
        finally:
            for ep in reversed(targets):
                self.pause(ep, False)
            self.control_mu.release()
            if self.gate_suspends:
                self.resume_scans()

    def reshard_cutover(self) -> None:
        """ReshardController._cutover: suspend scans, flip the routing
        epoch under control_mu with sources paused."""
        with self.op_mu:
            self.suspend()
            prims = []
            try:
                self.control_mu.acquire()
                try:
                    epoch, shards = self.read_routing()
                    prims = [sh["primary"] for sh in shards]
                    for ep in prims:
                        self.pause(ep, True)
                    self.publish(epoch + 1, shards)   # the flip
                finally:
                    self.control_mu.release()
                # resume OUTSIDE control_mu (the real finally's order)
                for ep in reversed(prims):
                    self.pause(ep, False)
            finally:
                self.resume_scans()

    def writer(self) -> None:
        """A trainer push path: route, then mutate iff unpaused."""
        for _ in range(2):
            _, shards = self.read_routing()
            srv = self.servers[shards[0]["primary"]]
            with srv.pause_mu:
                if srv.pause_depth == 0:
                    srv.data += 1


def three_way_model(gate_suspends: bool = True, depth_counted: bool = True,
                    with_reshard: bool = True, with_writer: bool = True):
    """Model factory for Explorer: gate × failover × reshard (+writer).

    The writer widens the schedule space considerably; the systematic
    pb-2 sweep runs the pure three-way (``with_writer=False``, where
    the UNPAUSED-read check alone detects the torn cut) to exhaustion,
    and the random-walk sweep adds the writer back for data-version
    tears."""

    def model(sched):
        tw = _ThreeWay(sched, gate_suspends, depth_counted)
        sched.spawn(tw.gate_capture, name="gate")
        sched.spawn(tw.failover_step, name="failover")
        if with_reshard:
            sched.spawn(tw.reshard_cutover, name="reshard")
        if with_writer:
            sched.spawn(tw.writer, name="writer")

    return model


# ---------------------------------------------------------------------------
# 2. ServingFleet drain vs watcher tick (REAL class under the scheduler)
# ---------------------------------------------------------------------------

class _StubFrontend:
    def __init__(self):
        self.stopped = False

    def idle(self) -> bool:
        return True

    def stop(self) -> None:
        self.stopped = True


class _StubReplica:
    def close(self) -> None:
        pass

    def kill(self) -> None:
        pass


class _StubMember:
    """Duck-typed FleetMember: healthy, leased, no warm-handoff tier."""

    def __init__(self, ep: str) -> None:
        self.endpoint = ep
        self.frontend = _StubFrontend()
        self.replica = _StubReplica()
        self.lookup = None

    @property
    def healthy(self) -> bool:
        return True

    def stop(self) -> None:
        self.frontend.stop()

    def crash(self) -> None:
        self.frontend.stop()


class _StubRouter:
    def __init__(self):
        self._mu = _sync.Lock(name="router_mu")
        self._eps = []

    def attach(self, member) -> None:
        with self._mu:
            if member.endpoint not in self._eps:
                self._eps.append(member.endpoint)

    def eject(self, ep: str) -> None:
        with self._mu:
            if ep in self._eps:
                self._eps.remove(ep)

    def remove(self, ep: str) -> None:
        with self._mu:
            if ep in self._eps:
                self._eps.remove(ep)

    def endpoints(self):
        with self._mu:
            return list(self._eps)

    def inflight(self, ep: str) -> int:
        return 0


class _StubStore:
    """Both members hold live observer leases for the whole run."""

    def list_prefix(self, prefix: str):
        return [f"{prefix}m0", f"{prefix}m1"]


def fleet_drain_tick_model():
    """drain("m1") racing two watcher tick()s.  Starting state: m1 was
    ejected by the router on a transient error (the heal path's
    trigger), so every tick WANTS to re-admit it while the drain is
    taking it out on purpose.  Every interleaving must end with m1
    out of routing, out of membership, and stopped."""
    from ..serving.fleet import ServingFleet

    def model(sched):
        router = _StubRouter()
        fleet = ServingFleet(_StubStore(), "sched", lambda: None, router,
                             clock=lambda: 0.0, sleep=lambda s: None)
        m0, m1 = _StubMember("m0"), _StubMember("m1")
        fleet._members = {"m0": m0, "m1": m1}
        fleet._join_order = ["m0", "m1"]
        router._eps = ["m0"]           # m1 ejected on a transient error

        def drainer():
            fleet.drain("m1")

        def ticker():
            for _ in range(2):
                fleet.tick()

        sched.spawn(drainer, name="drain")
        sched.spawn(ticker, name="tick")

        def finish():
            assert "m1" not in router.endpoints(), \
                "drained member re-admitted to routing after drain()"
            assert "m1" not in fleet._members, \
                "drained member still in fleet membership"
            assert m1.frontend.stopped, "drained member never stopped"
            assert "m0" in router.endpoints(), \
                "healthy member m0 fell out of routing"
        sched.on_finish(finish)

    return model


# ---------------------------------------------------------------------------
# 3. JobCheckpointManager writer vs save()/stop() (REAL class)
# ---------------------------------------------------------------------------

def ssd_compact_model(two_phase: bool = True, with_shrink: bool = True):
    """Cold-tier background compactor (csrc/ssd_table.cc) in miniature:
    the two-phase compaction sweep racing a push-path rewrite, a
    promote-on-read, a save snapshot and (full variant) a lifecycle
    shrink, using the REAL lock names from the csrc declaration
    (``ssd_save_mu < mem_save_mu < shard_mu < disk_mu < bg_mu``, leaf
    ``io_mu``) so the dynamic checker validates the same ``// LOCK
    ORDER:`` declaration the source carries.

    ``two_phase=False`` reproduces the naive single-phase publisher
    (install the phase-A snapshot verbatim instead of reconciling
    against the live index under ``disk_mu``): a rewrite landing during
    the unlocked copy is reverted to its stale version, and a key
    promoted to RAM during the copy is resurrected on disk — the save
    snapshot then sees it in BOTH tiers.  The default (the shipped
    phase-B reconcile) must explore clean."""

    def model(sched):
        sh = _SsdShardModel(sched, two_phase)
        sched.spawn(sh.writer, name="push")
        sched.spawn(sh.bg_worker, name="bg")
        sched.spawn(sh.reader, name="pull")
        sched.spawn(sh.saver, name="save")
        if with_shrink:
            sched.spawn(sh.shrinker, name="shrink")

        def finish():
            assert sh.index_val("k0") == 2, \
                f"push-path rewrite lost: k0 is {sh.index_val('k0')!r} " \
                "on disk, last write was 2 — a compaction published a " \
                "stale phase-A copy over it"
            assert "k1" in sh.hot and "k1" not in sh.index, \
                "promoted key resurrected on disk by compaction " \
                f"(hot={'k1' in sh.hot}, cold={'k1' in sh.index})"
            assert sh.index_val("k2") == 1, "bystander row k2 lost"
        sched.on_finish(finish)

    return model


class _SsdShardModel:
    """One cold shard: append-only ``log`` of (key, flag, value)
    records (ordinal = position, flag 0 = dead), ``index`` key ->
    ordinal, ``hot`` the RAM tier.  A key lives in at most ONE tier."""

    def __init__(self, sched, two_phase: bool) -> None:
        self.sched = sched
        self.two_phase = two_phase
        self.save_mu = _sync.Lock(name="ssd_save_mu")
        self.mem_save_mu = _sync.Lock(name="mem_save_mu")
        self.shard_mu = _sync.Lock(name="shard_mu")
        self.disk_mu = _sync.Lock(name="disk_mu")
        self.bg_mu = _sync.Lock(name="bg_mu")
        self.io_mu = _sync.Lock(name="io_mu")
        # k0 will be rewritten by the push path, k1 promoted by the
        # read path, k2 is the bystander; ord 3 is pre-existing garbage
        # (the policy debt that seeds bg_dirty)
        self.log = [("k0", 1, 1), ("k1", 1, 1), ("k2", 1, 1),
                    ("k0", 0, 0)]
        self.index = {"k0": 0, "k1": 1, "k2": 2}
        self.hot = {"h0": 1}
        self.bg_dirty = 1
        self.bg_busy = False

    def index_val(self, key):
        ord_ = self.index.get(key)
        return None if ord_ is None else self.log[ord_][2]

    def _request_bg(self, level: int) -> None:
        with self.bg_mu:          # nested under shard_mu+disk_mu
            if self.bg_dirty < level:
                self.bg_dirty = level

    def _check_index(self) -> None:
        for key, ord_ in self.index.items():
            rec = self.log[ord_] if 0 <= ord_ < len(self.log) else None
            self.sched.check(
                rec is not None and rec[0] == key and rec[1] == 1,
                f"index[{key}] = {ord_} points at a dead or mismatched "
                "record after publish")

    # -- tasks ------------------------------------------------------------

    def writer(self) -> None:
        """Push path: rewrite k0's cold row (append + repoint), then
        hand the garbage to the worker (maybe_compact)."""
        with self.shard_mu:
            with self.disk_mu:
                self.sched.yield_point("push.rewrite")
                self.log.append(("k0", 1, 2))
                self.index["k0"] = len(self.log) - 1
                self._request_bg(1)

    def reader(self) -> None:
        """Pull path: serve k1 from disk (io charge — leaf lock under
        disk_mu), then promote it: hot insert + INDEX-ONLY erase."""
        with self.shard_mu:
            with self.disk_mu:
                with self.io_mu:   # charge_serve: leaf, never blocks
                    pass
                self.sched.yield_point("pull.promote")
                ord_ = self.index.pop("k1", None)
                if ord_ is not None:
                    self.hot["k1"] = self.log[ord_][2]

    def saver(self) -> None:
        """sst_save_begin: both save locks, then both tier locks per
        shard — the snapshot must see every key in exactly one tier."""
        with self.save_mu:
            with self.mem_save_mu:
                with self.shard_mu:
                    with self.disk_mu:
                        self.sched.yield_point("save.snapshot")
                        both = set(self.hot) & set(self.index)
                        self.sched.check(
                            not both,
                            f"save snapshot sees {sorted(both)} in BOTH "
                            "tiers — a compaction resurrected a "
                            "promoted key on disk")

    def shrinker(self) -> None:
        """sst_shrink's disk sweep: rewrite every live cold row, then
        force-request compaction of the garbage it just made."""
        with self.shard_mu:
            with self.disk_mu:
                for key in sorted(self.index):
                    val = self.log[self.index[key]][2]
                    self.sched.yield_point("shrink.rewrite")
                    self.log.append((key, 1, val))
                    self.index[key] = len(self.log) - 1
                self._request_bg(2)

    def bg_worker(self) -> None:
        """bg_main in miniature: two dirty-flag sweeps, each running
        the two-phase compaction off the flag set under bg_mu."""
        for _ in range(2):
            with self.bg_mu:
                dirty = self.bg_dirty
                self.bg_dirty = 0
                self.bg_busy = dirty > 0
            if dirty:
                self._compact_bg()
                with self.bg_mu:
                    self.bg_busy = False

    def _compact_bg(self) -> None:
        # phase A: snapshot under disk_mu
        with self.disk_mu:
            snap_log = list(self.log)
            snap_ords = sorted(self.index.values())
        # unlocked budgeted copy (io_mu = acquire_bg's token bucket)
        self.sched.yield_point("compact.copy")
        with self.io_mu:
            pass
        new_log = []
        new_of = {}
        for ord_ in snap_ords:
            key, flag, val = snap_log[ord_]
            if not flag:
                continue
            new_of[ord_] = len(new_log)
            new_log.append((key, flag, val))
        # phase B: reconcile against the LIVE index + swap, under the
        # lock.  The naive publisher skips reconciliation and installs
        # the snapshot's view verbatim.
        with self.disk_mu:
            self.sched.yield_point("compact.publish")
            if self.two_phase:
                fresh = {}
                for key, ord_ in self.index.items():
                    if ord_ not in new_of:
                        # appended/rewritten during the copy: take the
                        # live record now, under the lock
                        new_of[ord_] = len(new_log)
                        new_log.append(self.log[ord_])
                    fresh[key] = new_of[ord_]
            else:
                fresh = {snap_log[o][0]: n for o, n in new_of.items()}
            self.log = new_log
            self.index = fresh
            self._check_index()


def ckpt_writer_model(root: str = None):
    """Two save()s racing stop() over a depth-1 queue: admission is
    atomic under _mu, the backpressured put is lock-free, and stop()'s
    sentinel must land BEHIND every admitted snapshot."""
    from ..io.job_checkpoint import JobCheckpointManager

    base = root or os.path.join(tempfile.gettempdir(), "sched-ckpt-model")

    def model(sched):
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base, exist_ok=True)
        mgr = JobCheckpointManager(base, max_keep=4, queue_depth=1)
        written = []
        mgr._write = lambda snap: written.append(snap.ckpt_id)
        admitted = []

        def saver(step):
            try:
                admitted.append(mgr.save(step))
            except Exception:      # noqa: BLE001 — save-after-stop is a
                pass               # legal loser of the race

        def stopper():
            mgr.stop()

        sched.spawn(lambda: saver(1), name="saver1")
        sched.spawn(lambda: saver(2), name="saver2")
        sched.spawn(stopper, name="stop")

        def finish():
            assert set(admitted) <= set(written), \
                f"admitted snapshot lost: save() returned {admitted} but " \
                f"writer only wrote {written} — a snapshot landed behind " \
                "the shutdown sentinel"
            assert mgr._thread is None or not mgr._thread.is_alive(), \
                "writer thread survived stop()"
        sched.on_finish(finish)

    return model


# ---------------------------------------------------------------------------
# 4. declarative reconciler: proposers × serialized actuator × failover
# ---------------------------------------------------------------------------

class _ReconcilerModel:
    """ps/reconcile.py actuation protocol in miniature, REAL lock names
    (``_act_mu``, ``control_mu``, ``_step_mu``, ``_susp_mu``,
    ``_spec_mu``): proposers read-modify-write the versioned spec doc,
    actuator passes diff observed vs desired and sequence cutovers
    through ``begin_actuation`` (suspend scans, then ``control_mu``),
    and a lease-expiry failover scan races both.  ``serialized=False``
    reproduces the pre-reconciler world — two control loops each
    diffing and actuating directly, with no actuator mutex between
    diff and apply: both observe 2 shards with 4 desired and both
    admit the grow, so the second one actuates a STALE plan (the
    doubled-transition bug the single-actuator discipline removes).
    The default must explore clean."""

    def __init__(self, sched, serialized: bool) -> None:
        self.sched = sched
        self.serialized = serialized
        self.act_mu = _sync.Lock(name="_act_mu")
        self.control_mu = _sync.RLock(name="control_mu")
        self.step_mu = _sync.Lock(name="_step_mu")
        self.susp_mu = _sync.Lock(name="_susp_mu")
        self.spec_mu = _sync.Lock(name="_spec_mu")
        self.suspended = _sync.Event(name="suspended")
        self.susp_depth = 0
        self.spec = {"version": 0, "shards": 2, "trainer_np": 4}
        self.routing = {"epoch": 0, "shards": 2, "primary": "s0a"}
        # s0a's lease has expired; the scan WILL promote s0b if allowed
        self.alive = {"s0b"}

    # -- spec store (SpecStore.propose: rmw under _spec_mu) ---------------

    def read_spec(self) -> dict:
        self.sched.yield_point("spec.read")
        return dict(self.spec)

    def propose(self, field: str, value) -> None:
        with self.spec_mu:
            cur = dict(self.spec)
            self.sched.yield_point("spec.rmw")
            if cur[field] == value:
                return
            cur[field] = value
            cur["version"] = self.spec["version"] + 1
            self.spec = cur

    # -- routing + failover-suspend (HACluster/FailoverCoordinator) -------

    def publish(self, epoch: int, **delta) -> None:
        self.sched.yield_point("routing.publish")
        self.sched.check(
            epoch == self.routing["epoch"] + 1,
            f"routing clobbered: publish(epoch={epoch}) over live epoch "
            f"{self.routing['epoch']} — the routing table must stay "
            "single-writer (begin_actuation's suspend exists for this)")
        self.routing = dict(self.routing, epoch=epoch, **delta)

    def suspend(self) -> None:
        with self.susp_mu:
            self.susp_depth += 1
            self.suspended.set()
        with self.step_mu:
            pass            # barrier: in-flight scan finishes

    def resume_scans(self) -> None:
        with self.susp_mu:
            self.susp_depth = max(0, self.susp_depth - 1)
            if self.susp_depth == 0:
                self.suspended.clear()

    # -- tasks ------------------------------------------------------------

    def proposer_shards(self) -> None:
        """Autoscaler-as-proposer: desired shards 2 -> 4."""
        self.propose("shards", 4)

    def proposer_np(self) -> None:
        """Elastic-trainer proposer: desired trainer_np 4 -> 8."""
        self.propose("trainer_np", 8)

    def failover_step(self) -> None:
        """FailoverCoordinator.step(): promote the expired primary's
        backup unless actuation has the scans suspended."""
        with self.step_mu:
            if self.suspended.is_set():
                return
            self.sched.yield_point("scan.read")
            epoch = self.routing["epoch"]
            if self.routing["primary"] in self.alive:
                return
            self.sched.yield_point("scan.fence")
            self.publish(epoch + 1, primary="s0b")

    def actuator(self, who: str) -> None:
        """One reconcile pass: diff spec vs observed, actuate to
        convergence.  The real Reconciler holds ``_act_mu`` across the
        WHOLE diff-and-apply; the knob drops it."""
        if self.serialized:
            self.act_mu.acquire()
        try:
            self._reconcile_pass(who)
        finally:
            if self.serialized:
                self.act_mu.release()

    def _reconcile_pass(self, who: str) -> None:
        desired = self.read_spec()["shards"]
        self.sched.yield_point("reconcile.observe")
        observed = self.routing["shards"]
        while observed != desired:
            self.suspend()       # begin_actuation: scans first,
            try:                 # then the control mutex
                self.control_mu.acquire()
                try:
                    live = self.routing["shards"]
                    self.sched.check(
                        live == observed,
                        f"stale transition admitted by {who}: planned "
                        f"{'grow' if desired > observed else 'shrink'} "
                        f"from {observed} shards but the live topology "
                        f"has {live} — a second actuator applied the "
                        "step first (the actuator mutex + per-step "
                        "verification exist to refuse exactly this)")
                    new_n = live * 2 if desired > live else live // 2
                    self.publish(self.routing["epoch"] + 1, shards=new_n)
                finally:
                    self.control_mu.release()
            finally:
                self.resume_scans()
            self.sched.yield_point("reconcile.observe")
            observed = self.routing["shards"]


def reconciler_model(serialized: bool = True,
                     with_np_proposer: bool = True):
    """Model factory for Explorer: proposer(s) × two actuator passes ×
    lease-expiry failover.  The pb-2 sweep runs the lean variant (one
    proposer) to exhaustion; the random walk adds the trainer_np
    proposer back for spec-write interleavings."""

    def model(sched):
        rc = _ReconcilerModel(sched, serialized)
        sched.spawn(rc.proposer_shards, name="propose")
        if with_np_proposer:
            sched.spawn(rc.proposer_np, name="propose-np")
        sched.spawn(lambda: rc.actuator("act1"), name="act1")
        sched.spawn(lambda: rc.actuator("act2"), name="act2")
        sched.spawn(rc.failover_step, name="failover")

        def finish():
            assert rc.routing["shards"] in (2, 4), \
                f"topology overshot: {rc.routing['shards']} shards " \
                "(desired never exceeded 4) — doubled actuation"
            assert rc.spec["shards"] == 4, \
                f"shards proposal lost: spec says {rc.spec['shards']}"
            want_ver = 2 if with_np_proposer else 1
            assert rc.spec["version"] == want_ver, \
                f"spec version {rc.spec['version']} != {want_ver} — a " \
                "proposal was lost or double-counted under _spec_mu"
            if with_np_proposer:
                assert rc.spec["trainer_np"] == 8, \
                    "trainer_np proposal lost to a concurrent rmw"
        sched.on_finish(finish)

    return model
