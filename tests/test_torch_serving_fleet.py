"""The serving fleet in the port (``paddle_tpu_torch.serving``: ``router``,
``fleet``, ``rollout``), the cases of ``tests/test_serving_fleet.py`` held
against the JAX package.

Each scenario is a function of a package namespace run through the JAX
package and through the port, and the records compared with ``==``:
routed members, counters, version counts, digests, served values, miss
counts. The router's ring and band hashes are the JAX module's bit for
bit, so the same endpoints and the same seeded ``rng`` give the same ring
and the same block owners (checked on the ring itself too).

Nothing waits on a sleep against a timing budget: a slow or failing
member is a lookup held on an event the test releases; the frontend's
drain rate runs on a clock patched into ``serving.frontend`` (a lookup
moves it 20 ms); lease expiry is a store delete and ``tick()``, except
the crash, which waits (bounded) for the dead member's own lease TTL.

The control plane over the fleet: the ``Autoscaler`` (``ps.autoscale``)
driving the replica count through ``FleetController`` on an injected
clock, the fleet SLO rules, and the router process's ``/metrics`` scrape
through ``obs.exporter``, parsed by the port's parser.
"""

import importlib
import random
import threading
import time
import types

import numpy as np
import pytest

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("jax_native")

WAIT_S = 15.0


def _pkg(root, tier_kw):
    m = lambda name: importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        serving=m("serving"), frontend_mod=m("serving.frontend"), ha=m("ps.ha"), rpc=m("ps.rpc"),
        elastic=m("distributed.elastic"), registry=m("obs.registry"), slo=m("obs.slo"),
        exporter=m("obs.exporter"), autoscale=m("ps.autoscale"),
        crc32c=m("io.fs").crc32c, enforce=m("core.enforce"),
        AccessorConfig=m("ps.accessor").AccessorConfig,
        SGDRuleConfig=m("ps.sgd_rule").SGDRuleConfig, TableConfig=m("ps.table").TableConfig,
        HotEmbeddingTier=m("ps.hot_tier").HotEmbeddingTier,
        HotTierConfig=m("ps.hot_tier").HotTierConfig, tier_kw=tier_kw)


JAX = _pkg("paddle_tpu", {})
PORT = _pkg("paddle_tpu_torch", {"device": "cpu"})


def both(scenario, *args):
    """The scenario's record through the JAX package, then the port's; they
    must be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want, f"port {got}\n!= JAX {want}"
    return got


def _wait(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# -- stub plumbing (router tests: no cluster) -----------------------------------------


class _StubLookup:
    """[n, 2] rows (key, key + tag). ``gate``: each lookup waits for it
    (a held member); ``fail``: the lookup raises after the gate."""

    def __init__(self, tag=0.0, gate=None, fail=False, clock_step=None):
        self.tag, self.gate, self.fail, self.clock_step = tag, gate, fail, clock_step
        self.calls = 0

    def lookup(self, keys):
        self.calls += 1
        if self.gate is not None:
            assert self.gate.wait(WAIT_S), "a held lookup was never released"
        if self.clock_step is not None:
            self.clock_step()
        if self.fail:
            raise RuntimeError("replica storage gone")
        k = keys.astype(np.float64)
        return np.stack([k, k + self.tag], axis=1).astype(np.float32)


class _FakeReplicaHandle:
    """Replica-shaped stub for FleetMember lifecycle tests."""

    class _Srv:
        stopped = False

    def __init__(self, endpoint):
        self.endpoint = endpoint
        self.server = self._Srv()

    def status(self):
        return {"endpoint": self.endpoint}

    def close(self):
        self.server.stopped = True

    def kill(self):
        self.server.stopped = True


class _StubMember:
    """Router-protocol member over a real frontend and a stub lookup."""

    def __init__(self, p, name, tag=0.5, model=None, lookup=None, **fe_kw):
        self.endpoint = name
        self.lookup = lookup or _StubLookup(tag)
        fe_kw.setdefault("max_batch", 8)
        fe_kw.setdefault("max_delay_us", 100)
        fe_kw.setdefault("queue_cap", 256)
        self.frontend = p.serving.ServingFrontend(
            self.lookup, config=p.serving.FrontendConfig(**fe_kw), replica_label=name)
        self.model = model

    @property
    def healthy(self):
        return not self.frontend.stopped

    def stop(self):
        self.frontend.stop()


def _router(p, **kw):
    kw.setdefault("rng", random.Random(0))
    cfg = kw.pop("config", None) or p.serving.RouterConfig()
    return p.serving.ServingRouter(cfg, **kw)


def _keys_for_block(block, shift=6, n=8):
    base = block << shift
    return np.arange(base, base + n, dtype=np.uint64)


def _counts(r, *names):
    st = r.stats()
    return {k: st[k] for k in names}


# -- router: affinity, bounded load, P2C, hedging, reroute ----------------------------


def _affinity(p):
    members = [_StubMember(p, f"m{i}") for i in range(3)]
    with _router(p) as r:
        for m in members:
            r.attach(m)
        try:
            picks = set()
            for _ in range(8):
                rr = r.submit(_keys_for_block(5), deadline_ms=5000)
                rr.result(10)
                picks.add(rr.tried[0])
            owners = []
            for b in range(48):
                rr = r.submit(_keys_for_block(b), deadline_ms=5000)
                rr.result(10)
                owners.append(rr.tried[0])
            return {"picks": sorted(picks), "owners": owners,
                    "counts": _counts(r, "sparse_ch", "errors", "reroutes", "routed")}
        finally:
            for m in members:
                m.stop()


def test_ch_affinity_same_block_same_member_blocks_spread():
    """Same block → same member every time; 48 blocks cover the fleet; the
    block owners are JAX's, member for member."""
    got = both(_affinity)
    assert len(got["picks"]) == 1 and set(got["owners"]) == {"m0", "m1", "m2"}
    assert got["counts"] == {"sparse_ch": 56, "errors": 0, "reroutes": 0, "routed": 56}


def test_ring_hash_is_process_stable():
    """Golden values pin the ring hash (no PYTHONHASHSEED), and the port's
    ring and band equal JAX's for the same endpoints."""
    from paddle_tpu.serving import router as jax_router
    from paddle_tpu_torch.serving.router import _splitmix64, _stable_str_hash

    assert _stable_str_hash("127.0.0.1:7001") == 17876159239217230246
    assert _stable_str_hash("127.0.0.1:7002") == 15823385287752048255
    rng = np.random.default_rng(18)
    for x in [0, 1, 2 ** 63, 2 ** 64 - 1, *rng.integers(0, 2 ** 63, 64).tolist()]:
        assert _splitmix64(int(x)) == jax_router._splitmix64(int(x))

    def ring(p):
        members = [_StubMember(p, f"127.0.0.1:{7000 + i}") for i in range(4)]
        with _router(p) as r:
            for m in members:
                r.attach(m)
            try:
                return {"ring": list(r._ring),
                        "band": [r.in_canary_band(b, 0.3) for b in range(512)]}
            finally:
                for m in members:
                    m.stop()

    got = both(ring)
    assert len(got["ring"]) == 4 * 64 and 0 < sum(got["band"]) < 512


def _bounded_load(p):
    members = [_StubMember(p, f"m{i}") for i in range(3)]
    with _router(p) as r:
        for m in members:
            r.attach(m)
        try:
            rr = r.submit(_keys_for_block(5), deadline_ms=5000)
            rr.result(10)
            home = rr.tried[0]
            with r._mu:
                r._members[home].inflight = 100  # saturate the home member
            rr2 = r.submit(_keys_for_block(5), deadline_ms=5000)
            rr2.result(10)
            with r._mu:
                r._members[home].inflight = 0
            rr3 = r.submit(_keys_for_block(5), deadline_ms=5000)
            rr3.result(10)
            return {"home": home, "diverted": rr2.tried[0], "back": rr3.tried[0]}
        finally:
            for m in members:
                m.stop()


def test_bounded_load_diverts_overloaded_member():
    got = both(_bounded_load)
    assert got["diverted"] != got["home"] and got["back"] == got["home"]


def _p2c(p):
    # m0's worker is held on a batch with a backlog queued behind it: P2C
    # (seeded rng) steers non-affinity traffic to m1
    gate = threading.Event()
    m0 = _StubMember(p, "m0", lookup=_StubLookup(gate=gate), max_batch=1, max_delay_us=10)
    m1 = _StubMember(p, "m1")
    with _router(p) as r:
        r.attach(m0)
        r.attach(m1)
        try:
            backlog = [m0.frontend.submit(_keys_for_block(1), deadline_ms=30000)
                       for _ in range(8)]
            _wait(lambda: m0.frontend.queue_depth == 7, "m0 never held its first batch")
            picks, routed = [], []
            for _ in range(12):
                rr = r.submit(_keys_for_block(2), deadline_ms=30000, affinity=False)
                if rr.tried[0] == "m1":
                    rr.result(30)
                picks.append(rr.tried[0])
                routed.append(rr)
            gate.set()
            for pr in backlog + routed:
                pr.result(30)
            return {"picks": picks, "dense_p2c": r.stats()["dense_p2c"]}
        finally:
            gate.set()
            m0.stop()
            m1.stop()


def test_p2c_dense_prefers_shallower_queue():
    got = both(_p2c)
    assert got["picks"].count("m1") > got["picks"].count("m0"), got["picks"]
    assert got["dense_p2c"] == 12


def _hedge(p):
    """The first choice is held; its hedge (the fast member) answers while
    it is still held; released, the slow answer is the deduped loser."""
    gate = threading.Event()
    slow = _StubMember(p, "slow", lookup=_StubLookup(tag=100.0, gate=gate))
    fast = _StubMember(p, "fast", tag=0.5)
    cfg = p.serving.RouterConfig(hedge_default_ms=20.0, hedge_min_samples=1 << 30)
    with _router(p, config=cfg) as r:
        r.attach(slow)
        r.attach(fast)
        try:
            block = next(b for b in range(64) if r._pick(
                p.serving.RoutedRequest(r, None, None, 1e4, b, "-")).endpoint == "slow")
            rr = r.submit(_keys_for_block(block), deadline_ms=10000)
            out = rr.result(10)
            held = not gate.is_set() and slow.lookup.calls == 1
            won = _counts(r, "hedges", "hedge_wins", "hedge_lost", "errors")
            gate.set()
            _wait(lambda: r.stats()["hedge_lost"] >= 1, "the loser was never counted")
            return {"block": block, "tags": (out[:, 1] - out[:, 0]).tolist(), "held": held,
                    "tried": rr.tried, "at_win": won,
                    "after": _counts(r, "hedges", "hedge_wins", "hedge_lost", "errors")}
        finally:
            gate.set()
            slow.stop()
            fast.stop()


def test_hedge_fires_after_budget_dedupes_and_meters():
    got = both(_hedge)
    assert got["held"] and np.allclose(got["tags"], 0.5)
    assert got["tried"] == ["slow", "fast"]
    assert got["at_win"] == {"hedges": 1, "hedge_wins": 1, "hedge_lost": 0, "errors": 0}
    assert got["after"]["hedge_lost"] == 1 and got["after"]["errors"] == 0


def _reroute(p):
    members = [_StubMember(p, f"m{i}") for i in range(3)]
    with _router(p) as r:
        for m in members:
            r.attach(m)
        try:
            rr = r.submit(_keys_for_block(7), deadline_ms=5000)
            rr.result(10)
            home = rr.tried[0]
            next(m for m in members if m.endpoint == home).stop()  # the member dies
            shapes = [r.submit(_keys_for_block(7), deadline_ms=5000).result(10).shape
                      for _ in range(4)]
            st = _counts(r, "reroutes", "errors")
            live = r.endpoints()
            for m in members:
                m.stop()
                r.remove(m.endpoint)
            try:
                r.submit(_keys_for_block(1), deadline_ms=1000)
                rejected = None
            except p.serving.RequestRejected as e:
                rejected = "no live" in str(e)
            return {"home": home, "shapes": shapes, "counts": st, "live": live,
                    "rejected": rejected}
        finally:
            for m in members:
                m.stop()


def test_failure_reroutes_and_ejects_dead_member():
    got = both(_reroute)
    assert got["shapes"] == [(8, 2)] * 4
    assert got["counts"]["reroutes"] >= 1 and got["counts"]["errors"] == 0
    assert got["home"] not in got["live"] and got["rejected"] is True


def _hedge_outstanding(p):
    """The held first choice fails after its hedge launched: the request
    stays open (no attempt left, but the hedge is out) and the hedge's
    answer is delivered."""
    bad_gate, ok_gate = threading.Event(), threading.Event()
    bad = _StubMember(p, "bad", lookup=_StubLookup(gate=bad_gate, fail=True), queue_cap=64)
    slow_ok = _StubMember(p, "slow-ok", lookup=_StubLookup(tag=0.5, gate=ok_gate))
    cfg = p.serving.RouterConfig(hedge_default_ms=20.0, hedge_min_samples=1 << 30,
                                 max_attempts=2)
    with _router(p, config=cfg) as r:
        r.attach(bad)
        r.attach(slow_ok)
        try:
            block = next(b for b in range(64) if r._pick(
                p.serving.RoutedRequest(r, None, None, 1e4, b, "-")).endpoint == "bad")
            rr = r.submit(_keys_for_block(block), deadline_ms=10000)
            _wait(lambda: r.stats()["hedges"] == 1 and slow_ok.lookup.calls == 1,
                  "the hedge never launched")
            bad_gate.set()
            _wait(lambda: r.inflight("bad") == 0, "the first choice never failed")
            open_after_failure = not rr.done()
            ok_gate.set()
            out = rr.result(10)
            return {"open": open_after_failure, "tags": (out[:, 1] - out[:, 0]).tolist(),
                    "errors": r.stats()["errors"]}
        finally:
            bad_gate.set()
            ok_gate.set()
            bad.stop()
            slow_ok.stop()


def test_failure_with_hedge_outstanding_waits_for_sibling():
    got = both(_hedge_outstanding)
    assert got["open"] and np.allclose(got["tags"], 0.5) and got["errors"] == 0


# -- fleet membership over stub handles -----------------------------------------------


def _stub_fleet(p, job, name):
    store = p.elastic.MemoryStore()
    sm = _StubMember(p, name)
    member = p.serving.FleetMember(_FakeReplicaHandle(name), sm.lookup, sm.frontend)
    router = _router(p)
    fleet = p.serving.ServingFleet(store, job, lambda: member, router)
    with fleet._mu:
        fleet._members[name] = member
        fleet._join_order.append(name)
    router.attach(member)
    return store, sm, member, router, fleet


def _drain_marker(p):
    store, sm, member, router, fleet = _stub_fleet(p, "dr-job", "dr1")
    try:
        store.put("ps/dr-job/obs/0/dr1", "{}", ttl=30.0)  # leased
        router.eject("dr1")
        fleet.tick()
        readmitted = "dr1" in router.endpoints()  # the transient-error heal
        router.eject("dr1")
        with fleet._mu:
            fleet._draining.add("dr1")
        fleet.tick()
        return {"readmitted": readmitted, "while_draining": "dr1" in router.endpoints()}
    finally:
        sm.stop()
        fleet.stop()
        router.stop()


def test_drain_marker_blocks_watcher_readmission():
    """``tick()`` re-admits a healthy leased member the router ejected, but
    not one ``drain()`` is taking out."""
    assert both(_drain_marker) == {"readmitted": True, "while_draining": False}


def _lease_grace(p):
    store, sm, member, router, fleet = _stub_fleet(p, "ev-job", "ev1")
    steps = []

    def note(what):
        steps.append((what, fleet.member("ev1") is member, member.healthy,
                      "ev1" in router.endpoints(live_only=False),
                      fleet.counters["crashes_removed"]))
    try:
        lease = "ps/ev-job/obs/0/ev1"
        store.put(lease, "{}", ttl=30.0)
        store.delete(lease)
        fleet.tick()
        note("miss 1")
        store.put(lease, "{}", ttl=30.0)
        fleet.tick()
        store.delete(lease)
        fleet.tick()
        note("hit, then miss 1 again")
        fleet.tick()
        note("miss 2")
        sm2 = _StubMember(p, "ev2")
        member2 = p.serving.FleetMember(_FakeReplicaHandle("ev2"), sm2.lookup, sm2.frontend)
        with fleet._mu:
            fleet._members["ev2"] = member2
            fleet._join_order.append("ev2")
        member2.replica.kill()  # the process is verifiably gone
        fleet.tick()
        steps.append(("dead member, miss 1", fleet.member("ev2") is None,
                      fleet.counters["crashes_removed"]))
        sm2.stop()
        return steps
    finally:
        sm.stop()
        fleet.stop()
        router.stop()


def test_lease_miss_grace_before_eviction():
    """Eviction needs ``evict_misses`` consecutive misses, a hit resets the
    count, and a verifiably dead member gets no grace."""
    assert both(_lease_grace) == [
        ("miss 1", True, True, True, 0), ("hit, then miss 1 again", True, True, True, 0),
        ("miss 2", False, False, False, 1), ("dead member, miss 1", True, 2)]


def _lifecycle(p):
    sm = _StubMember(p, "h1")
    rep = _FakeReplicaHandle("h1")
    member = p.serving.FleetMember(rep, sm.lookup, sm.frontend)
    rec = {"healthy": member.healthy, "resident": member.resident_keys().size}
    member.stop()
    rec.update(after=member.healthy, stopped=rep.server.stopped)
    return rec


def test_fleet_member_lifecycle_with_stub_handles():
    assert both(_lifecycle) == {"healthy": True, "resident": 0, "after": False,
                                "stopped": True}


def _lever(p):
    seq = iter(range(1, 100))

    def factory():
        name = f"as-m{next(seq)}"
        sm = _StubMember(p, name)
        return p.serving.FleetMember(_FakeReplicaHandle(name), sm.lookup, sm.frontend)

    store = p.elastic.MemoryStore()
    router = _router(p)
    fleet = p.serving.ServingFleet(store, "as-job", factory, router,
                                   config=p.serving.FleetConfig(min_replicas=2, max_replicas=8))
    try:
        ctl = fleet.controller()
        fleet.add(2, warm=False)
        up = ctl.grow(2)
        sizes = [fleet.size(), ctl.cluster.num_shards]
        down = ctl.shrink(2)
        try:
            ctl.shrink(2)
            refused = None
        except p.enforce.PreconditionNotMetError:
            refused = "PreconditionNotMetError"
        return {"joined": up["joined"], "sizes": sizes, "drained": down["drained"],
                "after": router.endpoints(), "refused": refused,
                "job": ctl.cluster.job_id}
    finally:
        fleet.stop()
        router.stop()


def test_fleet_controller_grow_shrink_lever():
    """The autoscaler's lever: grow doubles the replica count, shrink drains the newest first, and a
    shrink below ``min_replicas`` is refused."""
    got = both(_lever)
    assert got["joined"] == ["as-m3", "as-m4"] and got["sizes"] == [4, 4]
    assert got["drained"] == {"as-m4": True, "as-m3": True}
    assert got["after"] == ["as-m1", "as-m2"] and got["refused"] == "PreconditionNotMetError"
    assert got["job"] == "as-job/serving"


def _autoscaled(p):
    seq = iter(range(1, 100))

    def factory():
        name = f"as-m{next(seq)}"
        sm = _StubMember(p, name)
        return p.serving.FleetMember(_FakeReplicaHandle(name), sm.lookup, sm.frontend)

    store = p.elastic.MemoryStore()
    router = _router(p)
    fleet = p.serving.ServingFleet(store, "as-job", factory, router,
                                   config=p.serving.FleetConfig(min_replicas=2, max_replicas=8))
    t = [0.0]
    scaler = p.autoscale.Autoscaler(fleet.controller(), config=p.autoscale.AutoscaleConfig(
        min_shards=2, max_shards=8, up_rules=("fleet_serving_p99", "serving_p99"),
        cooldown_up_s=5.0, cooldown_down_s=10.0, clear_hold_s=4.0), clock=lambda: t[0])
    alert = lambda rule: types.SimpleNamespace(rule=rule)
    try:
        fleet.add(2, warm=False)
        steps = [scaler.step()]
        scaler.notify_fire(alert("fleet_serving_p99"))
        steps.append((scaler.step(), fleet.size()))
        t[0] = 2.0
        steps.append(scaler.step())
        scaler.notify_clear(alert("fleet_serving_p99"))
        t[0] = 4.0
        steps.append(scaler.step())
        t[0] = 20.0
        steps.append((scaler.step(), fleet.size()))
        return {"steps": steps, "members": router.endpoints(),
                # wall-clock fields and the measured bootstrap time dropped
                "journal": [{k: v for k, v in e.items() if k not in ("t", "wall_s", "bootstrap_s")}
                            for e in scaler.events],
                "stored": sorted(store.list_prefix("ps/as-job/serving/scale/"))}
    finally:
        fleet.stop()
        router.stop()


def test_autoscaler_drives_replica_count():
    """The autoscaler's hysteresis with the replica count as its actuator:
    an up-rule alert doubles the fleet, the cooldown and the quiet-hold
    hold it, and once both pass it drains back to ``min_replicas``; the
    journal lands in the serving namespace of the elastic store."""
    got = both(_autoscaled)
    assert got["steps"] == [None, ("up", 4), None, None, ("down", 2)]
    assert [e["kind"] for e in got["journal"]] == ["scale", "scale"]
    assert got["members"] == ["as-m1", "as-m2"] and got["stored"]


# -- the frontend's retry-after from the measured drain rate ---------------------------


def _retry_after(p):
    """Four 1-request batches, each lookup moving the patched clock 20 ms
    (a 50/s drain rate); then the worker is held on a fifth with 40
    queued behind it, and the queue fills to its cap of 64."""
    now = [1000.0]
    fake = types.SimpleNamespace(perf_counter=lambda: now[0], time=time.time,
                                 monotonic=time.monotonic, sleep=time.sleep)
    real, p.frontend_mod.time = p.frontend_mod.time, fake
    gate = threading.Event()
    gate.set()

    def step():
        now[0] += 0.02

    idle = _StubMember(p, "idle")
    busy = _StubMember(p, "busy", lookup=_StubLookup(gate=gate, clock_step=step),
                       max_batch=1, max_delay_us=10, queue_cap=64)
    try:
        floor = idle.frontend.retry_after_hint_ms()
        for _ in range(4):
            busy.frontend.submit(_keys_for_block(0), deadline_ms=30000).result(30)
        gate.clear()
        backlog = [busy.frontend.submit(_keys_for_block(0), deadline_ms=30000)]
        _wait(lambda: busy.frontend.queue_depth == 0 and busy.lookup.calls == 5,
              "the worker never took the held batch")
        backlog += [busy.frontend.submit(_keys_for_block(0), deadline_ms=30000)
                    for _ in range(40)]
        hint = busy.frontend.retry_after_hint_ms()
        shed = None
        try:
            for _ in range(80):
                backlog.append(busy.frontend.submit(_keys_for_block(0), deadline_ms=30000))
        except p.serving.RequestRejected as e:
            shed = e.retry_after_ms
        gate.set()
        for pr in backlog:
            pr.result(60)
        return {"floor": floor, "config_floor": idle.frontend.config.retry_after_ms,
                "hint": hint, "shed": shed, "queued_at_shed": len(backlog) - 1,
                "max": busy.frontend.config.retry_after_max_ms}
    finally:
        gate.set()
        idle.stop()
        busy.stop()
        p.frontend_mod.time = real


def test_retry_after_derived_from_drain_rate():
    """An idle frontend quotes the floor; a backlog quotes backlog / drain
    rate (40 queued at 50/s = 800 ms), and a shed carries the measured
    hint (the full queue of 64: 1280 ms), in both packages alike."""
    got = both(_retry_after)
    assert got["floor"] == got["config_floor"]
    assert got["hint"] == pytest.approx(800.0) and got["hint"] <= got["max"]
    assert got["queued_at_shed"] == 64 and got["shed"] == pytest.approx(1280.0)


# -- the fleet over a real cluster ----------------------------------------------------


def _cfg(p, dim=4):
    return p.TableConfig(shard_num=4, accessor_config=p.AccessorConfig(
        embedx_dim=dim, embedx_threshold=0.0, sgd=p.SGDRuleConfig(initial_range=0.01)))


def _push(rng, keys, width):
    push = np.zeros((len(keys), width), np.float32)
    push[:, 1] = 1.0
    push[:, 2:] = rng.normal(0, 0.1, (len(keys), width - 2)).astype(np.float32)
    return push


def _cluster(p, **kw):
    kw.setdefault("num_shards", 1)
    kw.setdefault("replication", 1)
    kw.setdefault("sync", True)
    return p.ha.HACluster(**kw)


def _wait_caught_up(cluster, serve_cli, table_id=0):
    def same():
        prim = cluster.primary(0)
        return cluster.digests(table_id, 0).get(prim.endpoint) == serve_cli.digest(table_id)[0]
    _wait(same, "a replica never caught up")


def _member_factory(p, cluster, capacity=1 << 11, model_flat=None):
    """A real member: a replica (fast lease), its caught-up serve view, a
    read-only tier and a CachedLookup, a frontend labelled by endpoint."""
    def build():
        rep = p.serving.ServingReplica(cluster.store, cluster.job_id, shard=0,
                                       hb_interval=0.05, hb_ttl=0.4)
        serve = rep.client()
        view = rep.serve_view(0, _cfg(p), client=serve)
        _wait_caught_up(cluster, serve)
        tier = p.HotEmbeddingTier(view, p.HotTierConfig(capacity=capacity,
                                                        create_on_miss=False), **p.tier_kw)
        cl = p.serving.CachedLookup(tier, replica=rep, freshness_budget_s=30.0)
        model = None if model_flat is None else p.serving.DenseModel(lambda f: f, model_flat)
        fe = p.serving.ServingFrontend(cl, config=p.serving.FrontendConfig(
            max_batch=16, max_delay_us=200, queue_cap=512, default_deadline_ms=5000.0),
            replica_label=rep.endpoint)
        return p.serving.FleetMember(rep, cl, fe, model=model)
    return build


def _preload(p, cli, keys, rng):
    cli.create_sparse_table(0, _cfg(p))
    cli.pull_sparse(0, keys)
    width = cli._dims(0)[1]
    cli.push_sparse(0, keys, _push(rng, keys, width))
    return width


def _join_drain_crash(p):
    with _cluster(p) as cluster:
        cli = cluster.client()
        rng = np.random.default_rng(0)
        keys = np.arange(512, dtype=np.uint64)
        _preload(p, cli, keys, rng)
        router = _router(p)
        fleet = p.serving.ServingFleet(cluster.store, cluster.job_id,
                                       _member_factory(p, cluster), router,
                                       config=p.serving.FleetConfig(poll_s=0.05))
        try:
            m1, m2 = fleet.add(2, warm=False)
            rec = {"size": fleet.size(),
                   "routed": set(router.endpoints()) == {m1.endpoint, m2.endpoint}}
            rec["served"] = [router.submit(keys[b * 64:b * 64 + 8], deadline_ms=5000)
                             .result(10).tolist() for b in range(8)]
            rec["drained_clean"] = fleet.drain(m1.endpoint)
            rec["after_drain"] = (fleet.size(), m1.endpoint in router.endpoints(),
                                  m1.endpoint in fleet._leased_endpoints())
            rec["survivor"] = router.submit(keys[:8], deadline_ms=5000).result(10).tolist()
            m2.crash()
            deadline = time.monotonic() + WAIT_S
            while fleet.members(live_only=False):  # the dead lease's own TTL
                fleet.tick()
                assert time.monotonic() < deadline, "the crashed member's lease never expired"
                time.sleep(0.05)
            rec["after_crash"] = (m2.endpoint in router.endpoints(live_only=False),
                                  fleet.counters["crashes_removed"])
            fleet.add(1, warm=False)
            rec["rejoined"] = router.submit(keys[:8], deadline_ms=5000).result(10).tolist()
            return rec
        finally:
            fleet.stop()
            router.stop()


def test_fleet_join_drain_and_crash_lease_removal():
    """Two members serve; a drain takes one out cleanly (lease released);
    a crash is found by its lapsed lease and removed; a fresh member
    joins. Every served row is JAX's, bit for bit (the same C++ rows)."""
    got = both(_join_drain_crash)
    assert got["size"] == 2 and got["routed"]
    assert all(np.asarray(v).shape == (8, 5) for v in got["served"])
    assert got["drained_clean"] and got["after_drain"] == (1, False, False)
    assert got["after_crash"] == (False, 1)
    assert got["rejoined"] == got["survivor"]


def _warm_vs_cold(p):
    with _cluster(p) as cluster:
        cli = cluster.client()
        rng = np.random.default_rng(1)
        keys = np.arange(1024, dtype=np.uint64)
        _preload(p, cli, keys, rng)
        router = _router(p)
        fleet = p.serving.ServingFleet(cluster.store, cluster.job_id,
                                       _member_factory(p, cluster), router,
                                       config=p.serving.FleetConfig(poll_s=0.05,
                                                                    warm_chunk=256))
        try:
            (seed,) = fleet.add(1, warm=False)
            for lo in range(0, len(keys), 64):  # season the peer
                seed.lookup.lookup(keys[lo:lo + 64])
            occ = seed.lookup.tier.stats()["occupancy"]
            (warm,) = fleet.add(1, warm=True)
            handoff = fleet.events[-1]["handoff"]
            w0 = warm.lookup.tier.counters["misses"]
            for lo in range(0, len(keys), 64):
                warm.lookup.lookup(keys[lo:lo + 64])
            warm_misses = warm.lookup.tier.counters["misses"] - w0
            (cold,) = fleet.add(1, warm=False)
            c0 = cold.lookup.tier.counters["misses"]
            for lo in range(0, len(keys), 64):
                cold.lookup.lookup(keys[lo:lo + 64])
            cold_misses = cold.lookup.tier.counters["misses"] - c0
            return {"occ": occ, "handoff": (handoff["rows"], handoff["chunks"]),
                    "warm_misses": warm_misses, "cold_misses": cold_misses,
                    "warm_rows": warm.lookup.lookup(keys[:64]).tolist(),
                    "cold_rows": cold.lookup.lookup(keys[:64]).tolist(),
                    "warm_counter": fleet.counters["warm_rows"]}
        finally:
            fleet.stop()
            router.stop()


def test_warm_handoff_beats_cold_join():
    """A warm join bulk-admits the peer's resident set and misses nothing
    on the working set; a cold join misses every row; the warm rows are the
    cold (feed-converged) reads bit for bit, and JAX's."""
    got = both(_warm_vs_cold)
    assert got["occ"] >= 1024 and got["handoff"][0] >= 1024
    assert got["warm_misses"] == 0 and got["cold_misses"] >= 1024
    assert got["warm_rows"] == got["cold_rows"]


# -- the rollout: canary, promote, rollback -------------------------------------------


def _model_member(p, name, dim=16):
    holder = {}
    model = p.serving.DenseModel(lambda f: f, np.arange(dim, dtype=np.float32), version=1,
                                 sink=lambda q: holder.__setitem__("p", q))
    m = _StubMember(p, name, model=model)
    m.holder = holder
    return m


def _with_members(p, names, fn):
    members = [_model_member(p, n) for n in names]
    with _router(p) as r:
        for m in members:
            r.attach(m)
        try:
            return fn(members, r)
        finally:
            for m in members:
                m.stop()


def _canary_split(p):
    def run(members, r):
        mgr = p.serving.RolloutManager(lambda: members, r,
                                       p.serving.RolloutConfig(canary_members=1))
        v1 = mgr.register_baseline(np.arange(16, dtype=np.float32))
        v2 = mgr.begin_canary(np.arange(16, dtype=np.float32) + 1.0, fraction=0.3)
        canary_eps = set(r.stats()["canary"]["endpoints"])
        blocks = list(range(400))
        expect = sum(r.in_canary_band(b, 0.3) for b in blocks)
        sides = []
        for b in blocks:
            rr = r.submit(_keys_for_block(b), deadline_ms=5000)
            rr.result(10)
            sides.append((rr.tried[0] in canary_eps) == r.in_canary_band(b, 0.3))
        return {"canary": sorted(canary_eps), "expect": expect, "all_sides": all(sides),
                "counts": r.stats()["version_counts"], "v": (v1, v2)}
    return _with_members(p, [f"c{i}" for i in range(4)], run)


def test_canary_split_exact_counted_per_version():
    """The routed side of every block matches the band predicate, and the
    split counted per version is exactly the predicate's."""
    got = both(_canary_split)
    v1, v2 = got["v"]
    assert len(got["canary"]) == 1 and got["all_sides"] and 0 < got["expect"] < 400
    assert got["counts"] == {str(v2): got["expect"], str(v1): 400 - got["expect"]}


def _promote_rollback(p):
    def run(members, r):
        mgr = p.serving.RolloutManager(lambda: members, r)
        flat1 = np.arange(16, dtype=np.float32)
        flat2 = flat1 + 2.0
        v1 = mgr.register_baseline(flat1)
        for m in members:
            m.model.set(v1, flat1)
        v2 = mgr.begin_canary(flat2, fraction=0.34)
        rec = {"mid": sorted(v for v, _ in mgr.fleet_versions().values()),
               "promoted": mgr.promote(), "after_promote": set(mgr.fleet_versions().values()),
               "open": mgr.canary_open(),
               "sinks2": all(np.array_equal(m.holder["p"], flat2) for m in members),
               "rolled": mgr.rollback(), "after_rollback": set(mgr.fleet_versions().values()),
               "sinks1": all(np.array_equal(m.holder["p"], flat1) for m in members),
               "dg": (p.crc32c(flat1.tobytes()), p.crc32c(flat2.tobytes()),
                      mgr.version_digest(v1)), "v": (v1, v2)}
        return rec
    return _with_members(p, [f"p{i}" for i in range(3)], run)


def test_promote_flips_fleet_rollback_digest_identical():
    """Promote flips every member to v2 (the sinks get its params);
    rollback restores v1 crc32c-identical on every member."""
    got = both(_promote_rollback)
    (v1, v2), (dg1, dg2, stored1) = got["v"], got["dg"]
    assert got["mid"] == [v1, v1, v2] and got["promoted"] == v2
    assert got["after_promote"] == {(v2, dg2)} and got["open"] is None and got["sinks2"]
    assert got["rolled"] == v1 and got["after_rollback"] == {(v1, dg1)} and got["sinks1"]
    assert stored1 == dg1


def _needs_baseline(p):
    def run(members, r):
        mgr = p.serving.RolloutManager(lambda: members, r)
        try:
            mgr.begin_canary(np.ones(8, np.float32))
            refused = None
        except p.enforce.PreconditionNotMetError as e:
            refused = "register_baseline" in str(e)
        v1 = mgr.register_baseline(np.zeros(8, np.float32))
        for m in members:
            m.model.set(v1, np.zeros(8, np.float32))
        mgr.begin_canary(np.ones(8, np.float32))
        return {"refused": refused, "healed": mgr.assert_assignments()}
    return _with_members(p, [f"nb{i}" for i in range(2)], run)


def test_canary_requires_registered_baseline():
    assert both(_needs_baseline) == {"refused": True, "healed": 0}


def _keep_baseline(p):
    def run(members, r):
        mgr = p.serving.RolloutManager(lambda: members, r)
        flat1 = np.zeros(8, np.float32)
        v1 = mgr.register_baseline(flat1)
        dg1 = mgr.version_digest(v1)
        for m in members:
            m.model.set(v1, flat1)
        for cycle in range(mgr.config.keep_versions + 2):
            mgr.begin_canary(np.full(8, cycle + 1.0, np.float32))
            mgr.rollback(reason="aborted")
        return {"current": mgr.current == v1, "digest": mgr.version_digest(v1) == dg1,
                "fleet": set(mgr.fleet_versions().values()) == {(v1, dg1)},
                "stored": len(mgr._store)}
    return _with_members(p, [f"ev{i}" for i in range(2)], run)


def test_version_store_never_evicts_live_baseline():
    got = both(_keep_baseline)
    assert got["current"] and got["digest"] and got["fleet"]


class _Alert:
    def __init__(self, rule):
        self.rule = rule


def _auto_rollback(p):
    def run(members, r):
        mgr = p.serving.RolloutManager(lambda: members, r)
        v1 = mgr.register_baseline(np.zeros(8, np.float32))
        for m in members:
            m.model.set(v1, np.zeros(8, np.float32))
        mgr.begin_canary(np.ones(8, np.float32))
        mgr._on_alert(_Alert("checkpoint_staleness"))  # not a guard rule
        still_open = mgr.canary_open() is not None
        mgr._on_alert(_Alert("fleet_serving_p99"))
        return {"still_open": still_open, "closed": mgr.canary_open() is None,
                "current": mgr.current == v1,
                "versions": sorted({v for v, _ in mgr.fleet_versions().values()}),
                "reason": mgr.events[-1]["reason"]}
    return _with_members(p, [f"g{i}" for i in range(2)], run)


def test_auto_rollback_on_fired_alert():
    """Any object with a ``rule`` is an alert: a guard rule's fire rolls an
    open canary back, another rule does nothing."""
    assert both(_auto_rollback) == {"still_open": True, "closed": True, "current": True,
                                    "versions": [1], "reason": "slo_alert:fleet_serving_p99"}


def _reattach(p):
    with _cluster(p, replication=2) as cluster:
        cli = cluster.client()
        rng = np.random.default_rng(3)
        keys = np.arange(256, dtype=np.uint64)
        width = _preload(p, cli, keys, rng)
        flat1 = np.arange(8, dtype=np.float32)
        flat2 = flat1 + 5.0
        router = _router(p)
        fleet = p.serving.ServingFleet(cluster.store, cluster.job_id,
                                       _member_factory(p, cluster, model_flat=flat1), router,
                                       config=p.serving.FleetConfig(poll_s=0.05))
        try:
            m1, m2 = fleet.add(2, warm=False)
            mgr = p.serving.RolloutManager(lambda: fleet.members(), router)
            fleet.rollout = mgr
            mgr.register_baseline(flat1)
            mgr.begin_canary(flat2, fraction=0.5)
            v2 = mgr.promote()
            dg2 = mgr.version_digest(v2)
            rec = {"promoted": set(mgr.fleet_versions().values()) == {(v2, dg2)}}
            prim = cluster.primary(0)
            epochs0 = {m.endpoint: m.replica.status()["epoch"] for m in (m1, m2)}
            prim.server.arm_fault("kill-shard", cmd=p.rpc._PUSH_SPARSE, after=2)
            for _ in range(4):
                cli.push_sparse(0, keys[:32], _push(rng, keys[:32], width))
            cluster.wait_promoted(0, prim.endpoint)
            for m in (m1, m2):
                _wait(lambda m=m: m.replica.status()["epoch"] > epochs0[m.endpoint],
                      "a replica never re-attached on the new epoch")
            m1.model.set(1, flat1)  # the re-attach rewrote one member's tower
            rec["drifted"] = mgr.fleet_versions()[m1.endpoint][0] != v2
            rec["healed"] = fleet.tick()["healed"]
            rec["after"] = set(mgr.fleet_versions().values()) == {(v2, dg2)}
            rec["serves"] = router.submit(keys[:8], deadline_ms=5000).result(10).shape
            return rec
        finally:
            fleet.stop()
            router.stop()


def test_reattached_replica_rejoins_at_correct_version():
    """A primary dies under the fleet; both replicas re-attach on the new
    epoch; the tick's assignment heal re-pins the drifted member to the
    promoted version, digest-checked, and the fleet serves on."""
    assert both(_reattach) == {"promoted": True, "drifted": True, "healed": 1,
                               "after": True, "serves": (8, 5)}


def _labels(p):
    m = _StubMember(p, "127.0.0.1:9999")
    try:
        m.frontend.submit(_keys_for_block(0), deadline_ms=5000).result(10)
        snap = p.registry.REGISTRY.snapshot()
        lat = snap["metrics"]["serving_latency_s"]["series"]
        adm = snap["metrics"]["serving_frontend_events"]["series"]
        return {"latency": any(s["labels"].get("replica") == "127.0.0.1:9999"
                               and s["labels"].get("recorder") == "frontend_request"
                               for s in lat),
                "admission": any(s["labels"].get("replica") == "127.0.0.1:9999" for s in adm)}
    finally:
        m.stop()


def _fleet_rules(p):
    rules = {r.name: r for r in p.slo.default_rules()}
    return {name: (rules[name].family, rules[name].labels, rules[name].kind,
                   rules[name].threshold, rules[name].windows)
            for name in ("fleet_serving_p99", "fleet_hedge_rate") if name in rules}


def test_per_replica_labels_and_fleet_slo_rules():
    """A frontend's latency and admission series carry its replica label,
    and the fleet's SLO rules read the router's end-to-end series and its
    hedges."""
    assert both(_labels) == {"latency": True, "admission": True}
    rules = both(_fleet_rules)
    assert rules["fleet_serving_p99"][1] == {"recorder": "router_request"}
    assert rules["fleet_hedge_rate"][0] == "serving_hedges"


def _router_scrape(p):
    import urllib.request

    members = [_StubMember(p, f"127.0.0.1:{7000 + i}") for i in range(2)]
    with _router(p) as r:
        for mm in members:
            r.attach(mm)
        exp = p.exporter.ObsExporter(lambda: p.registry.REGISTRY.snapshot()).start()
        try:
            for b in range(32):
                r.submit(_keys_for_block(b), deadline_ms=5000).result(10)
            with urllib.request.urlopen(exp.url + "/metrics", timeout=10) as resp:
                fams = p.exporter.parse_openmetrics(resp.read().decode())
            lat = [lbl for n, lbl, v in fams["serving_latency_s"]["samples"]
                   if lbl.get("recorder") == "router_member"]
            return {"size": "serving_fleet_size" in fams,
                    "router": "serving_router_events" in fams,
                    "replicas": {lbl["replica"] for lbl in lat} >= {m.endpoint for m in members}}
        finally:
            exp.stop()
            for mm in members:
                mm.stop()


def test_router_process_metrics_carries_fleet_view():
    """One scrape of the ROUTER process's exporter shows the fleet: the size
    gauge, the router's events and per-replica latency series."""
    assert both(_router_scrape) == {"size": True, "router": True, "replicas": True}
