"""The port's SLO-driven autoscaler (``paddle_tpu_torch.ps.autoscale``)
against the JAX package's, on the CPU: the cases of
``tests/test_autoscale.py``.

Each scenario is a function of a package namespace, run through both
packages with the same injected clock, the same alert sequence and a fake
controller over each package's ``MemoryStore``; the records compared with
``==`` are the ``step()`` decisions, the controller's operations, the
journal (its wall-clock fields ``t``/``wall_s`` dropped: they are checked
against the real clock instead) and the elastic store's keys and
desired-np targets.

Tolerance: exact (no floating-point arithmetic is compared).
"""

import importlib
import time
import types


def _pkg(root):
    m = lambda name: importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(elastic=m("distributed.elastic"), slo=m("obs.slo"),
                                 timeseries=m("obs.timeseries"), autoscale=m("ps.autoscale"))


JAX = _pkg("paddle_tpu")
PORT = _pkg("paddle_tpu_torch")


def both(scenario, *args):
    """The scenario's record through the JAX package, then the port's; they
    must be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want, f"port {got}\n!= JAX {want}"
    return got


class _FakeCluster:
    job_id = "as-test"

    def __init__(self, p, n=2):
        self.n = n
        self.store = p.elastic.MemoryStore()

    @property
    def num_shards(self):
        return self.n


class _FakeController:
    def __init__(self, p, n=2, fail=False):
        self.cluster = _FakeCluster(p, n)
        self.ops = []
        self.fail = fail

    def grow(self, factor):
        if self.fail:
            raise RuntimeError("boom")
        self.cluster.n *= factor
        self.ops.append(("grow", self.cluster.n))
        return {"cutover_pause_ms": 1.0, "bootstrap_s": 0.01}

    def shrink(self, factor):
        self.cluster.n //= factor
        self.ops.append(("shrink", self.cluster.n))
        return {"cutover_pause_ms": 1.0, "bootstrap_s": 0.01}


class _Alert:
    def __init__(self, rule):
        self.rule = rule


def _scaler(p, ctrl=None, **cfg_kw):
    ctrl = ctrl or _FakeController(p)
    t = [0.0]
    cfg = p.autoscale.AutoscaleConfig(min_shards=2, max_shards=8, cooldown_up_s=5.0,
                                      cooldown_down_s=10.0, clear_hold_s=4.0, **cfg_kw)
    return ctrl, t, p.autoscale.Autoscaler(ctrl, config=cfg, clock=lambda: t[0])


def _journal(a):
    return [{k: v for k, v in e.items() if k not in ("t", "wall_s")} for e in a.events]


def _record(ctrl, a, steps):
    return {"steps": steps, "ops": ctrl.ops, "n": ctrl.cluster.n, "journal": _journal(a),
            "errors": a.errors}


def _up_cooldown(p):
    ctrl, t, a = _scaler(p)
    steps = [a.step()]
    a.notify_fire(_Alert("step_time_p95"))
    steps.append(a.step())
    t[0] = 2.0
    steps.append(a.step())
    t[0] = 6.0
    steps.append(a.step())
    return _record(ctrl, a, steps)


def test_scale_up_on_alert_and_cooldown():
    got = both(_up_cooldown)
    assert got["steps"] == [None, "up", None, "up"] and got["n"] == 8


def _max_bound(p):
    ctrl, t, a = _scaler(p, ctrl=_FakeController(p, n=8))
    a.notify_fire(_Alert("serving_p99"))
    return _record(ctrl, a, [a.step()])


def test_max_bound_refuses_and_journals():
    got = both(_max_bound)
    assert got["steps"] == [None] and got["ops"] == []
    assert got["journal"][-1]["kind"] == "scale_refused"
    assert got["journal"][-1]["reason"] == "max_shards"


def _down(p):
    ctrl, t, a = _scaler(p)
    a.notify_fire(_Alert("step_time_p95"))
    steps = [a.step()]
    a.notify_clear(_Alert("step_time_p95"))
    for now in (2.0, 5.0, 11.0, 30.0):
        t[0] = now
        steps.append(a.step())
    return _record(ctrl, a, steps)


def test_scale_down_needs_quiet_hold_and_cooldown():
    got = both(_down)
    assert got["steps"] == ["up", None, None, "down", None] and got["n"] == 2


def _non_up(p):
    ctrl, t, a = _scaler(p)
    a.notify_fire(_Alert("checkpoint_staleness"))
    return _record(ctrl, a, [a.step()]), a.active_up_rules()


def test_non_up_rule_alerts_are_ignored():
    rec, active = both(_non_up)
    assert rec["steps"] == [None] and rec["ops"] == [] and active == []


def _must_clear(p):
    ctrl, t, a = _scaler(p)
    a.notify_fire(_Alert("replication_lag"))
    steps = [a.step()]
    t[0] = 100.0
    steps.append(a.step())
    t[0] = 200.0
    steps.append(a.step())
    return _record(ctrl, a, steps)


def test_alert_must_clear_before_down_even_after_cooldowns():
    got = both(_must_clear)
    assert got["steps"] == ["up", "up", None] and got["n"] == 8
    assert all(op != "shrink" for op, _ in got["ops"])


def _failed(p):
    ctrl = _FakeController(p, fail=True)
    _, t, a = _scaler(p, ctrl=ctrl)
    a.notify_fire(_Alert("step_time_p95"))
    steps = [a.step()]
    t[0] = 1.0
    steps.append(a.step())
    return _record(ctrl, a, steps)


def test_failed_scale_is_journaled_and_cooled_down():
    got = both(_failed)
    assert got["steps"] == [None, None] and got["errors"] == 1
    assert got["journal"][-1]["kind"] == "scale_failed"
    assert got["journal"][-1]["error"] == "RuntimeError: boom"


def _wall_and_tenant(p):
    ctrl = _FakeController(p)
    t = [0.0]
    cfg = p.autoscale.AutoscaleConfig(min_shards=2, max_shards=8, cooldown_up_s=5.0,
                                      cooldown_down_s=10.0, clear_hold_s=4.0)
    a = p.autoscale.Autoscaler(ctrl, config=cfg, clock=lambda: t[0], tenant="ctr_team")
    a.notify_fire(_Alert("step_time_p95"))
    before = time.time() - 1.0
    step = a.step()
    ev = a.events[-1]
    _, _, a2 = _scaler(p)
    a2.notify_fire(_Alert("step_time_p95"))
    a2.step()
    return {"step": step, "tenant": ev["tenant"], "wall": ev["wall_s"] >= before,
            "alias": ev["t"] == ev["wall_s"], "untagged": "tenant" not in a2.events[-1],
            "wall2": a2.events[-1]["wall_s"] >= before, "journal": _journal(a)}


def test_journal_wall_clock_and_tenant_labels():
    got = both(_wall_and_tenant)
    assert got["step"] == "up" and got["tenant"] == "ctr_team"
    assert got["wall"] and got["alias"] and got["untagged"] and got["wall2"]


def _mirror(p):
    ctrl, t, a = _scaler(p)
    a.notify_fire(_Alert("step_time_p95"))
    a.step()
    keys = ctrl.cluster.store.list_prefix("ps/as-test/scale/")
    import json

    return sorted(keys), [{k: v for k, v in json.loads(ctrl.cluster.store.get(k)).items()
                           if k not in ("t", "wall_s")} for k in sorted(keys)]


def test_journal_mirrors_into_elastic_store():
    keys, docs = both(_mirror)
    assert keys == ["ps/as-test/scale/1"] and docs[0]["kind"] == "scale"


def _trainer_np(p):
    ctrl = _FakeController(p)
    t = [0.0]
    cfg = p.autoscale.AutoscaleConfig(min_shards=2, max_shards=8, cooldown_up_s=1.0,
                                      trainer_np=lambda shards: shards * 2,
                                      elastic_job_id="job-x")
    a = p.autoscale.Autoscaler(ctrl, config=cfg, clock=lambda: t[0])
    a.notify_fire(_Alert("step_time_p95"))
    step = a.step()
    mgr = p.elastic.ElasticManager(ctrl.cluster.store, "job-x", np=2, host="h0", min_np=1,
                                   max_np=64)
    return {"step": step, "desired": mgr.desired_np(), "adopted": mgr.adopt_desired_np(),
            "np": mgr.np, "journal": _journal(a)}


def test_trainer_np_target_published():
    got = both(_trainer_np)
    assert got["step"] == "up" and got["desired"] == 8 and got["adopted"] and got["np"] == 8
    assert got["journal"][-1] == {"kind": "trainer_target", "np": 8, "shards": 4}


def _adopt(p):
    store = p.elastic.MemoryStore()
    mgr = p.elastic.ElasticManager(store, "j2", np=2, host="h0", min_np=2, max_np=4)
    out = [mgr.desired_np(), mgr.adopt_desired_np()]
    p.elastic.set_desired_np(store, "j2", 16)
    out += [mgr.adopt_desired_np(), mgr.np]
    store.put(mgr.member_key("h0"), "{}", ttl=10)
    store.put(mgr.member_key("h1"), "{}", ttl=10)
    p.elastic.set_desired_np(store, "j2", 2)
    out += [mgr.watch_once().name, mgr.np]
    return out


def test_elastic_adopt_clamps_and_watch_consumes():
    assert both(_adopt) == [None, False, True, 4, "HOLD", 2]


def _ring_with(p, values, t0=1000.0):
    ring = p.timeseries.MetricRing()
    for i, v in enumerate(values):
        ring.append({"metrics": {"g": {"type": "gauge", "series": [
            {"labels": {}, "value": v}]}}}, t=t0 + i)
    return ring, t0 + len(values) - 1


def _watchdog_drives(p):
    ring, now = _ring_with(p, [5.0, 5.0, 5.0])
    wd = p.slo.SloWatchdog(ring, [p.slo.SloRule("step_time_p95", "g", kind="threshold",
                                                agg="max", threshold=1.0,
                                                windows=((10.0, 1.0),))])
    ctrl, t, a = _scaler(p)
    wd.on_fire(a.notify_fire)
    wd.on_clear(a.notify_clear)
    fired = [al.rule for al in wd.evaluate(now=now)]
    active = a.active_up_rules()
    step = a.step()
    for i in range(3):
        ring.append({"metrics": {"g": {"type": "gauge", "series": [
            {"labels": {}, "value": 0.1}]}}}, t=now + 20 + i)
    wd.evaluate(now=now + 22)
    return {"fired": fired, "active": active, "step": step, "after": a.active_up_rules(),
            "journal": _journal(a)}


def test_watchdog_fire_and_clear_drive_autoscaler():
    got = both(_watchdog_drives)
    assert got["fired"] == ["step_time_p95"] and got["active"] == ["step_time_p95"]
    assert got["step"] == "up" and got["after"] == []


def _worker_thread(p):
    """The worker thread loops ``step()``: an alert wakes it at once (no
    poll period to wait out), and ``stop()`` joins it."""
    ctrl = _FakeController(p)
    cfg = p.autoscale.AutoscaleConfig(min_shards=2, max_shards=8, cooldown_up_s=3600.0)
    a = p.autoscale.Autoscaler(ctrl, config=cfg, poll_s=3600.0)
    import threading

    grew = threading.Event()
    real_grow = ctrl.grow

    def grow(factor):
        rec = real_grow(factor)
        grew.set()
        return rec

    ctrl.grow = grow
    with a:
        a.notify_fire(_Alert("step_time_p95"))
        assert grew.wait(30), "the worker never woke on the alert"
    return {"ops": ctrl.ops, "thread": a._thread, "journal": [e["kind"] for e in a.events]}


def test_autoscaler_worker_wakes_on_alert_and_stops():
    got = both(_worker_thread)
    assert got == {"ops": [("grow", 4)], "thread": None, "journal": ["scale"]}
