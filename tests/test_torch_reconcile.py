"""The port's declarative control plane (``paddle_tpu_torch.ps``: ``spec``,
``reconcile``, ``simulate``) against the JAX package's, on the CPU: the
cases of ``tests/test_reconcile.py``.

Each scenario is a function of a package namespace, run through both
packages, and the records compared with ``==``: spec documents and
deltas, the planner's transitions, the spec log (its ``wall_s`` dropped),
``Reconciler.step`` results and journals (``wall_s`` dropped), the
simulated shard counts, aborts and stall counts, the postmortem
manifests' spec diffs, and the serving fleet's versions under a spec'd
canary. The reconciler runs on an injected clock (``step(now=)``) over
``SimCluster``/``SimController`` or a failing controller; the rollout
cases over a 4-member router fleet of real frontends. Both simulators
replay the two committed traces (``RESHARD.json``, ``RECSYS_E2E.json``:
input data the repo keeps) and must give the same timeline, the same
scale events and the same oscillation verdicts; the port's wall time is
held to the JAX test's 60 s budget.

The compound-transition chaos run of the JAX file is slow-marked there;
its counterpart here (``test_compound_transition_chaos_e2e_on_the_port``)
is slow-marked too and holds the port's compound run bitwise against the
port's own sequential oracle.

Tolerance: exact.
"""

import importlib
import json
import os
import random
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK = 0xFFFFFFFFFFFFFFFF


def _pkg(root):
    m = lambda name: importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, enforce=m("core.enforce"), flightrec=m("obs.flightrec"), slo=m("obs.slo"),
        registry=m("obs.registry"), timeseries=m("obs.timeseries"),
        reconcile=m("ps.reconcile"), simulate=m("ps.simulate"), spec=m("ps.spec"),
        autoscale=m("ps.autoscale"), serving=m("serving"))


JAX = _pkg("paddle_tpu")
PORT = _pkg("paddle_tpu_torch")


def both(scenario, *args):
    """The scenario's record through the JAX package, then the port's; they
    must be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want, f"port {got}\n!= JAX {want}"
    return got


@pytest.fixture(autouse=True)
def _clean_flightrec():
    yield
    JAX.flightrec.uninstall()
    PORT.flightrec.uninstall()


def _no_wall(events):
    return [{k: v for k, v in e.items() if k != "wall_s"} for e in events]


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the record is the error's name
        return type(e).__name__
    return None


# -- ClusterSpec: the document --------------------------------------------------------


def _roundtrip(p):
    s = p.spec.ClusterSpec(version=3, shards=4, replication=2, model_version=7,
                           canary={"version": 8, "fraction": 0.25},
                           placements={"0": "collective"}, trainer_np=16, origin="gameday")
    s2 = p.spec.ClusterSpec.from_json(s.to_json())
    c = s.copy()
    c.placements["1"] = "ps"
    return {"json": s.to_json(), "equal": s2 == s, "isolated": "1" not in s.placements}


def test_spec_roundtrip_and_copy_isolation():
    got = both(_roundtrip)
    assert got["equal"] and got["isolated"]


def _validate(p):
    C = p.spec.ClusterSpec
    bad = [C(shards=0), C(canary={"version": 2, "fraction": 1.5}), C(canary={"fraction": 0.25}),
           C(placements={"0": "gpu"}), C(trainer_np=0)]
    out = [_raises(s.validate) for s in bad]
    out.append(_raises(C(shards=8, canary={"version": 2, "fraction": 0.5},
                         placements={"0": "ps"}, trainer_np=4).validate))
    return out


def test_spec_validate_rejects_bad_documents():
    assert both(_validate) == ["PreconditionNotMetError"] * 5 + [None]


def _delta(p):
    C = p.spec.ClusterSpec
    a = C(version=1, shards=2, origin="operator")
    b = C(version=9, shards=4, origin="autoscaler")
    return p.spec.spec_delta(a, b), p.spec.spec_delta(a, a.copy())


def test_spec_delta_skips_version_and_origin():
    assert both(_delta) == ({"shards": {"from": 2, "to": 4}}, {})


# -- plan_transitions: the pure diff ----------------------------------------------------


def _obs(shards=2, stable=None, canary=None, placements=None, trainer_np=None):
    return {"shards": shards, "stable_version": stable, "canary": canary,
            "placements": placements or {}, "trainer_np": trainer_np}


def _plan(p, spec_kw, obs_kw):
    steps = p.spec.plan_transitions(p.spec.ClusterSpec(**spec_kw), _obs(**obs_kw))
    return [(s.kind, s.detail) for s in steps]


def test_plan_grow_is_one_factor_step():
    assert both(_plan, {"shards": 8}, {"shards": 2}) == \
        [("reshard_grow", {"factor": 4, "from": 2, "to": 8})]


def test_plan_shrink_chains_halvings():
    got = both(_plan, {"shards": 2}, {"shards": 8})
    assert [k for k, _ in got] == ["reshard_shrink", "reshard_shrink"]
    assert [d["to"] for _, d in got] == [4, 2]


def test_plan_unreachable_is_surfaced_not_dropped():
    assert [k for k, _ in both(_plan, {"shards": 3}, {"shards": 2})] == ["unreachable"]
    assert both(_plan, {"shards": 4}, {"shards": 6}) == \
        [("unreachable", {"field": "shards", "from": 6, "to": 4})]


def test_plan_canary_moves_precede_the_reshard():
    got = both(_plan, {"shards": 4, "model_version": 1,
                       "canary": {"version": 2, "fraction": 0.25}},
               {"shards": 2, "stable": 1})
    assert [k for k, _ in got] == ["canary_open", "reshard_grow"]


def test_plan_canary_clear_promotes_or_rolls_back():
    obs = {"stable": 1, "canary": {"version": 2, "fraction": 0.25}}
    assert [k for k, _ in both(_plan, {"shards": 2, "model_version": 2}, obs)] == \
        ["canary_promote"]
    assert [k for k, _ in both(_plan, {"shards": 2, "model_version": 1}, obs)] == \
        ["canary_rollback"]


def test_plan_canary_retarget_is_rollback_then_open():
    got = both(_plan, {"shards": 2, "model_version": 1,
                       "canary": {"version": 3, "fraction": 0.5}},
               {"stable": 1, "canary": {"version": 2, "fraction": 0.25}})
    assert [k for k, _ in got] == ["canary_rollback", "canary_open"]
    assert got[1][1] == {"version": 3, "fraction": 0.5}


def test_plan_canary_open_skipped_when_already_stable():
    assert both(_plan, {"shards": 2, "model_version": 2,
                        "canary": {"version": 2, "fraction": 0.25}}, {"stable": 2}) == []


def test_plan_placement_and_trainer_lever():
    got = both(_plan, {"shards": 2, "placements": {"0": "collective", "1": "ps"},
                       "trainer_np": 8}, {"trainer_np": 4})
    assert got == [("placement", {"table": "0", "target": "collective"}),
                   ("trainer_np", {"np": 8})]


# -- SpecStore: single-writer versioning ------------------------------------------------


def _init_clobber(p):
    cluster = p.simulate.SimCluster(2, job_id="specstore-a")
    st = p.spec.SpecStore(cluster.store, cluster.job_id)
    st.initialize(p.spec.ClusterSpec(version=0, shards=2))
    return _raises(lambda: st.initialize(p.spec.ClusterSpec(version=0, shards=4))), \
        st.read().to_json()


def test_spec_store_initialize_refuses_clobber():
    err, doc = both(_init_clobber)
    assert err == "PreconditionNotMetError" and json.loads(doc)["shards"] == 2


def _dedup(p):
    cluster = p.simulate.SimCluster(2, job_id="specstore-b")
    st = p.spec.SpecStore(cluster.store, cluster.job_id)
    st.initialize(p.spec.ClusterSpec(version=0, shards=2))
    seen = []
    st.subscribe(seen.append)

    def noop(s):
        s.shards = 2

    def grow(s):
        s.shards = 4

    out = {"noop": st.propose("autoscaler", noop).version, "log0": st.log(), "seen0": len(seen)}
    new = st.propose("autoscaler", grow)
    out.update(new=(new.version, new.origin), seen=[s.version for s in seen],
               log=_no_wall(st.log()), again=st.propose("autoscaler", grow).version,
               log_len=len(st.log()))
    return out


def test_spec_store_propose_dedups_and_journals():
    got = both(_dedup)
    assert got["noop"] == 0 and got["log0"] == [] and got["seen0"] == 0
    assert got["new"] == (1, "autoscaler") and got["seen"] == [1]
    assert got["log"] == [{"version": 1, "origin": "autoscaler",
                           "delta": {"shards": {"from": 2, "to": 4}}}]
    assert got["again"] == 1 and got["log_len"] == 1


# -- Reconciler against duck-typed fakes --------------------------------------------------


def _sim_rig(p, job_id, shards=2, **kw):
    clock = p.simulate.SimClock()
    cluster = p.simulate.SimCluster(shards, job_id=job_id)
    ctrl = p.simulate.SimController(cluster, clock)
    rec = p.reconcile.Reconciler(cluster, ctrl, clock=clock.now,
                                 sleep=lambda s: clock.advance(s), **kw)
    rec.capture()
    return clock, cluster, ctrl, rec


def _capture(p):
    _, cluster, _, rec = _sim_rig(p, "cap-a")
    spec = rec.capture()
    first = (spec.version, spec.shards, spec.origin)
    rec.propose_shards(4)
    return first, rec.capture().version


def test_capture_is_idempotent_version_zero():
    assert both(_capture) == ((0, 2, "capture"), 1)


def _grow(p):
    _, cluster, ctrl, rec = _sim_rig(p, "grow-a")
    spec = rec.propose_shards(8, origin="operator")
    out = {"version": spec.version, "converged0": rec.converged(), "done": rec.step(now=0.0),
           "shards": cluster.num_shards, "converged": rec.converged(),
           "stall": rec.stalled_ticks(), "journal": _no_wall(rec.events),
           "mirror": json.loads(cluster.store.get("ps/grow-a/reconcile/1")).get("kind"),
           "ops": ctrl.ops}
    return out


def test_reconcile_grow_converges_in_one_pass():
    got = both(_grow)
    assert got["version"] == 1 and not got["converged0"] and got["done"] == 1
    assert got["shards"] == 8 and got["converged"] and got["stall"] == 0
    (tr,) = [e for e in got["journal"] if e["kind"] == "transition"]
    assert tr["transition"] == "reshard_grow" and tr["spec_version"] == 1
    assert tr["info"]["to_shards"] == 8 and got["mirror"] == "transition"


def _shrink(p):
    _, cluster, ctrl, rec = _sim_rig(p, "shrink-a", shards=8)
    rec.propose_shards(2)
    return rec.step(now=0.0), cluster.num_shards, [op["to_shards"] for op in ctrl.ops], \
        _no_wall(rec.events)


def test_reconcile_shrink_chain_verified_per_step():
    done, n, tos, _ = both(_shrink)
    assert (done, n, tos) == (2, 2, [4, 2])


def _np_lever(p):
    _, cluster, _, rec = _sim_rig(p, "np-a", elastic_job_id="np-a-job",
                                  trainer_np_fn=lambda n: 2 * n)
    rec.propose_shards(4)
    done = rec.step(now=0.0)
    return {"done": done, "np": rec.observe()["trainer_np"],
            "kinds": [e["transition"] for e in rec.events if e["kind"] == "transition"],
            "journal": _no_wall(rec.events)}


def test_reconcile_trainer_np_lever():
    got = both(_np_lever)
    assert got["done"] == 2 and got["np"] == 8
    assert got["kinds"] == ["reshard_grow", "trainer_np"]


def _as_proposer(p):
    clock, cluster, ctrl, rec = _sim_rig(p, "as-a")
    cfg = p.autoscale.AutoscaleConfig(min_shards=1, max_shards=8, cooldown_up_s=30.0)
    scaler = p.autoscale.Autoscaler(ctrl, config=cfg, clock=clock.now, proposer=rec)
    scaler.notify_fire(types.SimpleNamespace(rule="step_time_p95"))
    out = {"step": scaler.step(now=0.0), "shards0": cluster.num_shards}
    spec = rec.spec_store.read()
    out["spec"] = (spec.version, spec.shards, spec.origin)
    out["proposed"] = [{k: v for k, v in e.items() if k not in ("t", "wall_s")}
                       for e in scaler.events if e["kind"] == "scale_proposed"]
    out["rec"] = rec.step(now=0.0)
    out["shards1"] = cluster.num_shards
    out["steps"] = [scaler.step(now=1.0), scaler.step(now=31.0)]
    out["final"] = rec.spec_store.read().shards
    return out


def test_autoscaler_proposes_and_reconciler_actuates():
    got = both(_as_proposer)
    assert got["step"] == "up" and got["shards0"] == 2 and got["spec"] == (1, 4, "autoscaler")
    assert len(got["proposed"]) == 1 and got["proposed"][0]["spec_version"] == 1
    assert got["rec"] == 1 and got["shards1"] == 4
    assert got["steps"] == [None, "up"] and got["final"] == 8


class _FailController:
    """grow/shrink raise until ``healed`` — the abort/stall rigs."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.healed = False
        self.calls = 0

    def grow(self, factor, replication=None):
        self.calls += 1
        if not self.healed:
            raise RuntimeError("cutover refused (injected)")
        self.cluster._n *= int(factor)
        return {"to_shards": self.cluster._n, "cutover_pause_ms": 1.0}

    def shrink(self, divisor=2):
        raise RuntimeError("cutover refused (injected)")


def _manifests(fr):
    return [json.load(open(os.path.join(b, "manifest.json"))) for b in fr.bundles()]


def _abort(p, root):
    fr = p.flightrec.install(p.flightrec.FlightRecorder(os.path.join(root, p.root),
                                                        min_interval_s=0.0))
    cluster = p.simulate.SimCluster(2, job_id="abort-a")
    ctrl = _FailController(cluster)
    rec = p.reconcile.Reconciler(cluster, ctrl, abort_backoff_s=5.0)
    rec.capture()
    rec.propose_shards(4)
    out = {"first": rec.step(now=0.0), "aborts": rec.aborts()}
    man = next(m for m in _manifests(fr) if m["reason"] == "spec_abort")
    out["diff"] = man["info"]["spec_diff"]
    out["backoff"] = [(rec.step(now=1.0), ctrl.calls), (rec.step(now=6.0), ctrl.calls),
                      rec.aborts()]
    ctrl.healed = True
    out["healed"] = (rec.step(now=12.0), cluster.num_shards, rec.converged(),
                     rec.stalled_ticks())
    out["journal"] = _no_wall(rec.events)
    return out


def test_abort_journals_dumps_bundle_and_backs_off(tmp_path):
    got = both(_abort, str(tmp_path))
    assert got["first"] == 0 and got["aborts"] == 1
    ab = [e for e in got["journal"] if e["kind"] == "spec_abort"]
    assert len(ab) == 2 and "cutover refused" in ab[0]["error"]
    assert ab[0]["transition"] == "reshard_grow"
    assert got["diff"]["shards"] == {"from": 2, "to": 4}
    assert got["backoff"] == [(0, 1), (0, 2), 2]
    assert got["healed"] == (1, 4, True, 0)


def _stall(p, root):
    fr = p.flightrec.install(p.flightrec.FlightRecorder(os.path.join(root, p.root),
                                                        min_interval_s=0.0))
    cluster = p.simulate.SimCluster(2, job_id="stall-a")
    ctrl = _FailController(cluster)
    rec = p.reconcile.Reconciler(cluster, ctrl, stall_ticks=3, abort_backoff_s=0.0)
    rec.capture()
    rec.propose_shards(4)
    steps = [rec.step(now=float(i)) for i in range(8)]
    stalled = rec.stalled_ticks()
    stalls = [e for e in _no_wall(rec.events) if e["kind"] == "reconcile_stall"]
    mans = [m["info"]["spec_diff"] for m in _manifests(fr) if m["reason"] == "reconcile_stall"]
    ctrl.healed = True
    return {"steps": steps, "stalled": stalled, "stalls": stalls, "mans": mans,
            "healed": (rec.step(now=9.0), rec.stalled_ticks())}


def test_stall_detection_dumps_once_per_episode(tmp_path):
    got = both(_stall, str(tmp_path))
    assert got["steps"] == [0] * 8 and got["stalled"] == 8
    assert len(got["stalls"]) == 1 and got["stalls"][0]["ticks"] == 4
    assert got["stalls"][0]["pending"] == ["reshard_grow"]
    assert len(got["mans"]) == 1 and got["mans"][0]["shards"]["to"] == 4
    assert got["healed"] == (1, 0)


def _unreachable(p):
    _, cluster, _, rec = _sim_rig(p, "unreach-a")
    rec.propose_shards(3)
    return rec.step(now=0.0), rec.aborts(), \
        [e["error"] for e in rec.events if e["kind"] == "spec_abort"], cluster.num_shards


def test_unreachable_spec_aborts_with_the_reason():
    done, aborts, errors, n = both(_unreachable)
    assert (done, aborts, n) == (0, 1, 2) and "unreachable" in errors[0]


def _stall_rule(p):
    reg = p.registry.Registry()
    reg.gauge("reconcile_stall_ticks", job="slo-a").set(12.0)
    ring = p.timeseries.MetricRing()
    ring.append(reg.snapshot(), t=100.0)
    rules = [r for r in p.slo.default_rules() if r.name == "reconcile_stall"]
    wd = p.slo.SloWatchdog(ring, rules)
    return len(rules), [(a.rule, a.windows) for a in wd.evaluate(now=100.0)]


def test_reconcile_stall_slo_rule_fires():
    n, fired = both(_stall_rule)
    assert n == 1 and [r for r, _ in fired] == ["reconcile_stall"]


# -- the rollout guard as proposer (the serving plane under spec control) ------------------


def _serving_rig(p, rec_factory):
    """4-member router-protocol fleet over real frontends, a
    RolloutManager, and a Reconciler wired as its proposer."""
    S = p.serving

    class _Lookup:
        def lookup(self, keys):
            k = keys.astype(np.float64)
            return np.stack([k, k + 0.5], axis=1).astype(np.float32)

    class _Member:
        def __init__(self, name, flat):
            self.endpoint = name
            self.lookup = _Lookup()
            self.frontend = S.ServingFrontend(self.lookup, config=S.FrontendConfig(
                max_batch=8, max_delay_us=100, queue_cap=256), replica_label=name)
            self.model = S.DenseModel(lambda f: f, flat.copy(), version=1,
                                      sink=lambda q: None)

        @property
        def healthy(self):
            return not self.frontend.stopped

        def stop(self):
            self.frontend.stop()

    flat1 = np.arange(16, dtype=np.float32)
    flat2 = flat1 + 2.0
    members = [_Member(f"m{i}", flat1) for i in range(4)]
    router = S.ServingRouter(S.RouterConfig(), rng=random.Random(0))
    for m in members:
        router.attach(m)
    rollout = S.RolloutManager(lambda: members, router, S.RolloutConfig(canary_members=1))
    v1 = rollout.register_baseline(flat1)
    for m in members:
        m.model.set(v1, flat1)
    rec = rec_factory(rollout, lambda v: {2: flat2}[v])
    if rec is not None:
        rollout.set_proposer(rec)
    return members, router, rollout, rec


def _guard(p):
    cluster = p.simulate.SimCluster(2, job_id="guard-a")
    members, router, rollout, rec = _serving_rig(
        p, lambda ro, src: p.reconcile.Reconciler(cluster, None, rollout=ro, model_source=src))
    try:
        rec.capture()
        rec.propose_canary(2, 0.25)
        out = {"open": (rec.step(now=0.0), rollout.canary_open())}
        rollout._on_alert(types.SimpleNamespace(rule="serving_p99"))
        out["proposed"] = (rec.spec_store.read().canary, rollout.canary_open(),
                           [e["reason"] for e in rec.events if e["kind"] == "rollback_proposed"])
        out["rolled"] = (rec.step(now=1.0), rollout.canary_open(),
                         sorted(v for v, _ in rollout.fleet_versions().values()))
        out["journal"] = _no_wall(rec.events)
        return out
    finally:
        for m in members:
            m.stop()
        router.stop()


def test_rollout_guard_rolls_back_through_the_spec():
    got = both(_guard)
    assert got["open"] == (1, 2)
    assert got["proposed"] == (None, 2, ["slo_alert:serving_p99"])
    assert got["rolled"] == (1, None, [1, 1, 1, 1])


def _promote(p):
    cluster = p.simulate.SimCluster(2, job_id="promote-a")
    members, router, rollout, rec = _serving_rig(
        p, lambda ro, src: p.reconcile.Reconciler(cluster, None, rollout=ro, model_source=src))
    try:
        rec.capture()
        rec.propose_canary(2, 0.25)
        first = rec.step(now=0.0)
        rec.propose_promote()
        return {"steps": [first, rec.step(now=1.0)], "canary": rollout.canary_open(),
                "stable": rollout.stable_version(),
                "versions": sorted(v for v, _ in rollout.fleet_versions().values()),
                "converged": rec.converged(), "journal": _no_wall(rec.events)}
    finally:
        for m in members:
            m.stop()
        router.stop()


def test_spec_promote_flips_the_fleet():
    got = both(_promote)
    assert got["steps"] == [1, 1] and got["canary"] is None and got["stable"] == 2
    assert got["versions"] == [2, 2, 2, 2] and got["converged"]


# -- the policy simulator: the committed traces at 1000-shard scale ------------------------


STOCK = dict(min_shards=256, max_shards=1024)


def _sim(p, cfg_kw, profile, base_shards, kw=None):
    make = getattr(p.simulate, profile)
    path = os.path.join(REPO, "RESHARD.json" if profile == "diurnal_wave_profile"
                        else "RECSYS_E2E.json")
    res = p.simulate.simulate(p.autoscale.AutoscaleConfig(**STOCK, **cfg_kw),
                              make(path, base_shards=base_shards), **(kw or {}))
    return {"timeline": res.timeline, "events": res.scale_events, "final": res.final_shards,
            "spec_version": res.spec_version, "over": res.over_slo_fraction,
            "ticks": res.ticks, "osc15": res.oscillations(window_s=15.0),
            "osc_all": res.oscillations(window_s=None), "max": res.max_shards_seen(),
            "fast": res.wall_s < 60.0}


def test_sim_diurnal_wave_stock_policy_is_stable():
    got = both(_sim, {}, "diurnal_wave_profile", 512)
    assert got["fast"] and got["events"] and got["max"] == 1024 and got["final"] < 1024
    assert got["osc15"] == 0 and all(t["shards"] >= 256 for t in got["timeline"])
    assert got["spec_version"] >= 1


def test_sim_hysteresis_inversion_caught_as_oscillation():
    kw = dict(fire_after_ticks=1, clear_after_ticks=1)
    stock = both(_sim, {}, "diurnal_wave_profile", 256, kw)
    broken = both(_sim, dict(cooldown_up_s=0.0, cooldown_down_s=0.0, clear_hold_s=0.0),
                  "diurnal_wave_profile", 256, kw)
    assert stock["osc15"] == 0 and broken["osc15"] >= 5
    assert len(broken["events"]) > len(stock["events"])


def test_sim_flash_crowd_scales_up_and_recovers():
    got = both(_sim, {}, "flash_crowd_profile", 256)
    assert got["fast"] and got["max"] > 256 and got["osc15"] == 0 and got["final"] >= 256
    assert got["spec_version"] >= len(got["events"])


# -- the compound transition under chaos (slow) --------------------------------------------


def _stream_data(n, S, D, seed=0):
    from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc

    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ids = rng.integers(0, 48, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                              + [f"1 {label}"]))
    slots = ([SlotDesc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [SlotDesc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [SlotDesc("label", is_float=True, max_len=1)])
    ds = InMemoryDataset(slots, seed=0)
    ds.load_from_lines(lines)
    return ds


def _stream_trainer(cli, cluster, S=3, D=2):
    import torch

    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer

    comm = SyncCommunicator(cli)
    base_send = comm.send_sparse

    def send_and_drain(table_id, keys, values):
        # sync replication made airtight per batch: nothing is
        # acked-but-unshipped when the chaos kill fires
        base_send(table_id, keys, values)
        cluster.drain()

    comm.send_sparse = send_and_drain
    comm.start()
    torch.manual_seed(0)
    model = DeepFM(CtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=8, dnn_hidden=(8,)))
    tr = CtrStreamTrainer(model, Adam(1e-2), None, communicator=comm, table_id=0, embedx_dim=8,
                          sparse_slots=[f"s{i}" for i in range(S)],
                          dense_slots=[f"d{i}" for i in range(D)], label_slot="label",
                          device="cpu")
    return tr, comm


@pytest.mark.slow
def test_compound_transition_chaos_e2e_on_the_port():
    """Canary open (v2 at 0.25) + grow 2→4 proposed as ONE spec update
    while a CtrStreamTrainer streams (sync replication) and a kill-shard
    faultpoint fires mid-bootstrap: the port's reconciler sequences
    canary-before-reshard at the same spec version, the coordinator's
    promotion repairs observed state under the in-flight transition, and
    the result is bit-identical to the port's sequential direct-primitive
    oracle — rows, content digest, pulled probe, dense params."""
    from paddle_tpu_torch.ps import ha, rpc
    from paddle_tpu_torch.ps.reshard import ReshardController
    from paddle_tpu_torch.ps.table import TableConfig

    p = PORT
    S, D, EPOCHS, BLOCKS = 3, 2, 4, 64

    def run(compound):
        with ha.HACluster(num_shards=2, replication=2, sync=True) as c:
            members = router = rec = comm = None
            try:
                cli = c.client()
                cli.create_sparse_table(0, TableConfig(table_id=0, shard_num=4,
                                                       accessor="ctr"))
                ctrl = ReshardController(c)
                if compound:
                    members, router, rollout, rec = _serving_rig(
                        p, lambda ro, src: p.reconcile.Reconciler(
                            c, ctrl, rollout=ro, model_source=src, poll_s=0.02).start())
                else:
                    members, router, rollout, _ = _serving_rig(p, lambda ro, src: None)
                tr, comm = _stream_trainer(cli, c, S, D)
                steps = 0
                for e in range(EPOCHS):
                    if e == 1:
                        if compound:
                            c.primary(0).server.arm_fault("kill-shard", cmd=rpc._SAVE_ALL,
                                                          after=1)

                            def mut(s):
                                s.canary = {"version": 2, "fraction": 0.25}
                                s.shards = 4
                            assert rec.propose("e2e", mut).version == 1
                        else:
                            rollout.begin_canary(np.arange(16, dtype=np.float32) + 2.0,
                                                 fraction=0.25)
                            ctrl.grow(2)
                    out = tr.train_from_dataset(_stream_data(768, S, D, seed=e),
                                                batch_size=128)
                    steps += out["steps"]
                if compound:
                    assert rec.wait_converged(120.0), list(rec.events)
                    trans = [e for e in rec.events if e["kind"] == "transition"]
                    kinds = [t["transition"] for t in trans]
                    assert kinds.index("canary_open") < kinds.index("reshard_grow")
                    assert {t["spec_version"] for t in trans} == {1}
                    assert c.coordinator.promotions >= 1
                    assert any(e["kind"] == "observed_repair" for e in rec.events)
                comm.barrier()
                c.drain()
                assert len(c.routing.read()[1]) == 4
                assert rollout.canary_open() == 2
                expect = sum(router.in_canary_band(b, 0.25) for b in range(BLOCKS))
                for b in range(BLOCKS):
                    router.submit(np.arange(b << 6, (b << 6) + 8, dtype=np.uint64),
                                  deadline_ms=5000).result(10)
                counts = router.stats()["version_counts"]
                assert counts.get("2", 0) == expect, (counts, expect)
                probe = np.unique((np.arange(0, 48, dtype=np.uint64)[None, :]
                                   + (np.arange(S, dtype=np.uint64)[:, None]
                                      << np.uint64(32))).reshape(-1))
                pulled = cli.pull_sparse(0, probe, create=False)
                digest = sum(cli.digest(0)) & MASK
                params = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
                return pulled, params, digest, cli.size(0), steps
            finally:
                if rec is not None:
                    rec.stop()
                if comm is not None:
                    comm.stop()
                if members is not None:
                    for m in members:
                        m.stop()
                if router is not None:
                    router.stop()

    p_c, w_c, d_c, n_c, s1 = run(compound=True)
    p_o, w_o, d_o, n_o, s2 = run(compound=False)
    assert s1 == s2 and n_c == n_o and d_c == d_o
    np.testing.assert_array_equal(p_c, p_o)
    assert sorted(w_c) == sorted(w_o)
    for k in w_c:
        assert bool((w_c[k] == w_o[k]).all()), k
