"""The port's observability plane (``paddle_tpu_torch.obs``), its fault
points and its auto-checkpoint, on the CPU, against the JAX package.

- The registry: the port's and the JAX package's take the same sequence
  of counter, gauge and histogram operations (labels, custom and default
  buckets, a cardinality overflow, ``CounterGroup`` increments and a
  lower write) and give equal ``snapshot()`` dicts but for the process's
  identity (pid, host, uptime). ``FLAGS_obs_metrics=0`` gives the null
  handle in both. The hot tier's counters land in the registry.
- Trace spans: the same span tree exports to chrome-trace events of the
  same shape in both packages (names, phases, categories, argument keys,
  the flow event of a span that crossed the wire, parent links).
- The flight recorder: bundles, rate limit, GC and restart numbering,
  the hook surface, a fired faultpoint, a ``CtrStreamTrainer`` exception
  (a bundle with ``batches_done`` in it), SIGTERM in a subprocess; its
  ``client=`` source puts the PS shards' server spans in the bundle's
  trace; its ``ring=``/``watchdog=`` sources fill ``timeline.json`` and
  ``alerts.json`` as the JAX recorder's do from the same ring and rules.
- Faultpoints: the flag's parser and the scheduling (after, every,
  count) against the JAX module's.
- ``auto_checkpoint``: the JAX tests' counterparts, and a
  ``train_epoch_range`` of either package resumes at the same epoch and
  step over the other's saves.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.core.flags import get_flags as jax_get_flags
from paddle_tpu.core.flags import set_flags as jax_set_flags
from paddle_tpu.io.auto_checkpoint import TrainEpochRange as JaxTrainEpochRange
from paddle_tpu.obs import registry as jax_registry
from paddle_tpu.obs import trace as jax_trace
from paddle_tpu.ps import faultpoints as jax_fp
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.io.auto_checkpoint import (CheckpointSaver, TrainEpochRange,
                                                 train_epoch_range)
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.obs import flightrec, registry, trace
from paddle_tpu_torch.obs.flightrec import FlightRecorder
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import faultpoints as fp
from paddle_tpu_torch.ps.hot_tier import HotTierConfig
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _clean_hooks():
    yield
    flightrec.uninstall()
    fp.disarm_faultpoints()
    jax_fp.disarm_faultpoints()
    for t in (trace, jax_trace):
        t.stop_tracing()
        t.drain_spans()


# -- the registry ----------------------------------------------------------------


def _drive(reg_mod):
    """One sequence of registry operations; returns the snapshot."""
    reg = reg_mod.Registry()
    reg.set_role("trainer")
    c = reg.counter("reqs", table="0")
    c.inc()
    c.inc(4)
    assert reg.counter("reqs", table="0") is c
    reg.counter("reqs", table="1").inc(2)
    g = reg.gauge("density", table="0")
    for v in (1.0, 0.5, 0.25):
        g.set(v)
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    hd = reg.histogram("step_s")
    for v in np.linspace(1e-5, 20.0, 37):
        hd.observe(float(v))
    for i in range(7):   # 4 series admitted, 3 collapse into the overflow
        reg.counter("noisy", max_series=4, k=str(i)).inc(i + 1)
    grp = reg_mod.CounterGroup("events", ("hits", "misses"), registry=reg, tier="1")
    grp["hits"] += 3
    grp["misses"] += 1
    grp["hits"] = 0      # a lower write resets the local window only
    grp["hits"] += 2
    assert grp["hits"] == 2 and dict(grp.items())["misses"] == 1
    with pytest.raises(ValueError):
        reg.gauge("reqs")   # a kind mismatch on an existing family
    return reg.snapshot()


def test_registry_snapshot_equals_jax():
    got, want = _drive(registry), _drive(jax_registry)
    for snap in (got, want):
        proc = snap.pop("process")
        assert proc["pid"] == os.getpid() and proc["role"] == "trainer"
        assert set(proc) == {"role", "pid", "host", "uptime_s"}
    assert got == want
    series = {s["labels"].get("key"): s["value"] for s in got["metrics"]["events"]["series"]}
    assert series == {"hits": 5, "misses": 1}   # the registry stays monotonic
    assert got["metrics"]["noisy"]["dropped_series"] == 3


@pytest.mark.parametrize("mod", [registry, jax_registry], ids=["port", "jax"])
def test_registry_reset_exports_only_later_handles(mod):
    """After ``reset()`` a handle made before it keeps counting but is not
    exported; families made after it are, from zero (a bench round that
    wants its own series alone in the process registry)."""
    reg = mod.Registry()
    old = reg.counter("reqs", table="0")
    old.inc(3)
    reg.histogram("lat", buckets=(0.1, 1.0)).observe(0.5)
    reg.reset()
    old.inc(2)
    assert old.value == 5 and reg.snapshot()["metrics"] == {}
    reg.counter("reqs", table="0").inc()
    reg.gauge("density").set(0.5)
    got = reg.snapshot()["metrics"]
    assert set(got) == {"reqs", "density"}
    assert got["reqs"]["series"] == [{"labels": {"table": "0"}, "value": 1}]


@pytest.mark.parametrize("mod_flags", ["port", "jax"])
def test_disabled_metrics_give_the_null_handle(mod_flags):
    reg_mod, get, put = ((registry, get_flags, set_flags) if mod_flags == "port"
                         else (jax_registry, jax_get_flags, jax_set_flags))
    was = get(["obs_metrics"])["obs_metrics"]
    put({"obs_metrics": False})
    try:
        reg = reg_mod.Registry()
        c = reg.counter("fam")
        c.inc(100)
        assert c.value == 0 and reg.snapshot()["metrics"] == {}
        assert reg.gauge("g") is reg.histogram("h") is c   # one shared null handle
        assert not reg_mod.metrics_enabled()
    finally:
        put({"obs_metrics": was})


def test_obs_flags_match_jax():
    names = ["obs_metrics", "obs_max_series", "ps_faultpoints"]
    assert get_flags(names) == jax_get_flags(names)


def test_hot_tier_counters_land_in_the_registry():
    table = MemorySparseTable(TableConfig(shard_num=2))
    model = DeepFM(CtrConfig(3, 2, 8, (8,)), generator=torch.Generator().manual_seed(0))
    tr = CtrStreamTrainer(model, Adam(1e-2), table, hot_tier=HotTierConfig(capacity=256),
                          device="cpu", **_names())
    tr.train_from_dataset(_dataset(128), batch_size=64)
    st = tr.hot_tier.stats()
    assert st["misses"] > 0 and isinstance(st["misses"], int)
    tier = [s for s in registry.snapshot()["metrics"]["hot_tier_events"]["series"]
            if s["labels"]["key"] == "misses" and s["value"] == st["misses"]]
    assert tier, "the tier's misses are not in the registry"
    hist = registry.snapshot()["metrics"]["trainer_step_time_s"]["series"]
    assert sum(s["count"] for s in hist) >= 2


# -- trace spans -------------------------------------------------------------------


def _span_tree(tr_mod):
    tr_mod.start_tracing(sample=1.0)
    with tr_mod.span("step") as root:
        root.add_attr("batch", 3)
        with tr_mod.span("pull", kind="client") as s:
            s.add_bytes(tx=10, rx=20)
            assert tr_mod.wire_context() == (s.trace_id, s.span_id)
        with tr_mod.span("push", kind="client"):
            tr_mod.mark_retried()
    tr_mod.stop_tracing()
    assert tr_mod.wire_context() == (0, 0)
    spans = tr_mod.drain_spans()
    return spans, tr_mod.spans_to_chrome(spans, pid=3, process_name="trainer")


def _shape(spans, events):
    by_id = {s.span_id: s.name for s in spans}
    parents = sorted((s.name, by_id.get(s.parent_id)) for s in spans)
    shape = [(e["name"], e["ph"], e.get("cat"), e["pid"], sorted(e.get("args", {})))
             for e in events]
    return parents, shape


def test_span_tree_exports_chrome_of_the_same_shape(tmp_path):
    got_spans, got = _span_tree(trace)
    want_spans, want = _span_tree(jax_trace)
    assert _shape(got_spans, got) == _shape(want_spans, want)
    assert len({s.trace_id for s in got_spans}) == 1
    push = [s for s in got_spans if s.name == "push"][0]
    assert push.attrs == {"retried": True, "retries": 1}
    # the file export drains the ring and anchors the clock
    trace.start_tracing()
    with trace.span("x"):
        pass
    path = trace.export_chrome_trace(str(tmp_path / "t.json"), process_name="p")
    blob = json.load(open(path))
    assert blob["clockSyncUs"] == trace.EPOCH_ANCHOR_US
    assert [e["name"] for e in blob["traceEvents"]] == ["process_name", "x"]
    assert trace.drain_spans() == []


def test_unsampled_root_suppresses_child_spans():
    trace.start_tracing(sample=0.0)
    with trace.span("root") as r:
        assert r is None
        with trace.span("child") as c:
            assert c is None and trace.wire_context() == (0, 0)
    assert trace.drain_spans() == []


def test_span_ring_is_bounded():
    trace.start_tracing(sample=1.0, ring=4)
    for i in range(10):
        with trace.span(f"s{i}"):
            pass
    assert [s.name for s in trace.peek_spans()] == ["s6", "s7", "s8", "s9"]
    assert trace.dropped_spans() == 6


# -- the flight recorder -----------------------------------------------------------


def test_trigger_dumps_parseable_atomic_bundle(tmp_path):
    rec = FlightRecorder(str(tmp_path), min_interval_s=0.0)
    rec.note("transport_error", shard=0, endpoint="127.0.0.1:1")
    trace.start_tracing(sample=1.0)
    with trace.span("incident_step"):
        pass
    path = rec.trigger("unit_test", detail="x")
    assert path is not None and os.path.isdir(path)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["reason"] == "unit_test" and man["info"]["detail"] == "x"
    assert man["process"]["pid"] == os.getpid()
    assert set(man["files"]) == {"trace.json", "timeline.json", "alerts.json", "events.json"}
    names = {e.get("name") for e in json.load(open(os.path.join(path, "trace.json")))
             ["traceEvents"]}
    assert {"incident_step", "EVENT transport_error"} <= names
    assert any(s.name == "incident_step" for s in trace.peek_spans())  # peeked, not drained
    assert json.load(open(os.path.join(path, "timeline.json"))) == {"records": []}
    assert json.load(open(os.path.join(path, "alerts.json"))) == {"alerts": []}
    ev = json.load(open(os.path.join(path, "events.json")))["events"]
    assert ev[0]["kind"] == "transport_error"


def _ring_watchdog_bundle(root, source, pkg):
    """One bundle of ``pkg``'s recorder over a ring of three registry ticks
    (a counter, a gauge, a histogram whose last two ticks burn) and a
    watchdog that fired on it; the bundle's timeline and alerts, and the
    manifest's file list."""
    import importlib

    reg_mod = importlib.import_module(f"{pkg}.obs.registry")
    ts = importlib.import_module(f"{pkg}.obs.timeseries")
    slo = importlib.import_module(f"{pkg}.obs.slo")
    rec_mod = importlib.import_module(f"{pkg}.obs.flightrec")
    reg = reg_mod.Registry()
    c, g = reg.counter("c"), reg.gauge("lag")
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    ring = ts.MetricRing()
    for i, v in enumerate((0.05, 5.0, 5.0)):
        c.inc(3)
        g.set(10.0 * i)
        h.observe(v)
        ring.append(reg.snapshot(), t=1.0 + i)
    wd = slo.SloWatchdog(ring, [slo.SloRule("lat_p", "lat", threshold=1.0, budget=0.25,
                                            windows=((2.5, 1.0),), labels=None)])
    wd.evaluate(now=3.0)
    rec = rec_mod.FlightRecorder(os.path.join(root, pkg), min_interval_s=0.0,
                                 **{source: ring if source == "ring" else wd})
    path = rec.trigger("unit_test")
    man = json.load(open(os.path.join(path, "manifest.json")))
    return {"timeline": json.load(open(os.path.join(path, "timeline.json"))),
            "alerts": json.load(open(os.path.join(path, "alerts.json"))),
            "files": man["files"]}


@pytest.mark.parametrize("source", ["ring", "watchdog"])
def test_ring_and_watchdog_sources_fill_the_bundle(tmp_path, source):
    """``ring=`` fills ``timeline.json`` with the ring's delta records and
    ``watchdog=`` ``alerts.json`` with its alert log, equal to the JAX
    recorder's bundle from the same ticks and rules; the other file stays
    empty."""
    got = _ring_watchdog_bundle(str(tmp_path), source, "paddle_tpu_torch")
    assert got == _ring_watchdog_bundle(str(tmp_path), source, "paddle_tpu")
    if source == "ring":
        assert [r["t"] for r in got["timeline"]["records"]] == [1.0, 2.0, 3.0]
        assert got["alerts"] == {"alerts": []}
    else:
        assert got["timeline"] == {"records": []}
        assert [a["rule"] for a in got["alerts"]["alerts"]] == ["lat_p"]


def test_client_source_bundles_server_spans(tmp_path):
    """``client=`` (ported with ``obs/aggregate.py``): a bundle's trace
    holds each shard's server spans on its own lane, each a flow finish
    bound to the traced client span it served, and the peek leaves the
    shards' rings for the next bundle; a dead shard is skipped."""
    from paddle_tpu_torch.obs import aggregate
    from paddle_tpu_torch.ps import rpc

    servers = [rpc.NativePsServer() for _ in range(2)]
    cli = rpc.RpcPsClient([f"127.0.0.1:{s.port}" for s in servers])
    try:
        cli.create_sparse_table(0, TableConfig(shard_num=4))
        keys = np.arange(1, 65, dtype=np.uint64)
        trace.start_tracing(sample=1.0)
        with trace.span("step"):
            cli.pull_sparse(0, keys)
        trace.stop_tracing()
        rec = FlightRecorder(str(tmp_path), client=cli, min_interval_s=0.0)
        blob = json.load(open(os.path.join(rec.trigger("test"), "trace.json")))
        evs = blob["traceEvents"]
        served = [e for e in evs if e["name"] == "ps_server_pull_sparse"]
        assert sorted(e["pid"] for e in served) == [1, 2]
        pull = next(e for e in evs if e["name"] == "pserver_client_pull_sparse")
        assert {e["id"] for e in evs if e.get("ph") == "f"} == {int(pull["args"]["span_id"], 16)}
        assert all(len(aggregate.fetch_server_obs(cli, s, drain=False)[1]) == 1 for s in range(2))
        servers[1].stop()
        was = get_flags(["pserver_timeout_ms"])
        set_flags({"pserver_timeout_ms": 500})  # the dead shard's call fails fast
        try:
            blob = json.load(open(os.path.join(rec.trigger("dead shard"), "trace.json")))
        finally:
            set_flags(was)
        assert {e["pid"] for e in blob["traceEvents"]
                if e["name"] == "ps_server_pull_sparse"} == {1}
    finally:
        trace.drain_spans()
        cli.close()
        for s in servers:
            s.stop()
            s.close()


def test_rate_limit_gc_and_restart_numbering(tmp_path):
    rec = FlightRecorder(str(tmp_path), min_interval_s=3600.0, keep=2)
    p1 = rec.trigger("first")
    assert p1 is not None
    assert rec.trigger("suppressed") is None
    assert rec.suppressed == 1
    rec2 = FlightRecorder(str(tmp_path), min_interval_s=0.0, keep=2)
    p2, p3 = rec2.trigger("second"), rec2.trigger("third")
    assert [os.path.basename(p) for p in (p1, p2, p3)] == [
        "postmortem_1", "postmortem_2", "postmortem_3"]
    assert [os.path.basename(b) for b in rec2.bundles()] == ["postmortem_2", "postmortem_3"]


def test_module_hooks_and_dump_on_policy(tmp_path):
    assert flightrec.notify("breaker_open", endpoint="x") is None
    rec = flightrec.install(FlightRecorder(str(tmp_path), min_interval_s=0.0,
                                           dump_on={"faultpoint"}))
    assert flightrec.installed() is rec
    assert flightrec.notify("slo_alert", rule="r") is None   # a note-only kind
    assert len(rec.events()) == 1
    path = flightrec.notify("faultpoint", site="s", action="delay-ms")
    assert path is not None and os.path.isdir(path)
    flightrec.uninstall()
    assert flightrec.notify("faultpoint") is None


def test_trigger_never_raises(tmp_path, monkeypatch):
    rec = FlightRecorder(str(tmp_path), min_interval_s=0.0)
    monkeypatch.setattr(rec, "_dump", lambda *a, **k: (_ for _ in ()).throw(OSError("disk")))
    assert rec.trigger("boom") is None
    assert rec.dump_errors == 1 and "disk" in rec.last_error


def test_faultpoint_fire_counts_and_notifies(tmp_path):
    rec = flightrec.install(FlightRecorder(str(tmp_path), min_interval_s=0.0))
    fp.arm_faultpoint("fr.site", "delay-ms", ms=0, after=2)
    fp.faultpoint("fr.site")
    assert not rec.events()
    fp.faultpoint("fr.site")
    ev = rec.events()
    assert ev and (ev[0]["kind"], ev[0]["site"], ev[0]["action"]) == \
        ("faultpoint", "fr.site", "delay-ms")
    assert rec.bundles()
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in registry.snapshot()["metrics"]["ps_faultpoints_fired"]["series"]}
    assert series[(("site", "fr.site"),)] >= 1


def _names(S=3, D=2):
    return dict(sparse_slots=[f"s{i}" for i in range(S)],
                dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


def _dataset(n, S=3, D=2):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(n):
        ids = rng.integers(0, 48, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                              + [f"1 {label}"]))
    ds = InMemoryDataset([SlotDesc(f"s{i}") for i in range(S)]
                         + [SlotDesc(f"d{i}", is_float=True) for i in range(D)]
                         + [SlotDesc("label", is_float=True)], seed=0)
    ds.load_from_lines(lines)
    return ds


@pytest.mark.parametrize("hot", [False, True], ids=["local_table", "hot_tier"])
def test_trainer_exception_dumps_a_bundle_with_batches_done(tmp_path, hot):
    """A step that raises at the third batch: the exception goes up, and
    the recorder's bundle names it with ``batches_done`` = 2."""
    rec = flightrec.install(FlightRecorder(str(tmp_path), min_interval_s=0.0))
    tr = CtrStreamTrainer(DeepFM(CtrConfig(3, 2, 8, (8,))), Adam(1e-2),
                          MemorySparseTable(TableConfig(shard_num=2)),
                          hot_tier=HotTierConfig(capacity=256) if hot else None,
                          device="cpu", **_names())
    name = "_hot_step" if hot else "_step"
    real, calls = getattr(tr, name), []

    def poisoned(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("poisoned batch")
        return real(*a)

    setattr(tr, name, poisoned)
    with pytest.raises(RuntimeError, match="poisoned batch"):
        tr.train_from_dataset(_dataset(256), batch_size=64)
    ev = [e for e in rec.events() if e["kind"] == "trainer_exception"]
    assert ev and "poisoned batch" in ev[0]["error"] and ev[0]["batches_done"] == 2
    (bundle,) = rec.bundles()
    man = json.load(open(os.path.join(bundle, "manifest.json")))
    assert man["reason"] == "trainer_exception" and man["info"]["batches_done"] == 2


_SIGTERM_SCRIPT = """
import os, signal, sys, time
from paddle_tpu_torch.obs import flightrec
rec = flightrec.install(flightrec.FlightRecorder(sys.argv[1], min_interval_s=0.0))
assert flightrec.install_signal_handler()
print("READY", flush=True)
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(10)   # never reached: the chained default disposition ends the process
"""


def test_sigterm_dumps_bundle_then_terminates(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _SIGTERM_SCRIPT, str(tmp_path)],
                          capture_output=True, text=True, timeout=120, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert "READY" in proc.stdout, proc.stderr
    assert proc.returncode == -signal.SIGTERM
    man = json.load(open(os.path.join(tmp_path, "postmortem_1", "manifest.json")))
    assert man["reason"] == "sigterm" and man["info"]["signal"] == 15


# -- faultpoints -------------------------------------------------------------------


@pytest.mark.parametrize("raw", ["ckpt.manifest=kill-job:after=3",
                                 "a=delay-ms:ms=20;b=drop-frame:after=2:every=3:count=2",
                                 " x = flip-bytes : param=5 ; "])
def test_faultpoint_flag_parses_like_jax(raw):
    """``FLAGS_ps_faultpoints`` arms the same specs in both packages."""
    def load(mod, put):
        put({"ps_faultpoints": raw})
        try:
            mod.disarm_faultpoints()
            mod._load_flag_specs()
            return {k: (s.action, s.cmd, s.after, s.every, s.count, s.ms, s.param)
                    for k, s in mod.armed_faultpoints().items()}
        finally:
            put({"ps_faultpoints": ""})
            mod.disarm_faultpoints()

    got, want = load(fp, set_flags), load(jax_fp, jax_set_flags)
    assert got == want and got


def test_faultpoint_schedule_matches_jax():
    """after/every/count fire on the same hits in both packages."""
    fired = {}
    for name, mod in (("port", fp), ("jax", jax_fp)):
        spec = mod.arm_faultpoint("sched.site", "delay-ms", after=3, every=2, count=3)
        hits = []
        for i in range(12):
            before = spec.fired
            mod.faultpoint("sched.site")
            hits.append(spec.fired > before)
        fired[name] = hits
        mod.disarm_faultpoints()
    assert fired["port"] == fired["jax"]
    assert [i for i, f in enumerate(fired["port"]) if f] == [2, 4, 6]
    with pytest.raises(ValueError, match="unknown faultpoint action"):
        fp.arm_faultpoint("x", "explode")


def test_faultpoint_drop_frame_raises_a_transport_error():
    from paddle_tpu_torch.core.enforce import PsTransportError

    fp.arm_faultpoint("t.site", "drop-frame")
    with pytest.raises(PsTransportError):
        fp.faultpoint("t.site")
    assert fp.faultpoint("t.site") is None   # fired once (every=0)


# -- auto_checkpoint ---------------------------------------------------------------


def test_checkpoint_saver_gc(tmp_path):
    s = CheckpointSaver(str(tmp_path), max_keep=2)
    for i in range(4):
        s.save({"v": i}, {"epoch": i})
    no, payload, meta = s.get_last()
    assert no == 3 and payload["v"] == 3 and meta["epoch"] == 3
    assert s._ids() == [2, 3]


def test_train_epoch_range_resumes(tmp_path):
    state = {"w": 0.0}

    def run(crash_after=None):
        seen = []
        r = train_epoch_range(5, "job", checkpoint_dir=str(tmp_path))
        r.set_state_getter(lambda: dict(state))
        r.set_state_setter(lambda s: state.update(s))
        for epoch in r:
            state["w"] += 1.0
            seen.append(epoch)
            if crash_after is not None and epoch == crash_after:
                r.save(epoch)
                raise RuntimeError("simulated crash")
        return seen

    with pytest.raises(RuntimeError):
        run(crash_after=2)
    assert state["w"] == 3.0
    state["w"] = -100.0
    assert run() == [3, 4]
    assert state["w"] == 5.0


def test_train_epoch_range_resumes_mid_epoch_steps(tmp_path):
    state = {"w": 0.0}

    def run(crash_at=None):
        trained = []
        r = TrainEpochRange(2, "midjob", checkpoint_dir=str(tmp_path))
        r.set_state_getter(lambda: dict(state))
        r.set_state_setter(lambda s: state.update(s))
        for epoch in r:
            for step, _ in r.steps(range(4)):
                state["w"] += 1.0
                trained.append((epoch, step))
                if crash_at is not None and (epoch, step) == crash_at:
                    r.save(epoch, step=step + 1)
                    raise RuntimeError("simulated crash")
        return trained

    with pytest.raises(RuntimeError):
        run(crash_at=(1, 1))
    assert state["w"] == 6.0
    state["w"] = -100.0
    assert run() == [(1, 2), (1, 3)]
    assert state["w"] == 8.0


def test_train_epoch_range_mid_epoch_resume_requires_cursor(tmp_path):
    state = {"w": 0.0}

    def rng_():
        r = TrainEpochRange(3, "midguard", checkpoint_dir=str(tmp_path))
        r.set_state_getter(lambda: dict(state))
        r.set_state_setter(lambda s: state.update(s))
        return r

    rng_().save(0, step=2)
    with pytest.raises(Exception, match="never skipped"):
        for _ in rng_():
            pass
    r3, seen = rng_(), []
    for epoch in r3:
        seen.append((epoch, r3.step_in_epoch))
    assert seen[0] == (0, 2) and [e for e, _ in seen] == [0, 1, 2]


def test_train_epoch_range_cursor_consumed_before_loop(tmp_path):
    state = {"w": 0.0}
    r = TrainEpochRange(2, "preloop", checkpoint_dir=str(tmp_path))
    r.set_state_getter(lambda: dict(state))
    r.set_state_setter(lambda s: state.update(s))
    r.save(0, step=2)
    r2 = TrainEpochRange(2, "preloop", checkpoint_dir=str(tmp_path))
    r2.set_state_getter(lambda: dict(state))
    r2.set_state_setter(lambda s: state.update(s))
    assert r2.step_in_epoch == 2
    assert [epoch for epoch in r2] == [0, 1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_epoch_range_resumes_where_the_other_package_does(tmp_path, writer):
    """Saves made by one package's range — whole epochs, then a mid-epoch
    snapshot — resume both packages' ranges at the same epoch and step
    with the same state."""
    make = {"jax": JaxTrainEpochRange, "port": TrainEpochRange}
    state = {"w": np.float32(0.0), "v": np.arange(3, dtype=np.float32)}
    r = make[writer](4, "x", checkpoint_dir=str(tmp_path))
    r.set_state_getter(lambda: dict(state))
    r.set_state_setter(lambda s: state.update(s))
    for epoch in r:
        state["v"] = state["v"] + 1.0
        if epoch == 1:
            r.save(epoch, step=3)   # a mid-epoch snapshot, then a crash
            break
    resumed = {}
    for name, cls in make.items():
        got = {}
        rr = cls(4, "x", checkpoint_dir=str(tmp_path))
        rr.set_state_getter(lambda: {})
        rr.set_state_setter(lambda s: got.update(s))
        epochs = []
        for epoch in rr:
            epochs.append((epoch, rr.step_in_epoch))
            break
        resumed[name] = (rr.restored_epoch, epochs, np.asarray(got["v"]).tolist())
    assert resumed["port"] == resumed["jax"]
    assert resumed["port"] == (1, [(1, 3)], [2.0, 3.0, 4.0])
