"""The port's telemetry plane (``paddle_tpu_torch.obs``: ``timeseries``,
``slo``, ``exporter``) against the JAX package's, on the CPU: the cases of
``tests/test_slo.py`` and the recsys SLO-rule cases of
``tests/test_recsys_pipeline.py``.

Each scenario is a function of a package namespace, run through the JAX
package and through the port, and the two records are compared with
``==``: ring records and curves, windowed quantiles and bad fractions,
alert sequences (rule, fire time, per-window burns, clear time),
subscriber calls, OpenMetrics text (byte for byte) and parsed families,
the HTTP endpoints' bodies and status codes, and the job collector's
merged view over each package's own PS shards. The clocks are injected
(``t=``/``now=``), so the values are not timing-dependent; the only
threaded moments (the sampler's named thread, the HTTP server) are reached
by events.

Tolerance: exact. The ring's rates and the rules' burns are the same
Python float arithmetic in both packages.
"""

import importlib
import json
import os
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)


def _pkg(root):
    m = lambda name: importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, slo=m("obs.slo"), timeseries=m("obs.timeseries"),
        exporter=m("obs.exporter"), registry=m("obs.registry"), aggregate=m("obs.aggregate"),
        flightrec=m("obs.flightrec"), rpc=m("ps.rpc"), TableConfig=m("ps.table").TableConfig)


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
def _no_recorder_leak():
    yield
    JAX.flightrec.uninstall()
    PORT.flightrec.uninstall()


def _alerts(fired):
    return [(a.rule, a.t, a.windows, a.cleared_t) for a in fired]


# -- quantile helper -----------------------------------------------------------------


def _quantiles(p):
    q = p.timeseries.quantile_from_hist
    bounds = (0.1, 1.0, 10.0)
    return [q(bounds, [0, 10, 0, 0], 0.5), q(bounds, [0, 10, 0, 0], 1.0),
            q(bounds, [0, 0, 0, 5], 0.99), q(bounds, [0, 0, 0, 0], 0.5),
            q(bounds, [3, 1, 7, 2], 0.9), q(bounds, [3, 1, 7, 2], 0.25)]


def test_quantile_from_hist_interpolates():
    got = both(_quantiles)
    assert got[0] == pytest.approx(0.55) and got[1] == pytest.approx(1.0)
    assert got[2] == 10.0 and got[3] == 0.0


# -- MetricRing ------------------------------------------------------------------------


def _rates(p):
    reg = p.registry.Registry()
    c = reg.counter("reqs", table="0")
    g = reg.gauge("dens")
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    ring = p.timeseries.MetricRing()
    c.inc(10)
    g.set(0.5)
    h.observe(0.05)
    ring.append(reg.snapshot(), t=100.0)
    c.inc(6)
    g.set(0.25)
    h.observe(5.0)
    ring.append(reg.snapshot(), t=102.0)
    return {"rate": ring.series("reqs", "rate"), "delta": ring.series("reqs", "delta"),
            "value": ring.series("dens", "value"), "records": ring.records(),
            "p50": ring.series("lat", "p50"), "count": ring.series("lat", "count")}


def test_ring_counter_rates_gauge_last_hist_deltas():
    got = both(_rates)
    assert got["rate"] == [(100.0, 0.0), (102.0, 3.0)]
    assert got["delta"] == [(100.0, 10.0), (102.0, 6.0)]
    assert got["value"] == [(100.0, 0.5), (102.0, 0.25)]
    lat = got["records"][1]["metrics"]["lat"]["series"][0]
    assert lat["buckets"] == [0, 0, 1] and lat["count"] == 1


def _restart(p):
    ring = p.timeseries.MetricRing()
    mk = lambda v: {"metrics": {"c": {"type": "counter", "series": [{"labels": {}, "value": v}]}}}
    ring.append(mk(100), t=10.0)
    ring.append(mk(3), t=11.0)  # process restarted: 3 < 100
    return ring.series("c", "delta"), ring.series("c", "rate")


def test_ring_counter_restart_rebases_not_negative():
    deltas, _ = both(_restart)
    assert [v for _, v in deltas] == [100.0, 3.0]


def _window(p):
    ring = p.timeseries.MetricRing(capacity=4)
    reg = p.registry.Registry()
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for i in range(8):
        h.observe(0.05 if i < 6 else 5.0)
        ring.append(reg.snapshot(), t=float(i))
    return {"len": len(ring), "bad": ring.bad_fraction("lat", 1.0, window_s=10.0, now=7.0),
            "bad_mid": ring.bad_fraction("lat", 0.5, window_s=2.5, now=7.0),
            "hist": ring.window_hist("lat", 10.0, now=7.0), "records": ring.records()}


def test_ring_bounded_capacity_and_window_queries():
    got = both(_window)
    assert got["len"] == 4
    bad, count = got["bad"]
    assert count == 4 and bad == pytest.approx(0.5)
    _, acc, _ = got["hist"]
    assert sum(acc) == 4 and acc[-1] == 2


def _subset(p):
    ring = p.timeseries.MetricRing()
    snap = {"metrics": {"wire": {"type": "counter", "series": [
        {"labels": {"table": "0", "dir": "in"}, "value": 10},
        {"labels": {"table": "1", "dir": "in"}, "value": 30},
        {"labels": {"table": "0", "dir": "out"}, "value": 5}]}}}
    ring.append(snap, t=1.0)
    return [ring.series("wire", "delta", labels={"dir": "in"}),
            ring.series("wire", "delta", labels={"table": "0", "dir": "out"}),
            ring.series("wire", "delta", reduce="max"), ring.series("wire", "delta", reduce="mean"),
            ring.series("wire", "delta", reduce="last")]


def test_ring_label_subset_match_and_reduce():
    got = both(_subset)
    assert got[0] == [(1.0, 40.0)] and got[1] == [(1.0, 5.0)]


def _conflict(p):
    ring = p.timeseries.MetricRing()
    mk = lambda bounds: {"metrics": {"lat": {"type": "histogram", "series": [
        {"labels": {}, "count": 3, "sum": 1.0, "bounds": list(bounds),
         "buckets": [1] * (len(bounds) + 1)}]}}}
    ring.append(mk((0.1, 1.0)), t=1.0)
    ring.append(mk((0.5, 2.0)), t=2.0)  # different ladder, same family
    return ring.records(), ring.bounds("lat")


def test_ring_histogram_bounds_conflict_marked_not_corrupted():
    recs, bounds = both(_conflict)
    assert recs[1]["metrics"]["lat"]["series"][0] == {"labels": {}, "bounds_conflict": True}
    assert bounds == (0.1, 1.0)


# -- Sampler -----------------------------------------------------------------------------


def _sampler_tick(p):
    reg = p.registry.Registry()
    c = reg.counter("x")
    probed, seen = [], []
    s = p.timeseries.Sampler(period_s=99.0, snapshot_fn=reg.snapshot, name="t-sampler")
    s.add_probe(lambda: probed.append(1))
    s.on_sample(lambda t: seen.append(t))
    c.inc(2)
    rec = s.tick(t=50.0)

    def boom():
        raise RuntimeError("shard died")

    bad = p.timeseries.Sampler(period_s=99.0, snapshot_fn=boom)
    bad_rec = bad.tick()
    s2 = p.timeseries.Sampler(period_s=99.0, snapshot_fn=reg.snapshot)
    s2.on_sample(lambda t: (_ for _ in ()).throw(RuntimeError("l")))
    rec2 = s2.tick(t=1.0)
    return {"rec": rec, "probed": probed, "seen": seen, "ticks": s.ticks, "errors": s.errors,
            "bad": (bad_rec, bad.errors, bad.last_error),
            "s2": (rec2 is not None, s2.errors, s2.ticks, s2.last_error)}


def test_sampler_tick_probes_listeners_and_errors():
    got = both(_sampler_tick)
    assert got["rec"]["t"] == 50.0 and got["probed"] == [1] and got["seen"] == [50.0]
    assert got["ticks"] == 1 and got["errors"] == 0
    assert got["bad"] == (None, 1, "RuntimeError: shard died")
    assert got["s2"] == (True, 1, 1, "RuntimeError: l")


def _sampler_thread(p):
    reg = p.registry.Registry()
    ticked = threading.Event()
    name = f"obs-sampler-{p.root}"
    s = p.timeseries.Sampler(period_s=0.01, snapshot_fn=reg.snapshot, name=name)
    s.on_sample(lambda t: ticked.set())
    s.start()
    try:
        named = name in [t.name for t in threading.enumerate()]
        assert ticked.wait(30), "the sampler thread never ticked"
    finally:
        s.stop()
    return {"named": named, "ticked": s.ticks > 0,
            "gone": all(t.name != name for t in threading.enumerate())}


def test_sampler_thread_named_and_stops():
    assert both(_sampler_thread) == {"named": True, "ticked": True, "gone": True}


# -- SLO watchdog ------------------------------------------------------------------------


def _burn_ring(p, good_then_bad, t0=0.0, dt=1.0, family="lat", labels=None):
    """Ring with one 2-bucket histogram: 'g' ticks observe 0.05 (good), 'b'
    ticks 5.0 (bad against a 1.0 threshold)."""
    reg = p.registry.Registry()
    h = reg.histogram(family, buckets=(0.1, 1.0), **(labels or {}))
    ring = p.timeseries.MetricRing()
    t = t0
    for ch in good_then_bad:
        h.observe(0.05 if ch == "g" else 5.0)
        ring.append(reg.snapshot(), t=t)
        t += dt
    return ring, t - dt


def _multiwindow(p):
    rule = p.slo.SloRule("lat_p", "lat", threshold=1.0, budget=0.25,
                         windows=((8.0, 1.0), (3.0, 1.0)))
    ring, now = _burn_ring(p, "gggggggggg")
    healthy = _alerts(p.slo.SloWatchdog(ring, [rule]).evaluate(now=now))
    ring2, now2 = _burn_ring(p, "gggggbbbbb")
    wd2 = p.slo.SloWatchdog(ring2, [rule])
    fired = _alerts(wd2.evaluate(now=now2))
    active = wd2.active()
    again = _alerts(wd2.evaluate(now=now2))
    log = wd2.alerts()
    ring3, now3 = _burn_ring(p, "gbbgggggggggggggg")
    wd3 = p.slo.SloWatchdog(ring3, [rule])
    return {"healthy": healthy, "fired": fired, "active": active, "again": again, "log": log,
            "recovered": (_alerts(wd3.evaluate(now=now3)), wd3.active())}


def test_watchdog_multiwindow_fires_and_clears():
    got = both(_multiwindow)
    assert got["healthy"] == [] and [a[0] for a in got["fired"]] == ["lat_p"]
    assert got["active"] == ["lat_p"] and got["again"] == []
    assert len(got["log"]) == 1 and got["log"][0]["cleared_t"] is None
    assert got["recovered"] == ([], [])


def _short_gate(p):
    ring, now = _burn_ring(p, "bbbbbggg")
    rule = p.slo.SloRule("lat_p", "lat", threshold=1.0, budget=0.25,
                         windows=((8.0, 1.0), (2.5, 1.0)))
    wd = p.slo.SloWatchdog(ring, [rule])
    return _alerts(wd.evaluate(now=now)), rule.evaluate(ring, now)


def test_watchdog_short_window_gates_stale_burn():
    fired, (fires, detail) = both(_short_gate)
    assert fired == [] and not fires and detail["w8s"] > 1.0


def _threshold(p):
    ring = p.timeseries.MetricRing()
    snap = lambda v: {"metrics": {"lag": {"type": "gauge", "series": [{"labels": {}, "value": v}]}}}
    for i, v in enumerate([10, 20, 5000]):
        ring.append(snap(v), t=float(i))
    wd = p.slo.SloWatchdog(ring, [p.slo.SloRule(
        "lag", "lag", kind="threshold", agg="max", threshold=1000, windows=((10.0, 1.0),))])
    out = {"max": _alerts(wd.evaluate(now=2.0))}
    ring2 = p.timeseries.MetricRing()
    csnap = lambda v: {"metrics": {"opens": {"type": "counter", "series": [
        {"labels": {}, "value": v}]}}}
    ring2.append(csnap(0), t=0.0)
    ring2.append(csnap(0), t=1.0)
    wd2 = p.slo.SloWatchdog(ring2, [p.slo.SloRule(
        "opens", "opens", kind="threshold", field="delta", agg="rate", threshold=0.0,
        windows=((10.0, 1.0),))])
    out["rate_quiet"] = _alerts(wd2.evaluate(now=1.0))
    ring2.append(csnap(2), t=2.0)
    out["rate"] = _alerts(wd2.evaluate(now=2.0))
    ring3 = p.timeseries.MetricRing()
    gsnap = lambda v: {"metrics": {"ckpt": {"type": "gauge", "series": [
        {"labels": {}, "value": v}]}}}
    ring3.append(gsnap(1000.0), t=1001.0)
    wd3 = p.slo.SloWatchdog(ring3, [p.slo.SloRule(
        "stale", "ckpt", kind="threshold", agg="age", threshold=600, windows=((10.0, 1.0),))])
    out["age_fresh"] = _alerts(wd3.evaluate(now=1001.0))
    ring3.append(gsnap(1000.0), t=1700.0)
    out["age"] = _alerts(wd3.evaluate(now=1700.0))
    for agg in ("mean", "last"):
        r = p.slo.SloRule(agg, "lag", kind="threshold", agg=agg, threshold=1000, op="<",
                          windows=((10.0, 1.0),))
        out[agg] = r.evaluate(ring, 2.0)
    return out


def test_watchdog_threshold_rules_value_rate_age():
    got = both(_threshold)
    assert [a[0] for a in got["max"]] == ["lag"]
    assert got["rate_quiet"] == [] and [a[0] for a in got["rate"]] == ["opens"]
    assert got["age_fresh"] == [] and [a[0] for a in got["age"]] == ["stale"]


def _alert_metrics(p):
    ring, now = _burn_ring(p, "ggbbbb")
    rule = p.slo.SloRule("m_rule", "lat", threshold=1.0, budget=0.25, windows=((6.0, 1.0),))
    wd = p.slo.SloWatchdog(ring, [rule], log_cap=2)
    wd.evaluate(now=now)
    snap = p.registry.snapshot()["metrics"]
    fired = {tuple(sorted(s["labels"].items())): s["value"]
             for s in snap["slo_alerts"]["series"]}[(("rule", "m_rule"),)]
    active = {tuple(sorted(s["labels"].items())): s["value"]
              for s in snap["slo_alert_active"]["series"]}[(("rule", "m_rule"),)]
    for i in range(5):
        wd._log.append(p.slo.Alert(f"r{i}", "lat", 0.0, 1.0, "burn_rate", {}))
    try:
        wd.add_rule(rule)
        dup = None
    except ValueError as e:
        dup = str(e)
    return {"fired": fired >= 1, "active": active, "log": wd.alerts(), "dup": dup}


def test_watchdog_alerts_are_metrics_and_log_bounded():
    got = both(_alert_metrics)
    assert got["fired"] and got["active"] == 1.0
    assert len(got["log"]) == 2 and got["dup"] == "duplicate SLO rule 'm_rule'"


def _notifies(p, root):
    rec = p.flightrec.install(p.flightrec.FlightRecorder(
        os.path.join(root, p.root), dump_on=set(), min_interval_s=0.0))
    ring, now = _burn_ring(p, "bbbb")
    wd = p.slo.SloWatchdog(ring, [p.slo.SloRule(
        "fr_rule", "lat", threshold=1.0, budget=0.25, windows=((6.0, 1.0),))])
    wd.evaluate(now=now)
    return [{k: v for k, v in e.items() if k != "t"} for e in rec.events()]


def test_watchdog_alert_notifies_flightrec(tmp_path):
    got = both(_notifies, str(tmp_path))
    assert [e["kind"] for e in got] == ["slo_alert"]
    assert got[0]["rule"] == "fr_rule"


def _rules(p):
    def rows(rules):
        return [(r.name, r.family, r.kind, r.labels, r.threshold, r.budget, r.windows, r.agg,
                 r.op, r.min_count, r.field) for r in rules]

    return {"default": rows(p.slo.default_rules()),
            "tuned": rows(p.slo.default_rules(step_p95_s=0.5, fleet_p99_s=0.2, long_s=30,
                                              short_s=5)),
            "recsys": rows(p.slo.recsys_rules()), "cold": rows(p.slo.cold_tier_rules())}


def test_default_rules_cover_the_issue_slos():
    got = both(_rules)
    assert {"step_time_p95", "serving_p99", "freshness_p95", "breaker_open",
            "failover_promotion", "replication_lag", "checkpoint_staleness"} <= \
        {r[0] for r in got["default"]}


# -- obs/aggregate bounds_conflict ---------------------------------------------------------


def _hist_snap(bounds, buckets, count, total):
    return {"process": {"role": "p"},
            "metrics": {"lat": {"type": "histogram", "dropped_series": 0,
                                "series": [{"labels": {"k": "v"}, "count": count, "sum": total,
                                            "bounds": list(bounds),
                                            "buckets": list(buckets)}]}}}


def _agg_conflict(p):
    a = _hist_snap((0.1, 1.0), [1, 2, 3], 6, 9.0)
    b = _hist_snap((0.5, 2.0), [4, 4, 4], 12, 20.0)
    c = _hist_snap((0.1, 1.0), [1, 0, 0], 1, 0.05)
    return (p.aggregate.merge_snapshots([a, b])["metrics"]["lat"]["series"][0],
            p.aggregate.merge_snapshots([a, c])["metrics"]["lat"]["series"][0])


def test_aggregate_bounds_conflict_keeps_first_ladder_intact():
    s, ok = both(_agg_conflict)
    assert s["bounds"] == [0.1, 1.0] and s["buckets"] == [1, 2, 3]
    assert s["count"] == 6 and s["sum"] == 9.0 and s["bounds_conflict"] is True
    assert ok["buckets"] == [2, 2, 3] and ok["count"] == 7 and "bounds_conflict" not in ok


def _om_conflict(p):
    merged = p.aggregate.merge_snapshots([_hist_snap((0.1, 1.0), [1, 2, 3], 6, 9.0),
                                          _hist_snap((0.5, 2.0), [4, 4, 4], 12, 20.0)])
    text = p.exporter.to_openmetrics(merged)
    return text, p.exporter.parse_openmetrics(text)


def test_openmetrics_skips_conflicted_series():
    text, _ = both(_om_conflict)
    assert "lat_bucket" not in text


# -- OpenMetrics rendering and strict parse --------------------------------------------------


def _escaping(p):
    reg = p.registry.Registry()
    nasty = 'back\\slash "quoted" new\nline'
    reg.counter("evil", path=nasty).inc(3)
    text = p.exporter.to_openmetrics(reg.snapshot())
    return text, p.exporter.parse_openmetrics(text), nasty


def test_openmetrics_label_escaping_round_trip():
    text, fams, nasty = both(_escaping)
    sample = [ln for ln in text.splitlines() if ln.startswith("evil_total")]
    assert len(sample) == 1
    assert '\\\\' in sample[0] and '\\"' in sample[0] and '\\n' in sample[0]
    (_, labels, value), = fams["evil"]["samples"]
    assert labels["path"] == nasty and value == 3.0


def _om_hist(p):
    reg = p.registry.Registry()
    h = reg.histogram("lat_s", buckets=(0.1, 1.0), table="0")
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.counter("reqs_total").inc(2)
    reg.gauge("g", shard="1").set(2.5)
    text = p.exporter.to_openmetrics(reg.snapshot())
    return text, p.exporter.parse_openmetrics(text)


def test_openmetrics_histogram_cumulative_and_counter_total():
    text, fams = both(_om_hist)
    buckets = [(lbl["le"], v) for n, lbl, v in fams["lat_s"]["samples"] if n == "lat_s_bucket"]
    assert buckets == [("0.1", 1.0), ("1", 2.0), ("+Inf", 3.0)]
    assert ("reqs_total", {}, 2.0) in fams["reqs"]["samples"]
    assert "reqs_total_total" not in text and text.endswith("# EOF\n")


_MALFORMED = [
    ('# TYPE x counter\nx_total 1\n', "EOF"),
    ('x_total 1\n# EOF\n', "TYPE"),
    ('# TYPE x counter\ny_total 1\n# EOF\n', "belong"),
    ('# TYPE x counter\nx_total{a="\\q"} 1\n# EOF\n', "escape"),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n# EOF\n', "cumulative"),
    ('# TYPE h histogram\nh_bucket{le="+Inf"} 3\nh_count 4\n# EOF\n', "count"),
    ('# TYPE x gauge\nx nope\n# EOF\n', "value"),
]


def _malformed(p):
    out = []
    for text, _ in _MALFORMED:
        try:
            p.exporter.parse_openmetrics(text)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def test_openmetrics_parser_rejects_malformations():
    got = both(_malformed)
    for msg, (_, want) in zip(got, _MALFORMED):
        assert msg is not None and want in msg, (msg, want)


# -- the HTTP exporter -------------------------------------------------------------------


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _endpoints(p):
    reg = p.registry.Registry()
    reg.counter("scraped").inc(7)
    ring = p.timeseries.MetricRing()
    ring.append(reg.snapshot(), t=1.0)
    alerts = [{"rule": "r", "t": 1.0}]
    out = {}
    with p.exporter.ObsExporter(reg.snapshot, ring=ring, alerts_fn=lambda: alerts) as exp:
        for path in ("/metrics", "/history.json", "/alerts.json", "/healthz", "/nope"):
            out[path] = _get(exp.url + path)
        snap = json.loads(_get(exp.url + "/snapshot.json")[2])
        out["snapshot"] = snap["metrics"]
        for method in ("POST", "PUT", "DELETE", "PATCH"):
            req = urllib.request.Request(exp.url + "/metrics", data=b"x", method=method)
            try:
                urllib.request.urlopen(req, timeout=10)
                out[method] = None
            except urllib.error.HTTPError as e:
                out[method] = (e.code, e.read().decode())
        out["scrapes"] = exp.scrapes
        url = exp.url
    try:
        urllib.request.urlopen(url + "/healthz", timeout=0.5)
        out["after_stop"] = "answered"
    except Exception:  # noqa: BLE001 — any refusal is the point
        out["after_stop"] = "refused"
    out["families"] = p.exporter.parse_openmetrics(out["/metrics"][2])
    return out


def test_exporter_endpoints_and_read_only():
    got = both(_endpoints)
    status, ctype, _ = got["/metrics"]
    assert status == 200 and ctype == PORT.exporter.CONTENT_TYPE
    assert ("scraped_total", {}, 7.0) in got["families"]["scraped"]["samples"]
    assert json.loads(got["/history.json"][2])["records"][0]["t"] == 1.0
    assert json.loads(got["/alerts.json"][2])["alerts"] == [{"rule": "r", "t": 1.0}]
    assert json.loads(got["/healthz"][2])["ok"] is True
    assert got["/nope"][0] == 404 and got["POST"][0] == 405 and got["PATCH"][0] == 405
    assert got["after_stop"] == "refused"


# -- the job collector over each package's own shard pair ----------------------------------


def _collector(p):
    servers = [p.rpc.NativePsServer(n_trainers=1) for _ in range(2)]
    client = p.rpc.RpcPsClient([f"127.0.0.1:{s.port}" for s in servers])
    try:
        client.create_sparse_table(0, p.TableConfig(table_id=0, shard_num=4, accessor="ctr"))
        client.pull_sparse(0, np.arange(64, dtype=np.uint64), create=True)
        coll = p.timeseries.JobCollector(client=client, period_s=99.0)
        rec = coll.tick(t=1.0)
        merged = coll.latest()
        roles = sorted(pr.get("role") for pr in merged["processes"] if pr.get("role"))
        wire = merged["metrics"]["ps_server_wire_bytes"]["series"]
        first = {"landed": rec is not None, "shard_errors": coll.shard_errors,
                 "shard_roles": [r for r in roles if r.startswith("ps_shard_")],
                 "processes": len(merged["processes"]) >= 3,
                 "wire": any(s["value"] > 0 for s in wire)}
        servers[0].stop()
        rec2 = coll.tick(t=2.0)
        return {"first": first, "second": (rec2 is not None, coll.shard_errors >= 1,
                                           coll.ticks, coll.errors)}
    finally:
        client.close()
        for s in servers:
            s.stop()
            s.close()


def test_job_collector_merges_shards_and_tolerates_death(jax_native):
    got = both(_collector)
    assert got["first"] == {"landed": True, "shard_errors": 0,
                            "shard_roles": ["ps_shard_0", "ps_shard_1"], "processes": True,
                            "wire": True}
    assert got["second"] == (True, True, 2, 0)


# -- the alert log as instant events in a postmortem trace ---------------------------------


def _alert_instants(p, root):
    """The JAX test renders the watchdog's alert log through the repo's
    timeline merge tool; the port renders it through the flight recorder's
    merged trace, the same instant events on the wall-clock axis."""
    ring, now = _burn_ring(p, "gggbbbb", t0=1000.0)
    wd = p.slo.SloWatchdog(ring, [p.slo.SloRule(
        "step_time_p95", "lat", threshold=1.0, budget=0.25, windows=((4.0, 1.0),))])
    wd.evaluate(now=now)
    rec = p.flightrec.FlightRecorder(os.path.join(root, p.root), watchdog=wd,
                                     min_interval_s=0.0)
    path = rec.trigger("unit_test")
    evs = json.load(open(os.path.join(path, "trace.json")))
    alerts = [{k: v for k, v in e.items() if k not in ("pid", "tid")}
              for e in evs["traceEvents"] if e.get("cat") == "slo_alert"]
    return {"alerts": alerts, "clock": evs["clockSyncUs"], "log": wd.alerts()}


def test_timeline_renders_slo_alerts_as_instants(tmp_path):
    got = both(_alert_instants, str(tmp_path))
    (alert,) = got["alerts"]
    assert alert["name"] == "ALERT step_time_p95" and alert["ph"] == "i" and alert["s"] == "g"
    # wall-aligned: the re-zeroed instant plus the trace's anchor is the
    # alert's wall time
    assert alert["ts"] + got["clock"] == pytest.approx(got["log"][0]["t"] * 1e6)


# -- push subscriptions: on_fire / on_clear ------------------------------------------------


def _transitions(p):
    rule = p.slo.SloRule("lat_p", "lat", threshold=1.0, budget=0.25,
                         windows=((8.0, 1.0), (3.0, 1.0)))
    ring, now = _burn_ring(p, "gggggbbbbb")
    wd = p.slo.SloWatchdog(ring, [rule])
    fired, cleared = [], []
    wd.on_fire(lambda a: fired.append((a.rule, a.t)))
    wd.on_clear(lambda a: cleared.append((a.rule, a.cleared_t)))
    wd.evaluate(now=now)
    first = (list(fired), list(cleared))
    wd.evaluate(now=now)
    reg = p.registry.Registry()
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    t = now + 1
    for _ in range(12):
        h.observe(0.05)
        ring.append(reg.snapshot(), t=t)
        t += 1.0
    wd.evaluate(now=t - 1)
    after_clear = (list(fired), list(cleared), wd.active())
    wd.evaluate(now=t - 1)
    return {"first": first, "after_clear": after_clear, "final": (fired, cleared),
            "log": wd.alerts()}


def test_watchdog_on_fire_and_on_clear_transitions_only():
    got = both(_transitions)
    assert [f[0] for f in got["first"][0]] == ["lat_p"] and got["first"][1] == []
    fired, cleared, active = got["after_clear"]
    assert len(fired) == 1 and cleared[0][0] == "lat_p" and cleared[0][1] is not None
    assert active == [] and len(got["final"][0]) == 1 and len(got["final"][1]) == 1


def _subscriber_errors(p):
    rule = p.slo.SloRule("lat_p", "lat", threshold=1.0, budget=0.25, windows=((3.0, 1.0),))
    ring, now = _burn_ring(p, "bbbb")
    wd = p.slo.SloWatchdog(ring, [rule])
    seen = []

    def broken(alert):
        raise RuntimeError("subscriber bug")

    wd.on_fire(broken)
    wd.on_fire(lambda a: seen.append(a.rule))
    return _alerts(wd.evaluate(now=now)), wd.subscriber_errors, seen


def test_watchdog_subscriber_errors_counted_not_fatal():
    fired, errors, seen = both(_subscriber_errors)
    assert [a[0] for a in fired] == ["lat_p"] and errors == 1 and seen == ["lat_p"]


def _healthy(p):
    rule = p.slo.SloRule("lat_p", "lat", threshold=1.0, budget=0.25, windows=((8.0, 1.0),))
    ring, now = _burn_ring(p, "gggggggg")
    wd = p.slo.SloWatchdog(ring, [rule])
    called = []
    wd.on_fire(lambda a: called.append(a))
    wd.on_clear(lambda a: called.append(a))
    return _alerts(wd.evaluate(now=now)), called


def test_watchdog_on_fire_not_called_while_healthy():
    assert both(_healthy) == ([], [])


# -- the recsys pipeline's rules, both directions --------------------------------------------


def _recsys_rule(p, name):
    rules = p.slo.recsys_rules(e2e_p99_s=1.0, stage_retrieval_p99_s=1.0,
                               freshness_training_p95_s=1.0)
    return next(r for r in rules if r.name == name)


def _recsys_fire(p, name, family, hot, cold, pattern_hot):
    rule = _recsys_rule(p, name)
    ring, now = _burn_ring(p, pattern_hot, dt=0.05, family=family, labels=hot)
    fired = _alerts(p.slo.SloWatchdog(ring, [rule]).evaluate(now=now))
    quiet = []
    for labels, pattern in cold:
        r2, n2 = _burn_ring(p, pattern, dt=0.05, family=family, labels=labels)
        quiet.append(_alerts(p.slo.SloWatchdog(r2, [rule]).evaluate(now=n2)))
    return fired, quiet


def test_recsys_e2e_rule_fires_and_stays_quiet():
    labels = {"recorder": "recsys_e2e", "replica": "-"}
    fired, quiet = both(_recsys_fire, "recsys_e2e_p99", "serving_latency_s", labels,
                        [(labels, "g" * 300),
                         ({"recorder": "request", "replica": "-"}, "b" * 300)],
                        "g" * 150 + "b" * 150)
    assert [a[0] for a in fired] == ["recsys_e2e_p99"] and quiet == [[], []]


def test_recsys_stage_retrieval_rule_selects_its_stage():
    stage = {"recorder": "pipeline_stage", "replica": "-", "stage": "retrieval"}
    fired, quiet = both(_recsys_fire, "recsys_stage_retrieval_p99", "serving_stage_latency_s",
                        stage, [(dict(stage, stage="ranking"), "b" * 300)],
                        "g" * 150 + "b" * 150)
    assert [a[0] for a in fired] == ["recsys_stage_retrieval_p99"] and quiet == [[]]


def test_freshness_under_training_rule_both_directions():
    labels = {"recorder": "freshness", "replica": "-"}
    fired, quiet = both(_recsys_fire, "freshness_under_training", "serving_latency_s", labels,
                        [(labels, "g" * 200)], "g" * 100 + "b" * 100)
    assert [a[0] for a in fired] == ["freshness_under_training"] and quiet == [[]]


def _recsys_defaults(p):
    rules = {r.name: r for r in p.slo.recsys_rules(e2e_p99_s=0.5)}
    return (rules["recsys_stage_retrieval_p99"].threshold, rules["recsys_e2e_p99"].labels,
            rules["freshness_under_training"].budget)


def test_recsys_rules_default_stage_budget_is_retrieval_share():
    threshold, labels, budget = both(_recsys_defaults)
    assert threshold == pytest.approx(0.3) and labels == {"recorder": "recsys_e2e"}
    assert budget == pytest.approx(0.05)
