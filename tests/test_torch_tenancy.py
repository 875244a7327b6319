"""Tenancy in the port (``paddle_tpu_torch.ps.tenancy`` over the port's
``ps.rpc``, ``ps.ha`` and its copy of the C++ service's tenancy handlers),
the cases of ``tests/test_tenancy.py`` held against the JAX package.

Each test runs one scenario twice, through the JAX package's servers and
client and through the port's, and compares what each saw: the error
raised at each step, sizes, usage meters, digests and pulled rows, all
exactly. Token buckets are sized so that the refill over a test's run time
is far below one frame's cost (rate 5 units/s against frames of 4 to 257
units), so which frame sheds does not depend on the clock.

The per-tenant control plane: ``tenant_slo_rules`` over each package's
ring and watchdog (the alerts that fire, and a scoped recorder's bundle
fed by that watchdog), and a tenant-scoped ``Autoscaler``'s decisions and
journal. The JAX interference e2e's p99 bound is timing-bound and left
out; its isolation digests are held here.
"""

import importlib
import json
import os
import threading
import types

import numpy as np
import pytest

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

from paddle_tpu.ps import tenancy as jax_tenancy
from paddle_tpu_torch.obs import flightrec
from paddle_tpu_torch.ps import rpc, tenancy

pytestmark = pytest.mark.usefixtures("jax_native")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root, tier_kw):
    """One package's modules and classes under the names the scenarios use."""
    m = lambda name: importlib.import_module(f"{root}.{name}")
    enf = m("core.enforce")
    return types.SimpleNamespace(
        rpc=m("ps.rpc"), ha=m("ps.ha"), tenancy=m("ps.tenancy"), registry=m("obs.registry"),
        timeseries=m("obs.timeseries"), slo=m("obs.slo"), autoscale=m("ps.autoscale"),
        elastic=m("distributed.elastic"),
        WrongTenant=enf.WrongTenantError, Quota=enf.QuotaExceededError,
        Throttled=enf.ThrottledError, AccessorConfig=m("ps.accessor").AccessorConfig,
        SGDRuleConfig=m("ps.sgd_rule").SGDRuleConfig, TableConfig=m("ps.table").TableConfig,
        MemorySparseTable=m("ps.table").MemorySparseTable,
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


def _cfg(p, shards=4, **kw):
    return p.TableConfig(shard_num=shards, accessor_config=p.AccessorConfig(
        sgd=p.SGDRuleConfig(initial_range=0.0)), **kw)


def _op(p, server):
    """An operator-plane connection (no hello: tenant 0)."""
    return p.rpc.make_conn(f"127.0.0.1:{server.port}")


def _register(p, server, tid, token=b"", **kw):
    conn = _op(p, server)
    try:
        conn.tenant_config(tid, token=token, **kw)
    finally:
        conn.close()


def _usage(p, server, tid):
    conn = _op(p, server)
    try:
        u = conn.tenant_usage(tid)
    finally:
        conn.close()
    u.pop("tokens")  # the bucket's level reads the clock
    return u


def _client(p, server, tid, token=b""):
    return p.rpc.RpcPsClient([f"127.0.0.1:{server.port}"], tenant=(tid, token))


def _fill(cli, t, keys):
    """Push non-trivial rows (the width from the client's dims)."""
    push = np.zeros((len(keys), cli._dims(t)[1]), np.float32)
    push[:, 1] = 1.0
    cli.push_sparse(t, np.asarray(keys, np.uint64), push)


def _outcome(p, fn, *a, **kw):
    """What one call did: "ok", or the name of the tenancy error it raised."""
    try:
        fn(*a, **kw)
        return "ok"
    except (p.WrongTenant, p.Quota, p.Throttled) as e:
        return type(e).__name__


class _Server:
    def __init__(self, p):
        self.p = p

    def __enter__(self):
        self.s = self.p.rpc.NativePsServer(n_trainers=1)
        return self.s

    def __exit__(self, *exc):
        self.s.close()


# -- namespace constants and helpers ----------------------------------------------


def test_shift_constants_pinned_against_csrc():
    assert tenancy.TENANT_SHIFT == rpc._TENANT_SHIFT == jax_tenancy.TENANT_SHIFT == 24
    assert tenancy.KEY_TENANT_SHIFT == jax_tenancy.KEY_TENANT_SHIFT == 56
    assert tenancy.MAX_TENANTS == jax_tenancy.MAX_TENANTS == 255
    assert (rpc._TENANT_HELLO, rpc._TENANT_CONFIG) == (JAX.rpc._TENANT_HELLO,
                                                       JAX.rpc._TENANT_CONFIG) == (45, 46)
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "csrc", "ps_service.cc"),
               encoding="utf-8").read()
    for pinned in ("kTenantShift = 24", "kTenantHello = 45", "kTenantConfig = 46",
                   "kErrWrongTenant = -9", "kErrQuota = -10", "kErrThrottled = -11"):
        assert pinned in src, pinned
    assert (rpc._ERR_WRONG_TENANT, rpc._ERR_QUOTA, rpc._ERR_THROTTLED) == (-9, -10, -11)

    def record(p):
        t = p.tenancy
        keys = np.asarray([1, 2, (1 << 56) - 1, (1 << 64) - 1], np.uint64)
        nk = t.namespace_keys(9, keys)
        bad = [_raises(t.tenant_table_id, *a) for a in ((0, 1), (256, 1), (1, 1 << 24))]
        return {"id": t.tenant_table_id(7, 42), "split": t.split_table_id(t.tenant_table_id(7, 42)),
                "split0": t.split_table_id(42), "ns": nk.tolist(),
                "of": t.tenant_of_keys(nk).tolist(), "bad": bad}
    got = both(record)
    assert got["split"] == (7, 42) and got["split0"] == (0, 42) and all(got["bad"])
    assert got["of"] == [9] * 4


def _raises(fn, *a):
    try:
        fn(*a)
        return False
    except Exception:  # noqa: BLE001 — both packages' enforce errors
        return True


# -- the wire fence: hello, namespace, operator plane ----------------------------


def _hello_scenario(p):
    with _Server(p) as server:
        _register(p, server, 1, token=b"alpha")
        _register(p, server, 2, token=b"beta")
        c1 = _client(p, server, 1, b"alpha")
        t1 = p.tenancy.tenant_table_id(1, 0)
        c1.create_sparse_table(t1, _cfg(p))
        keys = np.arange(1, 9, dtype=np.uint64)
        out = {"pulled": c1.pull_sparse(t1, keys).tolist()}
        _fill(c1, t1, keys)
        out["size"] = c1.size(t1)
        out["other"] = _outcome(p, c1.size, p.tenancy.tenant_table_id(2, 0))
        out["operator"] = _outcome(p, c1.size, 0)
        out["size_after"] = c1.size(t1)
        out["rows"] = c1.pull_sparse(t1, keys, create=False).tolist()
        out["digest"] = c1.digest(t1)
        c1.close()
        return out


def test_hello_binds_and_namespace_is_wire_enforced():
    got = both(_hello_scenario)
    assert got["other"] == got["operator"] == "WrongTenantError"
    assert got["size"] == got["size_after"] == 8


def _bind_scenario(p):
    with _Server(p) as server:
        _register(p, server, 1, token=b"alpha")
        out = {"wrong_token": _outcome(p, _client, p, server, 1, b"wrong"),
               "unknown": _outcome(p, _client, p, server, 9, b"")}
        conn = _op(p, server)
        try:
            out["first"] = _outcome(p, conn.tenant_hello, 1, b"alpha")
            out["rebind"] = _outcome(p, conn.tenant_hello, 1, b"alpha")
        finally:
            conn.close()
        return out


def test_unknown_tenant_bad_token_and_rebind_refused():
    got = both(_bind_scenario)
    assert got == {"wrong_token": "WrongTenantError", "unknown": "WrongTenantError",
                   "first": "ok", "rebind": "WrongTenantError"}


def _operator_scenario(p):
    with _Server(p) as server:
        _register(p, server, 1, token=b"alpha")
        conn = _op(p, server)
        try:
            conn.tenant_hello(1, b"alpha")
            out = {"config": _outcome(p, conn.tenant_config, 3, token=b"x"),
                   "usage": _outcome(p, conn.tenant_usage, 1)}
        finally:
            conn.close()
        out["meter"] = _usage(p, server, 1)
        return out


def test_tenant_config_is_operator_plane_only():
    got = both(_operator_scenario)
    assert got["config"] == got["usage"] == "WrongTenantError"
    assert got["meter"]["rows"] == 0 and got["meter"]["pclass"] == 1


# -- quotas: PS rows and SSD bytes, refused, never evicted ------------------------


def _row_quota_scenario(p):
    with _Server(p) as server:
        _register(p, server, 1, token=b"a", max_rows=8)
        _register(p, server, 2, token=b"b")
        c1, c2 = _client(p, server, 1, b"a"), _client(p, server, 2, b"b")
        t1, t2 = p.tenancy.tenant_table_id(1, 0), p.tenancy.tenant_table_id(2, 0)
        c1.create_sparse_table(t1, _cfg(p))
        c2.create_sparse_table(t2, _cfg(p))
        _fill(c2, t2, np.arange(1, 21, dtype=np.uint64))
        steps = [_outcome(p, _fill, c1, t1, np.arange(i * 4 + 1, i * 4 + 5, dtype=np.uint64))
                 for i in range(5)]
        out = {"steps": steps, "size1": c1.size(t1), "size2": c2.size(t2),
               "again": _outcome(p, _fill, c1, t1, np.asarray([777], np.uint64)),
               "size1_after": c1.size(t1),
               "neighbour": _outcome(p, _fill, c2, t2, np.asarray([999], np.uint64)),
               "size2_after": c2.size(t2),
               "u1": _usage(p, server, 1), "u2": _usage(p, server, 2),
               "rows1": c1.pull_sparse(t1, np.arange(1, 21, dtype=np.uint64),
                                       create=False).tolist(),
               "digest2": c2.digest(t2)}
        c1.close()
        c2.close()
        return out


def test_row_quota_refuses_and_never_touches_neighbors():
    got = both(_row_quota_scenario)
    assert "QuotaExceededError" in got["steps"]
    assert got["size1"] <= 8 + 4 and got["size1_after"] == got["size1"]
    assert got["again"] == "QuotaExceededError" and got["neighbour"] == "ok"
    assert got["size2"] == 20 and got["size2_after"] == 21
    assert got["u1"]["rows"] == got["size1"] and got["u1"]["quota_refused"] >= 2
    assert got["u2"]["quota_refused"] == 0


def _ssd_quota_scenario(p, root):
    acc = p.AccessorConfig(embedx_dim=4, embedx_threshold=0.0,
                           sgd=p.SGDRuleConfig(initial_range=0.0))
    path = os.path.join(root, "jax" if p is JAX else "port")
    cfg = p.TableConfig(shard_num=4, accessor_config=acc, storage="ssd", ssd_path=path)
    with _Server(p) as server:
        _register(p, server, 5, token=b"ssd")
        c = _client(p, server, 5, b"ssd")
        t = p.tenancy.tenant_table_id(5, 0)
        c.create_sparse_table(t, cfg)
        keys = np.arange(1, 201, dtype=np.uint64)
        _fill(c, t, keys)
        out = {"spilled": c.spill(t, hot_budget=0)}
        u = _usage(p, server, 5)
        out["ssd_positive"] = u["ssd_bytes"] > 0
        _register(p, server, 5, token=b"ssd", max_ssd_bytes=1)
        out["over"] = _outcome(p, _fill, c, t, np.asarray([10_001], np.uint64))
        out["size"] = c.size(t)
        out["read"] = c.pull_sparse(t, keys[:8], create=False).tolist()
        out["refused"] = _usage(p, server, 5)["quota_refused"]
        c.close()
        return out


def test_ssd_bytes_quota_metered_from_live_sst_stats(tmp_path):
    got = both(_ssd_quota_scenario, str(tmp_path))
    assert got["spilled"] == 200 and got["ssd_positive"]
    assert got["over"] == "QuotaExceededError" and got["size"] == 200
    assert got["refused"] == 1 and len(got["read"]) == 8


# -- weighted admission: batch sheds, serve queues --------------------------------


def _batch_shed_scenario(p):
    # rate 5/s, burst 10, cost 1 + 3 keys = 4 a pull: two pulls fit the
    # bucket, the third sheds (the refill over the run is far below 1 token)
    with _Server(p) as server:
        _register(p, server, 1, token=b"a", pclass=1, rate=5.0, burst=10.0)
        _register(p, server, 2, token=b"b")
        c1 = _client(p, server, 1, b"a")
        t1 = p.tenancy.tenant_table_id(1, 0)
        c1.create_sparse_table(t1, _cfg(p))
        keys = np.arange(1, 4, dtype=np.uint64)
        steps, hint = [], None
        for _ in range(4):
            try:
                c1.pull_sparse(t1, keys)
                steps.append("ok")
            except p.Throttled as e:
                steps.append("ThrottledError")
                hint = e.retry_after_ms
        c2 = _client(p, server, 2, b"b")
        t2 = p.tenancy.tenant_table_id(2, 0)
        c2.create_sparse_table(t2, _cfg(p))
        neighbour = [_outcome(p, c2.pull_sparse, t2, keys) for _ in range(6)]
        out = {"steps": steps, "hint_actionable": hint is not None and hint >= 1,
               "neighbour": neighbour, "u1": _usage(p, server, 1), "u2": _usage(p, server, 2)}
        c1.close()
        c2.close()
        return out


def test_batch_class_sheds_with_retry_after():
    got = both(_batch_shed_scenario)
    assert got["steps"][:3] == ["ok", "ok", "ThrottledError"] and got["hint_actionable"]
    assert got["neighbour"] == ["ok"] * 6
    assert got["u1"]["throttled"] >= 1 and got["u2"]["throttled"] == 0


def _serve_queue_scenario(p):
    # serve class at a refill that recovers within the server's brief wait:
    # a modest overload rides through with no ThrottledError
    with _Server(p) as server:
        _register(p, server, 3, token=b"s", pclass=0, rate=2000.0, burst=5.0)
        c = _client(p, server, 3, b"s")
        t = p.tenancy.tenant_table_id(3, 0)
        c.create_sparse_table(t, _cfg(p))
        keys = np.arange(1, 4, dtype=np.uint64)
        out = {"steps": [_outcome(p, c.pull_sparse, t, keys) for _ in range(10)],
               "u": _usage(p, server, 3)}
        c.close()
        return out


def test_serve_class_queues_briefly_instead_of_shedding():
    got = both(_serve_queue_scenario)
    assert got["steps"] == ["ok"] * 10 and got["u"]["throttled"] == 0 and got["u"]["pclass"] == 0


def _replay_scenario(p):
    with _Server(p) as server:
        _register(p, server, 1, token=b"a")
        c = _client(p, server, 1, b"a")
        t = p.tenancy.tenant_table_id(1, 0)
        c.create_sparse_table(t, _cfg(p))
        _fill(c, t, np.arange(1, 9, dtype=np.uint64))
        # sever every socket: the next call reconnects and must say hello
        # first, or it would bounce off the fence as tenant 0
        for conn in c._conns:
            conn.close()
        out = {"size": c.size(t), "other": _outcome(p, c.size, p.tenancy.tenant_table_id(2, 0))}
        c.close()
        return out


def test_reconnect_replays_hello():
    assert both(_replay_scenario) == {"size": 8, "other": "WrongTenantError"}


def test_every_connection_of_a_tenant_client_says_hello():
    """The serve class and the tenant binding reach every connection the
    client builds: the first ones, a failover's replacement and a
    reshard's new shards (``_conn_kw``, as the JAX client keeps it)."""
    with _Server(PORT) as a, _Server(PORT) as b:
        _register(PORT, a, 4, token=b"t")
        _register(PORT, b, 4, token=b"t")
        c = PORT.rpc.RpcPsClient([f"127.0.0.1:{a.port}"], qos="serve", tenant=(4, b"t"))
        assert c._conn_kw == {"io_timeout_flag": "pserver_serve_timeout_ms",
                              "max_retry_flag": "pserver_serve_max_retry",
                              "hello": (4, b"t")}
        c._swap_conn(0, f"127.0.0.1:{b.port}")
        conn = c._conns[0]
        assert (conn.endpoint, conn._hello, conn._io_flag) == (
            f"127.0.0.1:{b.port}", (4, b"t"), "pserver_serve_timeout_ms")
        t = tenancy.tenant_table_id(4, 0)
        c.create_sparse_table(t, _cfg(PORT))
        assert _outcome(PORT, c.size, tenancy.tenant_table_id(5, 0)) == "WrongTenantError"
        c.close()


# -- the directory over an HACluster ----------------------------------------------


def _directory_scenario(p):
    p.registry.REGISTRY.reset()
    with p.ha.HACluster(num_shards=2, replication=2, sync=True) as cluster:
        d = p.tenancy.TenantDirectory(cluster)
        ctr = d.register(p.tenancy.Tenant(name="ctr", tid=1, token=b"ctr", max_rows=10_000))
        d.register(p.tenancy.Tenant(name="moe", tid=2, token=b"moe"))
        out = {"imposter": _raises(d.register, p.tenancy.Tenant(name="imposter", tid=1))}
        cli = d.client("ctr")
        t = ctr.table_id(0)
        cli.create_sparse_table(t, _cfg(p))
        keys = np.arange(1, 65, dtype=np.uint64)
        cli.pull_sparse(t, keys)
        _fill(cli, t, keys)
        cluster.drain()
        out["usage"] = {n: d.usage(n) for n in ("ctr", "moe")}
        out["refreshed"] = d.refresh_usage()
        snap = p.registry.REGISTRY.snapshot()["metrics"]["tenant_rows"]
        out["gauges"] = {s["labels"]["tenant"]: s["value"] for s in snap["series"]}
        before = cli.pull_sparse(t, keys, create=False)
        dead = cluster.kill_primary(0)
        after = cli.pull_sparse(t, keys, create=False)
        out["rows_across_failover"] = np.array_equal(before, after)
        out["rows"] = after.tolist()
        out["promoted"] = cluster.wait_promoted(0, dead) != dead
        out["fence_after_failover"] = _outcome(p, cli.size, p.tenancy.tenant_table_id(2, 0))
        out["usage_after"] = d.usage("ctr")
        back = cluster.restart_replica(0, dead)
        out["synced"] = d.sync_server(back.endpoint)
        return out


def test_tenant_directory_register_client_usage_failover():
    got = both(_directory_scenario)
    assert got["imposter"] and got["rows_across_failover"] and got["promoted"]
    assert got["usage"]["ctr"]["rows"] == 64 and got["usage"]["moe"]["rows"] == 0
    assert got["gauges"] == {"ctr": 64, "moe": 0}
    assert got["fence_after_failover"] == "WrongTenantError"
    assert got["usage_after"]["rows"] == 64 and got["synced"] == 2


# -- hot-tier slot caps --------------------------------------------------------------


def _tier_caps_scenario(p):
    tbl = p.MemorySparseTable(p.TableConfig(shard_num=2, accessor="ctr"))
    tier = p.HotEmbeddingTier(tbl, p.HotTierConfig(capacity=64, tenant_slots={1: 8}),
                              **p.tier_kw)
    ns = p.tenancy.namespace_keys
    t2_keys = ns(2, np.arange(1, 17, dtype=np.uint64))
    out = {"rows2": tier.ensure(t2_keys).tolist(), "res": []}
    for i in range(3):
        rows = tier.ensure(ns(1, np.arange(100 + i * 8, 108 + i * 8, dtype=np.uint64)))
        out["res"].append((rows.tolist(), tier.tenant_residency()))
    st = tier.stats()
    out["stats_tenants"] = st["tenants"]
    out["evictions"] = tier.counters["tenant_cap_evictions"]
    misses = tier.stats()["misses"]
    tier.ensure(t2_keys)
    out["misses_unchanged"] = tier.stats()["misses"] == misses
    out["res2"] = tier.tenant_residency()[2]
    out["resident"] = sorted(tier.resident_keys().tolist())
    out["too_big"] = _raises(tier.ensure, ns(1, np.arange(500, 512, dtype=np.uint64)))
    return out


def test_hot_tier_tenant_caps_evict_own_rows_only():
    got = both(_tier_caps_scenario)
    assert all(res.get(1, 0) <= 8 for _, res in got["res"])
    assert got["stats_tenants"][1] <= 8 and got["evictions"] >= 16
    assert got["misses_unchanged"] and got["res2"] == 16 and got["too_big"]


# -- the per-tenant control plane ----------------------------------------------------


def _tenant_rules(p, root):
    reg = p.registry.Registry()
    ring = p.timeseries.MetricRing()
    g_a = reg.gauge("tenant_pull_s", max_series=8, tenant="ctr")
    g_b = reg.gauge("tenant_pull_s", max_series=8, tenant="moe")
    for i in range(4):
        g_a.set(0.2)  # ctr breaches 50 ms
        g_b.set(0.001)  # moe is healthy
        ring.append(reg.snapshot(), t=float(i))
    rules = p.tenancy.tenant_slo_rules("ctr") + p.tenancy.tenant_slo_rules("moe")
    wd = p.slo.SloWatchdog(ring, rules)
    fired = [(a.rule, a.t, a.windows, a.labels) for a in wd.evaluate(now=3.0)]
    rec = p.tenancy.tenant_flight_recorder(os.path.join(root, "jax" if p is JAX else "port"),
                                           "ctr", ring=ring, watchdog=wd, min_interval_s=0.0)
    path = rec.trigger("tenant_slo")
    man = json.load(open(os.path.join(path, "manifest.json")))
    return {"rules": [(r.name, r.family, r.kind, r.threshold, r.agg, r.field, r.labels,
                       r.windows, r.min_count) for r in rules],
            "fired": fired, "dir": os.path.basename(os.path.dirname(path)),
            "scope": man["scope"],
            "alerts": json.load(open(os.path.join(path, "alerts.json")))["alerts"],
            "timeline": len(json.load(open(os.path.join(path, "timeline.json")))["records"])}


def test_tenant_slo_rules_fire_per_tenant_only(tmp_path):
    got = both(_tenant_rules, str(tmp_path))
    fired = {f[0] for f in got["fired"]}
    assert "ctr_pull_p99" in fired and not any(r.startswith("moe_") for r in fired)
    assert got["dir"] == "tenant_ctr" and got["scope"] == {"tenant": "ctr"}
    assert got["alerts"], "the scoped bundle dropped the tenant's own alerts"
    assert all((a.get("labels") or {}).get("tenant") == "ctr" for a in got["alerts"])
    assert got["timeline"] == 4


class _FakeCluster:
    job_id = "as-test"

    def __init__(self, p):
        self.n = 2
        self.store = p.elastic.MemoryStore()

    @property
    def num_shards(self):
        return self.n


class _FakeController:
    def __init__(self, p):
        self.cluster = _FakeCluster(p)

    def grow(self, factor):
        self.cluster.n *= factor
        return {"cutover_pause_ms": 1.0, "bootstrap_s": 0.01}


def _tenant_lever(p):
    rules = p.tenancy.tenant_slo_rules("ctr", pull_p99_s=0.05)
    ctrl = _FakeController(p)
    a = p.autoscale.Autoscaler(ctrl, config=p.autoscale.AutoscaleConfig(
        min_shards=2, max_shards=8, cooldown_up_s=5.0, cooldown_down_s=10.0,
        clear_hold_s=4.0, up_rules=("ctr_pull_p99",)), clock=lambda: 0.0, tenant="ctr")
    a.notify_fire(types.SimpleNamespace(rule="moe_pull_p99"))  # a neighbour's burn
    steps = [a.step()]
    a.notify_fire(types.SimpleNamespace(rule=rules[0].name))
    steps.append(a.step())
    return {"steps": steps, "shards": ctrl.cluster.n,
            "journal": [{k: v for k, v in e.items() if k not in ("t", "wall_s")}
                        for e in a.events]}


def test_tenant_autoscaler_lever_is_scoped():
    """A per-tenant Autoscaler answers ONE tenant's rules and journals under
    its tenant tag — the per-tenant scaling lever."""
    got = both(_tenant_lever)
    assert got["steps"] == [None, "up"] and got["shards"] == 4
    assert got["journal"][-1]["tenant"] == "ctr"


def _recorder_scenario(p, root):
    rec = p.tenancy.tenant_flight_recorder(os.path.join(root, "jax" if p is JAX else "port"),
                                           "ctr", min_interval_s=0.0)
    path = rec.trigger("tenant_slo")
    man = json.load(open(os.path.join(path, "manifest.json")))
    alerts = json.load(open(os.path.join(path, "alerts.json")))["alerts"]
    return {"dir": os.path.basename(os.path.dirname(path)), "bundle": os.path.basename(path),
            "scope": man["scope"], "reason": man["reason"], "alerts": alerts,
            "files": man["files"]}


def test_tenant_flight_recorder_is_scoped(tmp_path):
    """The scoped recorder's bundle lives in the tenant's own directory and
    stamps its scope; with no watchdog its alert file is empty in both."""
    got = both(_recorder_scenario, str(tmp_path))
    assert got["dir"] == "tenant_ctr" and got["scope"] == {"tenant": "ctr"}


def test_scoped_recorder_filters_alerts_by_label(tmp_path):
    """The scope filter itself, on alerts of three labellings, called
    directly."""
    mixed = [{"rule": "ctr_pull_p99", "labels": {"tenant": "ctr"}},
             {"rule": "moe_pull_p99", "labels": {"tenant": "moe"}},
             {"rule": "global"}]
    scoped = tenancy.tenant_flight_recorder(str(tmp_path), "ctr")
    assert scoped.in_scope(mixed) == mixed[:1]
    assert flightrec.FlightRecorder(str(tmp_path / "all")).in_scope(mixed) == mixed


# -- the interference e2e's isolation, without its p99 bound ----------------------


def _interference_scenario(p):
    with p.ha.HACluster(num_shards=2, replication=1, sync=True) as cluster:
        d = p.tenancy.TenantDirectory(cluster)
        names = ["ctr", "moe", "tdm"]
        for i, name in enumerate(names):
            d.register(p.tenancy.Tenant(name=name, tid=i + 1, token=name.encode()))
        # the abuser: rate 5/s (the refill over the run is ~1 % of a frame's
        # 257 units), burst 1000, capped at 200 rows a shard
        d.register(p.tenancy.Tenant(name="abuse", tid=9, token=b"abuse", pclass=1, rate=5.0,
                                    burst=1000.0, max_rows=200))
        clis, tables = {}, {}
        for name in names + ["abuse"]:
            cli = d.client(name)
            t = d.get(name).table_id(0)
            cli.create_sparse_table(t, _cfg(p))
            if name != "abuse":
                _fill(cli, t, np.arange(1, 2001, dtype=np.uint64))
            clis[name], tables[name] = cli, t
        cluster.drain()
        before = {n: clis[n].digest(tables[n]) for n in names}
        rows_before = {n: d.usage(n)["rows"] for n in names}
        seen = []

        def flood():
            # fat pulls that create rows (256 keys a shard a frame) and
            # probes of a neighbour's table
            cli, t = clis["abuse"], tables["abuse"]
            for i in range(5):
                keys = np.arange((i + 1) << 20, ((i + 1) << 20) + 512, dtype=np.uint64)
                seen.append(_outcome(p, cli.pull_sparse, t, keys, create=True))
                seen.append(_outcome(p, cli.size, tables["ctr"]))

        th = threading.Thread(target=flood, name="tenant-abuse")
        th.start()
        pulled = {n: clis[n].pull_sparse(tables[n], np.arange(1, 2001, dtype=np.uint64),
                                          create=False) for n in names}
        th.join(60)
        cluster.drain()
        au = d.usage("abuse")
        return {"abuse": seen, "abuse_usage": {k: au[k] for k in ("rows", "throttled",
                                                                  "quota_refused")},
                "digests_kept": {n: clis[n].digest(tables[n]) == before[n] for n in names},
                "digests": before,
                "rows_kept": {n: d.usage(n)["rows"] == rows_before[n] for n in names},
                "pulled": {n: v.tolist() for n, v in pulled.items()}}


def test_interference_isolation_digests_abuser_contained():
    got = both(_interference_scenario)
    pulls = got["abuse"][0::2]
    assert pulls == ["ok", "QuotaExceededError", "QuotaExceededError", "ThrottledError",
                     "ThrottledError"], pulls
    assert set(got["abuse"][1::2]) == {"WrongTenantError"}
    assert got["abuse_usage"]["rows"] <= 2 * (200 + 256)
    assert got["abuse_usage"]["throttled"] > 0 and got["abuse_usage"]["quota_refused"] > 0
    assert all(got["digests_kept"].values()) and all(got["rows_kept"].values())
