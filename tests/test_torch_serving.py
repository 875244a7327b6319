"""The serving read path in the port (``paddle_tpu_torch.serving`` over the
port's read-only attach mode, observer registration and serve QoS class),
the cases of ``tests/test_serving.py`` held against the JAX package.

Each test runs one scenario through the JAX package and through the port
and compares what each saw, exactly: errors, flags and breaker states,
digests, rows and values served, the frontend's results and counters.
Where a scenario waits on threads (the feed, the frontend's worker), what
is compared is what the wait proves, not how long it took. The cached
lookup's staleness bound runs on a clock patched into both lookup modules
(``serving.lookup.time``), not on sleeps.

Across the packages, on top: the dense-tower publishers give the same flat
vector bit for bit for a DeepFM's converted params, and the port's
``unravel`` gives the dict back; a small end to end run (a 2-shard HA
cluster, a DeepFM tenant trained 2 epochs over the hot tier beside a
throttled abuser, then read-only replicas serving its predictions) agrees
with the same composition in JAX at the tolerances of
``tests/test_torch_reshard.py`` (losses rtol 1e-5, dense params rtol 1e-4 /
atol 1e-6, rows rtol 1e-4 / atol 1e-5) and predictions at rtol 1e-4 / atol
1e-5 (the same dense products in another BLAS order). ``chip_smoke.py``
phase 18 runs at a small size on the CPU.
"""

import importlib
import os
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

import paddle_tpu as pt
from paddle_tpu import nn as jax_nn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.data.dataset import InMemoryDataset as JaxDataset
from paddle_tpu.data.dataset import SlotDesc as JaxSlotDesc
from paddle_tpu.models.ctr import CtrConfig as JaxCtrConfig
from paddle_tpu.models.ctr import DeepFM as JaxDeepFM
from paddle_tpu.ps.ps_trainer import CtrStreamTrainer as JaxTrainer
from paddle_tpu_torch.convert import ctr_params_from_jax, ctr_params_to_jax, ravel_tree
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer

pytestmark = pytest.mark.usefixtures("jax_native")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 15.0
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
PRED_TOL = dict(rtol=1e-4, atol=1e-5)


def _pkg(root, tier_kw):
    m = lambda name: importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        rpc=m("ps.rpc"), ha=m("ps.ha"), serving=m("serving"),
        lookup_mod=m("serving.lookup"), tenancy=m("ps.tenancy"), flags=m("core.flags"),
        enforce=m("core.enforce"), AccessorConfig=m("ps.accessor").AccessorConfig,
        SGDRuleConfig=m("ps.sgd_rule").SGDRuleConfig, TableConfig=m("ps.table").TableConfig,
        HotEmbeddingTier=m("ps.hot_tier").HotEmbeddingTier,
        HotTierConfig=m("ps.hot_tier").HotTierConfig, comm=m("ps.communicator"),
        faultpoints=m("ps.faultpoints"), tier_kw=tier_kw)


JAX = _pkg("paddle_tpu", {})
PORT = _pkg("paddle_tpu_torch", {"device": "cpu"})


def both(scenario, *args):
    """The scenario's record through the JAX package, then the port's; they
    must be equal. Returns the port's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want, f"port {got}\n!= JAX {want}"
    return got


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


def _replica(p, cluster, shard=0, **kw):
    kw.setdefault("hb_interval", 0.05)
    kw.setdefault("hb_ttl", 0.4)
    return p.serving.ServingReplica(cluster.store, cluster.job_id, shard=shard, **kw)


def _wait(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _wait_digest_match(cluster, shard, serve_cli, table_id=0):
    """Until the replica's digest equals the shard primary's; returns it."""
    def same():
        prim = cluster.primary(shard).endpoint
        return cluster.digests(table_id, shard).get(prim) == serve_cli.digest(table_id)[0]
    _wait(same, "the replica's digest never reached the primary's")
    return serve_cli.digest(table_id)[0]


# -- read-only attach mode and serve QoS ---------------------------------------------


def _read_only_scenario(p):
    with _cluster(p) as cluster:
        cli = cluster.client()
        cli.create_sparse_table(0, _cfg(p))
        rng = np.random.default_rng(0)
        keys = np.arange(64, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        with _replica(p, cluster) as rep:
            serve = rep.client()
            serve.create_sparse_table(0, _cfg(p))  # the bootstrap plane: allowed
            width = serve._dims(0)[1]
            try:
                serve.push_sparse(0, keys[:4], _push(rng, keys[:4], width))
                refused = None
            except p.enforce.PreconditionNotMetError as e:
                refused = (type(e).__name__, "read-only" in str(e).lower())
            sz0 = serve.size(0)
            out = serve.pull_sparse(0, np.asarray([1 << 50], np.uint64), create=True)
            return {"refused": refused, "phantom": serve.size(0) != sz0,
                    "zeros": out.tolist(), "read_only": rep.status()["read_only"]}


def test_read_only_replica_refuses_training_plane():
    got = both(_read_only_scenario)
    assert got["refused"] == ("PreconditionNotMetError", True)
    assert not got["phantom"] and not np.any(got["zeros"]) and got["read_only"]


def _serve_qos_scenario(p):
    flag = p.flags.flag
    with _cluster(p) as cluster:
        serve_cli = cluster.client(qos="serve")
        train_cli = cluster.client()
        out = {"serve_flags": (serve_cli._conns[0]._io_flag, serve_cli._conns[0]._retry_flag),
               "train_flags": (train_cli._conns[0]._io_flag, train_cli._conns[0]._retry_flag),
               "serve_retry": int(flag("pserver_serve_max_retry"))}
        ep = serve_cli._conns[0].endpoint
        srouter, trouter = serve_cli._router, train_cli._router
        out["qos"] = (srouter.qos, trouter.qos)
        out["serve_failures"] = srouter.breaker(ep).failures
        out["flag_failures"] = int(flag("ps_serve_breaker_failures"))
        for _ in range(srouter.breaker(ep).failures):
            srouter.record(ep, ok=False)
        out["states"] = (srouter.breaker(ep).state, trouter.breaker(ep).state)
        out["train_allowed"] = trouter.allow(ep)
        out["serve_reads"] = serve_cli.qos
        return out


def test_serve_qos_deadline_class_and_breaker_isolation():
    got = both(_serve_qos_scenario)
    assert got["serve_flags"] == ("pserver_serve_timeout_ms", "pserver_serve_max_retry")
    assert got["train_flags"] == ("pserver_timeout_ms", "pserver_max_retry")
    assert got["serve_retry"] == 1 and got["serve_failures"] == got["flag_failures"] == 2
    assert got["states"] == (PORT.ha.CircuitBreaker.OPEN, PORT.ha.CircuitBreaker.CLOSED)
    assert got["train_allowed"] and got["qos"] == ("serve", "train")


# -- subscription catch-up, staleness, the dense feed ---------------------------------


def _catch_up_scenario(p):
    with _cluster(p) as cluster:
        cli = cluster.client()
        cli.create_sparse_table(0, _cfg(p))
        rng = np.random.default_rng(1)
        keys = rng.integers(0, 1 << 40, 2000).astype(np.uint64)
        cli.pull_sparse(0, keys)
        width = cli._dims(0)[1]
        cli.push_sparse(0, keys, _push(rng, keys, width))
        with _replica(p, cluster) as rep:
            serve = rep.client()
            serve.create_sparse_table(0, _cfg(p))
            snap = _wait_digest_match(cluster, 0, serve)
            cli.push_sparse(0, keys[:100], _push(rng, keys[:100], width))
            cluster.drain()
            tail = _wait_digest_match(cluster, 0, serve)
            return {"snapshot_digest": snap, "tail_digest": tail,
                    "applied": rep.status()["applied_seq"] > 0,
                    "rows": serve.pull_sparse(0, keys[:64], create=False).tolist()}


def test_replica_subscription_catch_up_digest_equal():
    got = both(_catch_up_scenario)
    assert got["applied"] and got["snapshot_digest"] != got["tail_digest"]


def _freshness_scenario(p):
    with _cluster(p) as cluster:
        cli = cluster.client()
        cli.create_sparse_table(0, _cfg(p))
        rng = np.random.default_rng(2)
        keys = np.arange(512, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        width = cli._dims(0)[1]
        marker_key = np.asarray([1 << 41], np.uint64)
        cli.pull_sparse(0, marker_key)
        with _replica(p, cluster) as rep:
            serve = rep.client()
            serve.create_sparse_table(0, _cfg(p))
            _wait_digest_match(cluster, 0, serve)
            stop = threading.Event()

            def writer():
                while not stop.is_set():
                    cli.push_sparse(0, keys, _push(rng, keys, width))

            th = threading.Thread(target=writer)
            th.start()
            try:
                probe = p.serving.FreshnessProbe(timeout_s=5.0)
                marker = [0.0]

                def write():
                    marker[0] += 1.0
                    mp = np.zeros((1, width), np.float32)
                    mp[0, 2] = marker[0]  # the click stat: additive, pull column 1
                    cli.push_sparse(0, marker_key, mp)

                seen = [probe.measure(write,
                                      lambda: serve.pull_sparse(0, marker_key, create=False)[0, 1],
                                      lambda v, m=marker: v >= m[0]) is not None
                        for _ in range(5)]
            finally:
                stop.set()
                th.join()
            st = probe.stats()
            return {"seen": seen, "failures": st["failures"], "probes": st["probes"],
                    "p95_bounded": st["p95_ms"] < 5000,
                    "fresh_feed": rep.status()["since_last_apply_s"] < 5.0}


def test_replica_bounded_staleness_under_concurrent_pushes():
    got = both(_freshness_scenario)
    assert got == {"seen": [True] * 5, "failures": 0, "probes": 5, "p95_bounded": True,
                   "fresh_feed": True}


def _dense_feed_scenario(p):
    with _cluster(p) as cluster:
        cli = cluster.client()
        params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "b": np.zeros(3, np.float32)}
        pub = p.serving.DenseTowerPublisher(cli, 7, params)
        with _replica(p, cluster) as rep:
            got = []
            p.serving.DenseTowerSync(rep, 7, pub.dim, pub.unravel, sink=got.append)
            pub.publish({"w": params["w"] + 1.0, "b": params["b"] + 2.0})
            _wait(lambda: got and np.allclose(np.asarray(got[-1]["b"]), 2.0),
                  "the dense sync never delivered the published values")
            st = rep.status()
            return {"dim": pub.dim, "w": np.asarray(got[-1]["w"]).tolist(),
                    "b": np.asarray(got[-1]["b"]).tolist(),
                    "refreshed": st["dense_refreshes"] >= 1, "errors": st["sync_errors"]}


def test_dense_tower_feed_triggered_sync():
    got = both(_dense_feed_scenario)
    assert got["w"] == (np.arange(6).reshape(2, 3) + 1.0).tolist() and got["b"] == [2.0] * 3
    assert got["refreshed"] and got["errors"] == 0 and got["dim"] == 9


def test_dense_tower_publisher_flat_vector_matches_jax():
    """A DeepFM's dense tower: the JAX publisher on the JAX model's params
    and the port's on the converted params (``ctr_params_to_jax``) send the
    same vector bit for bit; the port's ``unravel`` gives the dict back."""
    class _Rec:
        def create_dense_table(self, table_id, dim, optimizer="adam"):
            self.dim = dim

        def set_dense(self, table_id, values):
            self.flat = np.array(values, np.float32)

    pt.seed(3)
    jmodel = JaxDeepFM(JaxCtrConfig(num_sparse_slots=3, num_dense=2, embedx_dim=8,
                                    dnn_hidden=(8, 4)))
    jparams = {k: np.asarray(v) for k, v in jmodel.named_parameters()}
    jrec, prec = _Rec(), _Rec()
    jpub = JAX.serving.DenseTowerPublisher(jrec, 7, jparams)
    jpub.publish(jparams)
    port_params = ctr_params_from_jax(jparams)
    tree = ctr_params_to_jax(port_params)["params"]
    ppub = PORT.serving.DenseTowerPublisher(prec, 7, tree)
    ppub.publish(tree)
    assert jpub.dim == ppub.dim == jrec.dim == prec.dim == jrec.flat.size
    assert jrec.flat.dtype == prec.flat.dtype == np.float32
    assert np.array_equal(jrec.flat.view(np.uint32), prec.flat.view(np.uint32))
    back = ctr_params_from_jax(ppub.unravel(prec.flat))
    assert back.keys() == port_params.keys()
    for k, v in port_params.items():
        assert torch.equal(back[k], v), k
    # and the plain helper on a nested tree (an empty dict flattens to nothing)
    flat, unravel = ravel_tree({"b": torch.ones(2), "a": {"z": np.zeros((2, 2), np.float32)},
                                "e": {}})
    assert flat.tolist() == [0.0] * 4 + [1.0] * 2
    assert torch.equal(unravel(flat)["b"], torch.ones(2)) and unravel(flat)["e"] == {}


# -- the frontend: micro-batching, shedding, deadlines --------------------------------


class _StubLookup:
    """Deterministic source: value row = [key, key + 0.5]; counts calls and
    can add latency."""

    def __init__(self, delay_s=0.0):
        self.calls = 0
        self.keys_seen = 0
        self.delay_s = delay_s

    def lookup(self, keys):
        self.calls += 1
        self.keys_seen += len(keys)
        if self.delay_s:
            time.sleep(self.delay_s)
        k = keys.astype(np.float64)
        return np.stack([k, k + 0.5], axis=1).astype(np.float32)


def _micro_batch_scenario(p):
    src = _StubLookup()
    with p.serving.ServingFrontend(src, config=p.serving.FrontendConfig(
            max_batch=16, max_delay_us=5000, queue_cap=256)) as fe:
        pending = [fe.submit(np.arange(i * 8, i * 8 + 8, dtype=np.uint64), deadline_ms=5000)
                   for i in range(48)]
        outs = [pp.result(10).tolist() for pp in pending]
        st = fe.stats()
        return {"outs": outs, "served": st["served"], "coalesced": src.calls <= 24,
                "avg_batch_gt1": st["avg_batch"] > 1}


def test_frontend_micro_batches_and_scatters_correctly():
    got = both(_micro_batch_scenario)
    assert got["served"] == 48 and got["coalesced"] and got["avg_batch_gt1"]
    assert got["outs"][5] == [[float(k), k + 0.5] for k in range(40, 48)]


def _infer_scenario(p):
    def infer(emb, dense):
        return emb[:, :, 0].sum(axis=1) + dense[:, 0]

    with p.serving.ServingFrontend(_StubLookup(), infer=infer, config=p.serving.FrontendConfig(
            max_batch=8, max_delay_us=2000, queue_cap=64)) as fe:
        return float(fe(np.asarray([3, 4], np.uint64), dense=np.asarray([10.0], np.float32),
                        deadline_ms=5000))


def test_frontend_infer_receives_stacked_batch():
    assert both(_infer_scenario) == 17.0


def _shed_scenario(p):
    src = _StubLookup(delay_s=0.05)
    fe = p.serving.ServingFrontend(src, config=p.serving.FrontendConfig(
        max_batch=4, max_delay_us=100, queue_cap=4, retry_after_ms=7.0))
    try:
        accepted, shed, hints_ok = [], 0, True
        for _ in range(64):
            try:
                accepted.append(fe.submit(np.arange(4, dtype=np.uint64), deadline_ms=30000))
            except p.serving.RequestRejected as e:
                shed += 1
                hints_ok &= e.retry_after_ms >= 7.0
        counted = fe.stats()["shed"] == shed
        shapes = {pp.result(30).shape for pp in accepted}
    finally:
        fe.stop()
    try:
        fe.submit(np.arange(4, dtype=np.uint64))
        after_stop = "accepted"
    except p.serving.RequestRejected:
        after_stop = "rejected"
    return {"shed_some": shed > 0, "hints_ok": hints_ok, "counted": counted,
            "shapes": shapes, "after_stop": after_stop}


def test_frontend_admission_control_sheds_under_overload():
    assert both(_shed_scenario) == {"shed_some": True, "hints_ok": True, "counted": True,
                                    "shapes": {(4, 2)}, "after_stop": "rejected"}


def _priority_scenario(p):
    class _Gated(_StubLookup):
        def __init__(self):
            super().__init__()
            self.gate = threading.Event()

        def lookup(self, keys):
            self.gate.wait(30)
            return super().lookup(keys)

    src = _Gated()
    fe = p.serving.ServingFrontend(src, config=p.serving.FrontendConfig(
        max_batch=1, max_delay_us=100, queue_cap=2, retry_after_ms=5.0), idle_pop_s=0.005)
    key = np.arange(2, dtype=np.uint64)
    try:
        plug = fe.submit(key, deadline_ms=60000)
        # the plug occupies the worker before anything else is queued
        _wait(lambda: fe.stats()["queue_depth"] == 0 and src.calls == 0 and not fe.idle(),
              "the worker never took the plug")
        order, batch_p, serve_p = [], [], []
        for _ in range(2):
            pp = fe.submit(key, deadline_ms=60000, priority="batch")
            pp.add_done_callback(lambda: order.append("batch"))
            batch_p.append(pp)
        out = {}
        try:
            fe.submit(key, deadline_ms=60000, priority="batch")
        except p.serving.RequestRejected as e:
            out["batch_shed_hint"] = e.retry_after_ms >= 5.0
        st = fe.stats()
        out["after_batch"] = (st["shed_batch"], st["shed"])
        for _ in range(2):
            pp = fe.submit(key, deadline_ms=60000, priority="serve")
            pp.add_done_callback(lambda: order.append("serve"))
            serve_p.append(pp)
        try:
            fe.submit(key, deadline_ms=60000, priority="serve")
            out["serve_overload"] = "accepted"
        except p.serving.RequestRejected:
            out["serve_overload"] = "shed"
        st = fe.stats()
        out["counters"] = (st["shed"], st["shed_batch"], st["accepted"], st["accepted_batch"])
        src.gate.set()
        for pp in serve_p + batch_p + [plug]:
            pp.result(30)
        out["order"] = order
        out["served"] = fe.stats()["served"]
        return out
    finally:
        src.gate.set()
        fe.stop()


def test_frontend_priority_classes_shed_and_serve_order():
    got = both(_priority_scenario)
    assert got == {"batch_shed_hint": True, "after_batch": (1, 0), "serve_overload": "shed",
                   "counters": (1, 1, 3, 2), "order": ["serve", "serve", "batch", "batch"],
                   "served": 5}


def _deadline_scenario(p):
    src = _StubLookup(delay_s=0.03)
    with p.serving.ServingFrontend(src, config=p.serving.FrontendConfig(
            max_batch=2, max_delay_us=100, queue_cap=64)) as fe:
        slow = [fe.submit(np.arange(2, dtype=np.uint64), deadline_ms=30000) for _ in range(6)]
        doomed = fe.submit(np.arange(2, dtype=np.uint64), deadline_ms=1)
        try:
            doomed.result(30)
            fate = "served"
        except p.serving.DeadlineExceeded:
            fate = "dropped"
        for pp in slow:
            pp.result(30)
        return {"fate": fate, "dropped": fe.stats()["deadline_dropped"] >= 1,
                "keys_seen": src.keys_seen}


def test_frontend_deadline_dropped_before_lookup():
    assert both(_deadline_scenario) == {"fate": "dropped", "dropped": True, "keys_seen": 12}


# -- the warm path: the cached lookup over the replica --------------------------------


class _Clock:
    """A ``time`` stand-in for the lookup module: ``perf_counter`` reads
    ``now``, which the test moves."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now


def _cached_scenario(p, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(p.lookup_mod, "time", clock)
    with _cluster(p) as cluster:
        cli = cluster.client()
        cli.create_sparse_table(0, _cfg(p))
        rng = np.random.default_rng(3)
        keys = np.arange(256, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        width = cli._dims(0)[1]
        cli.push_sparse(0, keys, _push(rng, keys, width))
        with _replica(p, cluster) as rep:
            serve = rep.client()
            view = rep.serve_view(0, _cfg(p), client=serve)
            _wait_digest_match(cluster, 0, serve)
            # the digest matches once the snapshot lands, and the feed cursor
            # then moves through the oplog's tail (no row changes): rows
            # stamped before that would read as stale on an idle feed
            top = cluster.primary(0).server.oplog_seq()
            _wait(lambda: rep.applied_seq >= top, "the replica's feed never reached the oplog")
            tier = p.HotEmbeddingTier(view, p.HotTierConfig(capacity=1 << 10,
                                                            create_on_miss=False),
                                      **p.tier_kw)
            cl = p.serving.CachedLookup(tier, replica=rep, freshness_budget_s=0.03)
            v0 = cl.lookup(keys)
            out = {"shape": v0.shape, "v0": v0.tolist()}
            serve.reset_op_counts()
            v1 = cl.lookup(keys)
            out["warm_ops"] = serve.reset_op_counts()
            out["warm_same"] = np.array_equal(v0, v1)
            clock.now += 0.05  # past the budget, the feed idle: no refresh
            serve.reset_op_counts()
            cl.lookup(keys)
            out["idle_ops"] = serve.reset_op_counts()
            cli.push_sparse(0, keys[:16], _push(rng, keys[:16], width))
            cluster.drain()
            _wait_digest_match(cluster, 0, serve)
            clock.now += 0.05  # past the budget again, the feed advanced: refresh
            v2 = cl.lookup(keys[:16])
            out["v2"] = v2.tolist()
            out["changed"] = not np.allclose(v1[:16], v2)
            out["refreshes"] = cl.refreshes
            direct = p.serving.ReplicaLookup(serve, 0).lookup(keys[:16])
            out["matches_replica"] = np.array_equal(v2[:, 0], direct[:, 2])
            return out


def test_cached_lookup_warm_zero_rpc_and_staleness_bound(monkeypatch):
    got = both(_cached_scenario, monkeypatch)
    assert got["shape"] == (256, 5) and got["warm_ops"] == {} and got["warm_same"]
    assert got["idle_ops"] == {}
    assert got["changed"] and got["refreshes"] == 16 and got["matches_replica"]


# -- serving through a failover --------------------------------------------------------


def _failover_scenario(p, drain_before_kill=True, ship_delay_ms=0):
    """A primary killed by its third push, a replica serving through the
    promotion. The shipper forwards the primary's oplog to its backup on a
    thread of its own, so a push that the primary acknowledged but had not
    yet shipped when it died is lost with it: the promoted backup's rows,
    and the digest, depend on how far the shipper had got. The scenario
    drains replication before the push that the fault kills (which changes
    no state), so the backup holds every acknowledged push in both
    packages. ``ship_delay_ms`` slows every ship (the ``repl.ship`` delay
    fault), to show that dependence with ``drain_before_kill=False``."""
    faults = p.faultpoints
    with _cluster(p, replication=2) as cluster:
        cli = cluster.client()
        cli.create_sparse_table(0, _cfg(p))
        rng = np.random.default_rng(4)
        keys = np.arange(400, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        width = cli._dims(0)[1]
        cli.push_sparse(0, keys, _push(rng, keys, width))
        with _replica(p, cluster) as rep:
            serve = rep.client()
            serve.create_sparse_table(0, _cfg(p))
            _wait_digest_match(cluster, 0, serve)
            epoch0 = rep.status()["epoch"]
            prim = cluster.primary(0)
            prim.server.arm_fault("kill-shard", cmd=p.rpc._PUSH_SPARSE, after=3)
            if ship_delay_ms:
                faults.arm_faultpoint("repl.ship", "delay-ms", ms=ship_delay_ms, every=1)
            errors, promoted = [0], []

            def reader():
                while not promoted:
                    try:
                        out = serve.pull_sparse(0, keys[:32], create=False)
                        assert out.shape == (32, cli._dims(0)[0])
                    except Exception:  # noqa: BLE001 — counted, asserted 0
                        errors[0] += 1
                    time.sleep(0.005)

            th = threading.Thread(target=reader)
            th.start()
            try:
                for i in range(6):
                    if i == 2 and drain_before_kill:
                        cluster.drain()
                    cli.push_sparse(0, keys[:64], _push(rng, keys[:64], width))
                new_prim = cluster.wait_promoted(0, prim.endpoint)
            finally:
                promoted.append(True)
                th.join()
                faults.disarm_faultpoints()
            cli.push_sparse(0, keys, _push(rng, keys, width))
            cluster.drain()
            _wait(lambda: cluster.digests(0, 0).get(new_prim) == serve.digest(0)[0],
                  "the replica never converged to the promoted primary")
            st = rep.status()
            return {"serve_errors": errors[0], "new_primary": new_prim != prim.endpoint,
                    "epoch_up": st["epoch"] > epoch0, "reattached": st["epoch_changes"] >= 1,
                    "digest": serve.digest(0)[0]}


def test_serve_through_failover_reattach_and_converge():
    got = both(_failover_scenario)
    assert got["serve_errors"] == 0 and got["new_primary"]
    assert got["epoch_up"] and got["reattached"]


def test_failover_digest_depends_on_the_shipped_prefix():
    """The port's scenario with every ship slowed by 400 ms: without the
    drain, the two acknowledged pushes before the killing one die unshipped
    with the primary and the digest differs from the drained run's (what
    made the comparison above a race under load); with it, they agree."""
    slow = _failover_scenario(PORT, drain_before_kill=False, ship_delay_ms=400)
    drained = _failover_scenario(PORT, ship_delay_ms=400)
    want = _failover_scenario(PORT)
    assert slow["serve_errors"] == 0 and slow["new_primary"] and slow["reattached"]
    assert drained["digest"] == want["digest"]
    assert slow["digest"] != want["digest"]


# -- end to end: a tenant trains beside an abuser, replicas serve it ------------------

S, D = 3, 2
_NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
              dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


def _lines(n, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ids = rng.integers(0, 48, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                              + [f"1 {label}"]))
    return lines


def _dataset(lines, cls, desc):
    slots = ([desc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [desc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [desc("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=0)
    ds.load_from_lines(lines)
    return ds


def _keys_and_dense(lines):
    """[n, S] slot-tagged keys and [n, D] dense features of the lines."""
    cols = [[float(tok) for tok in line.split()[1::2]] for line in lines]
    a = np.asarray(cols)
    keys = (a[:, :S].astype(np.uint64) & np.uint64(0xFFFFFFFF)) \
        + (np.arange(S, dtype=np.uint64)[None, :] << np.uint64(32))
    return keys, a[:, S:S + D].astype(np.float32)


def _serve_e2e(p, lines, make_trainer, predict):
    """The composition on ``p``: a 2 × 2 sync cluster, the ``ctr`` tenant's
    trainer over the tier for 2 epochs beside the abuser's flood, then one
    replica a shard serving the trained model through the frontend."""
    with p.ha.HACluster(num_shards=2, replication=2, sync=True) as cluster:
        d = p.tenancy.TenantDirectory(cluster)
        d.register(p.tenancy.Tenant(name="ctr", tid=1, token=b"ctr"))
        d.register(p.tenancy.Tenant(name="abuse", tid=9, token=b"abuse", pclass=1, rate=5.0,
                                    burst=1000.0, max_rows=200))
        table = p.tenancy.tenant_table_id(1, 0)
        cli = d.client("ctr")
        cli.create_sparse_table(table, p.TableConfig(
            table_id=table, shard_num=4, accessor="ctr", accessor_config=p.AccessorConfig(
                sgd=p.SGDRuleConfig(initial_range=0.0))))
        abuse = d.client("abuse")
        at = p.tenancy.tenant_table_id(9, 0)
        abuse.create_sparse_table(at, _cfg(p))
        enf = p.enforce
        seen = []

        def flood():
            for i in range(5):
                keys = np.arange((i + 1) << 20, ((i + 1) << 20) + 512, dtype=np.uint64)
                for fn, a, kw in ((abuse.pull_sparse, (at, keys), {"create": True}),
                                  (abuse.size, (table,), {})):
                    try:
                        fn(*a, **kw)
                        seen.append("ok")
                    except (enf.ThrottledError, enf.QuotaExceededError,
                            enf.WrongTenantError) as e:
                        seen.append(type(e).__name__)

        comm = p.comm.SyncCommunicator(cli)
        # a tenant has no barrier (kBarrier is the operator plane's, refused
        # on a tenant connection in both packages): the tenant's one trainer
        # quiesces its own traffic instead, which a SyncCommunicator's inline
        # sends already have
        comm.barrier = comm.quiesce
        comm.start()
        tr = make_trainer(comm, table)
        th = threading.Thread(target=flood, name="tenant-abuse")
        th.start()
        outs = [tr.train_from_dataset(_dataset(lines, *p.ds), batch_size=128)
                for _ in range(2)]
        th.join(60)
        tr.hot_tier.flush()
        comm.barrier()
        comm.stop()
        cluster.drain()
        keys, dense = _keys_and_dense(lines[:64])
        rows = cli.pull_sparse(table, np.unique(keys), create=False)
        reps = [p.serving.ServingReplica(cluster.store, cluster.job_id, shard=s,
                                         hb_interval=0.05, hb_ttl=0.4) for s in range(2)]
        try:
            serve = p.serving.make_serve_client(reps)
            view = reps[0].serve_view(table, p.TableConfig(
                table_id=table, shard_num=4, accessor="ctr", accessor_config=p.AccessorConfig(
                    sgd=p.SGDRuleConfig(initial_range=0.0))), client=serve)
            for s in range(2):
                _wait(lambda s=s: cluster.digests(table, s)[cluster.primary(s).endpoint]
                      == serve.digest(table)[s], "a replica never caught up")
            tier = p.HotEmbeddingTier(view, p.HotTierConfig(capacity=1 << 10,
                                                            create_on_miss=False),
                                      **p.tier_kw)
            lookup = p.serving.CachedLookup(tier, replica=reps[0])
            fe = p.serving.ServingFrontend(lookup, infer=predict(tr),
                                           config=p.serving.FrontendConfig(max_batch=16))
            try:
                preds = np.asarray([fe(keys[i], dense=dense[i], deadline_ms=5000)
                                    for i in range(len(keys))], np.float32)
            finally:
                fe.stop()
            served_rows = serve.pull_sparse(table, np.unique(keys), create=False)
        finally:
            for r in reps:
                r.close()
        return {"losses": [o["loss"] for o in outs], "steps": [o["steps"] for o in outs],
                "rows": rows, "served_rows": served_rows, "preds": preds, "abuse": seen,
                "params": tr.params}


def test_tenant_trains_beside_abuser_and_replicas_serve_it_matches_jax():
    lines = _lines(512, 0)
    JAX.ds, PORT.ds = (JaxDataset, JaxSlotDesc), (InMemoryDataset, SlotDesc)
    pt.seed(0)
    jmodel = JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=8,
                                    dnn_hidden=(8,)))
    start = ctr_params_from_jax({k: np.asarray(v) for k, v in jmodel.named_parameters()})

    def jax_trainer(comm, table):
        return JaxTrainer(jmodel, jax_optimizer.Adam(1e-2), None, communicator=comm,
                          table_id=table, embedx_dim=8,
                          hot_tier=JAX.HotTierConfig(capacity=1 << 11), **_NAMES)

    def jax_predict(tr):
        return lambda emb, dense: np.asarray(
            jax_nn.functional_call(jmodel, tr.params, emb, dense, training=False)[0])

    model = DeepFM(CtrConfig(S, D, 8, (8,)))

    def port_trainer(comm, table):
        tr = CtrStreamTrainer(model, Adam(1e-2), None, communicator=comm, table_id=table,
                              embedx_dim=8, hot_tier=PORT.HotTierConfig(capacity=1 << 11),
                              device="cpu", **_NAMES)
        tr.params = {k: v.clone() for k, v in start.items()}
        tr.opt_state = tr.optimizer.init(tr.params)
        return tr

    def port_predict(tr):
        def infer(emb, dense):
            with torch.no_grad():
                return torch.func.functional_call(
                    model, tr.params, (torch.from_numpy(emb), torch.from_numpy(dense))).numpy()
        return infer

    j = _serve_e2e(JAX, lines, jax_trainer, jax_predict)
    t = _serve_e2e(PORT, lines, port_trainer, port_predict)
    assert t["abuse"] == j["abuse"]
    assert t["abuse"][0::2] == ["ok", "QuotaExceededError", "QuotaExceededError",
                                "ThrottledError", "ThrottledError"]
    assert set(t["abuse"][1::2]) == {"WrongTenantError"}
    assert t["steps"] == j["steps"]
    for tl, jl in zip(t["losses"], j["losses"]):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    jparams = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j["params"]))
    for k, w in jparams.items():
        np.testing.assert_allclose(t["params"][k].numpy(), w.numpy(), err_msg=k, **PARAM_TOL)
    np.testing.assert_allclose(t["rows"], j["rows"], **ROW_TOL)
    # within each package the replicas serve the primaries' rows exactly
    for r in (t, j):
        assert np.array_equal(r["served_rows"], r["rows"])
    np.testing.assert_allclose(t["preds"], j["preds"], **PRED_TOL)


# -- chip_smoke.py phase 18 ------------------------------------------------------------


def test_chip_smoke_phase_18_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 18 end to end on the CPU at a small size
    (2,048 lines, 400 ids a slot, batch 128, a 2^14-row tier, 256 requests):
    leg A's tenant bitwise against its own oracle beside the abuser (which
    was shed, quota-refused and fenced), leg B's predictions against the
    forward on the primaries' rows, no client op on a warm request, and the
    freshness probes (the phase's own checks; launch counts and the B2/B4
    checks are the card's only)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    for name, v in (("HA_LINES", 2048), ("HA_IDS", 400), ("HA_BATCH", 128),
                    ("HA_CAP", 1 << 14), ("SERVE_REQUESTS", 256), ("SERVE_CHECKED", 128),
                    ("SERVE_PROBES", 5)):
        monkeypatch.setattr(chip_smoke, name, v)
    counts, b2, b4 = chip_smoke.phase_tenancy(torch.device("cpu"), "cpu")
    assert sum(counts.values()) == 0 and b2 == b4 == {}
