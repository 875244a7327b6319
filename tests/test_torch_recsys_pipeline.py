"""The recsys serve path in the port (``paddle_tpu_torch.serving.pipeline``
and ``member_host``, the rankers over the serving read path), the cases
of ``tests/test_recsys_pipeline.py`` held against the JAX package.

Each stub scenario is a function of a package namespace run through the
JAX package and through the port, and the records compared with ``==``:
top-K keys and scores (the default ranker is numpy in both), counters,
the sub-request deadlines the pipeline and the router carved, fused
gather sizes. Timing-dependent counts (how many ranking batches a burst
took) are compared as the property the test states (coalesce factor > 1).

Over a real cluster, the served rows are equal across the packages (the
servers create rows as a function of key and seed), so the rankers and a
TDM walk through ``ServingBeamSource`` are held against JAX's on the same
rows with the JAX models' weights carried across: scores within 1e-5,
beam items exact. The subprocess member runs on the CPU
(``device="cpu"``, ``OMP_NUM_THREADS=1``); its wire is checked byte for
byte against the JAX module's framing, and the JAX package's proxies
talk to a port member.

Not here: the recsys SLO rules (``obs/slo.py``, ROADMAP Queue A item 10).
"""

import importlib
import random
import socket
import struct
import time
import types

import numpy as np
import numpy.testing  # noqa: F401  (eager: see tests/test_recsys_pipeline.py)
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import dssm as jdssm
from paddle_tpu.models import gru4rec as jgru
from paddle_tpu.models import tdm as jtdm
from paddle_tpu.serving import member_host as jmh
from paddle_tpu_torch.convert import recsys_params_from_jax
from paddle_tpu_torch.models import dssm as tdssm
from paddle_tpu_torch.models import gru4rec as tgru
from paddle_tpu_torch.models import tdm as ttdm
from paddle_tpu_torch.serving import member_host as tmh
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("jax_native")

TOL = 1e-5


def _pkg(root):
    m = lambda name: importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, serving=m("serving"), ha=m("ps.ha"), elastic=m("distributed.elastic"),
        registry=m("obs.registry"), enforce=m("core.enforce"),
        AccessorConfig=m("ps.accessor").AccessorConfig,
        SGDRuleConfig=m("ps.sgd_rule").SGDRuleConfig, TableConfig=m("ps.table").TableConfig,
        HotEmbeddingTier=m("ps.hot_tier").HotEmbeddingTier,
        HotTierConfig=m("ps.hot_tier").HotTierConfig, TreeIndex=m("data.index_dataset").TreeIndex,
        tier_kw={} if root == "paddle_tpu" else {"device": "cpu"})


JAX = _pkg("paddle_tpu")
PORT = _pkg("paddle_tpu_torch")


def both(scenario, *args):
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want, f"port {got}\n!= JAX {want}"
    return got


# -- stub plumbing (the JAX test's) --------------------------------------------------


class _Clk:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _rows_for(keys, width=3):
    """Member/lookup rows: [show=1, key, 1, ...]."""
    k = np.asarray(keys, np.float64)
    out = np.ones((len(k), width), np.float32)
    out[:, 1] = k
    return out


class _FanRR:
    def __init__(self, keys, deadline_ms):
        self.keys = np.asarray(keys, np.uint64)
        self.deadline_ms = deadline_ms
        self.value = self.error = None
        self._done = False
        self._cbs = []

    def add_done_callback(self, fn):
        if self._done:
            fn(self)
        else:
            self._cbs.append(fn)

    def settle(self, value=None, error=None):
        self.value, self.error, self._done = value, error, True
        for cb in self._cbs:
            cb(self)


class _PipeRouter:
    def __init__(self, auto=True, width=3):
        self.auto, self.width, self.requests = auto, width, []

    def submit(self, keys, deadline_ms=None, **kw):
        rr = _FanRR(keys, deadline_ms)
        self.requests.append(rr)
        if self.auto:
            rr.settle(value=_rows_for(keys, self.width))
        return rr


class _PipeLookup:
    def __init__(self, width=3):
        self.width, self.calls, self.sizes = width, 0, []

    def lookup(self, keys):
        self.calls += 1
        self.sizes.append(len(keys))
        return _rows_for(keys, self.width)


_UV = np.array([1.0, 0.0], np.float32)


def _pipe(p, router=None, lookup=None, **cfg_kw):
    cfg_kw.setdefault("fanout", 2)
    cfg_kw.setdefault("fan_width", 4)
    cfg_kw.setdefault("topk", 4)
    cfg_kw.setdefault("early_cut_frac", 1.0)
    cfg_kw.setdefault("rank_max_delay_us", 200)
    clock = cfg_kw.pop("clock", time.perf_counter)
    idle = cfg_kw.pop("idle_pop_s", 0.002)
    return p.serving.PipelineFrontend(router or _PipeRouter(), lookup or _PipeLookup(),
                                      config=p.serving.PipelineConfig(**cfg_kw),
                                      clock=clock, idle_pop_s=idle)


_COUNTERS = ("accepted", "served", "errors", "shed", "early_cuts", "retrieval_deadline",
             "rank_deadline_dropped", "deadline_misses", "stragglers_abandoned",
             "stragglers_late", "fan_failures")


def _counts(pipe):
    st = pipe.stats()
    return {k: st[k] for k in _COUNTERS}


# -- pipeline: staged budgets, early cut, coalescing ---------------------------------


def _basic(p):
    router, lookup = _PipeRouter(), _PipeLookup()
    with _pipe(p, router, lookup) as pipe:
        keys, scores = pipe.submit(_UV, [10, 11], np.arange(1, 9, dtype=np.uint64)).result(10)
        st = pipe.stats()
        return {"keys": keys.tolist(), "scores": scores.tolist(), **_counts(pipe),
                "gather": (lookup.calls, lookup.sizes),
                "latencies": [st[k]["count"] for k in ("e2e_ms", "stage_retrieval_ms",
                                                       "stage_ranking_ms")]}


def test_pipeline_basic_topk_ordering_and_fused_gather():
    got = both(_basic)
    assert got["keys"] == [8, 7, 6, 5] and (np.diff(got["scores"]) < 0).all()
    assert got["accepted"] == got["served"] == got["early_cuts"] == 1
    assert got["gather"] == (1, [6]) and got["latencies"] == [1, 1, 1]


def _carving(p):
    clk, router = _Clk(), _PipeRouter()
    with _pipe(p, router, clock=clk, retrieval_frac=0.6) as pipe:
        pipe.submit(_UV, [1, 2], np.arange(8, dtype=np.uint64), deadline_ms=100.0).result(10)
        return [rr.deadline_ms for rr in router.requests]


def test_pipeline_budget_carving_is_retrieval_share_of_remaining():
    assert both(_carving) == [pytest.approx(60.0)] * 2


def _coalesce(p):
    with _pipe(p, fanout=1, topk=2, rank_max_delay_us=100_000, rank_max_batch=64) as pipe:
        pending = [pipe.submit(_UV, [30 + i, 40 + i], np.arange(4 * i, 4 * i + 4,
                                                                dtype=np.uint64))
                   for i in range(8)]
        out = [tuple(np.asarray(x).tolist() for x in pr.result(10)) for pr in pending]
        st = pipe.stats()
        return {"out": out, "served": st["served"], "fewer": st["rank_batches"] < 8,
                "factor_above_1": st["coalesce_factor"] > 1.0}


def test_pipeline_coalesces_across_concurrent_requests():
    got = both(_coalesce)
    assert got["served"] == 8 and got["fewer"] and got["factor_above_1"]


def _early_cut(p):
    router = _PipeRouter(auto=False)
    with _pipe(p, router, fanout=4, fan_width=2, early_cut_frac=0.75) as pipe:
        pr = pipe.submit(_UV, [20, 21], np.arange(1, 9, dtype=np.uint64))
        fans = router.requests
        for rr in fans[:3]:
            rr.settle(value=_rows_for(rr.keys))
        keys, _ = pr.result(10)
        before = _counts(pipe)
        fans[3].settle(value=_rows_for(fans[3].keys))
        return {"fans": len(fans), "keys": keys.tolist(), "before": before,
                "after": _counts(pipe)}


def test_pipeline_early_cut_meters_stragglers():
    got = both(_early_cut)
    assert got["keys"] == [6, 5, 4, 3] and got["before"]["stragglers_abandoned"] == 1
    assert got["after"]["stragglers_late"] == 1 and got["after"]["served"] == 1


def _fan_failures(p):
    router = _PipeRouter(auto=False)
    with _pipe(p, router, fanout=4, fan_width=2, early_cut_frac=0.75) as pipe:
        pr = pipe.submit(_UV, [7, 8], np.arange(1, 9, dtype=np.uint64))
        fans = router.requests
        fans[0].settle(error=p.serving.RequestRejected("member down"))
        for rr in fans[1:]:
            rr.settle(value=_rows_for(rr.keys))
        keys, _ = pr.result(10)
        partial = _counts(pipe)
        pr2 = pipe.submit(_UV, [7, 8], np.arange(1, 9, dtype=np.uint64))
        for rr in router.requests[4:]:
            rr.settle(error=p.serving.RequestRejected("fleet gone"))
        try:
            pr2.result(10)
            err = None
        except p.serving.RequestRejected as e:
            err = str(e)
        return {"keys": keys.tolist(), "partial": partial, "err": err, "total": _counts(pipe)}


def test_pipeline_fan_failures_partial_and_total():
    got = both(_fan_failures)
    assert got["keys"] == [8, 7, 6, 5] and got["partial"]["fan_failures"] == 1
    assert got["err"] is not None and got["total"]["fan_failures"] == 5
    assert got["total"]["errors"] == 1


def _retrieval_deadline(p):
    clk, router = _Clk(), _PipeRouter(auto=False)
    with _pipe(p, router, clock=clk) as pipe:
        pr = pipe.submit(_UV, [1, 2], np.arange(8, dtype=np.uint64), deadline_ms=50.0)
        clk.t = 0.2
        for rr in router.requests:
            rr.settle(value=_rows_for(rr.keys))
        with pytest.raises(p.serving.DeadlineExceeded):
            pr.result(10)
        return _counts(pipe)


def test_pipeline_budget_spent_in_retrieval_is_deadline_exceeded():
    assert both(_retrieval_deadline)["retrieval_deadline"] == 1


def _rank_queue_expiry(p):
    clk = _Clk()
    with _pipe(p, clock=clk, rank_max_delay_us=200_000, default_deadline_ms=50.0) as pipe:
        pr = pipe.submit(_UV, [1, 2], np.arange(8, dtype=np.uint64))
        clk.t = 1.0
        with pytest.raises(p.serving.DeadlineExceeded):
            pr.result(10)
        return _counts(pipe)


def test_pipeline_drops_requests_expired_in_rank_queue():
    got = both(_rank_queue_expiry)
    assert got["rank_deadline_dropped"] == 1 and got["served"] == 0


def _shape_pins(p):
    out = []
    with _pipe(p) as pipe:
        for hist, n in (([1, 2], 5), ([1, 2], 8), ([1, 2, 3], 8)):
            try:
                pipe.submit(_UV, hist, np.arange(n, dtype=np.uint64)).result(10)
                out.append(None)
            except p.enforce.EnforceNotMet as e:
                out.append(type(e).__name__)
    return out


def test_pipeline_shape_pins():
    got = both(_shape_pins)
    assert got[1] is None and got[0] and got[2]


def _stage_families(p):
    with _pipe(p) as pipe:
        pipe.submit(_UV, [1, 2], np.arange(8, dtype=np.uint64)).result(10)
        snap = p.registry.REGISTRY.snapshot()["metrics"]
        stages = {s["labels"].get("stage") for s in snap["serving_stage_latency_s"]["series"]}
        e2e = [s for s in snap["serving_latency_s"]["series"]
               if s["labels"].get("recorder") == "recsys_e2e"]
        return {"stages": {"retrieval", "ranking"} <= stages,
                "e2e": bool(e2e) and sum(s["count"] for s in e2e) >= 1,
                "events": "serving_pipeline_events" in snap}


def test_pipeline_stage_metric_families_in_registry():
    assert both(_stage_families) == {"stages": True, "e2e": True, "events": True}


def _stop(p):
    with _pipe(p) as pipe:
        pipe.stop()
        try:
            pipe.submit(_UV, [1, 2], np.arange(8, dtype=np.uint64))
            return None
        except p.serving.RequestRejected as e:
            return str(e)


def test_pipeline_stop_rejects_and_fails_queued():
    assert both(_stop) == "pipeline stopped"


# -- the router's remaining-budget pins (tests/test_recsys_pipeline.py:383-470) -------


class _RecSub:
    def __init__(self):
        self._cbs, self._err, self._val, self._done = [], None, None, False

    def add_done_callback(self, fn):
        if self._done:
            fn()
        else:
            self._cbs.append(fn)

    def exception(self):
        return self._err

    def value(self):
        return self._val

    def settle(self, val=None, err=None):
        self._val, self._err, self._done = val, err, True
        for cb in self._cbs:
            cb()


class _RecFrontend:
    def __init__(self):
        self.deadlines, self.subs, self.queue_depth, self.stopped = [], [], 0, False

    def submit(self, keys, dense=None, deadline_ms=None):
        self.deadlines.append(float(deadline_ms))
        sub = _RecSub()
        self.subs.append(sub)
        return sub


class _RecMember:
    def __init__(self, name):
        self.endpoint, self.healthy, self.frontend = name, True, _RecFrontend()


def _pin_router(p, clk, **cfg_kw):
    cfg_kw.setdefault("hedge_default_ms", 20.0)
    cfg_kw.setdefault("hedge_min_samples", 1 << 30)
    r = p.serving.ServingRouter(p.serving.RouterConfig(**cfg_kw), rng=random.Random(0),
                                clock=clk)
    members = [_RecMember("m0"), _RecMember("m1")]
    for m in members:
        r.attach(m)
    return r, members


def _deadlines(members):
    return {m.endpoint: m.frontend.deadlines[:] for m in members}


def _hedge_budget(p):
    clk = _Clk()
    r, members = _pin_router(p, clk)
    try:
        rr = r.submit(np.arange(8, dtype=np.uint64), deadline_ms=100.0)
        first = _deadlines(members)
        clk.t = 0.060
        hedged = rr.maybe_hedge()
        after = _deadlines(members)
        for m in members:
            for sub in m.frontend.subs:
                sub.settle(val=_rows_for(np.arange(8)))
        return {"first": first, "hedged": hedged, "after": after, "tried": list(rr.tried),
                "shape": rr.result(10).shape}
    finally:
        r.stop()


def test_hedge_carries_measured_remaining_budget():
    got = both(_hedge_budget)
    assert got["hedged"] is True and got["shape"] == (8, 3)
    assert sorted(d for v in got["after"].values() for d in v) == [
        pytest.approx(40.0), pytest.approx(100.0)]


def _stale_now(p):
    clk = _Clk()
    r, members = _pin_router(p, clk)
    try:
        rr = r.submit(np.arange(8, dtype=np.uint64), deadline_ms=100.0)
        clk.t = 0.250
        a = rr.maybe_hedge(now=0.030)
        n_a, hedged = sum(len(m.frontend.deadlines) for m in members), rr.hedged
        clk.t = 0.0995
        b = rr.maybe_hedge(now=0.030)
        return [a, n_a, hedged, b, sum(len(m.frontend.deadlines) for m in members)]
    finally:
        r.stop()


def test_nearly_expired_request_cannot_hedge_with_stale_now():
    assert both(_stale_now) == [False, 1, False, False, 1]


def _reroute(p):
    clk = _Clk()
    r, members = _pin_router(p, clk, hedge=False)
    out = {}
    try:
        rr = r.submit(np.arange(8, dtype=np.uint64), deadline_ms=100.0)
        clk.t = 0.030
        first = [m for m in members if m.frontend.subs][0]
        first.frontend.subs[0].settle(err=RuntimeError("conn reset"))
        out["mid"] = _deadlines(members)
        other = [m for m in members if m is not first][0]
        other.frontend.subs[0].settle(val=_rows_for(np.arange(8)))
        out["shape"] = rr.result(10).shape
        out["reroutes"] = r.stats()["reroutes"]
        errs = []
        for t0, t1, dl, err in ((1.0, 1.2, 50.0, RuntimeError("conn reset")),
                                (2.0, 2.01, 100.0, p.serving.DeadlineExceeded("member"))):
            base = sum(len(m.frontend.subs) for m in members)
            clk.t = t0
            rr2 = r.submit(np.arange(8, dtype=np.uint64), deadline_ms=dl)
            clk.t = t1
            last = [m for m in members if m.frontend.subs
                    and not m.frontend.subs[-1]._done][0]
            last.frontend.subs[-1].settle(err=err)
            try:
                rr2.result(10)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 — compared by name
                errs.append(type(e).__name__)
            errs.append(sum(len(m.frontend.subs) for m in members) - base)
        out["final"] = errs
        return out
    finally:
        r.stop()


def test_reroute_inherits_remaining_and_expiry_is_final():
    got = both(_reroute)
    assert sorted(d for v in got["mid"].values() for d in v) == [
        pytest.approx(70.0), pytest.approx(100.0)]
    assert got["shape"] == (8, 3) and got["reroutes"] == 1
    assert got["final"] == ["RuntimeError", 1, "DeadlineExceeded", 1]


# -- real-cluster plumbing -----------------------------------------------------------


def _cfg(p, dim=4):
    return p.TableConfig(shard_num=4, accessor_config=p.AccessorConfig(
        embedx_dim=dim, embedx_threshold=0.0, sgd=p.SGDRuleConfig(initial_range=0.01)))


def _cluster(p, **kw):
    kw.setdefault("num_shards", 1)
    kw.setdefault("replication", 1)
    kw.setdefault("sync", True)
    return p.ha.HACluster(**kw)


def _preload(p, cli, keys, rng, dim=4):
    cli.create_sparse_table(0, _cfg(p, dim))
    cli.pull_sparse(0, keys)
    width = cli._dims(0)[1]
    push = np.zeros((len(keys), width), np.float32)
    push[:, 1] = 1.0
    push[:, 2:] = rng.normal(0, 0.1, (len(keys), width - 2)).astype(np.float32)
    cli.push_sparse(0, keys, push)


def _wait_caught_up(cluster, serve_cli, timeout=15.0):
    deadline = time.monotonic() + timeout
    while True:
        prim = cluster.primary(0)
        dg = cluster.digests(0, 0).get(prim.endpoint)
        if dg is not None and dg == serve_cli.digest(0)[0]:
            return
        assert time.monotonic() < deadline, "replica never caught up"
        time.sleep(0.02)


def _serving_stack(p, cluster, dim=4, capacity=1 << 12):
    rep = p.serving.ServingReplica(cluster.store, cluster.job_id, shard=0, hb_interval=0.05,
                                   hb_ttl=0.5)
    serve = rep.client()
    view = rep.serve_view(0, _cfg(p, dim), client=serve)
    _wait_caught_up(cluster, serve)
    tier = p.HotEmbeddingTier(view, p.HotTierConfig(capacity=capacity, create_on_miss=False),
                              **p.tier_kw)
    return rep, p.serving.CachedLookup(tier, replica=rep, freshness_budget_s=30.0)


def _emb_block(lookup, keys_2d):
    keys_2d = np.asarray(keys_2d, np.uint64)
    rows = np.asarray(lookup.lookup(keys_2d.reshape(-1)), np.float32)
    return rows.reshape(keys_2d.shape + (rows.shape[-1],))


def _served(p, seed, n_keys, body):
    """``body(p, lookup, keys)`` over a 1-shard cluster with ``n_keys``
    preloaded keys and a caught-up serving stack."""
    with _cluster(p) as cluster:
        keys = np.arange(n_keys, dtype=np.uint64)
        _preload(p, cluster.client(), keys, np.random.default_rng(seed))
        rep, lookup = _serving_stack(p, cluster)
        try:
            return body(p, lookup, keys)
        finally:
            rep.close()


def _rankers(p, models):
    """(rank_gru, rank_dssm) of the package, on the same weights."""
    jg, jd = models
    if p is JAX:
        return jgru.make_gru4rec_ranker(jg), jdssm.make_dssm_ranker(jd)
    tg = tgru.GRU4Rec(embedx_dim=4, hidden=8, out_dim=8)
    td = tdssm.DSSM(num_query_slots=3, num_doc_slots=1, embedx_dim=4, hidden=(8,), out_dim=8)
    conv = lambda m: recsys_params_from_jax({k: np.asarray(v) for k, v in m.named_parameters()})
    return (tgru.make_gru4rec_ranker(tg, conv(jg), device="cpu"),
            tdssm.make_dssm_ranker(td, conv(jd), device="cpu"))


def _jax_models():
    pt.seed(0)
    return (jgru.GRU4Rec(embedx_dim=4, hidden=8, out_dim=8),
            jdssm.DSSM(num_query_slots=3, num_doc_slots=1, embedx_dim=4, hidden=(8,),
                       out_dim=8))


def test_rankers_over_served_embeddings():
    """The GRU4Rec and DSSM ranker smokes over the serving read path: the
    served rows are equal across the packages and the scores within 1e-5;
    cosines, deterministic."""
    models = _jax_models()

    def body(p, lookup, keys):
        rank_g, rank_d = _rankers(p, models)
        hist = _emb_block(lookup, keys[:15].reshape(3, 5))
        cand = _emb_block(lookup, keys[32:44].reshape(3, 4))
        sg = rank_g(hist, np.full(3, 5, np.int32), cand)
        dh = _emb_block(lookup, keys[:6].reshape(2, 3))
        dc = _emb_block(lookup, keys[40:48].reshape(2, 4))
        sd = rank_d(dh, np.full(2, 3, np.int32), dc)
        again = rank_g(hist, np.full(3, 5, np.int32), cand)
        return hist, cand, dh, dc, np.asarray(sg), np.asarray(sd), np.array_equal(sg, again)

    want = _served(JAX, 1, 64, body)
    got = _served(PORT, 1, 64, body)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[4:6], want[4:6]):
        assert a.shape == b.shape and np.isfinite(a).all() and (np.abs(a) <= 1 + 1e-5).all()
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    assert got[6] and want[6]


def test_tdm_beam_search_through_serving_lookup():
    pt.seed(0)
    jm = jtdm.TDM(embedx_dim=4, hidden=(8, 8))
    jp = {"params": dict(jm.named_parameters()), "buffers": {}}
    tp = recsys_params_from_jax(jp)

    def body(p, lookup, keys):
        tree = p.TreeIndex(list(range(16)), branch=2)
        if p is JAX:
            src, model, params, walk = (jtdm.ServingBeamSource(lookup, capacity=1 << 10), jm,
                                        jp, jtdm.beam_search_retrieve)
        else:
            src, model, params, walk = (ttdm.ServingBeamSource(lookup, capacity=1 << 10,
                                                               device="cpu"),
                                        ttdm.TDM(embedx_dim=4, hidden=(8, 8)), tp,
                                        ttdm.beam_search_retrieve)
        got = walk(tree, model, params, src, [0, 3, 5], k=4)
        got2 = walk(tree, model, params, src, [9, 12], k=4)
        small = (p is JAX and jtdm or ttdm).ServingBeamSource(
            lookup, capacity=24, **p.tier_kw)
        got3 = [walk(tree, model, params, small, u, k=4) for u in ([0, 3, 5], [9, 12], [1])]
        return {"walks": [got, got2] + got3, "flushes": (src.flushes, small.flushes)}

    n = 2 * 16 - 1
    want = _served(JAX, 0, n, body)
    got = _served(PORT, 0, n, body)
    assert got == want
    assert got["walks"][0] and all(0 <= i < 16 for i in got["walks"][0])
    assert got["flushes"][0] == 0 and got["flushes"][1] >= 1


def test_pipeline_with_real_ranker_and_served_lookup():
    """Stub retrieval fleet, the real ranking stage: the coalesced cached
    gather and the stacked GRU4Rec ranker, scattered back per request;
    keys equal to JAX's, scores within 1e-5."""
    models = _jax_models()

    def body(p, lookup, keys):
        pipe = p.serving.PipelineFrontend(
            _PipeRouter(width=5), lookup, ranker=_rankers(p, models)[0],
            config=p.serving.PipelineConfig(fanout=2, fan_width=4, topk=4, early_cut_frac=1.0,
                                            rank_max_delay_us=20_000), idle_pop_s=0.002)
        uv = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        with pipe:
            pending = [pipe.submit(uv, keys[i * 2:i * 2 + 2], keys[64 + 8 * i:72 + 8 * i])
                       for i in range(6)]
            out = [pr.result(30) for pr in pending]
            st = pipe.stats()
        return out, st["served"], st["errors"], st["coalesce_factor"] > 1.0

    want = _served(JAX, 4, 256, body)
    got = _served(PORT, 4, 256, body)
    assert got[1:] == want[1:] == (6, 0, True)
    for (gk, gs), (wk, ws) in zip(got[0], want[0]):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_allclose(gs, ws, atol=TOL, rtol=0)
        assert np.isfinite(gs).all() and (np.diff(gs) <= 1e-6).all()


# -- the member wire -----------------------------------------------------------------


def _frame_bytes(mod, tag, payload):
    a, b = socket.socketpair()
    try:
        mod._send_frame(a, tag, payload)
        a.close()
        data = b""
        while chunk := b.recv(1 << 16):
            data += chunk
        return data
    finally:
        b.close()


def test_member_wire_frames_are_the_jax_bytes():
    keys = np.arange(5, dtype=np.uint64) * np.uint64(1 << 33)
    lookup = struct.pack("<fI", 12.5, len(keys)) + keys.tobytes()
    hdr = b'{"version": 3, "expect_digest": null}'
    model_set = struct.pack("<I", len(hdr)) + hdr + np.ones(4, np.float32).tobytes()
    for tag, payload in ((tmh._OP_LOOKUP, lookup), (tmh._OP_STATS, b""),
                         (tmh._OP_MODEL_SET, model_set), (tmh._ST_ERR, b"RuntimeError|x")):
        assert _frame_bytes(tmh, tag, payload) == _frame_bytes(jmh, tag, payload)
    ops = ("_OP_LOOKUP", "_OP_STATS", "_OP_MODEL_SET", "_OP_MODEL_GET", "_OP_RESET",
           "_OP_WARM", "_OP_STOP", "_ST_OK", "_ST_ERR")
    assert [getattr(tmh, o) for o in ops] == [getattr(jmh, o) for o in ops]
    a, b = socket.socketpair()
    try:
        tmh._send_frame(a, 7, b"abc")
        assert jmh._recv_frame(b) == (7, b"abc")
        jmh._send_frame(b, 1, b"\x00" * 9)
        assert tmh._recv_frame(a) == (1, b"\x00" * 9)
    finally:
        a.close()
        b.close()
    assert tmh._err_payload(ValueError("v")) == jmh._err_payload(ValueError("v"))
    with pytest.raises(PORT.serving.DeadlineExceeded, match="late"):
        tmh._raise_wire_error(b"DeadlineExceeded|late")
    with pytest.raises(RuntimeError, match="Boom"):
        tmh._raise_wire_error(b"Boom")


def test_spawn_member_subprocess_end_to_end(tmp_path, monkeypatch):
    """A port member process on the CPU: the rows it serves equal the
    parent-side replica's; the JAX package's proxies (frontend and model)
    talk to it over the same wire; the model push, digest pinning, warm op
    and the child's stats."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    p = PORT
    store_dir = str(tmp_path / "store")
    with _cluster(p, store=p.elastic.FileStore(store_dir)) as cluster:
        keys = np.arange(256, dtype=np.uint64)
        _preload(p, cluster.client(), keys, np.random.default_rng(3))
        member = p.serving.spawn_member(f"file:{store_dir}", cluster.job_id, embedx_dim=4,
                                        dense_len=8, hb_ttl=1.0, device="cpu")
        rep = jfe = None
        try:
            assert member.healthy
            out = member.frontend.submit(keys[:8], deadline_ms=5000).result(15)
            assert out.shape == (8, 5)
            rep, lookup = _serving_stack(p, cluster)
            np.testing.assert_array_equal(out, np.asarray(lookup.lookup(keys[:8]), np.float32))
            status = member.replica.status()
            assert status["multi_host"] is True and status["pid"] == member.replica._proc.pid
            v0, d0 = member.model.identity()
            member.model.set(v0 + 1, np.ones(8, np.float32))
            v1, d1 = member.model.identity()
            assert v1 == v0 + 1 and d1 != d0
            with pytest.raises(RuntimeError):
                member.model.set(v1 + 1, np.zeros(8, np.float32), expect_digest=d1)
            # the JAX package's proxies against the port's member
            jfe = jmh.RemoteFrontend(member.serve_addr, workers=1)
            np.testing.assert_array_equal(jfe.submit(keys[8:16], deadline_ms=5000).result(15),
                                          member.frontend.submit(keys[8:16],
                                                                 deadline_ms=5000).result(15))
            jctl = jmh._MemberClient(member.serve_addr)
            assert jmh.RemoteModel(jctl).identity() == (v1, d1)
            jctl.close()
            # keys[:16] are resident from the lookups: 16 rows admitted
            assert member.warm(keys[:32]) == 16
            assert member.frontend.stats().get("served", 0) >= 3
        finally:
            if jfe is not None:
                jfe.stop()
            if rep is not None:
                rep.close()
            member.frontend.stop()
            member.replica.stop()
    assert member.replica.server.stopped


def test_pipeline_chaos_kill_member_zero_visible_errors(tmp_path, monkeypatch):
    """Kill one of two member processes while a request stream is in
    flight: reroute and the early cut keep every request free of
    user-visible errors."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    p = PORT
    store_dir = str(tmp_path / "store")
    with _cluster(p, store=p.elastic.FileStore(store_dir)) as cluster:
        keys = np.arange(1024, dtype=np.uint64)
        _preload(p, cluster.client(), keys, np.random.default_rng(5))
        members = [p.serving.spawn_member(f"file:{store_dir}", cluster.job_id, embedx_dim=4,
                                          dense_len=8, hb_ttl=1.0, device="cpu")
                   for _ in range(2)]
        router = p.serving.ServingRouter(p.serving.RouterConfig(), rng=random.Random(0))
        pipe = p.serving.PipelineFrontend(
            router, _PipeLookup(width=5),
            config=p.serving.PipelineConfig(fanout=2, fan_width=8, topk=4, early_cut_frac=0.5,
                                            default_deadline_ms=4000.0,
                                            rank_max_delay_us=1000))
        try:
            for m in members:
                router.attach(m)
            uv = np.zeros(4, np.float32)
            uv[0] = 1.0
            pending = []
            for i in range(40):
                lo = (i * 16) % 992
                pending.append(pipe.submit(uv, keys[:4], keys[lo:lo + 16]))
                if i == 15:
                    members[0].replica.kill()
                time.sleep(0.01)
            for pr in pending:
                ks, sc = pr.result(30)
                assert ks.shape == (4,) and np.isfinite(sc).all()
            st = pipe.stats()
            assert st["served"] == 40 and st["errors"] == 0
        finally:
            pipe.stop()
            router.stop()
            for m in members:
                m.crash()
