"""paddle_tpu_torch's sharded cache (``ps.sharded_cache``) against the JAX
package, on the CPU.

The JAX functions run inside ``shard_map`` on a K-device sub-mesh of the
conftest's 8 virtual CPU devices; the port runs the same K ranks in
lockstep on one device (``core.mesh``). Inputs come from numpy seeds.
Tolerances:

- the routing geometry (bucket capacity, spread rows, the routing rule)
  is exact;
- routed and gathered pull and push are bitwise: the pull is a copy, and
  the push sums each row's entries in the same order in both packages
  (the pre-merge is ``segment_sum`` in occurrence order, the owner's
  merge takes the ranks' buckets in rank order) and applies the same
  f32-sealed rule. The JAX side compiles with XLA's algebraic simplifier
  off: that pass rewrites the rule's ``click + segment_sum(clicks)`` into
  a scatter-add onto the gathered click column, which adds a row's
  entries to the state one at a time (``(c + 1) + 1`` where the formula
  and the port say ``c + 2``, one ulp apart; eager JAX agrees with the
  port). The JAX package's own routed test meets the same fold;
- the sharded pass step from keys holds losses to rtol 1e-5 and dense
  parameters and cache state to rtol 1e-4 / atol 1e-6, the tolerances of
  ``test_torch_ctr.py``: the dense matmuls and their gradients run
  through different BLAS, XLA contracts the dense Adam update into FMAs
  and associates its all-reduce in its own order. Inside the port the
  routed and gathered steps are bitwise equal at ``pre_dedup=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import paddle_tpu as pt
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.core import mesh as jax_mesh
from paddle_tpu.models import ctr as jctr
from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps import sharded_cache as jsc
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax
from paddle_tpu_torch.core.enforce import EnforceNotMet, UnavailableError
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.ops import collectives
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import embedding_cache as tec
from paddle_tpu_torch.ps import sharded_cache as tsc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.hot_tier import HotEmbeddingTier, HotTierConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX side's pass build needs its native dedup order and key map
pytestmark = pytest.mark.usefixtures("jax_native")

LOSS_RTOL = 1e-5
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


def _jmesh(K):
    return jax_mesh.make_mesh({"ps": K}, devices=jax.devices()[:K])


def _state_np(capacity, dim, rng):
    f = np.float32
    return {"show": rng.uniform(0, 5, capacity).astype(f),
            "click": rng.uniform(0, 2, capacity).astype(f),
            "embed_w": rng.normal(size=(capacity, 1)).astype(f),
            "embed_state": rng.uniform(0, 1, (capacity, 1)).astype(f),
            "embedx_w": rng.normal(size=(capacity, dim)).astype(f),
            "embedx_state": rng.uniform(0, 1, (capacity, 1)).astype(f),
            "has_embedx": (rng.random(capacity) < 0.5).astype(f)}


def _assert_state_equal(got, want, what):
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=f"{what}: state[{k}]")


# -- collectives and routing geometry ------------------------------------------


def test_collectives_rank_order():
    """all_to_all moves tile s of rank r to rank s's slot r; sums run in
    rank order; gather/scatter are tiled along dim 0."""
    xs = [torch.arange(6).reshape(3, 2) + 10 * r for r in range(3)]
    out = collectives.all_to_all(xs)
    for s in range(3):
        for r in range(3):
            assert torch.equal(out[s][r], xs[r][s])
    assert torch.equal(collectives.all_gather(xs)[2], torch.cat(xs))
    tot = collectives.all_reduce(xs)[1]
    assert torch.equal(tot, xs[0] + xs[1] + xs[2])
    assert torch.equal(collectives.all_reduce([x.float() for x in xs], "avg")[0],
                       (xs[0] + xs[1] + xs[2]).float() / 3)
    parts = collectives.reduce_scatter(xs)
    assert all(torch.equal(parts[r], tot[r:r + 1]) for r in range(3))


def test_make_mesh_layouts():
    m = make_mesh({"ps": 4}, device="cpu")
    assert m.shape == {"ps": 4} and m.axis_names == ("ps",) and m.device.type == "cpu"
    # a mesh of two axes is made (the hybrid layouts run on it), and the
    # sharded PS paths refuse it: over such a mesh they come with item 7
    two = make_mesh({"dp": 2, "ps": 2}, device="cpu")
    assert two.shape == {"dp": 2, "ps": 2} and two.size == 4
    table = MemorySparseTable(TableConfig(shard_num=2,
                                          accessor_config=AccessorConfig(embedx_dim=DIM)))
    with pytest.raises(UnavailableError, match="item 7"):
        tec.HbmEmbeddingCache(table, tec.CacheConfig(**CACHE_KW), device="cpu", mesh=two)
    with pytest.raises(UnavailableError, match="item 7"):
        HotEmbeddingTier(table, HotTierConfig(capacity=1 << 12, mesh=two), device="cpu")
    with pytest.raises(UnavailableError, match="item 7"):
        tsc.make_sharded_ctr_train_step(tctr.DeepFM(tctr.CtrConfig(2, 2, DIM, (8,))), Adam(),
                                        tec.CacheConfig(**CACHE_KW), two)
    with pytest.raises(EnforceNotMet, match="positive"):
        make_mesh({"ps": 0}, device="cpu")


def test_route_capacity_and_spread_match_jax():
    for m in (1, 7, 64, 1000, 26_624, 106_496):
        for K in (1, 2, 4, 8):
            for f in (0.25, 1.0, 2.0):
                assert tsc.route_bucket_capacity(m, K, f) == \
                    jsc.route_bucket_capacity(m, K, f), (m, K, f)
    rows = np.arange(1000, dtype=np.int64)
    for K in (1, 2, 8):
        s = tsc.shard_spread_rows(rows, 1 << 12, K)
        np.testing.assert_array_equal(s, jsc.shard_spread_rows(rows, 1 << 12, K))
        np.testing.assert_array_equal(tsc.shard_unspread_rows(s, 1 << 12, K), rows)


@pytest.mark.parametrize("push_mode", ["auto", "sparse", "dense"])
def test_select_routing_matches_jax(push_mode):
    for K in (1, 2, 4, 8):
        assert tsc.select_routing(1024, 1 << 14, K, push_mode) == \
            jsc.select_routing(1024, 1 << 14, K, push_mode), K
    with pytest.raises(EnforceNotMet, match="push_mode"):
        tsc.select_routing(1024, 1 << 14, 8, "bogus")


def test_routing_arg_validation():
    model = tctr.DeepFM(tctr.CtrConfig(2, 2, 4, (8,)))
    cfg = tec.CacheConfig(capacity=1 << 10, embedx_dim=4)
    mesh = make_mesh({"ps": 2}, device="cpu")
    for bad in ("routed", ("alltoall",), ("alltoall", "nope"), 7):
        with pytest.raises(EnforceNotMet, match="routing"):
            tsc.make_sharded_ctr_train_step(model, Adam(), cfg, mesh, routing=bad)


# -- routed and gathered pull/push against the JAX package ---------------------


def _compiled(fn):
    """``jax.jit(fn)``, compiled at the first call with the algebraic
    simplifier off (see the module docstring)."""
    cache = {}

    def call(*args):
        if not cache:
            cache["f"] = jax.jit(fn).lower(*args).compile({"xla_disable_hlo_passes": "algsimp"})
        return cache["f"](*args)

    return call


def _jax_fns(K, cfg, routed, cap_factor=2.0, pre_dedup=True):
    mesh = _jmesh(K)
    if routed:
        pull = lambda st, r: jsc.routed_cache_pull(st, r, "ps", cap_factor, pre_dedup)
        push = lambda st, r, g, s, c: jsc.routed_cache_push(st, r, g, s, c, cfg, "ps",
                                                            cap_factor, pre_dedup)
        out_pull, out_push = (P("ps"), P()), (P("ps"), P())
    else:
        pull = lambda st, r: jsc.sharded_cache_pull(st, r, "ps")
        push = lambda st, r, g, s, c: jsc.sharded_cache_push(st, r, g, s, c, cfg, "ps")
        out_pull, out_push = P("ps"), P("ps")
    pull = _compiled(shard_map(pull, mesh=mesh, in_specs=(P("ps"), P("ps")),
                               out_specs=out_pull, check_vma=False))
    push = _compiled(shard_map(push, mesh=mesh, in_specs=(P("ps"),) * 5,
                               out_specs=out_push, check_vma=False))
    shard = NamedSharding(mesh, P("ps"))
    put = lambda st: {k: jax.device_put(jnp.asarray(v), shard) for k, v in st.items()}
    return pull, push, put


def _port_pull_push(K, state, rows, grads, shows, clicks, cfg, routed, cap_factor, pre_dedup):
    shards = tsc.shard_state(state, K)
    split = lambda a: list(torch.from_numpy(a).chunk(K))
    if routed:
        vals, ov1 = tsc.routed_cache_pull(shards, split(rows), cap_factor, pre_dedup)
        ov2 = tsc.routed_cache_push(shards, split(rows), split(grads), split(shows),
                                       split(clicks), cfg, cap_factor, pre_dedup)
        return torch.cat(vals), int(ov1), int(ov2)
    vals = tsc.sharded_cache_pull(shards, split(rows))
    tsc.sharded_cache_push(shards, split(rows), split(grads), split(shows), split(clicks), cfg)
    return torch.cat(vals), 0, 0


def _batch(rng, capacity, n, dim, negatives=True):
    rows = rng.integers(0, capacity, n).astype(np.int32)  # cross-rank duplicates
    rows[:n // 8] = rows[n // 8:n // 4]                   # and more
    if negatives:
        rows[::5] = -1          # miss markers: pull zeros, drop the push
        rows[3::11] = capacity  # the sentinel itself
    rng.shuffle(rows)
    return (rows, rng.normal(size=(n, 1 + dim)).astype(np.float32),
            np.ones(n, np.float32), (rng.random(n) < 0.4).astype(np.float32))


@pytest.mark.parametrize("K,routed,pre_dedup", [
    (2, True, True), (2, True, False), (8, True, True), (8, True, False),
    (2, False, True), (8, False, True)],
    ids=["routed-K2-dedup", "routed-K2-raw", "routed-K8-dedup", "routed-K8-raw",
         "gathered-K2", "gathered-K8"])
def test_pull_push_bitwise_vs_jax(K, routed, pre_dedup):
    """Pull values and the state after three chained pushes, bitwise —
    duplicate rows across ranks, negative miss markers and sentinel rows
    included (they pull zeros and drop)."""
    rng = np.random.default_rng(K * 10 + routed * 2 + pre_dedup)
    capacity, dim, n = 1 << 9, 4, 128
    cfg_kw = dict(capacity=capacity, embedx_dim=dim, embedx_threshold=2.0)
    jcfg, tcfg = jec.CacheConfig(**cfg_kw), tec.CacheConfig(**cfg_kw)
    state = _state_np(capacity, dim, rng)
    pull, push, put = _jax_fns(K, jcfg, routed, pre_dedup=pre_dedup)
    jstate, tstate = put(state), {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    for it in range(3):
        rows, grads, shows, clicks = _batch(rng, capacity, n, dim)
        jvals = pull(jstate, jnp.asarray(rows))
        out = push(jstate, *(jnp.asarray(a) for a in (rows, grads, shows, clicks)))
        if routed:
            jvals, jov1 = jvals
            jstate, jov2 = out
        else:
            jstate, jov1, jov2 = out, 0, 0
        tvals, tov1, tov2 = _port_pull_push(K, tstate, rows, grads, shows, clicks, tcfg,
                                            routed, 2.0, pre_dedup)
        np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals), err_msg=f"pull {it}")
        assert (tov1, tov2) == (int(jov1), int(jov2)) == (0, 0)
        assert (tvals.numpy()[rows < 0] == 0).all() and (tvals.numpy()[rows >= capacity] == 0).all()
        _assert_state_equal(tstate, jstate, f"push {it}")
    assert not np.array_equal(tstate["embed_w"].numpy(), state["embed_w"])


def test_overflow_count_matches_jax():
    """An adversarial batch (every row in shard 0's block) at cap_factor
    0.25 without dedup drops entries: the overflow counts are equal and
    positive, and the pull (zeros for dropped entries) and the push
    (dropped entries never applied) stay bitwise equal."""
    K, capacity, dim, n = 8, 1 << 10, 4, 256
    rng = np.random.default_rng(3)
    block = capacity // K
    rows = rng.permutation(block)[:n // K].repeat(K).astype(np.int32)
    _, grads, shows, clicks = _batch(rng, capacity, n, dim, negatives=False)
    cfg_kw = dict(capacity=capacity, embedx_dim=dim)
    state = _state_np(capacity, dim, rng)
    pull, push, put = _jax_fns(K, jec.CacheConfig(**cfg_kw), True, 0.25, False)
    jvals, jov1 = pull(put(state), jnp.asarray(rows))
    jstate, jov2 = push(put(state), *(jnp.asarray(a) for a in (rows, grads, shows, clicks)))
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    tvals, tov1, tov2 = _port_pull_push(K, tstate, rows, grads, shows, clicks,
                                        tec.CacheConfig(**cfg_kw), True, 0.25, False)
    assert tov1 == int(jov1) > 0 and tov2 == int(jov2) > 0
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    _assert_state_equal(tstate, jstate, "overflowing push")
    with pytest.raises(EnforceNotMet, match="overflow"):
        tsc.check_route_overflow(torch.tensor(tov1))


def test_routed_dedup_matches_jnp_unique():
    """``routed_dedup`` is ``jnp.unique(size=m, fill_value=sentinel,
    return_inverse=True)`` after canonicalizing negative rows."""
    rng = np.random.default_rng(9)
    rows = rng.integers(-3, 40, 97).astype(np.int32)
    ju, ji = jsc.routed_dedup(jnp.asarray(rows), 64)
    tu, ti = tsc.routed_dedup(torch.from_numpy(rows), 64)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# -- the sharded pass step from keys ---------------------------------------------

SK, S, DIM, B = 8, 5, 4, 32


def _pool():
    lo = np.random.default_rng(11).integers(0, 1 << 20, size=(200, S)).astype(np.uint64)
    return lo + (np.arange(S, dtype=np.uint64) << np.uint64(32))


def _batches():
    rng = np.random.default_rng(12)
    return (rng.integers(0, 200, size=(3, B)), rng.normal(size=(3, B, 3)).astype(np.float32),
            (rng.random((3, B)) < 0.4).astype(np.int32))


CACHE_KW = dict(capacity=1 << 12, embedx_dim=DIM, embedx_threshold=0.0)


def _port_run(routing, params, opt_state, keys_fed, pre_dedup=True):
    pool, (idx, dense, labels) = _pool(), _batches()
    mesh = make_mesh({"ps": SK}, device="cpu")
    table = MemorySparseTable(TableConfig(shard_num=4, backend="python",
                                          accessor_config=AccessorConfig(embedx_dim=DIM)))
    cfg = tec.CacheConfig(**CACHE_KW)
    cache = tec.HbmEmbeddingCache(table, cfg, device="cpu", device_map=keys_fed, mesh=mesh)
    cache.begin_pass(pool.reshape(-1))
    model = tctr.DeepFM(tctr.CtrConfig(S, 3, DIM, (8,)))
    opt = Adam(learning_rate=1e-3)
    kw = dict(routing=routing, pre_dedup=pre_dedup)
    if keys_fed:
        step = tsc.make_sharded_ctr_train_step_from_keys(model, opt, cfg, mesh, np.arange(S),
                                                         **kw)
    else:
        step = tsc.make_sharded_ctr_train_step(model, opt, cfg, mesh, **kw)
    losses = []
    for t in range(3):
        keys = pool[idx[t]]
        if keys_fed:
            lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))
            args = (cache.device_map.state, lo)
        else:
            args = (torch.from_numpy(cache.lookup(keys.reshape(-1)).reshape(keys.shape)),)
        params, opt_state, state, loss, ov = step(params, opt_state, cache.state, *args,
                                                  torch.from_numpy(dense[t]),
                                                  torch.from_numpy(labels[t]))
        tsc.check_route_overflow(ov)
        losses.append(float(loss))
    return losses, params, cache.state


@pytest.mark.parametrize("routing", ["alltoall", "allgather", "auto",
                                     ("alltoall", "allgather"), ("allgather", "alltoall")],
                         ids=["alltoall", "allgather", "auto", "a2a-ag", "ag-a2a"])
def test_sharded_step_from_keys_matches_jax(routing):
    """Three steps of the JAX sharded key-fed step on an 8-device mesh and
    of the port's on an 8-shard mesh, from the same weights and pass."""
    pool, (idx, dense, labels) = _pool(), _batches()
    mesh = _jmesh(SK)
    pt.seed(0)
    jtable = JaxTable(JaxTableConfig(shard_num=4, backend="python",
                                     accessor_config=JaxAccessorConfig(embedx_dim=DIM)))
    jcfg = jec.CacheConfig(**CACHE_KW)
    jcache = jec.HbmEmbeddingCache(jtable, jcfg, mesh=mesh, axis="ps", device_map=True)
    jcache.begin_pass(pool.reshape(-1))
    jmodel = jctr.DeepFM(jctr.CtrConfig(S, 3, DIM, (8,)))
    jopt = jax_optimizer.Adam(learning_rate=1e-3)
    jp = {"params": dict(jmodel.named_parameters()), "buffers": {}}
    js = jopt.init(jp)
    tparams = ctr_params_from_jax({k: np.asarray(v) for k, v in jp["params"].items()})
    topt = adam_state_from_jax(js)
    jstep = jsc.make_sharded_ctr_train_step_from_keys(
        jmodel, jopt, jcfg, mesh, slot_ids=np.arange(S), axis="ps", donate=False,
        routing=routing)
    jl = []
    for t in range(3):
        lo32 = (pool[idx[t]] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        jp, js, jcache.state, loss, ov = jstep(jp, js, jcache.state, jcache.device_map.state,
                                               jnp.asarray(lo32), jnp.asarray(dense[t]),
                                               jnp.asarray(labels[t]))
        assert int(ov) == 0
        jl.append(float(loss))
    tl, tp, tstate = _port_run(routing, tparams, topt, keys_fed=True)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    want = ctr_params_from_jax({k: np.asarray(v) for k, v in jp["params"].items()})
    for k, w in want.items():
        np.testing.assert_allclose(tp[k].numpy(), w.numpy(), err_msg=k, **STATE_TOL)
    for k, v in jcache.state.items():
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(v), err_msg=k, **STATE_TOL)


def test_sharded_steps_routed_equal_gathered_and_row_fed():
    """Inside the port, bitwise: the key-fed step routed (pre_dedup=False)
    ≡ gathered ≡ the row-fed step over ``lookup``'s spread rows."""
    model = tctr.DeepFM(tctr.CtrConfig(S, 3, DIM, (8,)), generator=torch.Generator().manual_seed(1))
    params = {k: v.detach() for k, v in model.named_parameters()}
    runs = [_port_run(r, dict(params), Adam(1e-3).init(params), keys_fed=kf, pre_dedup=False)
            for r, kf in (("alltoall", True), ("allgather", True), ("alltoall", False))]
    (la, pa, sa), others = runs[0], runs[1:]
    for lb, pb, sb in others:
        assert la == lb
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_sharded_cache_lookup_returns_spread_rows():
    """``HbmEmbeddingCache(mesh=)`` places the pass's rows round-robin over
    the shard blocks, as the JAX package does, and flushes back."""
    pool = _pool()
    mesh = make_mesh({"ps": 4}, device="cpu")
    table = MemorySparseTable(TableConfig(shard_num=2, backend="python",
                                          accessor_config=AccessorConfig(embedx_dim=DIM)))
    jtable = JaxTable(JaxTableConfig(shard_num=2, backend="python",
                                     accessor_config=JaxAccessorConfig(embedx_dim=DIM)))
    cache = tec.HbmEmbeddingCache(table, tec.CacheConfig(**CACHE_KW), device="cpu", mesh=mesh)
    jcache = jec.HbmEmbeddingCache(jtable, jec.CacheConfig(**CACHE_KW), mesh=_jmesh(4))
    cache.begin_pass(pool.reshape(-1))
    jcache.begin_pass(pool.reshape(-1))
    rows = cache.lookup(pool.reshape(-1))
    np.testing.assert_array_equal(rows, jcache.lookup(pool.reshape(-1)))
    assert len(np.unique(rows)) == len(np.unique(pool)) and np.bincount(rows // 1024).min() > 200
    for k, v in jcache.state.items():
        np.testing.assert_array_equal(cache.state[k].numpy(), np.asarray(v), err_msg=k)
    cache.end_pass()
    with pytest.raises(EnforceNotMet, match="divide"):
        tec.HbmEmbeddingCache(table, tec.CacheConfig(capacity=1001, embedx_dim=DIM),
                              device="cpu", mesh=mesh)
