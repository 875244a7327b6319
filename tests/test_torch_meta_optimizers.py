"""``distributed.meta_optimizers`` against the JAX package, on the CPU.

Each wrapper runs 5 updates on the same numpy-seeded params and
gradients in both packages; params and every state tensor must agree
within rtol 1e-6 / atol 1e-7 (the same elementwise f32 algebra; DGC's
quantile threshold releases the same entries on inputs without ties,
checked exactly). LocalSGD averages over "dp" with the port's axis
``psum`` inside ``run_ranks`` against JAX's ``pmean`` inside
``shard_map``. Then the chain order, ``select_runtime`` and the
``reducer=`` wrappers (the pre-reduction contract over
``comm_fusion.DpGradReducer``) rank by rank against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import meta_optimizers as jmo
from paddle_tpu.distributed.strategy import DistributedStrategy as JStrategy
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import opt_state_to_jax
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.distributed import DistributedStrategy, apply_strategy
from paddle_tpu_torch.distributed import meta_optimizers as tmo
from paddle_tpu_torch.ops import collectives as coll

TOL = dict(rtol=1e-6, atol=1e-7)
STEPS = 5


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}


def _grads(step, scale=1.0, seed=10):
    rng = np.random.default_rng(seed + step)
    return {"w": (rng.normal(size=(4, 8)) * scale).astype(np.float32),
            "b": (rng.normal(size=(8,)) * scale).astype(np.float32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)]


def run_both(jo, to, steps=STEPS, grads=_grads):
    """``steps`` updates of the JAX and the port optimizer from the same
    params and gradients: (JAX params, JAX state, port params, port state)."""
    jp = {k: jnp.asarray(v) for k, v in _params().items()}
    tp = {k: torch.from_numpy(v) for k, v in _params().items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(steps):
        g = grads(i)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    return jp, js, tp, ts


def _jax_layout(state, opt):
    """The port's chain state in the JAX chain's layout (a base
    optimizer's through ``convert.opt_state_to_jax``)."""
    if isinstance(opt, tmo.MetaOptimizerBase):
        return {k: (_jax_layout(v, opt.inner) if k == "inner" else v) for k, v in state.items()}
    return opt_state_to_jax(state, opt, params_to_jax=dict)


def assert_match(jp, js, tp, ts, to):
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
    jl, tl = _leaves(js), _leaves(_jax_layout(ts, to))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), **TOL)


@pytest.mark.parametrize("k,avg,base", [(3, True, "SGD"), (2, False, "SGD"), (2, True, "Adam")])
def test_gradient_merge_matches_jax(k, avg, base):
    jo = jmo.GradientMergeOptimizer(getattr(jopt, base)(0.1), k_steps=k, avg=avg)
    to = tmo.GradientMergeOptimizer(getattr(topt, base)(0.1), k_steps=k, avg=avg)
    assert_match(*run_both(jo, to), to)


def test_gradient_merge_holds_params_exactly():
    to = tmo.GradientMergeOptimizer(topt.Adam(0.1), k_steps=3)
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    s = to.init(p)
    g = {k: torch.from_numpy(v) for k, v in _grads(0).items()}
    for _ in range(2):
        new, s = to.update(g, s, p)
        assert all(torch.equal(new[k], p[k]) for k in p)
    new, s = to.update(g, s, p)
    assert not torch.equal(new["w"], p["w"]) and int(s["count"]) == 0


@pytest.mark.parametrize("case", ["nonfinite", "unscale", "growth"])
def test_amp_matches_jax(case):
    kw = {"nonfinite": dict(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=1),
          "unscale": dict(init_loss_scaling=8.0, use_dynamic_loss_scaling=False),
          "growth": dict(init_loss_scaling=4.0, incr_every_n_steps=2)}[case]

    def grads(i):
        g = _grads(i, scale=kw["init_loss_scaling"])
        if case == "nonfinite" and i in (1, 3):
            g["w"][0, 0] = np.nan
        return g

    jo = jmo.AMPOptimizer(jopt.Momentum(0.1), **kw)
    to = tmo.AMPOptimizer(topt.Momentum(0.1), **kw)
    jp, js, tp, ts = run_both(jo, to, grads=grads)
    assert_match(jp, js, tp, ts, to)
    loss = torch.tensor(2.0)
    assert float(to.scale_loss(loss, ts)) == float(jo.scale_loss(jnp.asarray(2.0), js))


@pytest.mark.parametrize("sparsity,begin,momentum", [([0.75], 0, 0.0), ([0.5, 0.75, 0.9], 1, 0.9),
                                                     ([0.99], 100, 0.9)])
def test_dgc_matches_jax_and_releases_the_same_entries(sparsity, begin, momentum):
    jo = jmo.DGCMomentumOptimizer(jopt.SGD(1.0), momentum=momentum, rampup_begin_step=begin,
                                  rampup_step=1, sparsity=sparsity)
    to = tmo.DGCMomentumOptimizer(topt.SGD(1.0), momentum=momentum, rampup_begin_step=begin,
                                  rampup_step=1, sparsity=sparsity)
    jp, js, tp, ts = run_both(jo, to)
    assert_match(jp, js, tp, ts, to)
    for k in jp:   # the residual's zero pattern: which entries were released
        np.testing.assert_array_equal(ts["v"][k].numpy() == 0, np.asarray(js["v"][k]) == 0)


def test_dgc_quantile_is_jax_quantile():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 16, 1000):
        x = np.abs(rng.normal(size=n)).astype(np.float32)
        for q in (0.0, 0.3, 0.5, 0.75, 0.999, 1.0):
            got = tmo._quantile(torch.from_numpy(x), torch.tensor(q, dtype=torch.float32))
            want = jnp.quantile(jnp.asarray(x), jnp.float32(q))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fp16_allreduce_matches_jax():
    to = tmo.FP16AllReduceOptimizer(topt.Adam(0.1))
    assert_match(*run_both(jmo.FP16AllReduceOptimizer(jopt.Adam(0.1)), to), to)


def test_asp_matches_jax():
    to = tmo.ASPOptimizer(topt.SGD(0.1))
    jp, js, tp, ts = run_both(jmo.ASPOptimizer(jopt.SGD(0.1)), to)
    assert_match(jp, js, tp, ts, to)
    mask = ts["asp_mask"]["w"].numpy()
    assert mask.reshape(4, 2, 4).sum(-1).tolist() == [[2, 2]] * 4
    assert ts["asp_mask"]["b"].all()
    assert (tp["w"].numpy()[~mask] == 0).all()


def test_asp_breaks_ties_by_position_as_jax():
    w = np.asarray([[1.0, 1.0, 1.0, 1.0, 3.0, -3.0, 2.0, 2.0]], np.float32)
    want = np.asarray(jmo.ASPOptimizer._make_mask(jnp.asarray(w), 2, 4))
    got = tmo.ASPOptimizer._make_mask(torch.from_numpy(w), 2, 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_recompute_passes_updates_through():
    to = tmo.RecomputeOptimizer(topt.Momentum(0.1))
    assert_match(*run_both(jmo.RecomputeOptimizer(jopt.Momentum(0.1)), to), to)


def test_localsgd_averages_over_dp_as_jax():
    """Two dp ranks with different gradients, k_steps 2: the port's psum
    over "dp" in run_ranks against JAX's pmean in shard_map."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    jo = jmo.LocalSGDOptimizer(jopt.SGD(0.5), k_steps=2, axis="dp")
    to = tmo.LocalSGDOptimizer(topt.SGD(0.5), k_steps=2, axis="dp")
    p0 = _params()
    rank_g = [[_grads(i, seed=10 + 7 * r) for i in range(STEPS)] for r in range(2)]

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    stack = lambda key, i: jnp.stack([jnp.asarray(rank_g[r][i][key]) for r in range(2)])  # noqa
    jp = {k: jnp.stack([jnp.asarray(v)] * 2) for k, v in p0.items()}
    js = jo.init({k: jnp.asarray(v) for k, v in p0.items()})

    def body(p, s, g):
        p1, s1 = jo.update({k: v[0] for k, v in g.items()}, s, {k: v[0] for k, v in p.items()})
        return {k: v[None] for k, v in p1.items()}, s1

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P(), P("dp")),
                           out_specs=(P("dp"), P()), check_vma=False))
    for i in range(STEPS):
        jp, js = fn(jp, js, {k: stack(k, i) for k in p0})

    tmesh = make_mesh({"dp": 2}, device="cpu")
    tps = [{k: torch.from_numpy(v) for k, v in p0.items()} for _ in range(2)]
    tss = [to.init(tps[r]) for r in range(2)]
    for i in range(STEPS):
        def rank_fn(r):
            g = {k: torch.from_numpy(v) for k, v in rank_g[r][i].items()}
            return to.update(g, tss[r], tps[r])

        out = coll.run_ranks(tmesh, rank_fn)
        tps, tss = [o[0] for o in out], [o[1] for o in out]
    for r in range(2):
        for k in p0:
            np.testing.assert_allclose(tps[r][k].numpy(), np.asarray(jp[k])[r], err_msg=k, **TOL)
        assert int(tss[r]["count"]) == int(js["count"])
    assert not np.array_equal(tps[0]["w"].numpy(), _params()["w"])


def test_chain_order_matches_jax():
    kw = dict(amp=True, gradient_merge=True, gradient_merge_configs={"k_steps": 2},
              localsgd=True, recompute=True, asp=True, fp16_allreduce=True, dgc=True)
    jc = jmo.apply_strategy(jopt.Momentum(0.1), JStrategy(**kw))
    tc = apply_strategy(topt.Momentum(0.1), DistributedStrategy(**kw))
    jn, tn = [], []
    while jc is not None:
        jn.append(type(jc).__name__)
        jc = getattr(jc, "inner", None)
    while tc is not None:
        tn.append(type(tc).__name__)
        tc = getattr(tc, "inner", None)
    assert tn == jn == ["AMPOptimizer", "RecomputeOptimizer", "GradientMergeOptimizer",
                        "LocalSGDOptimizer", "ASPOptimizer", "FP16AllReduceOptimizer",
                        "DGCMomentumOptimizer", "SGD"]


@pytest.mark.parametrize("flag,swapped", [("lars", topt.Lars), ("lamb", topt.Lamb)])
def test_base_swaps_keep_the_clip(flag, swapped):
    clip = topt.ClipGradByGlobalNorm(1.0)
    out = apply_strategy(topt.Momentum(0.1, grad_clip=clip), DistributedStrategy(**{flag: True}))
    assert isinstance(out, swapped) and out.grad_clip is clip and out.learning_rate == 0.1


def test_dgc_needs_a_momentum_base():
    with pytest.raises(Exception, match="SGD/Momentum"):
        apply_strategy(topt.Adam(0.1), DistributedStrategy(dgc=True))


def test_select_runtime_matches_jax():
    cases = [{}, {"a_sync": True}, {"geo_sgd_mode": True},
             {"sharding": True, "sharding_configs": {"stage": 2, "sharding_degree": 4}},
             {"without_graph_optimization": True}, {"pipeline": True},
             {"tensor_parallel": True, "tensor_parallel_configs": {"tensor_parallel_degree": 4}},
             {"hybrid_configs": {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2,
                                 "cp_degree": 1, "ep_degree": 1}}]
    for kw in cases:
        assert tmo.select_runtime(DistributedStrategy(**kw)) == \
            jmo.select_runtime(JStrategy(**kw)), kw


def run_ranks_both(jo, to, R=2, steps=3, grads=_grads):
    """``steps`` updates on R dp ranks, each with its own gradients (and,
    under the pre-reduction contract, its own params and state): JAX's
    chain inside ``shard_map`` over R CPU devices, the port's inside
    ``run_ranks`` over R logical ranks. → (JAX params [R, …], JAX state
    [R, …], the port's per-rank params, the port's per-rank states)."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    p0 = _params()
    rank_g = [[grads(i, seed=10 + 7 * r) for i in range(steps)] for r in range(R)]
    expand = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(np.broadcast_to(np.asarray(x), (R,) + np.shape(x)).copy()), t)
    jp = expand({k: jnp.asarray(v) for k, v in p0.items()})
    js = expand(jo.init({k: jnp.asarray(v) for k, v in p0.items()}))

    def body(p, s, g):
        sq = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)  # noqa: E731
        p1, s1 = jo.update(sq(g), sq(s), sq(p))
        return jax.tree_util.tree_map(lambda x: x[None], (p1, s1))

    fn = jax.jit(shard_map(body, mesh=Mesh(np.array(jax.devices()[:R]), ("dp",)),
                           in_specs=(P("dp"), P("dp"), P("dp")), out_specs=(P("dp"), P("dp")),
                           check_vma=False))
    tmesh = make_mesh({"dp": R}, device="cpu")
    tps = [{k: torch.from_numpy(v) for k, v in p0.items()} for _ in range(R)]
    tss = [to.init(tps[0])] * R
    for i in range(steps):
        jp, js = fn(jp, js, {k: jnp.stack([jnp.asarray(rank_g[r][i][k]) for r in range(R)])
                             for k in p0})
        out = coll.run_ranks(tmesh, lambda r: to.update(
            {k: torch.from_numpy(v) for k, v in rank_g[r][i].items()}, tss[r], tps[r]))
        tps, tss = [o[0] for o in out], [o[1] for o in out]
    return jp, js, tps, tss


def assert_ranks_match(jp, js, tps, tss, to):
    """Every rank's params and state equal JAX's rank within TOL."""
    for r, (tp, ts) in enumerate(zip(tps, tss)):
        jpr = {k: np.asarray(v)[r] for k, v in jp.items()}
        jsr = jax.tree_util.tree_map(lambda x: np.asarray(x)[r], js)
        assert_match(jpr, jsr, tp, ts, to)


@pytest.mark.parametrize("build", [
    lambda m, o, red, S: m.apply_strategy(o.SGD(0.1), S(), reducer=red),
    lambda m, o, red, S: m.AMPOptimizer(o.SGD(0.1), init_loss_scaling=4.0,
                                        decr_every_n_nan_or_inf=1, reducer=red),
    lambda m, o, red, S: m.LocalSGDOptimizer(o.SGD(0.5), k_steps=2, axis=("dp",), reducer=red),
    lambda m, o, red, S: m.FP16AllReduceOptimizer(o.SGD(0.1), reducer=red)])
def test_reducer_raises_naming_item_7(build):
    """Each entry that takes ``reducer=`` builds JAX's wrapper around a
    ``DpGradReducer`` over dp=2 (the fused reduction for the bare chain;
    AMP's uniform skip flag; LocalSGD's suspended local steps and its
    average; FP16AllReduce's wire scope), and 3 updates on two ranks with
    their own gradients follow JAX's rank by rank within TOL. A grad that
    is not finite on one rank makes both AMP ranks skip."""
    from paddle_tpu.distributed import comm_fusion as jcf
    from paddle_tpu_torch.distributed import comm_fusion as tcf

    jo = build(jmo, jopt, jcf.DpGradReducer(("dp",), (2,)), JStrategy)
    to = build(tmo, topt, tcf.DpGradReducer(("dp",), (2,)), DistributedStrategy)
    assert type(to).__name__ == type(jo).__name__

    def grads(i, seed=10):
        g = _grads(i, seed=seed)
        if isinstance(to, tmo.AMPOptimizer) and i == 1 and seed == 10:
            g["w"][0, 0] = np.inf            # rank 0 only
        return g

    jp, js, tps, tss = run_ranks_both(jo, to, grads=grads)
    assert_ranks_match(jp, js, tps, tss, to)
    if isinstance(to, tmo.AMPOptimizer):
        assert [float(ts["scaler"].loss_scale) for ts in tss] == [2.0, 2.0]
