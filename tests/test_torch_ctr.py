"""paddle_tpu_torch's DeepFM GPUPS step against the JAX package, on the CPU.

Both packages start from the same weights (``ctr_params_from_jax``,
``adam_state_from_jax``), the same host tables (Python shards, same
seeds) and the same packed wire buffers. Tolerances:

- the packed wire, the pass build, the key probe and ``serving_pull``
  are exact (byte/bit equality);
- losses agree to rtol 1e-5 and dense parameters / cache state to
  rtol 1e-4 (atol 1e-6): the DNN matmuls and their gradients run
  through different BLAS (XLA's vs PyTorch's), and XLA contracts the
  dense Adam update into FMAs, so the trajectories differ in the last
  bits and compound over steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.models import ctr as jctr
from paddle_tpu.nn import functional as jF
from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import embedding_cache as tec
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX side's pass build needs its native dedup order and key map
pytestmark = pytest.mark.usefixtures("jax_native")

S, D, B, DIM = 3, 4, 48, 4
HIDDEN = (16, 16)
LOSS_RTOL = 1e-5
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
CACHE_KW = dict(capacity=1024, embedx_dim=DIM, embedx_threshold=0.0)


class Pair:
    """The same pass, model and optimizer state in both packages."""

    def __init__(self):
        pt.seed(0)
        rng = np.random.default_rng(7)
        pool = rng.integers(1, 1 << 18, size=(120, S)).astype(np.uint64)
        self.pool = pool + (np.arange(S, dtype=np.uint64) << np.uint64(32))

        jtable = JaxTable(JaxTableConfig(shard_num=2, backend="python",
                                         accessor_config=JaxAccessorConfig(embedx_dim=DIM)))
        self.jccfg = jec.CacheConfig(**CACHE_KW)
        self.jcache = jec.HbmEmbeddingCache(jtable, self.jccfg, device_map=True)
        self.jcache.begin_pass(self.pool.reshape(-1))
        self.jmodel = jctr.DeepFM(jctr.CtrConfig(S, D, DIM, HIDDEN))
        self.jopt = jax_optimizer.Adam(learning_rate=1e-2)
        self.jparams = {"params": dict(self.jmodel.named_parameters()), "buffers": {}}
        self.jopt_state = self.jopt.init(self.jparams)

        self.ttable = MemorySparseTable(TableConfig(
            shard_num=2, accessor_config=AccessorConfig(embedx_dim=DIM)))
        self.tccfg = tec.CacheConfig(**CACHE_KW)
        self.tcache = tec.HbmEmbeddingCache(self.ttable, self.tccfg, device="cpu",
                                            device_map=True)
        self.tcache.begin_pass(self.pool.reshape(-1))
        self.tmodel = tctr.DeepFM(tctr.CtrConfig(S, D, DIM, HIDDEN))
        self.topt = Adam(learning_rate=1e-2)
        self.tparams = ctr_params_from_jax(
            {k: np.asarray(v) for k, v in self.jparams["params"].items()})
        self.topt_state = adam_state_from_jax(self.jopt_state)

    def packs(self, n, seed=3, weights=False):
        rng = np.random.default_rng(seed)
        packs = tctr.make_random_packs(rng, self.pool, B, D, n, p_click=0.4)
        if weights:  # re-pack with a 0/1 padding mask
            out = []
            for p in packs:
                lo = p[:B * S * 4].view(np.uint32).reshape(B, S)
                dense = p[B * S * 4:B * S * 4 + B * D * 2].view(np.float16).reshape(B, D)
                labels = p[B * S * 4 + B * D * 2:].view(np.int8)
                w = (rng.random(B) < 0.8).astype(np.uint8)
                out.append(tctr.pack_ctr_batch(lo, dense, labels, w))
            packs = out
        return packs

    def assert_close(self, jloss, tloss, tparams, jparams, tcache_state, jcache_state):
        np.testing.assert_allclose(np.asarray(tloss.detach()), np.asarray(jloss),
                                   rtol=LOSS_RTOL)
        for k, v in jparams["params"].items():
            v = np.asarray(v)
            np.testing.assert_allclose(tparams[k].numpy(), v.T if v.ndim == 2 else v,
                                       err_msg=k, **STATE_TOL)
        for k, v in jcache_state.items():
            np.testing.assert_allclose(tcache_state[k].numpy(), np.asarray(v),
                                       err_msg=k, **STATE_TOL)


def test_pack_ctr_batch_bytes_identical():
    rng = np.random.default_rng(0)
    lo = rng.integers(0, 1 << 32, size=(B, S), dtype=np.uint64).astype(np.uint32)
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = (rng.random(B) < 0.3).astype(np.int8)
    w = (rng.random(B) < 0.5).astype(np.uint8)
    assert tctr.pack_ctr_batch(lo, dense, labels).tobytes() == \
        jctr.pack_ctr_batch(lo, dense, labels).tobytes()
    assert tctr.pack_ctr_batch(lo, dense, labels, w).tobytes() == \
        jctr.pack_ctr_batch(lo, dense, labels, w).tobytes()
    pool = rng.integers(0, 1 << 20, size=(50, S)).astype(np.uint64)
    a = tctr.make_random_packs(np.random.default_rng(1), pool, B, D, 2)
    b = jctr.make_random_packs(np.random.default_rng(1), pool, B, D, 2)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def test_unpack_roundtrips_the_wire():
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 1 << 32, size=(B, S), dtype=np.uint64).astype(np.uint32)
    dense = rng.normal(size=(B, D)).astype(np.float16)
    labels = (rng.random(B) < 0.3).astype(np.int8)
    w = (rng.random(B) < 0.5).astype(np.uint8)
    packed = torch.from_numpy(tctr.pack_ctr_batch(lo, dense, labels, w))
    o = tctr._packed_layout(B, S, D, True)
    tlo, td, tl, tw = tctr._unpack_ctr(packed, B, S, D, *o[:3], True)
    np.testing.assert_array_equal(tlo.numpy(), lo.reshape(-1).astype(np.int64))
    np.testing.assert_array_equal(td.numpy(), dense)
    np.testing.assert_array_equal(tl.numpy(), labels)
    np.testing.assert_array_equal(tw.numpy(), w.astype(np.float32))


def test_pass_build_and_serving_pull_exact():
    p = Pair()
    for k, v in p.jcache.state.items():
        np.testing.assert_array_equal(p.tcache.state[k].numpy(), np.asarray(v), err_msg=k)
    rng = np.random.default_rng(4)
    keys = p.pool[rng.integers(0, len(p.pool), B)]
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lo[0, 1] = 12345  # a key outside the pass → zeros
    want, wreal = jctr.serving_pull(p.jcache.state, p.jcache.device_map.state,
                                    jnp.arange(S, dtype=jnp.uint32), jnp.asarray(lo),
                                    with_real=True)
    got, real = tctr.serving_pull(p.tcache.state, p.tcache.device_map.state,
                                  torch.arange(S), torch.from_numpy(lo.astype(np.int64)),
                                  with_real=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(real.numpy(), np.asarray(wreal))
    assert real[0, 1] == 0 and (got[0, 1] == 0).all()


def test_deepfm_forward_and_bce_match():
    p = Pair()
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(B, S, 1 + DIM)).astype(np.float32)
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)
    want = p.jmodel.forward(jnp.asarray(emb), jnp.asarray(dense))
    got = torch.func.functional_call(p.tmodel, p.tparams,
                                     (torch.from_numpy(emb), torch.from_numpy(dense)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    wl = jF.binary_cross_entropy_with_logits(want, jnp.asarray(labels), reduction="none")
    tl = tF.binary_cross_entropy_with_logits(got.detach(), torch.from_numpy(labels),
                                             reduction="none")
    np.testing.assert_allclose(tl.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-7)


def test_adam_update_matches_jax():
    p = Pair()
    rng = np.random.default_rng(6)
    jgrads = {"params": {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                         for k, v in p.jparams["params"].items()}, "buffers": {}}
    jp, js = p.jparams, p.jopt_state
    tp, ts = p.tparams, p.topt_state
    for _ in range(3):
        jp, js = p.jopt.update(jgrads, js, jp)
        tp, ts = p.topt.update(ctr_params_from_jax(
            {k: np.asarray(v) for k, v in jgrads["params"].items()}), ts, tp)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k, v in jp["params"].items():
        v = np.asarray(v)
        np.testing.assert_allclose(tp[k].numpy(), v.T if v.ndim == 2 else v,
                                   err_msg=k, **STATE_TOL)


@pytest.mark.parametrize("n_steps,weights", [(1, False), (3, False), (3, True)])
def test_packed_steps_match_jax(n_steps, weights):
    p = Pair()
    jstep = jctr.make_ctr_train_step_packed(p.jmodel, p.jopt, p.jccfg, np.arange(S),
                                            B, D, with_weights=weights, donate=False)
    tstep = tctr.make_ctr_train_step_packed(p.tmodel, p.topt, p.tccfg, np.arange(S),
                                            B, D, with_weights=weights, device="cpu")
    jp, js, jst = p.jparams, p.jopt_state, p.jcache.state
    tp, ts, tst = p.tparams, p.topt_state, p.tcache.state
    for pk in p.packs(n_steps, weights=weights):
        jp, js, jst, jloss = jstep(jp, js, jst, p.jcache.device_map.state,
                                   jnp.asarray(pk))
        tp, ts, tst, tloss = tstep(tp, ts, tst, p.tcache.device_map.state,
                                   torch.from_numpy(pk))
        p.assert_close(jloss, tloss, tp, jp, tst, jst)


def test_slab_matches_jax_and_sequential_packed():
    p = Pair()
    slab = 4
    packs = p.packs(slab, seed=8)
    jstep = jctr.make_ctr_train_step_slab(p.jmodel, p.jopt, p.jccfg, np.arange(S),
                                          B, D, slab=slab, donate=False)
    tstep = tctr.make_ctr_train_step_slab(p.tmodel, p.topt, p.tccfg, np.arange(S),
                                          B, D, slab=slab, device="cpu")
    jp, js, jst, jl = jstep(p.jparams, p.jopt_state, p.jcache.state,
                            p.jcache.device_map.state, jnp.asarray(np.stack(packs)))
    tp, ts, tst, tl = tstep(p.tparams, p.topt_state, p.tcache.state,
                            p.tcache.device_map.state, torch.from_numpy(np.stack(packs)))
    assert tl.shape == (slab,)
    p.assert_close(jl, tl, tp, jp, tst, jst)

    # the slab is the packed step run `slab` times: bitwise the same
    q = Pair()
    one = tctr.make_ctr_train_step_packed(q.tmodel, q.topt, q.tccfg, np.arange(S),
                                          B, D, device="cpu")
    qp, qs, qst = q.tparams, q.topt_state, q.tcache.state
    losses = []
    for pk in packs:
        qp, qs, qst, loss = one(qp, qs, qst, q.tcache.device_map.state,
                                torch.from_numpy(pk))
        losses.append(loss)
    np.testing.assert_array_equal(torch.stack(losses).numpy(), tl.numpy())
    for k in qst:
        np.testing.assert_array_equal(qst[k].numpy(), tst[k].numpy(), err_msg=k)


def test_row_fed_step_matches_jax():
    p = Pair()
    rng = np.random.default_rng(9)
    keys = p.pool[rng.integers(0, len(p.pool), B)]
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.int32)
    jstep = jctr.make_ctr_train_step(p.jmodel, p.jopt, p.jccfg, donate=False)
    tstep = tctr.make_ctr_train_step(p.tmodel, p.topt, p.tccfg, device="cpu")
    jrows = p.jcache.lookup(keys.reshape(-1)).reshape(B, S)
    trows = p.tcache.lookup(keys.reshape(-1)).reshape(B, S)
    np.testing.assert_array_equal(trows, jrows)
    jp, _, jst, jloss = jstep(p.jparams, p.jopt_state, p.jcache.state,
                              jnp.asarray(jrows), jnp.asarray(dense), jnp.asarray(labels))
    tp, _, tst, tloss = tstep(p.tparams, p.topt_state, p.tcache.state,
                              torch.from_numpy(trows.astype(np.int64)),
                              torch.from_numpy(dense), torch.from_numpy(labels))
    p.assert_close(jloss, tloss, tp, jp, tst, jst)


def test_trained_pass_flushes_like_jax():
    """Three packed steps then end_pass: the flushed table rows agree."""
    p = Pair()
    jstep = jctr.make_ctr_train_step_packed(p.jmodel, p.jopt, p.jccfg, np.arange(S),
                                            B, D, donate=False)
    tstep = tctr.make_ctr_train_step_packed(p.tmodel, p.topt, p.tccfg, np.arange(S),
                                            B, D, device="cpu")
    jp, js, jst = p.jparams, p.jopt_state, p.jcache.state
    tp, ts, tst = p.tparams, p.topt_state, p.tcache.state
    for pk in p.packs(3, seed=10):
        jp, js, jst, _ = jstep(jp, js, jst, p.jcache.device_map.state, jnp.asarray(pk))
        tp, ts, tst, _ = tstep(tp, ts, tst, p.tcache.device_map.state,
                               torch.from_numpy(pk))
    p.jcache.state = jst
    p.jcache.end_pass()
    p.tcache.end_pass()
    keys = np.unique(p.pool)
    want, _ = p.jcache.table.export_full(keys)
    got, found = p.ttable.export_full(keys)
    assert found.all()
    np.testing.assert_allclose(got, want, **STATE_TOL)


def _amp_gap(tp, jp, tst, jst):
    """Largest |port - JAX| over the dense params and the cache columns,
    each relative to that tensor's largest |JAX value|."""
    worst = {}
    for k, v in jp["params"].items():
        v = np.asarray(v)
        v = v.T if v.ndim == 2 else v
        worst[k] = float(np.abs(tp[k].numpy() - v).max() / max(np.abs(v).max(), 1e-30))
    for k, v in jst.items():
        v = np.asarray(v)
        worst[k] = float(np.abs(tst[k].numpy() - v).max() / max(np.abs(v).max(), 1e-30))
    return worst


@pytest.mark.parametrize("slab", [1, 3])
def test_amp_packed_and_slab_steps_match_jax_amp(slab):
    """``amp=True`` (bench.py's default) against the JAX step with
    ``amp=True``, 3 steps: losses rtol 1e-4; each dense param and each of
    the cache's seven columns after the push within 1e-2 of that
    tensor's largest value (measured 4e-3: the port rounds the tower's
    cotangent to bf16, so the embedding gradient that the push receives
    differs by that rounding, ROADMAP Queue C); show, click and
    has_embedx exact. The port's f32 step gives other params (amp took
    effect)."""
    p = Pair()
    kw = dict(slot_ids=np.arange(S), batch_size=B, num_dense=D)
    if slab == 1:
        jstep = jctr.make_ctr_train_step_packed(p.jmodel, p.jopt, p.jccfg, donate=False,
                                                amp=True, **kw)
        tstep = tctr.make_ctr_train_step_packed(p.tmodel, p.topt, p.tccfg, device="cpu",
                                                amp=True, **kw)
    else:
        jstep = jctr.make_ctr_train_step_slab(p.jmodel, p.jopt, p.jccfg, slab=slab,
                                              donate=False, amp=True, **kw)
        tstep = tctr.make_ctr_train_step_slab(p.tmodel, p.topt, p.tccfg, slab=slab,
                                              device="cpu", amp=True, **kw)
    packs = p.packs(3, seed=12)
    feeds = [np.stack(packs)] if slab > 1 else packs
    jp, js, jst = p.jparams, p.jopt_state, p.jcache.state
    tp, ts, tst = p.tparams, p.topt_state, p.tcache.state
    for pk in feeds:
        jp, js, jst, jl = jstep(jp, js, jst, p.jcache.device_map.state, jnp.asarray(pk))
        tp, ts, tst, tl = tstep(tp, ts, tst, p.tcache.device_map.state, torch.from_numpy(pk))
    np.testing.assert_allclose(np.asarray(tl), np.asarray(jl), rtol=1e-4)
    gap = _amp_gap(tp, jp, tst, jst)
    assert max(gap.values()) <= 1e-2, gap
    assert gap["show"] == gap["click"] == gap["has_embedx"] == 0.0
    one = {}
    for amp in (False, True):
        q = Pair()
        step = tctr.make_ctr_train_step_packed(q.tmodel, q.topt, q.tccfg, device="cpu",
                                               amp=amp, **kw)
        one[amp] = step(q.tparams, q.topt_state, q.tcache.state, q.tcache.device_map.state,
                        torch.from_numpy(packs[0]))[0]
    assert not torch.equal(one[False]["dnn.layers.0.weight"], one[True]["dnn.layers.0.weight"])
