"""The port's recsys models (``paddle_tpu_torch.models.{gru4rec,dssm,tdm}``)
against the JAX package's, on the CPU: the counterparts of
``tests/test_gru4rec.py``, ``tests/test_dssm.py`` and ``tests/test_tdm.py``.

Both packages start from the same weights (``convert.recsys_params_from_jax``,
``adam_state_from_jax``), the same pass build over Python-shard host tables
(exact, as ``test_torch_ctr.py`` checks it) and the same numpy-seeded
embeddings and batches. Tolerances:

- tower outputs, gradients and ranker scores: 1e-5 absolute;
- after 3 train steps, losses within 1e-5 (relative) and every dense
  parameter and cache column within 1e-5 of that tensor's largest
  magnitude: the towers' products run through different BLAS (XLA's and
  PyTorch's), so the trajectories differ in the last bits. TDM's dense
  parameters take the measured bound 5e-5 instead: over seeds 0-2 the
  worst was 1.14e-5, on the output layer's one-element bias, whose Adam
  steps are as large as the bias itself (the other families' worst:
  2.9e-6 params, 1.5e-6 cache);
- beam-search items, sampler outputs and ``ServingBeamSource``'s rows and
  flushes: exact.

The tower exports are held against JAX's in ``tests/test_torch_inference.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.data import index_dataset as jid
from paddle_tpu.models import dssm as jdssm
from paddle_tpu.models import gru4rec as jgru
from paddle_tpu.models import tdm as jtdm
from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, recsys_params_from_jax
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.data import index_dataset as tid
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import din as tdin
from paddle_tpu_torch.models import dssm as tdssm
from paddle_tpu_torch.models import gru4rec as tgru
from paddle_tpu_torch.models import tdm as ttdm
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import embedding_cache as tec
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX side's pass build needs its native dedup order
pytestmark = pytest.mark.usefixtures("jax_native")

TOL = 1e-5
DIM = 4
CPU = "cpu"


def _jparams(jm):
    return {"params": dict(jm.named_parameters()), "buffers": {}}


def _tparams(jm):
    return recsys_params_from_jax({k: np.asarray(v) for k, v in jm.named_parameters()})


TDM_PARAM_TOL = 5e-5


def _close_to_max(got, want, what, tol=TOL):
    """Within ``tol`` of the tensor's largest magnitude."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


class Caches:
    """The same pass in both packages: caches over Python-shard tables,
    begun on ``keys``, embedx (and optionally embed_w) set from one numpy
    draw."""

    def __init__(self, keys, capacity=256, lr=0.1, seed=0, embed_w=False):
        acc = dict(embedx_dim=DIM, embedx_threshold=0.0)
        jsgd, tsgd = JaxSGDRuleConfig(learning_rate=lr), SGDRuleConfig(learning_rate=lr)
        ckw = dict(capacity=capacity, embedx_dim=DIM, embedx_threshold=0.0)
        self.jcfg, self.tcfg = jec.CacheConfig(sgd=jsgd, **ckw), tec.CacheConfig(sgd=tsgd, **ckw)
        self.jtable = JaxTable(JaxTableConfig(shard_num=2, backend="python",
                                              accessor_config=JaxAccessorConfig(sgd=jsgd, **acc)))
        self.ttable = MemorySparseTable(TableConfig(
            shard_num=2, backend="python", accessor_config=AccessorConfig(sgd=tsgd, **acc)))
        self.j = jec.HbmEmbeddingCache(self.jtable, self.jcfg)
        self.t = tec.HbmEmbeddingCache(self.ttable, self.tcfg, device=CPU)
        self.j.begin_pass(keys)
        self.t.begin_pass(keys)
        rng = np.random.default_rng(seed)
        cols = ["embedx_w"] + (["embed_w"] if embed_w else [])
        for col in cols:
            v = rng.normal(scale=0.1, size=self.t.state[col].shape).astype(np.float32)
            self.j.state[col] = jnp.asarray(v)
            self.t.state[col].copy_(torch.from_numpy(v))
        for k, v in self.j.state.items():
            np.testing.assert_array_equal(self.t.state[k].numpy(), np.asarray(v), err_msg=k)

    def rows(self, keys):
        """(JAX int32 rows, port int64 rows) of ``keys``."""
        r = self.t.lookup(np.asarray(keys, np.uint64).reshape(-1))
        np.testing.assert_array_equal(r, self.j.lookup(np.asarray(keys, np.uint64).reshape(-1)))
        return r

    def close(self):
        self.ttable.close()


def _assert_step(step_i, jout, tout):
    jl, tl = float(jout[3]), float(tout[3])
    assert abs(tl - jl) <= TOL * max(abs(jl), 1.0), (step_i, tl, jl)


def _assert_state(jparams, tparams, jcache, tcache, param_tol=TOL):
    want = recsys_params_from_jax(jparams)
    for k, v in want.items():
        _close_to_max(tparams[k].numpy(), v.numpy(), k, param_tol)
    for k, v in jcache.items():
        _close_to_max(tcache[k].numpy(), v, k)


# -- GRU4Rec ---------------------------------------------------------------------------

N_ITEMS, N_CLUSTERS, T = 32, 4, 5


def _sessions(rng, n):
    cluster = rng.integers(0, N_CLUSTERS, n)
    lo = cluster * (N_ITEMS // N_CLUSTERS)
    span = N_ITEMS // N_CLUSTERS
    seq = lo[:, None] + rng.integers(0, span, (n, T))
    lengths = rng.integers(2, T + 1, n)
    target = lo + rng.integers(0, span, n)
    return seq.astype(np.uint64), lengths, target.astype(np.uint64), cluster


def _seq_rows(c, seq, lengths, C):
    rows = c.rows(seq).reshape(seq.shape)
    return np.where(np.arange(T)[None, :] >= lengths[:, None], C, rows)


def test_gru4rec_forward_and_grad_match_jax():
    pt.seed(0)
    rng = np.random.default_rng(1)
    jm = jgru.GRU4Rec(embedx_dim=DIM, hidden=8, out_dim=6)
    tm = tgru.GRU4Rec(embedx_dim=DIM, hidden=8, out_dim=6)
    tm.load_state_dict(_tparams(jm))
    seq = rng.normal(size=(5, T, 1 + DIM)).astype(np.float32)
    tgt = rng.normal(size=(5, 1 + DIM)).astype(np.float32)
    lengths = np.array([5, 1, 3, 2, 4])

    def jloss(state, s, t):
        (u, v), _ = jnn.functional_call(jm, state, s, t, jnp.asarray(lengths))
        return jnp.mean(jdssm.DSSM.loss_vec((u, v), None, 0.1)), (u, v)

    (jl, (ju, jv)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        _jparams(jm), jnp.asarray(seq), jnp.asarray(tgt))
    ts = torch.from_numpy(seq).requires_grad_(True)
    tt = torch.from_numpy(tgt).requires_grad_(True)
    u, v = tm(ts, tt, torch.from_numpy(lengths))
    tl = tdssm.DSSM.loss_vec((u, v), None, 0.1).mean()
    names = [k for k, _ in tm.named_parameters()]
    *gp, gs, gt = torch.autograd.grad(tl, [p for _, p in tm.named_parameters()] + [ts, tt])
    for a, b in ((u, ju), (v, jv), (tl, jl), (gs, jg[1]), (gt, jg[2])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=TOL, rtol=0)
    want = recsys_params_from_jax(jg[0]["params"])
    for k, g in zip(names, gp):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gru4rec_three_steps_match_jax(seed):
    pt.seed(seed)
    c = Caches(tgru.item_keys(np.arange(N_ITEMS)), seed=seed)
    try:
        jm = jgru.GRU4Rec(embedx_dim=DIM, hidden=8, out_dim=8)
        tm = tgru.GRU4Rec(embedx_dim=DIM, hidden=8, out_dim=8)
        jopt, topt = jax_optimizer.Adam(5e-3), Adam(5e-3)
        jp = _jparams(jm)
        jo = jopt.init(jp)
        tp, to = _tparams(jm), adam_state_from_jax(jo, params_from_jax=recsys_params_from_jax)
        jstep = jgru.make_gru4rec_train_step(jm, jopt, c.jcfg, donate=False)
        tstep = tgru.make_gru4rec_train_step(tm, topt, c.tcfg, device=CPU)
        rng = np.random.default_rng(2 + seed)
        C = c.tcfg.capacity
        for i in range(3):
            seq, lengths, target, _ = _sessions(rng, 16)
            rs, rt = _seq_rows(c, seq, lengths, C), c.rows(target)
            jout = jstep(jp, jo, c.j.state, jnp.asarray(rs, jnp.int32),
                         jnp.asarray(rt, jnp.int32), jnp.asarray(lengths))
            tout = tstep(tp, to, c.t.state, torch.from_numpy(rs), torch.from_numpy(rt),
                         torch.from_numpy(lengths))
            _assert_step(i, jout, tout)
            jp, jo, c.j.state = jout[:3]
            tp, to = tout[:2]
        _assert_state(jp, tp, c.j.state, c.t.state)
    finally:
        c.close()


def test_gru4rec_learns_session_recall():
    """tests/test_gru4rec.py's learning gate, on the port alone."""
    rng = np.random.default_rng(0)
    dim = 8
    sgd = SGDRuleConfig(learning_rate=0.1)
    table = MemorySparseTable(TableConfig(shard_num=2, accessor_config=AccessorConfig(
        embedx_dim=dim, embedx_threshold=0.0, sgd=sgd)))
    cfg = tec.CacheConfig(capacity=1 << 8, embedx_dim=dim, embedx_threshold=0.0, sgd=sgd)
    try:
        cache = tec.HbmEmbeddingCache(table, cfg, device=CPU)
        cache.begin_pass(tgru.item_keys(np.arange(N_ITEMS)))
        cache.state["embedx_w"].copy_(torch.from_numpy(rng.normal(
            scale=0.1, size=tuple(cache.state["embedx_w"].shape)).astype(np.float32)))
        model = tgru.GRU4Rec(embedx_dim=dim, hidden=16, out_dim=8,
                             generator=torch.Generator().manual_seed(0))
        opt = Adam(5e-3)
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        opt_state = opt.init(params)
        step = tgru.make_gru4rec_train_step(model, opt, cfg, device=CPU)
        C, losses = cfg.capacity, []

        def rows(seq, lengths, target):
            r = cache.lookup(tgru.item_keys(seq.reshape(-1))).reshape(seq.shape)
            r = np.where(np.arange(T)[None, :] >= lengths[:, None], C, r)
            return torch.from_numpy(r), torch.from_numpy(cache.lookup(tgru.item_keys(target)))

        for _ in range(120):
            seq, lengths, target, _ = _sessions(rng, 32)
            params, opt_state, cache.state, loss = step(
                params, opt_state, cache.state, *rows(seq, lengths, target),
                torch.from_numpy(lengths))
            losses.append(float(loss))
        assert np.isfinite(losses).all()
        assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7, losses
        seq, lengths, target, cluster = _sessions(rng, 64)
        rs, rt = rows(seq, lengths, target)
        with torch.no_grad():
            u, v = functional_call(model, params, (
                tec.cache_pull(cache.state, rs.reshape(-1)).reshape(64, T, -1),
                tec.cache_pull(cache.state, rt), torch.from_numpy(lengths)))
        scores = (u @ v.T).numpy()
        same = cluster[:, None] == cluster[None, :]
        auc = float(np.mean(scores[same][:, None] > scores[~same][None, :]))
        assert auc > 0.85, auc
        ranks_cross = ((scores > np.diag(scores)[:, None]) & ~same).sum(1)
        assert float(np.mean(ranks_cross)) < 3.0
    finally:
        table.close()


# -- DSSM ------------------------------------------------------------------------------

SQ, SD = 2, 2


def _synth(rng, n, n_pairs=48):
    topic = rng.integers(0, n_pairs, size=n).astype(np.uint64)
    q = topic[:, None] * np.uint64(4) + rng.integers(0, 4, size=(n, SQ)).astype(
        np.uint64) + np.uint64(1)
    d = (topic[:, None] * np.uint64(4) + rng.integers(0, 4, size=(n, SD)).astype(np.uint64)
         + np.uint64(1) + (np.uint64(1) << np.uint64(32)))
    return (np.concatenate([q, d], axis=1), np.zeros((n, 1), np.float32),
            np.ones(n, np.int32))


@pytest.mark.parametrize("seed,weighted", [(0, False), (1, True), (2, True)])
def test_dssm_three_steps_match_jax(seed, weighted):
    pt.seed(seed)
    rng = np.random.default_rng(seed)
    keys, dense, labels = _synth(rng, 96)
    c = Caches(keys.reshape(-1), capacity=1024, lr=0.05, seed=1 + seed, embed_w=True)
    try:
        jm = jdssm.DSSM(SQ, SD, DIM, hidden=(16, 8), out_dim=8)
        tm = tdssm.DSSM(SQ, SD, DIM, hidden=(16, 8), out_dim=8)
        jopt, topt = jax_optimizer.Adam(3e-3), Adam(3e-3)
        jp = _jparams(jm)
        jo = jopt.init(jp)
        tp, to = _tparams(jm), adam_state_from_jax(jo, params_from_jax=recsys_params_from_jax)
        jstep = jdssm.make_dssm_train_step(jm, jopt, c.jcfg, temperature=0.2, donate=False)
        tstep = tdssm.make_dssm_train_step(tm, topt, c.tcfg, temperature=0.2, device=CPU)
        B = 32
        for i in range(3):
            sl = slice(i * B, (i + 1) * B)
            r = c.rows(keys[sl]).reshape(B, SQ + SD)
            w = (np.arange(B) < B - 5).astype(np.float32) if weighted else None
            jargs = (jnp.asarray(r, jnp.int32), jnp.asarray(dense[sl]), jnp.asarray(labels[sl]))
            targs = (torch.from_numpy(r), torch.from_numpy(dense[sl]),
                     torch.from_numpy(labels[sl]))
            jout = jstep(jp, jo, c.j.state, *jargs, *(() if w is None else (jnp.asarray(w),)))
            tout = tstep(tp, to, c.t.state, *targs,
                         *(() if w is None else (torch.from_numpy(w),)))
            _assert_step(i, jout, tout)
            jp, jo, c.j.state = jout[:3]
            tp, to = tout[:2]
        _assert_state(jp, tp, c.j.state, c.t.state)
    finally:
        c.close()


def test_padded_examples_are_not_fake_negatives():
    """tests/test_dssm.py's padding contract, on the port, and loss_vec
    against JAX's with and without the mask."""
    pt.seed(0)
    rng = np.random.default_rng(3)
    jm = jdssm.DSSM(SQ, SD, DIM)
    tm = tdssm.DSSM(SQ, SD, DIM)
    tm.load_state_dict(_tparams(jm))
    B, Breal = 8, 5
    emb = rng.normal(scale=0.1, size=(B, SQ + SD, 1 + DIM)).astype(np.float32)
    dense = np.zeros((B, 1), np.float32)
    w = (np.arange(B) < Breal).astype(np.float32)
    with torch.no_grad():
        out_full = tm(torch.from_numpy(emb), torch.from_numpy(dense))
        per_masked = tdssm.DSSM.loss_vec(out_full, None, 0.2, weights=torch.from_numpy(w))
        per_real = tdssm.DSSM.loss_vec(tm(torch.from_numpy(emb[:Breal]),
                                          torch.from_numpy(dense[:Breal])), None, 0.2)
    np.testing.assert_allclose(per_masked.numpy()[:Breal], per_real.numpy(), rtol=1e-5)
    assert np.isfinite(per_masked.numpy()).all()
    jout, _ = jnn.functional_call(jm, _jparams(jm), jnp.asarray(emb), jnp.asarray(dense),
                                  training=False)
    for a, b in zip(out_full, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)
    for wt in (None, w):
        want = jdssm.DSSM.loss_vec(jout, None, 0.2, None if wt is None else jnp.asarray(wt))
        got = tdssm.DSSM.loss_vec(out_full, None, 0.2,
                                  None if wt is None else torch.from_numpy(wt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_dssm_learns_pairing_and_ranks_true_doc_on_the_port():
    """tests/test_dssm.py's learning gate, on the port alone."""
    rng = np.random.default_rng(0)
    cfg = tec.CacheConfig(capacity=2048, embedx_dim=8, embedx_threshold=0.0)
    table = MemorySparseTable(TableConfig(shard_num=4, accessor_config=AccessorConfig(
        embedx_dim=8, embedx_threshold=0.0)))
    try:
        cache = tec.HbmEmbeddingCache(table, cfg, device=CPU)
        keys, dense, labels = _synth(rng, 2048)
        cache.begin_pass(keys.reshape(-1))
        model = tdssm.DSSM(SQ, SD, 8, generator=torch.Generator().manual_seed(0))
        opt = Adam(learning_rate=3e-3)
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        opt_state = opt.init(params)
        step = tdssm.make_dssm_train_step(model, opt, cfg, temperature=0.2, device=CPU)
        B, losses = 128, []
        for _ in range(40):
            for i in range(0, len(keys), B):
                rows = torch.from_numpy(cache.lookup(keys[i:i + B].reshape(-1)).reshape(
                    B, SQ + SD))
                params, opt_state, cache.state, loss = step(
                    params, opt_state, cache.state, rows, torch.from_numpy(dense[i:i + B]),
                    torch.from_numpy(labels[i:i + B]))
                losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
        keys2, dense2, _ = _synth(rng, 512)
        hits = 0
        for i in range(0, len(keys2), B):
            rows = torch.from_numpy(cache.lookup(keys2[i:i + B].reshape(-1)))
            emb = tec.cache_pull(cache.state, rows).reshape(B, SQ + SD, -1)
            with torch.no_grad():
                q, d = functional_call(model, params, (emb, torch.from_numpy(dense2[i:i + B])))
            hits += int(((q @ d.T).argmax(dim=1) == torch.arange(B)).sum())
        assert hits / len(keys2) > 0.25, hits / len(keys2)
    finally:
        table.close()


# -- TDM -------------------------------------------------------------------------------

TDM_ITEMS = 32


def _tdm_batch(rng, leaf, codes_labels, c, B, U=3):
    cluster = rng.integers(0, 4, B)
    lo = cluster * (TDM_ITEMS // 4)
    behav = lo[:, None] + rng.integers(0, TDM_ITEMS // 4, (B, U))
    target = lo + rng.integers(0, TDM_ITEMS // 4, B)
    codes, labels = codes_labels(target)
    ru = c.rows(ttdm.node_keys(leaf[behav].reshape(-1))).reshape(B, U)
    rn = c.rows(ttdm.node_keys(codes.reshape(-1))).reshape(codes.shape)
    return ru, rn, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tdm_three_steps_and_beam_match_jax(seed):
    pt.seed(seed)
    jtree, ttree = jid.TreeIndex(list(range(TDM_ITEMS)), 2), tid.TreeIndex(
        list(range(TDM_ITEMS)), 2)
    jsam = jid.LayerWiseSampler(jtree, [1] * jtree.height, seed=seed)
    tsam = tid.LayerWiseSampler(ttree, [1] * ttree.height, seed=seed)
    c = Caches(ttdm.node_keys(np.arange(ttree.total_node_num())), seed=2 + seed)
    try:
        jm, tm = jtdm.TDM(embedx_dim=DIM, hidden=(16, 8)), ttdm.TDM(embedx_dim=DIM,
                                                                     hidden=(16, 8))
        jopt, topt = jax_optimizer.Adam(1e-2), Adam(1e-2)
        jp = _jparams(jm)
        jo = jopt.init(jp)
        tp, to = _tparams(jm), adam_state_from_jax(jo, params_from_jax=recsys_params_from_jax)
        jstep = jtdm.make_tdm_train_step(jm, jopt, c.jcfg, donate=False)
        tstep = ttdm.make_tdm_train_step(tm, topt, c.tcfg, device=CPU)
        leaf = np.array([int(ttree.get_travel_codes(i)[0]) for i in range(TDM_ITEMS)])
        rng = np.random.default_rng(4 + seed)
        for i in range(3):
            # both samplers draw in lockstep: one batch's codes must agree
            state = rng.bit_generator.state
            ru, rn, labels = _tdm_batch(rng, leaf, lambda t: ttdm.tdm_sample_batch(tsam, t),
                                        c, 16)
            rng.bit_generator.state = state
            _, jrn, _ = _tdm_batch(rng, leaf, lambda t: jtdm.tdm_sample_batch(jsam, t), c, 16)
            np.testing.assert_array_equal(rn, jrn)
            jout = jstep(jp, jo, c.j.state, jnp.asarray(ru, jnp.int32),
                         jnp.asarray(rn, jnp.int32), jnp.asarray(labels))
            tout = tstep(tp, to, c.t.state, torch.from_numpy(ru), torch.from_numpy(rn),
                         torch.from_numpy(labels))
            _assert_step(i, jout, tout)
            jp, jo, c.j.state = jout[:3]
            tp, to = tout[:2]
        _assert_state(jp, tp, c.j.state, c.t.state, TDM_PARAM_TOL)
        # the walk over the SAME state (JAX's, carried across) gives the same items
        for col, v in c.j.state.items():
            c.t.state[col].copy_(torch.from_numpy(np.array(v)))
        tp = recsys_params_from_jax(jp)
        for user in ([0, 3, 5], [9, 12], [30, 31, 17]):
            for k in (4, 8):
                want = jtdm.beam_search_retrieve(jtree, jm, jp, c.j, user, k=k)
                got = ttdm.beam_search_retrieve(ttree, tm, tp, c.t, user, k=k)
                assert got == want and len(got) <= k
    finally:
        c.close()


def test_tdm_learns_and_retrieves_on_the_port():
    """tests/test_tdm.py's learning gate, on the port alone (150 steps),
    then a flush and rebuild serving again."""
    rng = np.random.default_rng(0)
    tree = tid.TreeIndex(list(range(TDM_ITEMS)), 2)
    sampler = tid.LayerWiseSampler(tree, [1] * tree.height, seed=0)
    sgd = SGDRuleConfig(learning_rate=0.1)
    table = MemorySparseTable(TableConfig(shard_num=2, accessor_config=AccessorConfig(
        embedx_dim=8, embedx_threshold=0.0, sgd=sgd)))
    cfg = tec.CacheConfig(capacity=1 << 8, embedx_dim=8, embedx_threshold=0.0, sgd=sgd)
    try:
        cache = tec.HbmEmbeddingCache(table, cfg, device=CPU)
        cache.begin_pass(ttdm.node_keys(np.arange(tree.total_node_num())))
        cache.state["embedx_w"].copy_(torch.from_numpy(rng.normal(
            scale=0.1, size=tuple(cache.state["embedx_w"].shape)).astype(np.float32)))
        model = ttdm.TDM(embedx_dim=8, hidden=(32, 16),
                         generator=torch.Generator().manual_seed(0))
        opt = Adam(1e-2)
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        opt_state = opt.init(params)
        step = ttdm.make_tdm_train_step(model, opt, cfg, device=CPU)
        leaf = np.array([int(tree.get_travel_codes(i)[0]) for i in range(TDM_ITEMS)])

        class One:
            rows = staticmethod(cache.lookup)

        losses = []
        for _ in range(150):
            ru, rn, lb = _tdm_batch(rng, leaf, lambda t: ttdm.tdm_sample_batch(sampler, t),
                                    One, 32)
            params, opt_state, cache.state, loss = step(
                params, opt_state, cache.state, torch.from_numpy(ru), torch.from_numpy(rn),
                torch.from_numpy(lb))
            losses.append(float(loss))
        assert np.isfinite(losses).all()
        assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.8
        hits = total = 0
        for cl in range(4):
            lo = cl * 8
            got = ttdm.beam_search_retrieve(tree, model, params, cache, [lo, lo + 3, lo + 5], k=8)
            assert got
            hits += sum(1 for i in got if lo <= i < lo + 8)
            total += len(got)
        assert hits / total > 0.5, (hits, total)
        cache.end_pass()
        cache.begin_pass(ttdm.node_keys(np.arange(tree.total_node_num())))
        assert ttdm.beam_search_retrieve(tree, model, params, cache, [0, 3, 5], k=8)
    finally:
        table.close()


class _ValLookup:
    """Serving lookup stub: the row of key k is [k, k+0.5, ...] (width 5);
    counts the keys it was asked for."""

    def __init__(self):
        self.asked = []

    def lookup(self, keys):
        keys = np.asarray(keys, np.uint64)
        self.asked.append(keys.tolist())
        k = keys.astype(np.float64)[:, None]
        return (k + np.arange(5) * 0.5).astype(np.float32)


def test_serving_beam_source_flush_semantics_match_jax():
    """Slots, state rows, flushes and the fetches made, equal to JAX's
    through a fill, reuse, duplicates, an overflow flush and the
    too-large request."""
    j = jtdm.ServingBeamSource(_ValLookup(), capacity=6)
    t = ttdm.ServingBeamSource(_ValLookup(), capacity=6, device=CPU)
    for keys in ([1, 2, 3], [2, 3, 4], [4, 4, 5], [7, 8], [1], [9, 9, 9, 9]):
        want, got = j.lookup(keys), t.lookup(keys)
        np.testing.assert_array_equal(got, want)
        assert t.flushes == j.flushes
        for col in ("embed_w", "embedx_w"):
            np.testing.assert_array_equal(t.state[col].numpy(), j.state[col])
    assert t._lookup.asked == j._lookup.asked and t.flushes >= 1
    with pytest.raises(EnforceNotMet):
        t.lookup(np.arange(10, 17))


# -- rankers ---------------------------------------------------------------------------

def test_gru4rec_ranker_matches_jax_and_ignores_padding():
    pt.seed(0)
    jm = jgru.GRU4Rec(embedx_dim=DIM, hidden=8, out_dim=8)
    tm = tgru.GRU4Rec(embedx_dim=DIM, hidden=8, out_dim=8)
    rng = np.random.default_rng(6)
    B, H, K = 5, 6, 4   # 5 rows: JAX pads the batch to 8
    hist = rng.normal(size=(B, H, 1 + DIM)).astype(np.float32)
    cand = rng.normal(size=(B, K, 1 + DIM)).astype(np.float32)
    lengths = np.array([6, 2, 4, 1, 6], np.int32)
    want = jgru.make_gru4rec_ranker(jm)(hist, lengths, cand)
    got = tgru.make_gru4rec_ranker(tm, _tparams(jm), device=CPU)(hist, lengths, cand)
    assert got.shape == (B, K) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # a row's scores do not depend on the rest of the batch (no padding)
    one = tgru.make_gru4rec_ranker(tm, _tparams(jm), device=CPU)(hist[2:3], lengths[2:3],
                                                                 cand[2:3])
    np.testing.assert_allclose(one[0], got[2], atol=1e-6, rtol=0)
    # default params: the module's own
    tm.load_state_dict(_tparams(jm))
    np.testing.assert_array_equal(tgru.make_gru4rec_ranker(tm, device=CPU)(
        hist, lengths, cand), got)


def test_dssm_ranker_matches_jax_and_checks_its_contract():
    pt.seed(0)
    jm = jdssm.DSSM(num_query_slots=3, num_doc_slots=1, embedx_dim=DIM, hidden=(8,),
                    out_dim=8)
    tm = tdssm.DSSM(num_query_slots=3, num_doc_slots=1, embedx_dim=DIM, hidden=(8,),
                    out_dim=8)
    rng = np.random.default_rng(7)
    B, K = 3, 4
    hist = rng.normal(size=(B, 3, 1 + DIM)).astype(np.float32)
    cand = rng.normal(size=(B, K, 1 + DIM)).astype(np.float32)
    want = jdssm.make_dssm_ranker(jm)(hist, np.full(B, 3, np.int32), cand)
    rank = tdssm.make_dssm_ranker(tm, _tparams(jm), device=CPU)
    got = rank(hist, np.full(B, 3, np.int32), cand)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (np.abs(got) <= 1.0 + 1e-5).all()
    with pytest.raises(ValueError):
        rank(hist[:, :2], np.full(B, 2, np.int32), cand)
    with pytest.raises(ValueError):
        tdssm.make_dssm_ranker(tdssm.DSSM(2, 2, DIM), device=CPU)


# -- surface ---------------------------------------------------------------------------

def test_exports_and_with_real_wait_for_their_items():
    """The tower exports are ported (``tests/test_torch_inference.py``
    holds them against JAX's): without a pass they refuse as JAX's do.
    DIN's ``with_real`` step body runs (``tests/test_torch_din.py`` holds
    it against JAX's): the sentinel position pushes nothing."""
    cache = tec.HbmEmbeddingCache(MemorySparseTable(TableConfig(
        shard_num=1, accessor_config=AccessorConfig(embedx_dim=DIM))),
        tec.CacheConfig(capacity=16, embedx_dim=DIM), device=CPU, device_map=True)
    with pytest.raises(EnforceNotMet, match="begin_pass"):
        tgru.export_gru4rec_towers("d", tgru.GRU4Rec(DIM), cache, max_len=4)
    with pytest.raises(EnforceNotMet, match="begin_pass"):
        tdssm.export_dssm_towers("d", tdssm.DSSM(1, 1, DIM), cache, [0], [1])
    cache.begin_pass(np.arange(1, 5, dtype=np.uint64))
    rows = torch.from_numpy(np.array([list(cache.lookup(np.array([1, 2], np.uint64))) + [16]],
                                     np.int64))
    din = tdin.DIN(1, 2, 1, DIM, dnn_hidden=(4,), att_hidden=4,
                   generator=torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in din.named_parameters()}
    opt = Adam(1e-2)
    step = tdin.make_ctr_attention_train_step(din, opt, cache.config, device=CPU)
    show0 = float(cache.state["show"].sum())
    _, _, st, loss = step(params, opt.init(params), cache.state, rows, torch.zeros(1, 1),
                          torch.ones(1, dtype=torch.int32))
    assert torch.isfinite(loss) and float(st["show"].sum()) - show0 == 2.0


def test_default_loss_builder_is_the_bce_body():
    """Passing the default builder explicitly gives the same bits as not
    passing it (DeepFM and WideDeep keep their step)."""
    pt.seed(0)
    cfg = tctr.CtrConfig(2, 3, DIM, (8,))
    table = MemorySparseTable(TableConfig(shard_num=2, accessor_config=AccessorConfig(
        embedx_dim=DIM)))
    try:
        cache = tec.HbmEmbeddingCache(table, tec.CacheConfig(capacity=64, embedx_dim=DIM),
                                      device=CPU)
        keys = np.arange(1, 21, dtype=np.uint64)
        cache.begin_pass(keys)
        model = tctr.DeepFM(cfg, generator=torch.Generator().manual_seed(0))
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
        rng = np.random.default_rng(0)
        rows = torch.from_numpy(cache.lookup(keys[rng.integers(0, 20, 16)]))
        dense = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
        labels = torch.from_numpy((rng.random(8) < 0.5).astype(np.int32))
        outs = []
        for builder in (None, tctr._make_loss_fn):
            state = {k: v.clone() for k, v in cache.state.items()}
            opt = Adam(1e-2)
            outs.append(tctr._ctr_step_body(model, opt, cache.config, params,
                                            opt.init(params), state, rows, 8, 2, dense,
                                            labels, loss_builder=builder))
        for a, b in zip(outs[0], outs[1]):
            if isinstance(a, dict):
                for k in a:
                    if isinstance(a[k], torch.Tensor):
                        assert torch.equal(a[k], b[k]), k
            else:
                assert torch.equal(a, b)
    finally:
        table.close()
