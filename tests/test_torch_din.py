"""DIN (``models.din``) and the real-position mask of the CTR step body
against the JAX package, on the CPU.

A batch has G = 2 target columns and NB = 4 behaviour columns; a row's
behaviour length is drawn from 0..NB (0: a row that is all padding), and
the positions past it hold the cache's capacity sentinel C. Both packages
start from the same weights (``ctr_params_from_jax``), the same pass over
the same host tables (Python shards, the same seeds) and the same rows.
Tolerances are ``test_torch_ctr.py``'s: forward rtol 1e-5 / atol 1e-6,
gradients rtol 1e-5 / atol 1e-7; after 3 steps losses rtol 1e-4, dense
params and every cache column rtol 1e-4 / atol 1e-6. The export against
the JAX export at rtol 1e-5 / atol 1e-6 (``tests/test_inference_model.py``'s
DIN check: the last two behaviour keys of every row outside the pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.io import inference as jinf
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import din as jdin
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn.layer import functional_call as jcall
from paddle_tpu.ps import embedding_cache as jec
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax, ctr_params_to_jax
from paddle_tpu_torch.io import inference as tinf
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import din as tdin
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import embedding_cache as tec
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("jax_native")

G, NB, D, DIM, B = 2, 4, 3, 4, 32
T = G + NB
HIDDEN, ATT = (16, 8), 8
CAP = 1024
XTOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-4
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


class DinPair:
    """The same pass, DIN and Adam state in both packages."""

    def __init__(self):
        pt.seed(0)
        rng = np.random.default_rng(7)
        pool = rng.integers(1, 1 << 18, size=(96, T)).astype(np.uint64)
        self.pool = pool + (np.arange(T, dtype=np.uint64) << np.uint64(32))
        kw = dict(capacity=CAP, embedx_dim=DIM, embedx_threshold=0.0)
        self.jccfg = jec.CacheConfig(**kw)
        self.jcache = jec.HbmEmbeddingCache(
            JaxTable(JaxTableConfig(shard_num=2, backend="python",
                                    accessor_config=JaxAccessorConfig(embedx_dim=DIM))),
            self.jccfg, device_map=True)
        self.jcache.begin_pass(self.pool.reshape(-1))
        self.tccfg = tec.CacheConfig(**kw)
        self.tcache = tec.HbmEmbeddingCache(
            MemorySparseTable(TableConfig(shard_num=2, backend="python",
                                          accessor_config=AccessorConfig(embedx_dim=DIM))),
            self.tccfg, device="cpu", device_map=True)
        self.tcache.begin_pass(self.pool.reshape(-1))
        self.jmodel = jdin.DIN(G, NB, D, DIM, dnn_hidden=HIDDEN, att_hidden=ATT)
        self.tmodel = tdin.DIN(G, NB, D, DIM, dnn_hidden=HIDDEN, att_hidden=ATT)
        self.jopt, self.topt = jax_optimizer.Adam(learning_rate=1e-2), Adam(learning_rate=1e-2)
        self.jparams = {"params": dict(self.jmodel.named_parameters()), "buffers": {}}
        self.jopt_state = self.jopt.init(self.jparams)
        self.tparams = ctr_params_from_jax(
            {k: np.asarray(v) for k, v in self.jparams["params"].items()})
        self.topt_state = adam_state_from_jax(self.jopt_state)


def _lengths(rng, n):
    lengths = rng.integers(0, NB + 1, n)
    lengths[0] = 0                                      # one row all padding, always
    return lengths


def _rows(p, cache, seed):
    """[B, T] rows of a batch (behaviour positions past each row's length
    the sentinel), dense, labels."""
    rng = np.random.default_rng(seed)
    keys = p.pool[rng.integers(0, len(p.pool), B)]
    rows = cache.lookup(keys.reshape(-1)).reshape(B, T).astype(np.int64)
    pad = np.arange(NB)[None, :] >= _lengths(rng, B)[:, None]
    rows[:, G:][pad] = CAP
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.int32)
    return rows, dense, labels


def test_forward_and_grads_match_jax():
    """The forward, the loss and the gradients (params and embeddings);
    nonzero embeddings at padding positions change nothing, and get zero
    gradient."""
    p = DinPair()
    assert sorted(p.tparams) == sorted(dict(p.tmodel.named_parameters()))
    back = ctr_params_to_jax(p.tparams)["params"]
    for k, v in p.jparams["params"].items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    p.tmodel.load_state_dict(p.tparams)
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(B, T, 1 + DIM)).astype(np.float32)
    real = np.ones((B, T), np.float32)
    real[:, G:] = np.arange(NB)[None, :] < _lengths(rng, B)[:, None]
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)

    def jloss(params, e):
        out, _ = jcall(p.jmodel, params, e, jnp.asarray(real), jnp.asarray(dense),
                       training=True)
        return jnp.mean(jF.binary_cross_entropy_with_logits(out, jnp.asarray(labels),
                                                            reduction="none")), out

    (jl, jout), (jg, jge) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        p.jparams, jnp.asarray(emb))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.tparams.items()}
    te = torch.from_numpy(emb).requires_grad_(True)
    tout = torch.func.functional_call(p.tmodel, leaves,
                                      (te, torch.from_numpy(real), torch.from_numpy(dense)))
    tl = tF.binary_cross_entropy_with_logits(tout, torch.from_numpy(labels))
    *tg, tge = torch.autograd.grad(tl, [*leaves.values(), te])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **XTOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tge.numpy(), np.asarray(jge), rtol=1e-5, atol=1e-7)
    for k, g in zip(leaves, tg):
        want = np.asarray(jg["params"][k])
        np.testing.assert_allclose(g.numpy(), want.T if want.ndim == 2 else want,
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    pad = real == 0
    assert pad.any() and (pad[0, G:]).all()           # the all-padding row is there
    assert not tge.numpy()[pad].any()
    # the padding's values are masked out, not merely multiplied by zero rows
    emb2 = emb.copy()
    emb2[pad] = 0.0
    again = p.tmodel(torch.from_numpy(emb2), torch.from_numpy(real), torch.from_numpy(dense))
    np.testing.assert_array_equal(again.detach().numpy(), tout.detach().numpy())


def test_three_steps_match_jax_and_push_no_padding():
    """3 attention steps (the third with a 0/1 tail mask): losses, dense
    params and the seven cache columns after each push. Each step's shows
    add up to its real positions (× the mask): no padding position pushed."""
    p = DinPair()
    jstep = jdin.make_ctr_attention_train_step(p.jmodel, p.jopt, p.jccfg, donate=False)
    tstep = tdin.make_ctr_attention_train_step(p.tmodel, p.topt, p.tccfg, device="cpu")
    jp, js, jst = p.jparams, p.jopt_state, p.jcache.state
    tp, ts, tst = p.tparams, p.topt_state, p.tcache.state
    for seed in (21, 22, 23):
        rows, dense, labels = _rows(p, p.tcache, seed)
        np.testing.assert_array_equal(rows, _rows(p, p.jcache, seed)[0])
        w = (np.random.default_rng(seed).random(B) < 0.8).astype(np.float32) \
            if seed == 23 else np.ones(B, np.float32)
        show0 = float(tst["show"].sum())
        jp, js, jst, jl = jstep(jp, js, jst, jnp.asarray(rows.astype(np.int32)),
                                jnp.asarray(dense), jnp.asarray(labels), jnp.asarray(w))
        tp, ts, tst, tl = tstep(tp, ts, tst, torch.from_numpy(rows), torch.from_numpy(dense),
                                torch.from_numpy(labels), torch.from_numpy(w))
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
        for k, v in jp["params"].items():
            v = np.asarray(v)
            np.testing.assert_allclose(tp[k].numpy(), v.T if v.ndim == 2 else v,
                                       err_msg=k, **STATE_TOL)
        for k, v in jst.items():
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(v), err_msg=k, **STATE_TOL)
        real = (rows < CAP).astype(np.float32)
        assert float(tst["show"].sum()) - show0 == float((real * w[:, None]).sum())


def test_step_body_real_mask_goes_to_the_loss_and_the_push():
    """``_ctr_step_body(with_real=True)``: ``loss_builder``'s fifth argument is
    the [B, T] mask ``rows < C``, and the push's shows and clicks are
    ``_push_stats(..., real=)``'s, the JAX package's bit for bit."""
    p = DinPair()
    rows, dense, labels = _rows(p, p.tcache, 31)
    seen, pushed = {}, {}

    def make_loss(model, dense_x, labels_, weights, real):
        seen["real"] = real.clone()
        return lambda params, emb: (emb.sum() * 0 + sum(v.sum() for v in params.values()) * 0)

    orig = tctr.cache_push
    tctr.cache_push = lambda st, r, g, shows, clicks, cfg: (
        pushed.update(shows=shows.clone(), clicks=clicks.clone()) or st)
    try:
        tctr._ctr_step_body(p.tmodel, p.topt, p.tccfg, p.tparams, p.topt_state,
                            p.tcache.state, torch.from_numpy(rows).reshape(-1), B, T,
                            torch.from_numpy(dense), torch.from_numpy(labels),
                            loss_builder=make_loss, with_real=True)
    finally:
        tctr.cache_push = orig
    want_real = (rows < CAP).astype(np.float32)
    np.testing.assert_array_equal(seen["real"].numpy(), want_real)
    js, jc = jctr._push_stats(jnp.asarray(labels), None, T, real=jnp.asarray(want_real.ravel()))
    np.testing.assert_array_equal(pushed["shows"].numpy(), np.asarray(js))
    np.testing.assert_array_equal(pushed["clicks"].numpy(), np.asarray(jc))
    assert not pushed["shows"].numpy()[want_real.ravel() == 0].any()


def test_din_serving_export(tmp_path):
    """``export_ctr_inference(with_real=True)`` of DIN, as
    ``tests/test_inference_model.py`` checks the JAX one: the last two
    behaviour keys of every row are outside the pass, and the program
    (the mask from the sentinel in the graph) equals the forward on
    zeroed embeddings and a zeroed mask there, and the JAX export of the
    same weights and tables, at batch 1 and 4."""
    rng = np.random.default_rng(5)
    p = DinPair()
    for col in ("embed_w", "embedx_w"):
        v = rng.normal(size=tuple(p.tcache.state[col].shape)).astype(np.float32)
        p.jcache.state[col] = jnp.asarray(v)
        p.tcache.state[col].copy_(torch.from_numpy(v))
    p.tmodel.load_state_dict(p.tparams)
    tctr.export_ctr_inference(str(tmp_path / "t"), p.tmodel, p.tcache, slot_ids=np.arange(T),
                              num_dense=D, with_real=True)
    jctr.export_ctr_inference(str(tmp_path / "j"), p.jmodel, p.jcache, slot_ids=np.arange(T),
                              num_dense=D, with_real=True)
    pred = tinf.load_inference_model(str(tmp_path / "t"), device="cpu")
    jpred = jinf.load_inference_model(str(tmp_path / "j"))
    for n in (1, 4):
        lo32 = (p.pool[:n] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        lo32[:, -2:] = 0xFFFFFF                           # not in the pass
        dense = rng.normal(size=(n, D)).astype(np.float32)
        got = pred(lo32, dense).numpy()
        np.testing.assert_allclose(got, np.asarray(jpred(jnp.asarray(lo32), jnp.asarray(dense))),
                                   **XTOL)
        rows = p.tcache.lookup(p.pool[:n].reshape(-1)).astype(np.int64)
        emb = tec.cache_pull(p.tcache.state, torch.from_numpy(rows)).reshape(n, T, -1).clone()
        emb[:, -2:, :] = 0.0
        real = torch.ones((n, T))
        real[:, -2:] = 0.0
        want = torch.sigmoid(torch.func.functional_call(
            p.tmodel, p.tparams, (emb, real, torch.from_numpy(dense))))
        np.testing.assert_allclose(got, want.detach().numpy(), rtol=1e-6, atol=1e-7)
