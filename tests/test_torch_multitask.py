"""ESMM and MMoE (``models.multitask``) against the JAX package, on the CPU.

Both packages start from the same weights (``ctr_params_from_jax``,
``adam_state_from_jax``), the same pass over the same host tables and the
same batches (``test_torch_ctr.Pair``'s setup with the family's model).
Labels are two tasks: a click, and a conversion only where the click is 1
(``tests/test_multitask_models.py``'s recipe). Tolerances are
``test_torch_ctr.py``'s: forward rtol 1e-5 / atol 1e-6, gradients rtol
1e-5 / atol 1e-7; after 3 steps losses rtol 1e-4 (ESMM's log terms),
dense params and every cache column rtol 1e-4 / atol 1e-6. The exports
(``export_ctr_inference``) against the JAX exports at rtol 1e-5 / atol
1e-6, and against the model's own ``predict`` (ESMM's pCTCVR). The
card-vs-CPU steps are in ``test_torch_din_multitask_cuda.py`` (no JAX
there: the card's machine has none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.io import inference as jinf
from paddle_tpu.models import ctr as jctr
from paddle_tpu.models import multitask as jmt
from paddle_tpu.nn.layer import functional_call as jcall
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax, ctr_params_to_jax
from paddle_tpu_torch.io import inference as tinf
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models import multitask as tmt
from paddle_tpu_torch.ps.embedding_cache import cache_pull
from test_torch_ctr import B, D, DIM, HIDDEN, S, Pair
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("jax_native")

FAMILIES = ["ESMM", "MMoE"]
XTOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-4
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


def _models(family):
    cfg_j, cfg_t = jctr.CtrConfig(S, D, DIM, HIDDEN), tctr.CtrConfig(S, D, DIM, HIDDEN)
    if family == "ESMM":
        return jmt.ESMM(cfg_j), tmt.ESMM(cfg_t)
    return (jmt.MMoE(cfg_j, num_experts=3, expert_dim=8),
            tmt.MMoE(cfg_t, num_experts=3, expert_dim=8))


class MtPair(Pair):
    """``Pair`` with the family's model in both packages."""

    def __init__(self, family):
        super().__init__()
        pt.seed(0)
        self.jmodel, self.tmodel = _models(family)
        self.jparams = {"params": dict(self.jmodel.named_parameters()), "buffers": {}}
        self.jopt_state = self.jopt.init(self.jparams)
        self.tparams = ctr_params_from_jax(
            {k: np.asarray(v) for k, v in self.jparams["params"].items()})
        self.topt_state = adam_state_from_jax(self.jopt_state)


def _labels(rng, n):
    click = (rng.random(n) < 0.4).astype(np.int32)
    conv = ((rng.random(n) < 0.5) & (click == 1)).astype(np.int32)
    return np.stack([click, conv], axis=1)


def _batch(p, seed):
    rng = np.random.default_rng(seed)
    keys = p.pool[rng.integers(0, len(p.pool), B)]
    dense = rng.normal(size=(B, D)).astype(np.float32)
    return keys, dense, _labels(rng, B)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_grads_match_jax(family):
    p = MtPair(family)
    assert sorted(p.tparams) == sorted(dict(p.tmodel.named_parameters()))
    # the converters carry every name across and back
    back = ctr_params_to_jax(p.tparams)["params"]
    for k, v in p.jparams["params"].items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    p.tmodel.load_state_dict(p.tparams)
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(B, S, 1 + DIM)).astype(np.float32)
    dense = rng.normal(size=(B, D)).astype(np.float32)
    labels = _labels(rng, B)
    jcls, tcls = type(p.jmodel), type(p.tmodel)

    def jloss(params, e):
        out, _ = jcall(p.jmodel, params, e, jnp.asarray(dense), training=True)
        return jcls.loss(out, jnp.asarray(labels)), out

    (jl, jout), (jg, jge) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        p.jparams, jnp.asarray(emb))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.tparams.items()}
    te = torch.from_numpy(emb).requires_grad_(True)
    tout = torch.func.functional_call(p.tmodel, leaves, (te, torch.from_numpy(dense)))
    tl = tcls.loss(tout, torch.from_numpy(labels))
    *tg, tge = torch.autograd.grad(tl, [*leaves.values(), te])
    assert len(tout) == 2
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **XTOL)
    for a, b in zip(tcls.predict(tout), jcls.predict(jout)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **XTOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tge.numpy(), np.asarray(jge), rtol=1e-5, atol=1e-7)
    for k, g in zip(leaves, tg):
        want = np.asarray(jg["params"][k])
        np.testing.assert_allclose(g.numpy(), want.T if want.ndim == 2 else want,
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_three_steps_match_jax(family):
    """3 multitask steps (the third with a 0/1 tail mask): losses, dense
    params and the seven cache columns after each push."""
    p = MtPair(family)
    jstep = jmt.make_multitask_train_step(p.jmodel, p.jopt, p.jccfg, donate=False)
    tstep = tmt.make_multitask_train_step(p.tmodel, p.topt, p.tccfg, device="cpu")
    jp, js, jst = p.jparams, p.jopt_state, p.jcache.state
    tp, ts, tst = p.tparams, p.topt_state, p.tcache.state
    for seed in (31, 32, 33):
        keys, dense, labels = _batch(p, seed)
        w = (np.random.default_rng(seed).random(B) < 0.8).astype(np.float32) \
            if seed == 33 else None
        jrows = jnp.asarray(p.jcache.lookup(keys.reshape(-1)).reshape(B, S))
        trows = torch.from_numpy(p.tcache.lookup(keys.reshape(-1)).reshape(B, S)
                                 .astype(np.int64))
        jw, tw = (None, None) if w is None else (jnp.asarray(w), torch.from_numpy(w))
        jp, js, jst, jl = jstep(jp, js, jst, jrows, jnp.asarray(dense), jnp.asarray(labels),
                                jw)
        tp, ts, tst, tl = tstep(tp, ts, tst, trows, torch.from_numpy(dense),
                                torch.from_numpy(labels), tw)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
        for k, v in jp["params"].items():
            v = np.asarray(v)
            np.testing.assert_allclose(tp[k].numpy(), v.T if v.ndim == 2 else v,
                                       err_msg=k, **STATE_TOL)
        for k, v in jst.items():
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(v), err_msg=k, **STATE_TOL)


def test_push_counts_the_click_task():
    """The push's click is ``labels[:, 0]`` (the conversion column is not
    pushed): after one ESMM step from a fresh pass, the click column gained
    S × the batch's clicks and the show column S × B."""
    p = MtPair("ESMM")
    tstep = tmt.make_multitask_train_step(p.tmodel, p.topt, p.tccfg, device="cpu")
    keys, dense, labels = _batch(p, 41)
    labels[:, 1] = 1 - labels[:, 0]            # a conversion column unlike the click's
    show0, click0 = (p.tcache.state[c].sum().item() for c in ("show", "click"))
    rows = torch.from_numpy(p.tcache.lookup(keys.reshape(-1)).reshape(B, S).astype(np.int64))
    _, _, st, _ = tstep(p.tparams, p.topt_state, p.tcache.state, rows, torch.from_numpy(dense),
                        torch.from_numpy(labels))
    assert st["show"].sum().item() - show0 == S * B
    assert st["click"].sum().item() - click0 == S * int(labels[:, 0].sum())


def _valued(family, rng):
    p = MtPair(family)
    for col in ("embed_w", "embedx_w"):
        v = rng.normal(size=tuple(p.tcache.state[col].shape)).astype(np.float32)
        p.jcache.state[col] = jnp.asarray(v)
        p.tcache.state[col].copy_(torch.from_numpy(v))
    p.tmodel.load_state_dict(p.tparams)
    return p


@pytest.mark.parametrize("family", FAMILIES)
def test_multitask_serving_exports(tmp_path, family):
    """The export maps the logits as the model does: ESMM's ``predict``
    ((pCTR, pCTCVR = pCTR·pCVR)), MMoE's (a sigmoid a task). The port's
    program against the JAX export on the same weights and tables at batch
    1 and 8, and against the model's own forward and ``predict``. Before
    the port applied ``torch.sigmoid`` to the tuple (ROADMAP Queue C, C6)."""
    rng = np.random.default_rng(3)
    p = _valued(family, rng)
    tctr.export_ctr_inference(str(tmp_path / "t"), p.tmodel, p.tcache, slot_ids=np.arange(S),
                              num_dense=D)
    jctr.export_ctr_inference(str(tmp_path / "j"), p.jmodel, p.jcache, slot_ids=np.arange(S),
                              num_dense=D)
    pred = tinf.load_inference_model(str(tmp_path / "t"), device="cpu")
    jpred = jinf.load_inference_model(str(tmp_path / "j"))
    for n in (1, 8):
        lo32 = (p.pool[:n] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        dense = rng.normal(size=(n, D)).astype(np.float32)
        got = pred(lo32, dense)
        want = jpred(jnp.asarray(lo32), jnp.asarray(dense))
        assert isinstance(got, tuple) and len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert tuple(a.shape) == (n,)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **XTOL)
        rows = torch.from_numpy(p.tcache.lookup(p.pool[:n].reshape(-1)).astype(np.int64))
        emb = cache_pull(p.tcache.state, rows).reshape(n, S, -1)
        logits = torch.func.functional_call(p.tmodel, p.tparams, (emb, torch.from_numpy(dense)))
        for a, b in zip(got, type(p.tmodel).predict(logits)):
            np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-7)
        if family == "ESMM":
            pctr, pctcvr = got
            np.testing.assert_allclose(pctcvr.numpy(),
                                       (pctr * torch.sigmoid(logits[1])).detach().numpy(),
                                       rtol=1e-6, atol=1e-7)
            assert (pctcvr <= pctr + 1e-6).all()

