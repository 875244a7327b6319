"""The port's dense optimizers against ``paddle_tpu.optimizer``.

5 steps on a seeded parameter tree with seeded gradients, through both
packages, on the CPU; the port's state is held against the JAX state
through ``convert.opt_state_from_jax``. Tolerance rtol 2e-6 / atol 1e-7
on params and slots (the same f32 formulas; a schedule's power or cosine
and a norm's sum may round differently in the last place); the bf16
params of ``MasterWeights`` exactly equal to their masters cast down.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import opt_state_from_jax

SHAPES = {"conv.weight": (4, 3, 3, 3), "fc.bias": (5,), "fc.weight": (6, 5), "scale": (1,)}


def _tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _flat(state):
    """The port's state as {path: numpy}."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": a for p, a in _flat(v).items()})
        else:
            out[k] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return out


def _as_is(tree, device="cpu"):
    """JAX trees here have no 2-D Linear weights to transpose."""
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


def _run(make, steps=5, bf16=False):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(steps)]
    jo, to = make(jopt), make(topt)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    if bf16:
        jo, js, jp = jopt.decorate_o2(jo, jp)
        to, ts, tp = topt.decorate_o2(to, tp)
    else:
        js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tp[k].dtype) for k, v in g.items()}
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
    return jo, jp, js, to, tp, ts


def _check(jo, jp, js, to, tp, ts):
    for k in SHAPES:
        assert tp[k].dtype == {jnp.float32: torch.float32,
                               jnp.bfloat16: torch.bfloat16}[jp[k].dtype.type]
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                   rtol=2e-6, atol=1e-7, err_msg=k)
    want = _flat(opt_state_from_jax(js, to, params_from_jax=_as_is))
    got = _flat(ts)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-6, atol=1e-7, err_msg=k)
    assert int(ts["step"]) == 5


CASES = {
    "sgd": lambda m: m.SGD(0.1),
    "sgd-decay": lambda m: m.SGD(0.1, weight_decay=1e-2),
    "momentum": lambda m: m.Momentum(0.1, 0.9),
    "momentum-nesterov-decay": lambda m: m.Momentum(0.05, 0.8, use_nesterov=True,
                                                    weight_decay=1e-3),
    "adam": lambda m: m.Adam(1e-2),
    "adam-decay-globalclip": lambda m: m.Adam(1e-2, weight_decay=1e-2,
                                              grad_clip=m.ClipGradByGlobalNorm(1.0)),
    "adamw": lambda m: m.AdamW(1e-2, weight_decay=0.1),
    "momentum-clipnorm": lambda m: m.Momentum(0.1, grad_clip=m.ClipGradByNorm(0.5)),
    "sgd-clipvalue": lambda m: m.SGD(0.1, grad_clip=m.ClipGradByValue(0.3)),
    "sgd-clipvalue-asym": lambda m: m.SGD(0.1, grad_clip=m.ClipGradByValue(0.3, -0.1)),
    "adagrad": lambda m: m.Adagrad(0.1),
    "adagrad-init-decay": lambda m: m.Adagrad(0.05, initial_accumulator_value=0.1,
                                              weight_decay=1e-2),
    "adadelta": lambda m: m.Adadelta(1.0),
    "adadelta-decay": lambda m: m.Adadelta(0.5, rho=0.9, weight_decay=1e-2),
    "adamax": lambda m: m.Adamax(1e-2),
    "adamax-decay-globalclip": lambda m: m.Adamax(1e-2, weight_decay=1e-2,
                                                  grad_clip=m.ClipGradByGlobalNorm(1.0)),
    "rmsprop": lambda m: m.RMSProp(1e-2),
    "rmsprop-momentum-decay": lambda m: m.RMSProp(1e-2, rho=0.9, momentum=0.9,
                                                  weight_decay=1e-3),
    "lars": lambda m: m.Lars(0.1),
    "lars-eps-schedule": lambda m: m.Lars(m.lr.cosine_decay(0.1, 4), momentum=0.8,
                                          lars_coeff=0.01, epsilon=1e-8),
    "lamb": lambda m: m.Lamb(1e-2),
    "lamb-decay-schedule": lambda m: m.Lamb(m.lr.exponential_decay(1e-2, 0.8),
                                            lamb_weight_decay=0.1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_five_steps_match_jax(name):
    _check(*_run(CASES[name]))


SCHEDULES = {
    "constant": lambda lr: lr.constant(0.1),
    "exponential": lambda lr: lr.exponential_decay(0.1, 0.7),
    "cosine": lambda lr: lr.cosine_decay(0.1, 3, 0.01),
    "warmup_linear": lambda lr: lr.warmup_linear(0.1, 2, 6),
    "piecewise": lambda lr: lr.piecewise_decay([1, 3], [0.1, 0.05, 0.01]),
    "polynomial": lambda lr: lr.polynomial_decay(0.1, 4, 0.01, 2.0),
    "noam": lambda lr: lr.noam_decay(16, 2, 0.5),
    "step": lambda lr: lr.step_decay(0.1, 2, 0.5),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_values_and_steps_match_jax(name):
    js, ts = SCHEDULES[name](jopt.lr), SCHEDULES[name](topt.lr)
    for step in range(8):
        got = ts(torch.tensor(step, dtype=torch.int64))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(js(jnp.asarray(step, jnp.int32))),
                                   rtol=2e-6, atol=1e-9)
    _check(*_run(lambda m: m.Momentum(SCHEDULES[name](m.lr), 0.9)))


@pytest.mark.parametrize("inner", ["adam", "momentum", "sgd", "adamw", "lars", "lamb"])
def test_master_weights_o2_match_jax(inner):
    make = {"adam": lambda m: m.Adam(1e-2), "momentum": lambda m: m.Momentum(0.1, 0.9),
            "sgd": lambda m: m.SGD(0.1), "adamw": lambda m: m.AdamW(1e-2, weight_decay=0.1),
            "lars": lambda m: m.Lars(0.1), "lamb": lambda m: m.Lamb(1e-2)}[inner]
    jo, jp, js, to, tp, ts = _run(make, bf16=True)
    assert isinstance(to, topt.MasterWeights) and sorted(ts) == ["inner", "master", "step"]
    _check(jo, jp, js, to, tp, ts)
    for k, p in tp.items():  # pure projections of the masters
        assert torch.equal(p, ts["master"][k].to(torch.bfloat16)), k
    # decorating twice keeps one MasterWeights
    again, _, _ = topt.decorate_o2(to, {k: v.float() for k, v in tp.items()})
    assert again is to


def test_float_learning_rate_is_a_scalar_with_the_bits_of_a_tensor_rate():
    """A float rate runs no schedule (no device op a step) and gives the
    bits that the same rate as a 0-dim f32 tensor gives."""
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    g = {k: torch.from_numpy(v) for k, v in _tree(rng, 0.5).items()}
    for make in (lambda lr: topt.Momentum(lr, 0.9, use_nesterov=True, weight_decay=1e-3),
                 lambda lr: topt.AdamW(lr, weight_decay=0.1)):
        opt, sched = make(0.07), make(topt.lr.constant(0.07))
        assert opt.schedule is None and opt.learning_rate == 0.07
        got, _ = opt.update(g, opt.init(p), p)
        want, _ = sched.update(g, sched.init(p), p)
        for k in p:
            assert torch.equal(got[k], want[k]), k


def test_master_weights_pass_non_float_params_and_reject_non_optimizers():
    opt = topt.MasterWeights(topt.SGD(0.5))
    p = {"w": torch.ones(3, dtype=torch.bfloat16), "ids": torch.arange(3)}
    st = opt.init(p)
    new_p, st = opt.update({"w": torch.ones(3, dtype=torch.bfloat16),
                            "ids": torch.zeros(3, dtype=torch.int64)}, st, p)
    assert new_p["w"].dtype == torch.bfloat16 and torch.equal(new_p["ids"], p["ids"])
    assert float(new_p["w"][0]) == 0.5
    with pytest.raises(Exception, match="wraps an Optimizer"):
        topt.MasterWeights(object())


def test_global_norm_matches_jax():
    g = _tree(np.random.default_rng(9))
    np.testing.assert_allclose(float(topt.global_norm({k: torch.from_numpy(v)
                                                       for k, v in g.items()})),
                               float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, g))),
                               rtol=1e-6)
