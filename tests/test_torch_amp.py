"""The port's ``amp`` against ``paddle_tpu.amp``, and the two ops that
consult it (``linear``, ``conv2d``) against the JAX package's.

Same numpy-seeded inputs through both packages, on the CPU.

Tolerances:
- GradScaler, all_finite, auto_cast/step_ctx: exact (the same integer and
  power-of-two arithmetic).
- linear under amp, forward: atol 1e-5 at [64, 256] x [256, 128] (both
  sum the exact products of bf16-rounded operands in f32, in another
  order); the backward exactly equal to ``jax.vjp`` of the JAX ``linear``
  fed the bf16-rounded cotangent (the port rounds the cotangent to bf16,
  the JAX package keeps it f32: that gap is measured, not hidden).
- conv2d under amp: forward exact on these sizes (f32 sums of bf16
  products, the same order on the CPU); backward exact against the oracle
  built from parts, since the JAX package's amp conv cannot be
  differentiated (jax 0.9.0 raises in its transpose rule).
"""

import contextlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.nn import functional as tF


def _bf(a):
    """f32 values rounded to bf16 (numpy, through JAX's rounding)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# -- loss scaling -----------------------------------------------------------------

FINITE_SEQ = [True, True, True, False, False, True, False, True, True, True, False,
              False, False, True, True, True, True, True]


@pytest.mark.parametrize("kw", [dict(incr_every_n_steps=3, decr_every_n_nan_or_inf=2),
                                dict(incr_every_n_steps=1, decr_every_n_nan_or_inf=1,
                                     init_loss_scaling=4.0, decr_ratio=0.25),
                                dict(use_dynamic_loss_scaling=False)],
                         ids=["grow3-shrink2", "every-step-floor-1", "static"])
def test_grad_scaler_sequence_matches_jax(kw):
    """The grow/shrink sequence over finite and non-finite gradients:
    scale, good and bad counts equal the JAX package's at every step."""
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jst, tst = js.init(), ts.init("cpu")
    rng = np.random.default_rng(0)
    for ok in FINITE_SEQ:
        g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
        if not ok:
            g["b"][2] = np.inf if rng.random() < 0.5 else np.nan
        scaled_j = js.scale(jnp.float32(1.5), jst)
        scaled_t = ts.scale(torch.tensor(1.5), tst)
        assert float(scaled_j) == float(scaled_t)
        jg, jok = js.unscale(jax.tree_util.tree_map(jnp.asarray, g), jst)
        tg, tok = ts.unscale({k: torch.from_numpy(v) for k, v in g.items()}, tst)
        assert bool(jok) == bool(tok) == ok
        for k in g:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        jst, tst = js.update(jok, jst), ts.update(tok, tst)
        assert float(jst.loss_scale) == float(tst.loss_scale)
        assert int(jst.good_steps) == int(tst.good_steps)
        assert int(jst.bad_steps) == int(tst.bad_steps)
        assert tst.loss_scale.dtype == torch.float32 and tst.good_steps.dtype == torch.int32


def test_all_finite_over_nested_trees():
    ok = {"a": torch.ones(3), "b": [torch.zeros(2), (torch.ones(1),)]}
    assert bool(tamp.all_finite(ok)) and bool(jamp.all_finite(jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), ok)))
    bad = {"a": torch.ones(3), "b": [torch.tensor([0.0, float("-inf")])]}
    assert not bool(tamp.all_finite(bad))
    assert tamp.all_finite(bad).shape == ()


def test_all_finite_of_a_tree_without_tensors_raises():
    """An empty tree has no device to put the answer on."""
    from paddle_tpu_torch.core.enforce import InvalidArgumentError
    with pytest.raises(InvalidArgumentError, match="at least one tensor"):
        tamp.all_finite({"a": [], "b": {}})


def test_auto_cast_and_step_ctx_nesting_match_jax():
    """The state inside each context of the same nesting is the same in
    both packages; step_ctx(False) leaves an enclosing auto_cast on."""
    def trace(amp, to_str):
        seen = []
        rec = lambda: seen.append((amp.amp_enabled(), to_str(amp.amp_dtype())))  # noqa: E731
        rec()
        with amp.auto_cast():
            rec()
            with amp.step_ctx(False):
                rec()
            with amp.auto_cast(enable=False):
                rec()
                with amp.step_ctx(True, "float16"):
                    rec()
                rec()
            with amp.amp_guard(dtype="bf16"):
                rec()
        rec()
        return seen

    j = trace(jamp, lambda d: jnp.dtype(d).name)
    t = trace(tamp, lambda d: str(d).replace("torch.", ""))
    assert j == t
    assert t[2] == (True, "bfloat16") and t[4] == (True, "float16") and t[-1][0] is False


def test_cast_model_inputs_matches_jax():
    tree = {"x": np.ones((2, 2), np.float32), "ids": np.arange(3, dtype=np.int64),
            "l": [np.zeros(2, np.float64)]}
    jt = jamp.cast_model_inputs(jax.tree_util.tree_map(jnp.asarray, tree))
    tt = tamp.cast_model_inputs({"x": torch.ones(2, 2), "ids": torch.arange(3),
                                 "l": [torch.zeros(2, dtype=torch.float64)]})
    assert jt["x"].dtype == jnp.bfloat16 and tt["x"].dtype == torch.bfloat16
    assert tt["ids"].dtype == torch.int64 and tt["l"][0].dtype == torch.bfloat16
    assert tamp.cast_model_inputs({"x": torch.ones(1)}, torch.float16)["x"].dtype == torch.float16


# -- linear -----------------------------------------------------------------------

def _linear_inputs(seed=0, batch=(64,)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=batch + (256,)).astype(np.float32)
    w = (rng.normal(size=(256, 128)) * 0.1).astype(np.float32)   # JAX [in, out]
    b = rng.normal(size=(128,)).astype(np.float32)
    g = rng.normal(size=batch + (128,)).astype(np.float32)
    return x, w, b, g


def _jax_amp_linear(x, w, b):
    with jamp.auto_cast():
        return jF.linear(x, w, b)


@pytest.mark.parametrize("batch", [(64,), (4, 16)], ids=["2d", "3d"])
def test_amp_linear_forward_and_backward_match_jax(batch):
    x, w, b, g = _linear_inputs(batch=batch)
    jy, vjp = jax.vjp(_jax_amp_linear, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(_bf(g)))      # the bf16-rounded cotangent
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    with tamp.auto_cast():
        ty = tF.linear(tx, tw, tb)
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jdx))
    np.testing.assert_array_equal(tw.grad.numpy().T, np.asarray(jdw))
    # the bias add stays f32: its gradient is the f32 cotangent's sum
    np.testing.assert_allclose(tb.grad.numpy(), g.reshape(-1, 128).sum(0), rtol=1e-6,
                               atol=1e-5)
    # outside auto_cast the same call is the f32 product
    np.testing.assert_allclose(tF.linear(tx, tw, tb).detach().numpy(),
                               np.asarray(jF.linear(x, w, b)), rtol=1e-6, atol=1e-5)


def test_amp_linear_cotangent_rounding_gap_to_jax():
    """The port's one divergence from the JAX package on the CPU: it rounds
    the cotangent to bf16 before the backward products, the JAX package
    keeps it f32. At [64, 256] x [256, 128] (|dW| up to ~36) the gap
    measured 0.03125 on dx and 0.125 on dW (ROADMAP Queue C); held here
    to be present and at most twice that (another BLAS may flip a bf16
    rounding elsewhere), within a few bf16 steps of the gradients' size."""
    x, w, b, g = _linear_inputs()
    _, vjp = jax.vjp(_jax_amp_linear, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, _ = vjp(jnp.asarray(g))             # the JAX package's own f32 cotangent
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    with tamp.auto_cast():
        tF.linear(tx, tw).backward(torch.from_numpy(g))
    gap_dx = float(np.abs(tx.grad.numpy() - np.asarray(jdx)).max())
    gap_dw = float(np.abs(tw.grad.numpy().T - np.asarray(jdw)).max())
    assert 0 < gap_dx <= 0.0625 and 0 < gap_dw <= 0.25, (gap_dx, gap_dw)
    assert gap_dw <= 2 ** -7 * float(np.abs(np.asarray(jdw)).max())


def test_amp_linear_bf16_input_and_o2_weight():
    """A bf16 input is left as it is (the JAX package casts only f32
    inputs); a bf16 weight (O2) under amp gives a bf16 weight gradient."""
    x, w, _, g = _linear_inputs()
    tx = torch.from_numpy(x)
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(torch.bfloat16).requires_grad_()
    with tamp.auto_cast():
        y = tF.linear(tx, tw)
        y.backward(torch.from_numpy(g))
        y16 = tF.linear(tx.to(torch.bfloat16), tw.detach())
    assert y.dtype == torch.float32 and tw.grad.dtype == torch.bfloat16
    jy16 = jnp.matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16))
    assert y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().numpy(), np.asarray(jy16.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2e-2)


# -- conv2d -----------------------------------------------------------------------

CONV_CASES = [  # (N, C, H, W, O, k, stride, padding, groups)
    (2, 3, 16, 16, 8, 3, 1, 1, 1), (2, 4, 15, 13, 6, 5, 2, 2, 2),
    (1, 8, 9, 9, 8, 1, 2, 0, 1), (2, 3, 12, 12, 4, 3, 2, "SAME", 1)]


def _conv_inputs(case, seed=1):
    n, c, h, w, o, k, s, p, gr = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, h, w)).astype(np.float32)
    wt = (rng.normal(size=(o, c // gr, k, k)) * 0.2).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    return x, wt, b


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_amp_conv2d_forward_and_backward_match_jax(case):
    _, _, _, _, _, _, s, p, gr = case
    x, wt, b = _conv_inputs(case)
    with jamp.auto_cast():
        jy = jF.conv2d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), s, p, 1, gr)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(wt).requires_grad_()
    with tamp.auto_cast():
        ty = tF.conv2d(tx, tw, torch.from_numpy(b), s, p, 1, gr)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    # the oracle from parts: jax.vjp of the f32 conv on bf16-rounded
    # operands, fed the bf16-rounded cotangent, input gradients rounded to bf16
    g = np.random.default_rng(2).normal(size=jy.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, k: jF.conv2d(a, k, None, s, p, 1, gr),
                     jnp.asarray(_bf(x)), jnp.asarray(_bf(wt)))
    odx, odw = vjp(jnp.asarray(_bf(g)))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), _bf(odx))
    np.testing.assert_array_equal(tw.grad.numpy(), _bf(odw))


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_card_conv_rounding_rounds_the_cpu_amp_conv_output(case):
    """The card's oracle on the CPU (``amp.card_conv_rounding``): the amp
    conv's output rounded to bf16 once more, exactly the bf16 rounding of
    the JAX package's f32 output (the bias is added after, in f32), and
    the same input gradients as without it; an f32 conv is untouched."""
    _, _, _, _, _, _, s, p, gr = case
    x, wt, b = _conv_inputs(case)
    with jamp.auto_cast():
        jy = jF.conv2d(jnp.asarray(x), jnp.asarray(wt), None, s, p, 1, gr)
    g = np.random.default_rng(2).normal(size=jy.shape).astype(np.float32)
    out = {}
    for oracle in (False, True):
        tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(wt).requires_grad_()
        with tamp.auto_cast(), (tamp.card_conv_rounding() if oracle else contextlib.nullcontext()):
            ty = tF.conv2d(tx, tw, None, s, p, 1, gr)
            f32 = tF.conv2d(torch.from_numpy(x).double(), torch.from_numpy(wt).double(),
                            None, s, p, 1, gr)
        ty.backward(torch.from_numpy(g))
        out[oracle] = (ty.detach(), tx.grad, tw.grad, f32)
    assert not tamp.conv_output_rounded()
    y_round, dx, dw, f64 = out[True]
    assert y_round.dtype == torch.float32 and torch.equal(y_round, y_round.bfloat16().float())
    np.testing.assert_array_equal(y_round.numpy(), _bf(np.asarray(jy)))
    assert torch.equal(dx, out[False][1]) and torch.equal(dw, out[False][2])
    assert torch.equal(f64, out[False][3])  # an f64 (not amp) conv is not rounded


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_f32_conv2d_matches_jax(case):
    """f32 forward and gradients against ``jax.vjp`` of the JAX conv
    (atol 1e-4: f32 sums in another order)."""
    _, _, _, _, _, _, s, p, gr = case
    x, wt, b = _conv_inputs(case)
    jy, vjp = jax.vjp(lambda a, k, c: jF.conv2d(a, k, c, s, p, 1, gr),
                      jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b))
    g = np.random.default_rng(3).normal(size=jy.shape).astype(np.float32)
    jdx, jdw, jdb = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, wt, b))
    ty = tF.conv2d(tx, tw, tb, s, p, 1, gr)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    ty.backward(torch.from_numpy(g))
    for got, want in ((tx.grad, jdx), (tw.grad, jdw), (tb.grad, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_amp_conv2d_without_input_grad_and_bad_padding():
    x, wt, _ = _conv_inputs(CONV_CASES[0])
    tw = torch.from_numpy(wt).requires_grad_()
    with tamp.auto_cast():
        tF.conv2d(torch.from_numpy(x), tw, None, 1, 1).sum().backward()
    assert tw.grad is not None and tw.grad.dtype == torch.float32
    from paddle_tpu_torch.core.enforce import InvalidArgumentError
    with pytest.raises(InvalidArgumentError, match="SAME"):
        tF.conv2d(torch.from_numpy(x), tw, padding="FULL")
