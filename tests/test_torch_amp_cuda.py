"""The amp ``linear`` and the convolutions on a card, against the same
calls on the CPU.

Every test here is ``cuda``-marked and skips without a CUDA device; the
file imports neither jax nor ``paddle_tpu`` (run it on the card with
``pytest --noconftest -m cuda tests/test_torch_amp_cuda.py``).

Tolerances: amp products atol 1e-4 relative to the output's scale
(cuBLAS and cuDNN sum the exact bf16 products in f32 in another order);
the gradients, rounded to bf16 on both devices, may land one bf16 step
apart where the two f32 sums straddle a rounding boundary (2^-7 of the
value); the f32 conv with TF32 pinned off rtol 1e-5 / atol 1e-4, which
TF32's 10-bit mantissa (errors near 1e-3) would not meet.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import functional as F


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuBLAS/cuDNN paths have no CPU mode")


def _is_bf16(t):
    return torch.equal(t, t.to(torch.bfloat16).to(t.dtype))


def _run_linear(dev, x, w, g):
    tx = torch.from_numpy(x).to(dev).requires_grad_()
    tw = torch.from_numpy(w).to(dev).requires_grad_()
    with amp.auto_cast():
        y = F.linear(tx, tw)
    y.backward(torch.from_numpy(g).to(dev))
    return y.detach().cpu(), tx.grad.cpu(), tw.grad.cpu()


@pytest.mark.cuda
def test_amp_linear_on_card_is_f32_result_of_bf16_products():
    a = torch.randn(8, 16, device="cuda").bfloat16()
    b = torch.randn(16, 4, device="cuda").bfloat16()
    assert torch.mm(a, b, out_dtype=torch.float32).dtype == torch.float32  # out_dtype exists
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 1024)).astype(np.float32)
    w = (rng.normal(size=(768, 1024)) * 0.05).astype(np.float32)
    g = rng.normal(size=(512, 768)).astype(np.float32)
    gy, gdx, gdw = _run_linear("cuda", x, w, g)
    cy, cdx, cdw = _run_linear("cpu", x, w, g)
    assert gy.dtype == torch.float32 and not _is_bf16(gy)  # not rounded to bf16 once more
    torch.testing.assert_close(gy, cy, rtol=0, atol=1e-4 * float(cy.abs().max()))
    for got, want in ((gdx, cdx), (gdw, cdw)):
        assert got.dtype == torch.float32 and _is_bf16(got) and _is_bf16(want)
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-6 * float(want.abs().max()))


def _caller_tf32(api):
    """TF32 on for cuDNN convs as a caller may leave it: the legacy flag,
    or the per-operator API with conv and RNN set apart (after which
    reading the legacy flag raises)."""
    if api == "legacy":
        torch.backends.cudnn.allow_tf32 = True
    else:
        torch.backends.cudnn.conv.fp32_precision = "tf32"
        torch.backends.cudnn.rnn.fp32_precision = "ieee"


@pytest.mark.cuda
@pytest.mark.parametrize("api", ["legacy", "per_op"])
@pytest.mark.parametrize("mode", ["f32", "amp"])
def test_conv2d_on_card_matches_cpu(mode, api):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 64, 28, 28)).astype(np.float32)
    w = (rng.normal(size=(128, 64, 3, 3)) * 0.05).astype(np.float32)
    g = rng.normal(size=(8, 128, 14, 14)).astype(np.float32)
    prev = (torch.backends.cudnn.conv.fp32_precision, torch.backends.cudnn.rnn.fp32_precision)
    _caller_tf32(api)
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            tx = torch.from_numpy(x).to(dev).requires_grad_()
            tw = torch.from_numpy(w).to(dev).requires_grad_()
            with amp.step_ctx(mode == "amp"):
                y = F.conv2d(tx, tw, None, 2, 1)
            y.backward(torch.from_numpy(g).to(dev))
            out[dev] = (y.detach().cpu(), tx.grad.cpu(), tw.grad.cpu())
        assert torch.backends.cudnn.conv.fp32_precision == "tf32"  # the pin is scoped
    finally:
        torch.backends.cudnn.conv.fp32_precision, torch.backends.cudnn.rnn.fp32_precision = prev
    (gy, gdx, gdw), (cy, cdx, cdw) = out["cuda"], out["cpu"]
    if mode == "f32":
        for got, want in ((gy, cy), (gdx, cdx), (gdw, cdw)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        return
    # cuDNN's bf16 conv rounds its output once more (ROADMAP Queue C)
    assert _is_bf16(gy)
    torch.testing.assert_close(gy, cy, rtol=2 ** -8, atol=1e-4 * float(cy.abs().max()))
    for got, want in ((gdx, cdx), (gdw, cdw)):
        assert _is_bf16(got) and _is_bf16(want)
        torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 28, 28, 128, 3, 2, 1), (8, 3, 64, 64, 64, 7, 2, 3),
                                   (8, 256, 16, 16, 64, 1, 1, 0)],
                         ids=["3x3", "7x7-stem", "1x1"])
def test_amp_conv_on_card_matches_the_cpu_rounding_oracle(shape):
    """The card's amp conv against the CPU inside ``amp.card_conv_rounding``
    (its output rounded to bf16 as cuDNN rounds it): both bf16-valued and
    at most one bf16 step apart (2^-7 of the value: the f32 sums differ in
    order, so a value near a rounding boundary can round either way), and
    equal in at least 99 % of the elements. Without the oracle the CPU
    output is f32 (the gap phase 11 of chip_smoke.py cannot see past)."""
    n, c, h, w, o, k, s, p = shape
    rng = np.random.default_rng(6)
    x = rng.normal(size=(n, c, h, w)).astype(np.float32)
    wt = (rng.normal(size=(o, c, k, k)) * (2.0 / (c * k * k)) ** 0.5).astype(np.float32)
    with amp.auto_cast():
        gy = F.conv2d(torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda(), None, s, p).cpu()
        cy = F.conv2d(torch.from_numpy(x), torch.from_numpy(wt), None, s, p)
        with amp.card_conv_rounding():
            oy = F.conv2d(torch.from_numpy(x), torch.from_numpy(wt), None, s, p)
    assert _is_bf16(gy) and _is_bf16(oy) and not _is_bf16(cy)
    torch.testing.assert_close(gy, oy, rtol=2 ** -7, atol=1e-6 * float(oy.abs().max()))
    assert float((gy == oy).float().mean()) >= 0.99


@pytest.mark.cuda
def test_grad_scaler_on_card_by_default_matches_cpu():
    """``init()`` with no device puts the state on the card; scale,
    unscale, all_finite and the grow/shrink sequence stay there and give
    the CPU's numbers bit for bit."""
    sc = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2, decr_every_n_nan_or_inf=1)
    card, host = sc.init(), sc.init("cpu")
    assert card.loss_scale.is_cuda and card.good_steps.is_cuda and card.bad_steps.is_cuda
    rng = np.random.default_rng(5)
    for ok in (True, True, False, True, True, True):
        g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
        if not ok:
            g["b"][1] = np.inf
        loss = torch.tensor(1.5)
        sl_c, sl_h = sc.scale(loss.cuda(), card), sc.scale(loss, host)
        assert sl_c.is_cuda and float(sl_c) == float(sl_h)
        gc, ok_c = sc.unscale({k: torch.from_numpy(v).cuda() for k, v in g.items()}, card)
        gh, ok_h = sc.unscale({k: torch.from_numpy(v) for k, v in g.items()}, host)
        assert ok_c.is_cuda and bool(ok_c) == bool(ok_h) == ok
        for k in g:
            assert torch.equal(gc[k].cpu(), gh[k])
        card, host = sc.update(ok_c, card), sc.update(ok_h, host)
        assert all(t.is_cuda for t in card)
        assert [float(t) for t in card] == [float(t) for t in host]
