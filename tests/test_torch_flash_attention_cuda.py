"""The flash-attention kernels (B5–B7) against their plain versions, on a card.

Every test here is ``cuda``-marked and skips without a CUDA device; the
file imports neither jax nor ``paddle_tpu``, so it runs on a machine
without them (``pytest --noconftest -m cuda``). The plain versions run on
the same card (cuBLAS f32 with TF32 off).

Tolerances: "highest" 2e-5 absolute (the same f32 formulas, another
summation order and the kernel's 32-key online softmax); "default" 2e-2
absolute on out and the gradients, 1e-4 on lse: both round the operands
to bf16 and sum products exactly in f32, but the kernel rounds P to bf16
against its running maximum over 64-key tiles where the plain version
rounds it against the row's maximum, and a rounding flip of P or dS
moves its term by 2^-8 of itself.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa

# (B, Lq, Lk, H, D, causal, q_offset, k_offset)
SHAPES = [(2, 200, 200, 3, 64, False, 0, 0), (1, 130, 70, 2, 16, True, 64, 0),
          (1, 96, 128, 2, 8, True, 0, 40), (1, 64, 64, 1, 128, False, 0, 0)]


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_kernels_match_plain_and_count(shape, precision):
    B, Lq, Lk, H, D, causal, qo, ko = shape
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()  # noqa: E731
    q, k, v, do = mk(B, Lq, H, D), mk(B, Lk, H, D), mk(B, Lk, H, D), mk(B, Lq, H, D)
    kw = dict(causal=causal, q_offset=qo, k_offset=ko, precision=precision)
    tol = 2e-5 if precision == "highest" else 2e-2
    counts = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do * out).sum(-1).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    w_out, w_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(out, w_out, rtol=0, atol=tol)
    torch.testing.assert_close(lse, w_lse, rtol=0, atol=2e-5 if precision == "highest" else 1e-4)
    # the backward kernels against the plain backward on the same lse/delta
    torch.testing.assert_close(dq, fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
                               rtol=0, atol=tol)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.testing.assert_close(dk, w_dk, rtol=0, atol=tol)
    torch.testing.assert_close(dv, w_dv, rtol=0, atol=tol)


@pytest.mark.cuda
def test_unsupported_inputs_raise_before_launch():
    """The kernels read four elements of a row at a time and take head dims
    in steps of 8 up to 128: anything else raises, and nothing launches."""
    from paddle_tpu_torch.core.enforce import InvalidArgumentError

    before = fa.flash_attention_fwd.launches
    flat = torch.zeros(1 * 8 * 2 * 8 + 1, device="cuda")
    shifted = flat[1:].view(1, 8, 2, 8)                   # contiguous, 4 bytes off
    with pytest.raises(InvalidArgumentError, match="16-byte"):
        fa.flash_attention_fwd(shifted, shifted, shifted)
    odd = torch.zeros(1, 8, 2, 12, device="cuda")
    with pytest.raises(InvalidArgumentError, match="multiple of 8"):
        fa.flash_attention_fwd(odd, odd, odd)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        q = torch.zeros(1, 2, 8, 8, device="cuda").transpose(1, 2)
        fa.flash_attention_fwd(q, q, q)
    assert fa.flash_attention_fwd.launches == before


@pytest.mark.cuda
def test_bf16_inputs_and_autograd():
    """bf16 inputs go through the same kernels; the autograd Function on
    the card launches B5 once and B6, B7 once each."""
    rng = np.random.default_rng(1)
    mk = lambda: torch.from_numpy(rng.normal(size=(2, 96, 2, 32)).astype(np.float32)).cuda()  # noqa: E731
    q, k, v = mk(), mk(), mk()
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out, lse = fa.flash_attention_fwd(qb, kb, vb, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    w_out, w_lse = fa.flash_attention_fwd_plain(qb, kb, vb, causal=True)
    torch.testing.assert_close(out.float(), w_out.float(), rtol=0, atol=3e-2)
    torch.testing.assert_close(lse, w_lse, rtol=0, atol=1e-4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    o, l = fa.flash_attention_with_lse(*leaves, causal=True)
    grads = torch.autograd.grad((o * o).sum() + l.sum(), leaves)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(b + 1 for b in before)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
