"""The flash-attention kernels (B5–B7) against their plain versions, on a card.

Every test here is ``cuda``-marked and skips without a CUDA device; the
file imports neither jax nor ``paddle_tpu``, so it runs on a machine
without them (``pytest --noconftest -m cuda``). The plain versions run on
the same card (cuBLAS f32 with TF32 off).

Tolerances: "highest" 2e-5 absolute (the same f32 formulas, another
summation order and the kernel's 32-key online softmax); "default" 2e-2
absolute on out and the gradients, 1e-4 on lse: both round the operands
to bf16 and sum products exactly in f32, but the kernel rounds P to bf16
against its running maximum over 64-key steps (two 32-row ring tiles)
where the plain version rounds it against the row's maximum, and a
rounding flip of P or dS moves its term by 2^-8 of itself.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa

# (B, Lq, Lk, H, D, causal, q_offset, k_offset). From the fifth on, the
# edges of the kernels' ring (128 owned rows, 32-row stages, 2 stages):
# fewer key tiles than stages; a ragged last tile at ERNIE's width; a
# causal ring step whose skipped tiles fall mid-sequence (B7's key blocks
# start at different query tiles, B5 and B6 stop early); D = 128 (the
# 16-n-tile variant) over ragged rows; a single partial tile. The last
# four are B5's: a single partial key tile under two query blocks, the
# second ragged; a ragged last tile at D = 64 under the causal mask, so
# the diagonal and the keys' end cut the same tile; D = 128 over ragged
# rows and a ragged last key tile; a causal ring step whose leading rows
# see no key (block 0 walks no tile, and the first 72 rows of block 1 see
# nothing while its last 56 do: lse NEG and output 0, never NaN).
SHAPES = [(2, 200, 200, 3, 64, False, 0, 0), (1, 130, 70, 2, 16, True, 64, 0),
          (1, 96, 128, 2, 8, True, 0, 40), (1, 64, 64, 1, 128, False, 0, 0),
          (1, 64, 40, 2, 64, False, 0, 0), (1, 500, 500, 16, 64, False, 0, 0),
          (1, 256, 256, 2, 64, True, 0, 96), (2, 300, 260, 2, 128, True, 40, 0),
          (1, 20, 20, 2, 32, False, 0, 0), (1, 200, 17, 2, 64, False, 0, 0),
          (2, 333, 333, 3, 64, True, 0, 0), (1, 136, 100, 2, 128, False, 0, 0),
          (1, 256, 128, 2, 64, True, 0, 200)]


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
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
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


@pytest.mark.cuda
def test_bf16_backward_at_a_ragged_length():
    """bf16 inputs through the backward kernels' ring (16-byte copies of
    eight bf16, a ragged last tile) against the plain versions on the same
    bf16 inputs. Tolerance: the f32 bound of the "default" path (2e-2)
    plus one bf16 step of the output (relative 2^-7), since both sides
    round their f32 results to bf16."""
    rng = np.random.default_rng(2)
    B, L, H, D = 2, 300, 3, 64
    mk = lambda n: torch.from_numpy(  # noqa: E731
        rng.normal(size=(B, n, H, D)).astype(np.float32)).cuda().to(torch.bfloat16)
    q, k, v, do = mk(L), mk(L - 37), mk(L - 37), mk(L)
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)
    for got, want in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_kernels_are_deterministic(causal, kernel):
    """Each output row of B5, B6 and B7 is written by one block, with no
    atomics: two runs on the same inputs give the same bits."""
    rng = np.random.default_rng(3)
    B, L, H, D = 2, 512, 4, 64
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, L, H, D)).astype(np.float32)).cuda()
                   for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (do * out).sum(-1).contiguous()
    run = {"fwd": lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
           "bwd_dq": lambda: (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal),),
           "bwd_dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)}
    first, second = run[kernel](), run[kernel]()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
