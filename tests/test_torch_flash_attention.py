"""The port's flash attention (plain versions, CPU) against the JAX package.

The JAX kernels run as their own tests run them on the CPU
(``interpret=True``). Inputs come from numpy seeds and go to both.

Tolerances:
- "highest" (f32 operands): 2e-6 absolute — the same f32 formulas, summed
  in another order by the two frameworks' matmuls.
- "default" (bf16 operands, P and dS rounded to bf16): 2e-6 absolute on
  out and lse, 5e-4 on the gradients. A product of two bf16 values is
  exact in f32, so the two agree to the f32 summation order — except
  where a value of P or dS sits next to a bf16 rounding boundary and the
  other framework's summation order puts it on the other side: that
  term then moves by 2^-8 of itself (seen: 1.7e-4 on one dV element).
- Lengths where the JAX package pads no keys (a multiple of 8 within its
  one block, or causal): its non-causal attention at other lengths lets
  the zero-padded keys into the softmax (it masks by the padded length),
  so unaligned non-causal lengths are held against ``local_attention``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash
from paddle_tpu.parallel.ring_attention import local_attention as jax_local
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel.ring_attention import local_attention

NEG = fa.NEG

# (B, Lq, Lk, H, D, causal, q_offset, k_offset, precision)
CASES = [
    (2, 32, 32, 2, 16, False, 0, 0, "highest"),
    (2, 32, 32, 2, 16, False, 0, 0, "default"),
    (2, 32, 32, 2, 16, True, 0, 0, "default"),
    (1, 24, 16, 2, 8, True, 16, 0, "default"),    # ring step: queries after the keys
    (1, 24, 16, 2, 8, True, 0, 12, "highest"),    # leading rows see no key (lse NEG)
    (1, 13, 13, 2, 8, True, 0, 0, "default"),     # unaligned, causal
]


def _inputs(seed, B, Lq, Lk, H, D):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(B, Lq, H, D)).astype(f), rng.normal(size=(B, Lk, H, D)).astype(f),
            rng.normal(size=(B, Lk, H, D)).astype(f), rng.normal(size=(B, Lq, H, D)).astype(f),
            rng.normal(size=(B, Lq, H)).astype(f))


def _tol(precision):
    return (2e-6, 2e-6) if precision == "highest" else (2e-6, 5e-4)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_forward_and_backward_match_jax(case):
    """out, lse, and dq/dk/dv of <out, dO> + <lse, dlse> (the lse
    cotangent included) through the port's autograd Function on the CPU —
    the plain versions of B5, B6 and B7 — against jax.grad of the JAX
    custom VJP over the Pallas kernels."""
    B, Lq, Lk, H, D, causal, qo, ko, prec = case
    q, k, v, do, dl = _inputs(0, B, Lq, Lk, H, D)
    fwd_tol, grad_tol = _tol(prec)

    def jloss(q, k, v):
        o, lse = jax_flash(q, k, v, causal=causal, q_offset=qo, k_offset=ko,
                           interpret=True, precision=prec)
        live = jnp.where(lse > NEG / 2, lse, 0.0)
        return jnp.sum(o * do) + jnp.sum(live * dl), (o, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, causal, qo, ko, prec)
    live = torch.where(lse > NEG / 2, lse, torch.zeros(()))
    loss = (o * torch.from_numpy(do)).sum() + (live * torch.from_numpy(dl)).sum()
    tg = torch.autograd.grad(loss, (tq, tk, tv))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0, atol=fwd_tol)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl), rtol=0, atol=fwd_tol)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=grad_tol,
                                   err_msg=f"d{name}")
    if ko > qo:  # rows before the first key: no key, lse NEG, output 0
        dead = (np.arange(Lq) + qo) < ko
        assert (lse.detach().numpy()[:, dead] == NEG).all()
        assert (o.detach().numpy()[:, dead] == 0).all()


@pytest.mark.parametrize("L", [12, 50])
def test_unaligned_non_causal_matches_local_attention(L):
    """The port masks keys by their true length (the JAX kernel would not
    here: see the module docstring). "highest" against the JAX package's
    ``local_attention`` at 2e-6; "default" rounds the operands and P to
    bf16, so it sits within 2e-2 of exact attention."""
    q, k, v, _, _ = _inputs(1, 1, L, L, 3, 8)
    ref = np.asarray(jax_local(q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    hi, _ = fa.flash_attention_fwd(tq, tk, tv, precision="highest")
    lo, _ = fa.flash_attention_fwd(tq, tk, tv, precision="default")
    np.testing.assert_allclose(hi.numpy(), ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(lo.numpy(), ref, rtol=0, atol=2e-2)
    np.testing.assert_allclose(local_attention(tq, tk, tv).numpy(), ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_local_attention_matches_jax(causal):
    """The port's ``local_attention`` (the einsum path and the kernels'
    oracle) against the JAX one, offsets included: 2e-6 (f32 order)."""
    q, k, v, _, _ = _inputs(2, 2, 16, 24, 2, 8)
    kw = dict(causal=causal, q_offset=8, k_offset=0)
    ref = np.asarray(jax_local(q, k, v, **kw))
    got = local_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


def test_cpu_wrappers_run_plain_and_count_nothing():
    """On CPU tensors the wrappers are their plain versions: same values,
    and no kernel launch is counted."""
    q, k, v, do, _ = (torch.from_numpy(a) for a in _inputs(3, 1, 16, 16, 2, 8))
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    delta = (do * out).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    assert torch.equal(dq, fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=True))
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    wk, wv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True)
    assert torch.equal(dk, wk) and torch.equal(dv, wv)
    assert before == (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
                      fa.flash_attention_bwd_dkv.launches)


def test_bad_arguments_raise():
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(InvalidArgumentError, match="precision"):
        fa.flash_attention(q, q, q, precision="tf32")
    with pytest.raises(InvalidArgumentError, match="k, v"):
        fa.flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    with pytest.raises(InvalidArgumentError, match="no kernel for device meta"):
        fa.flash_attention_fwd(q.to("meta"), q.to("meta"), q.to("meta"))
