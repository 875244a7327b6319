"""Context parallelism of the port (``parallel.ring_attention``) against
the JAX package on the CPU.

- ``ring_attention`` and ``ulysses_attention`` on ``{"dp": 2, "cp": 4}``
  against JAX's under ``shard_map`` on the same mesh, causal and not:
  out and the q/k/v gradients of <out, dO>, atol 2e-5 (f32 einsums
  summed in other orders; the JAX package's own ring tests use 2e-5 and
  rtol 2e-4).
- ``ring_flash_attention``: JAX's version cannot run in interpret mode
  under ``shard_map`` on the CPU, so each of its hops is held against
  JAX's ``flash_attention_with_lse(interpret=True, precision="highest")``
  at the hop's offsets — a hop of past keys, the diagonal hop and a
  fully masked future hop — out, lse and the gradients fed by dO and
  dlse (2e-6: the same f32 formulas), the masked hop exactly (out 0,
  lse NEG, zero gradients). The whole ring (the plain versions of B5–B7
  on the CPU) is held against JAX's ``ring_attention`` and serial
  ``local_attention``: "highest" to 2e-5 like the einsum ring; the
  default precision (bf16 operands, P rounded to bf16 against each hop's
  own maximum) to 2e-2 absolute on out and 2e-2 of the largest gradient
  (seen: 7e-3 on both).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from paddle_tpu.core import mesh as jmesh
from paddle_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.ops import collectives as coll
from paddle_tpu_torch.ops import flash_attention as fa

# the packages export functions of the modules' names: take the modules
jra = importlib.import_module("paddle_tpu.parallel.ring_attention")
tra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

B, L, H, D = 2, 32, 4, 8     # global seq 32 over cp=4 → 8 a rank
CP = 4
Ll = L // CP
MESH = {"dp": 2, "cp": CP}


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(4)]


def _jax_ring(fn, causal, q, k, v, do):
    jm = jmesh.make_mesh(MESH)
    spec = P(None, "cp")
    f = shard_map(lambda a, b, c: fn(a, b, c, axis="cp", causal=causal), mesh=jm,
                  in_specs=(spec, spec, spec), out_specs=spec)

    def loss(q, k, v):
        out = f(q, k, v)
        return jnp.sum(out * do), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_ring(fn, q, k, v, do, **kw):
    """fn on every rank's sequence shard; the dp=0 ranks' outputs
    concatenated, and the gradients of <out, dO> over them."""
    m = make_mesh(MESH, device="cpu")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))

    def rank(r):
        c = m.coords(r)
        sl = slice(c["cp"] * Ll, (c["cp"] + 1) * Ll)
        return fn(tq[:, sl], tk[:, sl], tv[:, sl], axis="cp", **kw)

    outs = coll.run_ranks(m, rank)
    out = torch.cat(outs[:CP], dim=1)            # ranks 0..3: dp=0, cp=0..3
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (tq, tk, tv))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring_attention", "ulysses_attention"])
def test_einsum_ring_and_ulysses_match_jax(name, causal):
    q, k, v, do = _qkv(1)
    jo, jg = _jax_ring(getattr(jra, name), causal, q, k, v, do)
    to, tg = _port_ring(getattr(tra, name), q, k, v, do, causal=causal)
    np.testing.assert_allclose(to, jo, rtol=0, atol=2e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


# (causal, q_offset, k_offset): past keys, the diagonal, the future
HOPS = [(False, Ll, 0), (True, Ll, 0), (True, Ll, Ll), (True, 0, Ll)]


@pytest.mark.parametrize("hop", HOPS, ids=lambda h: "causal%d-q%d-k%d" % h)
def test_ring_flash_hop_matches_jax_flash(hop):
    """One hop of the ring: the port's flash_attention_with_lse (plain B5,
    B6, B7 on the CPU) at the hop's offsets against JAX's flash kernels in
    interpret mode, out, lse and the q/k/v gradients fed by dO and dlse."""
    causal, qo, ko = hop
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=(B, Ll, H, D)).astype(np.float32) for _ in range(4))
    dl = rng.normal(size=(B, Ll, H)).astype(np.float32)

    def jf(q, k, v):
        return jax_flash(q, k, v, causal=causal, q_offset=qo, k_offset=ko, interpret=True,
                         precision="highest")

    (jo, jl), vjp = jax.vjp(jf, q, k, v)
    jg = vjp((jnp.asarray(do), jnp.asarray(dl)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = fa.flash_attention_with_lse(tq, tk, tv, causal, qo, ko, "highest")
    tg = torch.autograd.grad((o, lse), (tq, tk, tv), (torch.from_numpy(do), torch.from_numpy(dl)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0, atol=2e-6)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl), rtol=0, atol=2e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)
    if causal and qo + Ll - 1 < ko:
        # every key in every query's future: nothing, exactly
        assert torch.equal(o, torch.zeros_like(o))
        assert torch.equal(lse, torch.full_like(lse, fa.NEG))
        assert all(torch.equal(g, torch.zeros_like(g)) for g in tg)
        assert np.array_equal(np.asarray(jo), np.zeros_like(jo))
        assert np.array_equal(np.asarray(jl), np.full_like(jl, fa.NEG))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_jax_ring_and_serial(causal):
    q, k, v, do = _qkv(2)
    jo, jg = _jax_ring(jra.ring_attention, causal, q, k, v, do)
    serial = np.asarray(jra.local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=causal))
    to, tg = _port_ring(tra.ring_flash_attention, q, k, v, do, causal=causal,
                        precision="highest")
    np.testing.assert_allclose(to, jo, rtol=0, atol=2e-5)
    np.testing.assert_allclose(to, serial, rtol=0, atol=2e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    # the default precision: the ERNIE path's
    to, tg = _port_ring(tra.ring_flash_attention, q, k, v, do, causal=causal)
    assert np.isfinite(to).all()
    np.testing.assert_allclose(to, jo, rtol=0, atol=2e-2)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * np.abs(b).max())


def test_ring_flash_counts_hops_of_the_kernel_wrappers():
    """Each hop calls the B5 wrapper once (the plain version on the CPU:
    no launch is counted), so the ring's calls are cp per rank."""
    calls = []
    real = fa.flash_attention_fwd

    def spy(*a, **kw):
        calls.append((kw.get("q_offset", a[4] if len(a) > 4 else 0),
                      kw.get("k_offset", a[5] if len(a) > 5 else 0)))
        return real(*a, **kw)

    q, k, v, do = _qkv(3)
    fa.flash_attention_fwd = spy
    try:
        _port_ring(tra.ring_flash_attention, q, k, v, do, causal=True)
    finally:
        fa.flash_attention_fwd = real
    assert len(calls) == 2 * CP * CP            # dp 2 × cp 4 ranks × 4 hops
    assert sorted(set(calls)) == sorted({(qo * Ll, ko * Ll)
                                         for qo in range(CP) for ko in range(CP)})
    assert real.launches == 0
