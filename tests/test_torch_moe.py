"""The port's MoE (``parallel.moe``) against the JAX package on the CPU.

- The gates on numpy-seeded logits, with ties (integer logits) and with
  capacities that drop tokens: dispatch bitwise equal (both gates take
  the first maximum and place tokens by an exact f32 cumsum), combine
  and the aux loss within 1e-6.
- ``MoELayer`` on ``{"dp": 2, "ep": 4}`` against JAX's on the same mesh
  — the same per-rank dispatch: each of the 8 ranks gates its own
  tokens, the experts split over ep — out and the gradients of <out, dO>
  in gate, expert weights and tokens, rtol 1e-4 / atol 1e-5 (the JAX
  package's own ep test uses these); and serially (ep 1) the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from paddle_tpu.core import mesh as jmesh
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.ops import collectives as coll
from paddle_tpu_torch.parallel import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-5)


def _logits(kind, seed, T=24, E=4):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(-1, 2, size=(T, E)).astype(np.float32)
    return rng.normal(size=(T, E)).astype(np.float32)


@pytest.mark.parametrize("gate", ["top1_gate", "top2_gate"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("capacity", [3, 8, 24])
def test_gates_match_jax(gate, kind, capacity):
    lg = _logits(kind, capacity)
    jd, jc, ja = getattr(jmoe, gate)(jnp.asarray(lg), capacity)
    td, tc, ta = getattr(tmoe, gate)(torch.from_numpy(lg), capacity)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)


E, DM, DH, EP, T = 4, 8, 16, 4, 12


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(DM, E)).astype(np.float32),
            (rng.normal(size=(E, DM, DH)) / np.sqrt(DM)).astype(np.float32),
            (rng.normal(size=(E, DH, DM)) / np.sqrt(DH)).astype(np.float32),
            rng.normal(size=(8 * T, DM)).astype(np.float32),
            rng.normal(size=(8 * T, DM)).astype(np.float32))


@pytest.mark.parametrize("gate", ["gshard", "switch"])
def test_expert_parallel_layer_matches_jax_on_the_same_mesh(gate):
    gw, wi, wo, x, do = _weights(1)
    jm = jmesh.make_mesh({"dp": 2, "ep": EP})
    jl = jmoe.MoELayer(DM, DH, E, ep_size=EP, gate=gate, capacity_factor=1.0)

    def f(gw, wi, wo, x):
        jl._parameters["gate_w"] = gw
        jl.experts._parameters["w_in"] = wi
        jl.experts._parameters["w_out"] = wo
        return jl(x)

    tok = P(("dp", "ep"), None)
    sm = shard_map(f, mesh=jm, in_specs=(P(), P("ep"), P("ep"), tok), out_specs=tok)

    def jloss(*a):
        out = sm(*a)
        return jnp.sum(out * do), out

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (gw, wi, wo, x)))

    m = make_mesh({"dp": 2, "ep": EP}, device="cpu")
    tgw, twi, two, tx = (torch.from_numpy(a).requires_grad_(True) for a in (gw, wi, wo, x))
    layers = [tmoe.MoELayer(DM, DH, E, ep_size=EP, gate=gate, capacity_factor=1.0)
              for _ in range(m.size)]

    def rank(r):
        c, lay = m.coords(r), layers[r]
        lay._parameters["gate_w"] = tgw
        per = E // EP
        lay.experts._parameters["w_in"] = twi[c["ep"] * per:(c["ep"] + 1) * per]
        lay.experts._parameters["w_out"] = two[c["ep"] * per:(c["ep"] + 1) * per]
        return lay(tx[r * T:(r + 1) * T])

    out = torch.cat(coll.run_ranks(m, rank))
    tg = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (tgw, twi, two, tx))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # capacity 1.0 drops tokens on some rank: the comparison covers drops
    fn, k = (tmoe.top2_gate, 2) if gate == "gshard" else (tmoe.top1_gate, 1)
    cap = layers[0]._capacity(T)
    kept = [float(fn(torch.from_numpy(x[r * T:(r + 1) * T] @ gw), cap)[0].sum())
            for r in range(m.size)]
    assert min(kept) < k * T, kept


def test_serial_layer_matches_jax():
    gw, wi, wo, x, do = _weights(2)
    jl = jmoe.MoELayer(DM, DH, E, ep_size=1, gate="gshard", capacity_factor=1.25)

    def jf(gw, wi, wo, x):
        jl._parameters["gate_w"] = gw
        jl.experts._parameters["w_in"] = wi
        jl.experts._parameters["w_out"] = wo
        return jnp.sum(jl(x) * do), jl.aux_loss

    (_, jaux), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (gw, wi, wo, x)))
    tl = tmoe.MoELayer(DM, DH, E, ep_size=1, gate="gshard", capacity_factor=1.25)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (gw, wi, wo, x)]
    tl._parameters["gate_w"] = ts[0]
    tl.experts._parameters["w_in"], tl.experts._parameters["w_out"] = ts[1], ts[2]
    tg = torch.autograd.grad((tl(ts[3]) * torch.from_numpy(do)).sum(), ts)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(float(tl.aux_loss.detach()), float(jaux), rtol=0, atol=1e-6)
