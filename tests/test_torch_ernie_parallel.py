"""The port's ERNIE over the parallel layouts against the JAX package on
the CPU.

- ``partition_spec``: equal to JAX's entry for entry, for every
  parameter and buffer of a dense and an MoE config, with and without
  ``leading_pp``.
- The sharded loss on the meshes of JAX's ``tests/test_ernie.py`` (tp
  ``{"dp": 2, "mp": 4}``, cp ``{"dp": 2, "cp": 4}``, causal cp
  ``{"cp": 8}``, ep: 4 experts riding dp on ``{"dp": 2, "mp": 4}``):
  JAX's model under ``shard_map`` and the port's in ``run_ranks`` from
  the same weights (``convert.ernie_params_from_jax``), each rank's
  parameters cut by ``partition_spec``; rtol 1e-5 (f32, the psums and
  the ring's merges summed in other orders). For the dense meshes the
  port's one backward through the ranks is held against ``jax.grad`` of
  the JAX serial loss, rtol 1e-4 / atol 1e-6 per tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.models import ernie as jernie
from paddle_tpu_torch.convert import ernie_params_from_jax
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.models import ernie
from paddle_tpu_torch.ops import collectives as coll

SMALL = dict(vocab_size=32, hidden_size=16, num_heads=4, ffn_size=32, num_layers=2,
             max_seq_len=64)


@pytest.mark.parametrize("experts", [0, 4])
@pytest.mark.parametrize("leading_pp", [False, True])
def test_partition_spec_matches_jax(experts, leading_pp):
    jcfg = jernie.ErnieConfig(**SMALL, num_experts=experts, ep_axis="dp")
    tcfg = ernie.ErnieConfig(**SMALL, num_experts=experts, ep_axis="dp")
    pt.seed(0)
    state = jnn.get_state(jernie.Ernie(jcfg))
    n = 0
    for group in ("params", "buffers"):
        for name, a in state[group].items():
            arr = np.zeros((2,) + a.shape) if leading_pp else np.asarray(a)
            want = tuple(jernie.partition_spec(name, arr, jcfg, leading_pp=leading_pp))
            got = ernie.partition_spec(name, arr, tcfg, leading_pp=leading_pp)
            assert got == want, (name, got, want)
            n += 1
    assert n == len(ernie.Ernie(tcfg).state_dict())


def _jax_state_and_port_weights(cfg_kw, seed):
    pt.seed(seed)
    jcfg = jernie.ErnieConfig(**cfg_kw)
    jm = jernie.Ernie(jcfg)
    state = jnn.get_state(jm)
    w = {k: np.asarray(v) for k, v in {**state["params"], **state["buffers"]}.items()}
    return jm, jcfg, state, w


def _data(vocab, batch, seq=8):
    rng = np.random.default_rng(0)
    return (rng.integers(0, vocab, size=(batch, seq)).astype(np.int32),
            rng.integers(0, vocab, size=(batch, seq)).astype(np.int32))


def _jax_sharded_loss(jm, cfg, mesh, state, ids, labels):
    """JAX's tests/test_ernie.py harness, jitted."""
    def spec(path, a):
        p = jernie.partition_spec(path[-1].key, a, cfg)
        return P(*[ax if ax in mesh.shape else None for ax in p])

    specs = jax.tree_util.tree_map_with_path(spec, state)
    batch_axes = tuple(a for a in ("dp", "cp") if a in mesh.shape)
    denom = int(np.prod([mesh.shape[a] for a in batch_axes]))

    def f(st, ids, labels):
        out, _ = jnn.functional_call(jm, st, ids, training=False)
        ce = jernie.parallel_cross_entropy(out, labels, cfg.vocab_size, cfg.mp_axis)
        return jax.lax.psum(jnp.mean(ce) / denom, batch_axes)

    ids_spec = P("dp" if "dp" in mesh.shape else None, "cp" if "cp" in mesh.shape else None)
    return float(jax.jit(shard_map(f, mesh=mesh, in_specs=(specs, ids_spec, ids_spec),
                                   out_specs=P()))(state, jnp.asarray(ids), jnp.asarray(labels)))


def _port_sharded_loss(cfg, shape, weights, ids, labels):
    """The port's ERNIE on every rank of ``shape``: each rank's module
    reads views of the global weights cut by ``partition_spec``; the
    loss psummed over dp and cp. → (loss, {name: global grad})."""
    m = make_mesh(shape, device="cpu")
    glob = {k: torch.from_numpy(v.copy()).requires_grad_(k.rsplit(".", 1)[-1] != "aux_loss")
            for k, v in weights.items()}
    mods = [ernie.Ernie(cfg) for _ in range(m.size)]
    batch_axes = tuple(a for a in ("dp", "cp") if a in shape)
    denom = int(np.prod([shape[a] for a in batch_axes]))
    tids, tlab = torch.from_numpy(ids), torch.from_numpy(labels)

    def cut(t, spec, c):
        for d, ax in enumerate(spec):
            if ax in shape:
                per = t.shape[d] // shape[ax]
                t = t.narrow(d, c[ax] * per, per)
        return t

    def rank(r):
        c = m.coords(r)
        local = {k: cut(t, ernie.partition_spec(k, t, cfg), c) for k, t in glob.items()}
        bsl = cut(tids, ("dp", "cp"), c), cut(tlab, ("dp", "cp"), c)
        out = torch.func.functional_call(mods[r], local, (bsl[0],))
        ce = ernie.parallel_cross_entropy(out, bsl[1], cfg.vocab_size, cfg.mp_axis)
        return coll.psum(ce.mean() / denom, batch_axes)

    loss = coll.run_ranks(m, rank)[0]
    keys = [k for k, t in glob.items() if t.requires_grad]
    grads = torch.autograd.grad(loss, [glob[k] for k in keys], allow_unused=True)
    return float(loss.detach()), {k: g for k, g in zip(keys, grads) if g is not None}


CASES = {
    "tp": (dict(), {"dp": 2, "mp": 4}, 4),
    "cp": (dict(), {"dp": 2, "cp": 4}, 4),
    "causal_cp": (dict(causal=True), {"cp": 8}, 4),
    "ep": (dict(num_experts=4, ep_axis="dp"), {"dp": 2, "mp": 4}, 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_matches_jax(case):
    over, shape, batch = CASES[case]
    cfg_kw = {**SMALL, **over}
    jm, jcfg, state, w = _jax_state_and_port_weights(cfg_kw, seed=sorted(CASES).index(case))
    ids, labels = _data(jcfg.vocab_size, batch)
    jmsh = jmesh.make_mesh(shape, devices=jax.devices()[:int(np.prod(list(shape.values())))])
    want = _jax_sharded_loss(jm, jcfg, jmsh, state, ids, labels)
    got, grads = _port_sharded_loss(ernie.ErnieConfig(**cfg_kw), shape, w, ids, labels)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if not over.get("num_experts"):
        def serial(p):
            out, _ = jnn.functional_call(jm, {"params": p, "buffers": state["buffers"]},
                                         jnp.asarray(ids), training=False)
            return jnp.mean(jnn.functional.cross_entropy(out, jnp.asarray(labels),
                                                         reduction="none"))

        jg = jax.jit(jax.grad(serial))(state["params"])
        assert set(grads) == set(jg)
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_serial_model_is_the_parallel_model_outside_a_run():
    """The serial Ernie (MoE included) runs the same layers with every axis
    inactive: the loss equals the JAX serial model's."""
    jm, jcfg, state, w = _jax_state_and_port_weights({**SMALL, "num_experts": 4}, seed=9)
    ids, labels = _data(jcfg.vocab_size, 4)
    want = float(jax.jit(jm.loss)(jnp.asarray(ids), jnp.asarray(labels)))
    tm = ernie.Ernie(ernie.ErnieConfig(**SMALL, num_experts=4))
    tm.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in w.items()})
    got = float(tm.loss(torch.from_numpy(ids), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert set(ernie_params_from_jax(state)) == {k for k, _ in tm.named_parameters()}
