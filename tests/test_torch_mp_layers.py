"""The port's tensor-parallel layers (``parallel.mp_layers``) and ERNIE's
mp cross entropy against the JAX package on the CPU, on ``{"mp": 4}``.

Values: the JAX layers under ``shard_map`` on the 4-device mesh against
the port's in ``run_ranks`` over 4 logical ranks, each rank's layer
holding its shard of the same numpy weights (rtol 1e-5, atol 1e-6: f32
products and a 4-term psum summed in other orders). Gradients: each
rank's shard is a view of one global tensor, so one backward gives the
global gradient, held against ``jax.grad`` of the serial computation on
the same inputs (rtol 1e-4, atol 1e-6). The serial function is the
target because JAX's own ``shard_map`` gradient of
``ParallelCrossEntropy`` fails its test at the installed jax
(``tests/test_mp_layers.py::test_parallel_cross_entropy_grad_matches_serial``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from paddle_tpu import nn as jnn
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.models import ernie as jernie
from paddle_tpu.parallel import mp_layers as jmp
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.models import ernie
from paddle_tpu_torch.ops import collectives as coll
from paddle_tpu_torch.parallel import mp_layers as tmp

MP = 4
VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh({"mp": MP}, devices=jax.devices()[:MP])


def _mesh():
    return make_mesh({"mp": MP}, device="cpu")


def _t(a, grad=False):
    t = torch.from_numpy(np.asarray(a))
    return t.requires_grad_(True) if grad else t


def _shard(t, dim, r, n=MP):
    per = t.shape[dim] // n
    return t.narrow(dim, r * per, per)


@pytest.mark.parametrize("vocab", [16, 13])
def test_vocab_parallel_embedding(jax_mesh, vocab):
    rng = np.random.default_rng(0)
    dim = 8
    padded = -(-vocab // MP) * MP
    w = rng.normal(size=(padded, dim)).astype(np.float32)
    ids = rng.integers(0, vocab, size=(3, 5)).astype(np.int32)
    do = rng.normal(size=(3, 5, dim)).astype(np.float32)
    jl = jmp.VocabParallelEmbedding(vocab, dim, mp_size=MP)

    def f(ws, ids):
        jl._parameters["weight"] = ws
        return jl(ids)

    want = jax.jit(shard_map(f, mesh=jax_mesh, in_specs=(P("mp", None), P()),
                             out_specs=P()))(jnp.asarray(w), jnp.asarray(ids))
    jg = jax.grad(lambda w: jnp.sum(jnp.take(w, ids, axis=0) * do))(jnp.asarray(w))

    tw = _t(w, grad=True)
    layers = [tmp.VocabParallelEmbedding(vocab, dim, mp_size=MP, mp_rank=r) for r in range(MP)]

    def rank(r):
        layers[r]._parameters["weight"] = _shard(tw, 0, r)
        return layers[r](_t(ids))

    outs = coll.run_ranks(_mesh(), rank)
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(want), **VAL)
    assert all(o is outs[0] for o in outs)               # one replicated result
    (g,) = torch.autograd.grad((outs[0] * _t(do)).sum(), (tw,))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD)


def test_column_then_row_parallel(jax_mesh):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    w1, b1 = rng.normal(size=(8, 16)).astype(np.float32), rng.normal(size=16).astype(np.float32)
    w2, b2 = rng.normal(size=(16, 8)).astype(np.float32), rng.normal(size=8).astype(np.float32)
    do = rng.normal(size=(4, 8)).astype(np.float32)
    col = jmp.ColumnParallelLinear(8, 16, mp_size=MP, gather_output=False)
    row = jmp.RowParallelLinear(16, 8, mp_size=MP, input_is_parallel=True)

    def f(w1s, b1s, w2s, b2, x):
        col._parameters["weight"], col._parameters["bias"] = w1s, b1s
        row._parameters["weight"], row._parameters["bias"] = w2s, b2
        return row(jax.nn.gelu(col(x)))

    want = jax.jit(shard_map(f, mesh=jax_mesh,
                             in_specs=(P(None, "mp"), P("mp"), P("mp", None), P(), P()),
                             out_specs=P()))(*map(jnp.asarray, (w1, b1, w2, b2, x)))

    def serial(w1, b1, w2, b2, x):
        return jnp.sum((jax.nn.gelu(x @ w1 + b1) @ w2 + b2) * do)

    jg = jax.grad(serial, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (w1, b1, w2, b2, x)))

    tw1, tb1, tw2, tb2, tx = (_t(a, grad=True) for a in (w1, b1, w2, b2, x))
    cols = [tmp.ColumnParallelLinear(8, 16, mp_size=MP, gather_output=False) for _ in range(MP)]
    rows = [tmp.RowParallelLinear(16, 8, mp_size=MP) for _ in range(MP)]

    def rank(r):
        cols[r]._parameters["weight"] = _shard(tw1, 1, r)
        cols[r]._parameters["bias"] = _shard(tb1, 0, r)
        rows[r]._parameters["weight"] = _shard(tw2, 0, r)
        rows[r]._parameters["bias"] = tb2
        return rows[r](torch.nn.functional.gelu(cols[r](tx), approximate="tanh"))

    outs = coll.run_ranks(_mesh(), rank)
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(want), **VAL)
    tg = torch.autograd.grad((outs[0] * _t(do)).sum(), (tw1, tb1, tw2, tb2, tx))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def test_gathered_column_and_split_row(jax_mesh):
    """``gather_output=True`` and ``input_is_parallel=False``: the
    all-gather over mp and the split before the row product."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    w1, w2 = rng.normal(size=(8, 12)).astype(np.float32), rng.normal(size=(12, 4)).astype(np.float32)
    col = jmp.ColumnParallelLinear(8, 12, mp_size=MP, gather_output=True, has_bias=False)
    row = jmp.RowParallelLinear(12, 4, mp_size=MP, input_is_parallel=False, has_bias=False)

    def f(w1s, w2s, x):
        col._parameters["weight"] = w1s
        row._parameters["weight"] = w2s
        return row(col(x))

    want = jax.jit(shard_map(f, mesh=jax_mesh, in_specs=(P(None, "mp"), P("mp", None), P()),
                             out_specs=P()))(*map(jnp.asarray, (w1, w2, x)))
    tw1, tw2 = _t(w1, grad=True), _t(w2, grad=True)
    cols = [tmp.ColumnParallelLinear(8, 12, mp_size=MP, has_bias=False) for _ in range(MP)]
    rows = [tmp.RowParallelLinear(12, 4, mp_size=MP, input_is_parallel=False, has_bias=False)
            for _ in range(MP)]

    def rank(r):
        cols[r]._parameters["weight"] = _shard(tw1, 1, r)
        rows[r]._parameters["weight"] = _shard(tw2, 0, r)
        return rows[r](cols[r](_t(x)))

    outs = coll.run_ranks(_mesh(), rank)
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(want), **VAL)
    jg = jax.grad(lambda a, b: jnp.sum(x @ a @ b), argnums=(0, 1))(jnp.asarray(w1),
                                                                   jnp.asarray(w2))
    tg = torch.autograd.grad(outs[0].sum(), (tw1, tw2))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("entry", ["layer", "ernie", "ernie_pinned"])
def test_parallel_cross_entropy(jax_mesh, entry):
    rng = np.random.default_rng(3)
    V = 32
    logits = (rng.normal(size=(2, 5, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, size=(2, 5)).astype(np.int32)
    w = rng.normal(size=(2, 5)).astype(np.float32)
    pce = jmp.ParallelCrossEntropy(mp_size=MP)
    want = jax.jit(shard_map(lambda lg, lb: pce(lg, lb), mesh=jax_mesh,
                             in_specs=(P(None, None, "mp"), P()), out_specs=P()))(
        jnp.asarray(logits), jnp.asarray(labels))
    # the JAX model's function under the same mesh gives the same values
    want_e = jax.jit(shard_map(
        lambda lg, lb: jernie.parallel_cross_entropy(lg, lb, V, "mp"), mesh=jax_mesh,
        in_specs=(P(None, None, "mp"), P()), out_specs=P()))(jnp.asarray(logits),
                                                             jnp.asarray(labels))
    np.testing.assert_allclose(np.asarray(want_e), np.asarray(want), rtol=1e-6)
    jg = jax.grad(lambda lg: jnp.sum(jnn.functional.cross_entropy(
        lg, jnp.asarray(labels), reduction="none") * w))(jnp.asarray(logits))

    tl = _t(logits, grad=True)
    tpce = tmp.ParallelCrossEntropy(mp_size=MP)

    def rank(r):
        shard, lb = _shard(tl, 2, r), _t(labels)
        if entry == "layer":
            return tpce(shard, lb)
        return ernie.parallel_cross_entropy(shard, lb, V, "mp",
                                            pinned_vjp=entry == "ernie_pinned")

    outs = coll.run_ranks(_mesh(), rank)
    for o in outs:
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), **VAL)
    (g,) = torch.autograd.grad((outs[0] * _t(w)).sum(), (tl,))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD)


def test_mp_size_1_and_outside_a_run_are_serial():
    torch.manual_seed(0)
    emb = tmp.VocabParallelEmbedding(8, 4, mp_size=1)
    ids = torch.tensor([1, 2, 7])
    assert torch.equal(emb(ids), emb.weight[ids])
    col = tmp.ColumnParallelLinear(4, 6, mp_size=1)
    x = torch.randn(2, 4)
    assert torch.equal(col(x), x @ col.weight + col.bias)
    row = tmp.RowParallelLinear(8, 3, mp_size=4)          # mp 4, but no run: serial
    y = torch.randn(2, 2)
    assert torch.equal(row(y), y @ row.weight + row.bias)
    logits, labels = torch.randn(3, 8), torch.tensor([0, 3, 7])
    assert torch.equal(tmp.ParallelCrossEntropy(mp_size=4)(logits, labels),
                       ernie.parallel_cross_entropy(logits, labels, 8))
