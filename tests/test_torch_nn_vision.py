"""The port's vision ops and layers against ``paddle_tpu.nn``.

Same numpy-seeded inputs through both packages, on the CPU. Tolerances:
pools and the elementwise ops atol 1e-6 (the same f32 formulas; a pool's
sum in another order); batch_norm atol 1e-5 on y and the running stats
(means and variances summed in another order), 1e-4 on its gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.nn import functional as tF

POOLS = [  # (kernel, stride, padding, H, W)
    (2, 2, 0, 8, 8), (3, 2, 1, 9, 7), (3, 1, 1, 6, 6), (3, None, 0, 9, 9), (5, 2, 2, 11, 10)]


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("cfg", POOLS, ids=lambda c: "-".join(map(str, c)))
def test_pools_match_jax(pool, cfg):
    k, s, p, h, w = cfg
    x = np.random.default_rng(0).normal(size=(2, 3, h, w)).astype(np.float32)
    jfn, tfn = (jF.max_pool2d, tF.max_pool2d) if pool == "max" else (jF.avg_pool2d,
                                                                      tF.avg_pool2d)
    jy, vjp = jax.vjp(lambda a: jfn(a, k, s, p), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tfn(tx, k, s, p)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    g = np.random.default_rng(1).normal(size=jy.shape).astype(np.float32)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=0, atol=1e-6)


def test_avg_pool_divides_by_valid_cells():
    """A corner window of a padded average sees 4 cells of 9: the mean of
    those 4, not their sum over 9 (torch's count_include_pad default)."""
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    y = tF.avg_pool2d(x, 3, 1, 1)
    assert float(y[0, 0, 0, 0]) == float((0 + 1 + 4 + 5) / 4)


@pytest.mark.parametrize("out", [1, 2, (2, 4)])
def test_adaptive_avg_pool_matches_jax_and_raises(out):
    x = np.random.default_rng(2).normal(size=(2, 3, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(tF.adaptive_avg_pool2d(torch.from_numpy(x), out).numpy(),
                               np.asarray(jF.adaptive_avg_pool2d(jnp.asarray(x), out)),
                               rtol=0, atol=1e-6)
    with pytest.raises(InvalidArgumentError, match="divisible"):
        tF.adaptive_avg_pool2d(torch.zeros(1, 1, 7, 7), 2)


@pytest.mark.parametrize("shape", [(4, 6), (4, 6, 5), (4, 6, 5, 3)], ids=["2d", "3d", "4d"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(shape, training):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    c = shape[1]
    rm, rv = rng.normal(size=c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    w, b = rng.normal(size=c).astype(np.float32), rng.normal(size=c).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)

    def jfn(a, ww, bb):
        return jF.batch_norm(a, jnp.asarray(rm), jnp.asarray(rv), ww, bb, training)

    (jy, jm, jv), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp((jnp.asarray(g), jnp.zeros_like(jm), jnp.zeros_like(jv)))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    ty, tm, tv = tF.batch_norm(tx, torch.from_numpy(rm), torch.from_numpy(rv), tw, tb, training)
    for got, want in ((ty, jy), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    ty.backward(torch.from_numpy(g))
    for got, want in ((tx.grad, jdx), (tw.grad, jdw), (tb.grad, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    if training:  # the biased variance and 0.9 of the old stats
        axes = (0,) + tuple(range(2, len(shape)))
        np.testing.assert_allclose(tv.numpy(), 0.9 * rv + 0.1 * x.var(axis=axes),
                                   rtol=1e-5, atol=1e-6)


def test_batch_norm_layer_writes_running_stats_in_training_only():
    bn = tnn.BatchNorm2D(3)
    assert [k for k, _ in bn.named_parameters()] == ["weight", "bias"]
    assert [k for k, _ in bn.named_buffers()] == ["_mean", "_variance"]
    x = torch.from_numpy(np.random.default_rng(4).normal(3.0, 2.0, (8, 3, 4, 4))
                         .astype(np.float32))
    jbn = jnn.BatchNorm2D(3)
    jy = jbn(jnp.asarray(x.numpy()))
    y = bn(x)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn._mean.numpy(), np.asarray(jbn._buffers["_mean"]), atol=1e-6)
    np.testing.assert_allclose(bn._variance.numpy(), np.asarray(jbn._buffers["_variance"]),
                               atol=1e-5)
    before = bn._mean.clone()
    bn.eval()
    bn(x)
    assert torch.equal(bn._mean, before)
    with pytest.raises(InvalidArgumentError, match="ndim"):
        tF.batch_norm(torch.zeros(2, 2, 2, 2, 2), bn._mean, bn._variance, bn.weight,
                      bn.bias, True)


def test_elementwise_ops_and_losses_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 7)).astype(np.float32)
    t = torch.from_numpy(x)
    for name in ("sigmoid", "tanh", "relu"):
        np.testing.assert_allclose(getattr(tF, name)(t).numpy(),
                                   np.asarray(getattr(jF, name)(jnp.asarray(x))), atol=1e-6)
    for axis in (-1, 0):
        np.testing.assert_allclose(tF.softmax(t, axis).numpy(),
                                   np.asarray(jF.softmax(jnp.asarray(x), axis)), atol=1e-6)
        np.testing.assert_allclose(tF.log_softmax(t, axis).numpy(),
                                   np.asarray(jF.log_softmax(jnp.asarray(x), axis)), atol=1e-6)
    y = rng.normal(size=(4, 7)).astype(np.float32)
    for red in ("mean", "sum", "none"):
        np.testing.assert_allclose(tF.mse_loss(t, torch.from_numpy(y), red).numpy(),
                                   np.asarray(jF.mse_loss(jnp.asarray(x), jnp.asarray(y), red)),
                                   rtol=1e-6, atol=1e-6)
    x4 = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    for start in (1, 2):
        assert tuple(tF.flatten(torch.from_numpy(x4), start).shape) == \
            jF.flatten(jnp.asarray(x4), start).shape
    ids = np.array([[0, 3, 9], [2, -1, 5]])
    np.testing.assert_array_equal(tF.one_hot(torch.from_numpy(ids), 6).numpy(),
                                  np.asarray(jF.one_hot(jnp.asarray(ids), 6)))
    table = rng.normal(size=(10, 4)).astype(np.float32)
    ids = np.array([[1, 0, 7], [0, 9, 0]])
    for pad in (None, 0):
        np.testing.assert_array_equal(
            tF.embedding(torch.from_numpy(ids), torch.from_numpy(table), pad).numpy(),
            np.asarray(jF.embedding(jnp.asarray(ids), jnp.asarray(table), pad)))


def test_layers_have_the_jax_names_shapes_and_init_ranges():
    g = torch.Generator().manual_seed(0)
    lin = tnn.Linear(9, 4, generator=g)
    conv = tnn.Conv2D(6, 8, 3, groups=2, bias_attr=False, generator=g)
    emb = tnn.Embedding(50, 16, generator=g)
    jlin, jconv, jemb = jnn.Linear(9, 4), jnn.Conv2D(6, 8, 3, groups=2, bias_attr=False), \
        jnn.Embedding(50, 16)
    assert tuple(lin.weight.shape) == tuple(jlin.weight.shape)[::-1]      # [out, in]
    assert [k for k, _ in conv.named_parameters()] == ["weight"]
    assert tuple(conv.weight.shape) == tuple(jconv.weight.shape)           # OIHW
    assert float(lin.weight.abs().max()) <= 1 / 3 and float(lin.bias.abs().max()) == 0
    assert float(conv.weight.abs().max()) <= 1 / np.sqrt(27)
    assert abs(float(emb.weight.std()) - 0.25) < 0.03
    again = tnn.Linear(9, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, lin.weight)
    x = np.random.default_rng(6).normal(size=(2, 6, 5, 5)).astype(np.float32)
    jconv._parameters["weight"] = jnp.asarray(conv.weight.detach().numpy())
    np.testing.assert_allclose(conv(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jconv(jnp.asarray(x))), rtol=0, atol=1e-5)
    seq = tnn.Sequential(tnn.Flatten(), tnn.Softmax(), tnn.Sigmoid(), tnn.Tanh(), tnn.GELU())
    assert tuple(seq(torch.zeros(2, 3, 4)).shape) == (2, 12)
    logits, labels = torch.randn(4, 5), torch.tensor([0, 1, 4, 2])
    assert torch.equal(tnn.CrossEntropyLoss()(logits, labels), tF.cross_entropy(logits, labels))
    assert torch.equal(tnn.MSELoss("sum")(logits, logits * 2), tF.mse_loss(logits, logits * 2,
                                                                            "sum"))
    assert torch.equal(tnn.BCEWithLogitsLoss()(logits, (logits > 0).float()),
                       tF.binary_cross_entropy_with_logits(logits, (logits > 0).float()))
    assert tuple(tnn.AvgPool2D(2)(torch.zeros(1, 1, 4, 4)).shape) == (1, 1, 2, 2)
