"""``distributed.recompute`` against the plain segment and the JAX package,
on the CPU.

For every policy the port's gradients with recompute equal its gradients
without, bit for bit (the recompute replays the same ops), and JAX's
``recompute`` gradients of the same function within rtol 1e-5 / atol
1e-6 (JAX's own test's tolerance: XLA fuses the two programs
differently). A dropout inside the segment replays its mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.recompute import recompute as jrecompute
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.distributed import recompute, recompute_sequential
from paddle_tpu_torch.distributed.recompute import RECOMPUTE_POLICIES
from paddle_tpu_torch.nn import Dropout, Linear

POLICIES = sorted(RECOMPUTE_POLICIES)


def _x():
    return np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32)


def test_policy_names_are_jax_names():
    from paddle_tpu.distributed.recompute import RECOMPUTE_POLICIES as JPOL

    assert set(RECOMPUTE_POLICIES) == set(JPOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_equal_plain_and_jax(policy):
    def f(x):
        y = torch.tanh(x @ x.T)
        z = torch.bmm(y[None], x[None])[0]
        return torch.sum(torch.sin(z) * y)

    def jf(x):
        y = jnp.tanh(x @ x.T)
        return jnp.sum(jnp.sin(y @ x) * y)

    x = torch.from_numpy(_x()).requires_grad_(True)
    (g_plain,) = torch.autograd.grad(f(x), x)
    (g_re,) = torch.autograd.grad(recompute(f, x, policy=policy), x)
    assert torch.equal(g_plain, g_re)
    g_jax = jax.grad(lambda a: jrecompute(jf, a, policy=policy))(jnp.asarray(_x()))
    np.testing.assert_allclose(g_re.numpy(), np.asarray(g_jax), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_sequential_segments_and_dropout_replay(policy):
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(5)
    blocks = []
    for _ in range(3):
        drop = Dropout(0.3)
        drop.generator = gen
        blocks.append(torch.nn.Sequential(Linear(8, 8), torch.nn.Tanh(), drop))
    x = torch.from_numpy(_x()).requires_grad_(True)
    gen.manual_seed(5)
    y = x
    for b in blocks:
        y = b(y)
    (g_plain,) = torch.autograd.grad(y.sum(), x)
    after_plain = gen.get_state()
    gen.manual_seed(5)
    y_re = recompute_sequential(blocks, x, policy=policy)
    assert torch.equal(y_re, y)
    (g_re,) = torch.autograd.grad(y_re.sum(), x)
    assert torch.equal(g_re, g_plain)
    # the replay gave each generator back its state
    assert torch.equal(gen.get_state(), after_plain)


def test_unknown_policy_raises():
    with pytest.raises(InvalidArgumentError, match="policy"):
        recompute(lambda x: x, torch.ones(2), policy="dots_with_everything")
