"""The vision zoo of the port (AlexNet, VGG, SqueezeNet, MobileNet,
ShuffleNetV2, GoogLeNet, DenseNet) against ``paddle_tpu.models``.

For each family one constructor is built in both packages; the JAX
model's weights and BatchNorm buffers carry over name for name
(``convert.vision_params_from_jax`` into ``load_state_dict``, strict:
every name and shape must match). The same numpy-seeded images go
through both on the CPU: the eval forward, then one ``Trainer`` step
with ``Momentum`` whose params and buffers (the moved running stats)
are held against the JAX trainer's. Dropout is set to p = 0 in both
models for the step: the packages draw their masks from different
generators. Sizes are each family's smallest legal input (AlexNet and
VGG need 224: their classifiers take 6×6 and 7×7 maps; GoogLeNet's aux
heads need taps divisible by 4: 128).

Tolerances, from f32 sums in other orders (CPU convs, BLAS products):
the eval out and the step's loss and BatchNorm buffers rtol 1e-4 / atol
1e-5. In training mode BatchNorm normalizes by the batch's statistics,
whose gradient is ill-conditioned at init (the last stages see a few
cells a channel): the packages' train-mode gradients were seen up to
2e-2 apart by norm (DenseNet's early BatchNorms). So a family with
BatchNorm is held twice: its eval-mode gradients (running statistics,
well conditioned; seen 2e-6 apart) within 1e-4 of the whole gradient's
norm, and no tensor off by more than 1e-3 of it (a BatchNorm bias's
gradient is a sum that cancels to near 0), with the port's ReLU taking
the JAX package's subgradient at 0 (``max(x, 0)``: 1/2; ``torch.relu``:
0; a kept divergence, ROADMAP Queue C); and its step's parameter
updates and velocities within 5e-2 of each tensor's norm. A family
without BatchNorm (AlexNet, SqueezeNet, GoogLeNet; dropout off) holds
its updates and velocities within 1e-4 of each tensor's norm. Each
tensor also gets an RMS error of 1e-7 (updates) / 1e-5 (velocities) an
element, the f32 noise of a gradient around 0. jax 0.9.0 cannot
differentiate the JAX ``avg_pool2d`` (DenseNet's transitions): its
oracle takes that pool as a reshape-mean (``_differentiable_jax_avg_pool``).
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import models as jmodels
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jfunctional
from paddle_tpu import optimizer as jopt
from paddle_tpu.executor import Trainer as JTrainer
from paddle_tpu.nn.layer import functional_call, get_state
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import opt_state_from_jax, vision_params_from_jax
from paddle_tpu_torch.executor import Trainer
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.nn.layers import Dropout

TOL = dict(rtol=1e-4, atol=1e-5)
CLASSES = 10

# family → (constructor name, kwargs, input side, batch); the concatenating
# families run in test_torch_vision_zoo_concat.py and DenseNet in
# test_torch_vision_zoo_densenet.py, so that test workers share the JAX compiles
FAMILIES = {
    "alexnet": ("alexnet", {}, 224, 2),
    "vgg": ("vgg11", {"batch_norm": True}, 224, 2),
    "squeezenet": ("squeezenet1_1", {}, 64, 2),
    "mobilenet": ("mobilenet_v2", {"scale": 0.5}, 64, 4),
}
CONCAT_FAMILIES = {
    "shufflenetv2": ("shufflenet_v2_x0_25", {}, 64, 4),
    "googlenet": ("googlenet", {"with_aux": True}, 128, 2),
}
DENSENET = ("densenet121", {}, 64, 4)   # test_torch_vision_zoo_densenet.py


def _loss(jax_side):
    """Cross entropy; with GoogLeNet's aux heads, the main loss plus 0.3
    of each aux loss (the reference's training objective)."""
    ce = jnn.functional.cross_entropy if jax_side else tF.cross_entropy

    def loss(out, y):
        if isinstance(out, tuple):
            main, a1, a2 = out
            return ce(main, y) + 0.3 * (ce(a1, y) + ce(a2, y))
        return ce(out, y)

    return loss


def _no_dropout(module, dropout_cls):
    for m in (module.modules() if isinstance(module, torch.nn.Module) else module.sublayers()):
        if isinstance(m, dropout_cls):
            m.p = 0.0


def _as_port(a):
    a = np.asarray(a, np.float32)
    return a.T if a.ndim == 2 else a


def _norm_close(got, want, tol, atol, what):
    """``got`` within ``tol`` of ``want``'s L2 norm plus an RMS error of
    ``atol`` an element (the f32 noise floor of a tensor near zero)."""
    want = np.asarray(want, np.float64)
    err = float(np.linalg.norm(np.asarray(got, np.float64) - want))
    bound = tol * float(np.linalg.norm(want)) + atol * np.sqrt(want.size)
    assert err <= bound, (what, err, bound)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_forward_and_trainer_step_match_jax(family):
    check_family(*FAMILIES[family])


def _reshape_mean_pool(x, kernel_size, stride=None, padding=0):
    """``avg_pool2d`` for the non-overlapping, unpadded windows DenseNet's
    transitions use, as a reshape and a mean."""
    assert kernel_size == stride == 2 and padding == 0
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).mean(axis=(3, 5))


@contextlib.contextmanager
def _differentiable_jax_avg_pool(jm, x):
    """jax 0.9.0 cannot differentiate the JAX package's ``avg_pool2d``
    (``lax.reduce_window`` with ``lax.add``: "Linearization failed"), so
    the JAX DenseNet cannot be trained there. The oracle swaps in the
    same pool as a reshape-mean (checked: the same eval forward bit for
    bit); the package itself is not edited."""
    want = np.asarray(jm(jnp.asarray(x)))
    with mock.patch.object(jfunctional, "avg_pool2d", _reshape_mean_pool):
        np.testing.assert_array_equal(np.asarray(jm(jnp.asarray(x))), want)
        yield


def _jax_relu(x):
    """The JAX package's ``relu``, ``max(x, 0)``, whose gradient at exactly
    0 is 1/2 (``torch.relu``'s is 0)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype))


def _eval_grads_close(jm, tm, x, y):
    """The eval-mode gradients (BatchNorm on its running stats): the
    whole gradient within 1e-4 of its norm, and no tensor off by more
    than 1e-3 of that norm. The port's ReLU takes the JAX package's
    subgradient here: at init a depthwise conv over a window of zeros
    gives exact zeros, where the two rules differ (MobileNet's depthwise
    BatchNorm biases read 30-40 % apart with ``torch.relu``)."""
    st = get_state(jm)

    def jloss(params):
        out, _ = functional_call(jm, {"params": params, "buffers": st["buffers"]},
                                 jnp.asarray(x), training=False)
        return jnn.functional.cross_entropy(out, jnp.asarray(y))

    jg = jax.jit(jax.grad(jloss))(st["params"])
    names = [k for k, _ in tm.named_parameters()]
    with mock.patch.object(tF, "relu", _jax_relu):
        tl = tF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    tg = dict(zip(names, torch.autograd.grad(tl, list(tm.parameters()))))
    diff = {k: np.linalg.norm(tg[k].numpy().astype(np.float64) - _as_port(jg[k])) for k in names}
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(jg[k], np.float64)))) for k in names))
    assert np.sqrt(sum(d * d for d in diff.values())) <= 1e-4 * total
    for k in names:
        assert diff[k] <= 1e-3 * total, (k, diff[k], total)


def check_family(name, kw, side, batch):
    pt.seed(0)
    jm = getattr(jmodels, name)(num_classes=CLASSES, **kw)
    tm = getattr(tmodels, name)(num_classes=CLASSES, **kw)
    tm.load_state_dict(vision_params_from_jax(get_state(jm)))  # strict: names and shapes
    rng = np.random.default_rng(3)
    x = rng.normal(size=(batch, 3, side, side)).astype(np.float32)
    y = rng.integers(0, CLASSES, batch).astype(np.int64)

    jm.eval()
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jm(jnp.asarray(x))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert tuple(g.shape) == (batch, CLASSES)
        _close(g.numpy(), w, "eval out")

    with contextlib.ExitStack() as stack:
        if name == "densenet121":
            stack.enter_context(_differentiable_jax_avg_pool(jm, x))
        _grads_and_step(jm, tm, x, y)


def _grads_and_step(jm, tm, x, y):
    has_bn = bool(dict(tm.named_buffers()))
    if has_bn:
        _eval_grads_close(jm, tm, x, y)

    jm.train()
    tm.train()
    _no_dropout(jm, jnn.Dropout)
    _no_dropout(tm, Dropout)
    start = {k: v.detach().clone() for k, v in tm.named_parameters()}
    jt = JTrainer(jm, jopt.Momentum(0.01, 0.9, weight_decay=1e-4), _loss(True))
    tt = Trainer(tm, topt.Momentum(0.01, 0.9, weight_decay=1e-4), _loss(False), device="cpu")
    _close(float(tt.train_step(x, y)), float(jt.train_step(x, y)), "step loss")
    want = vision_params_from_jax(jt.state)
    got = {**tt.state["params"], **tt.state["buffers"]}
    assert sorted(want) == sorted(got)
    for k in tt.state["buffers"]:
        _close(got[k].numpy(), want[k].numpy(), k)
    for k in start:  # without BatchNorm the step's gradient is well conditioned
        _norm_close((got[k] - start[k]).numpy(), (want[k] - start[k]).numpy(),
                    5e-2 if has_bn else 1e-4, 1e-7, f"update {k}")
    means = [k for k in want if k.endswith("._mean")]
    assert all(not torch.equal(got[k], torch.zeros_like(got[k])) for k in means)
    vel = opt_state_from_jax(jt.opt_state, tt.optimizer)["velocity"]
    for k in vel:
        _norm_close(tt.opt_state["velocity"][k].numpy(), vel[k].numpy(),
                    5e-2 if has_bn else 1e-4, 1e-5, f"v {k}")
