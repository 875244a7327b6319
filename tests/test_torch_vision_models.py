"""LeNet and ResNet of the port against ``paddle_tpu.models``.

The JAX model's weights carry over name for name
(``convert.vision_params_from_jax``); the same numpy-seeded batches go
through both packages on the CPU: forward, gradients at the start, and 3
``Trainer`` steps with ``Momentum`` (f32), BatchNorm's running stats
included. Tolerances, set from f32 sums in another order (cuDNN-free CPU
convs, BLAS products): LeNet rtol 1e-4 / atol 1e-5 everywhere; the small
ResNet (one bottleneck a stage, 32×32, batch 8) forward and loss rtol
1e-4, gradients atol 5e-5 + rtol 1e-3 (BatchNorm over 8×1×1 cells at the
last stage divides by small variances), and after 3 steps params and
buffers rtol 1e-4 / atol 1e-5, the velocities (sums of gradients) at the
gradients' tolerance (lr 0.01: at 0.05 this random-label run
diverges, and rounding grows to 1e-2 after 3 steps in both packages).

Amp: the JAX package's amp conv cannot be differentiated (jax 0.9.0), so
the O1 Trainer is held against JAX's ``Trainer(amp=True)`` on a
``Linear`` model, within the bf16-cotangent gap the port takes on
purpose (rtol 2e-2 on the updates, ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.executor import Trainer as JTrainer
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.nn.layer import functional_call, get_state
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import opt_state_from_jax, vision_params_from_jax
from paddle_tpu_torch.executor import Trainer, make_train_step
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.nn import functional as tF

TOL = {"lenet": dict(fwd=(1e-4, 1e-5), grad=(1e-4, 1e-5), steps=(1e-4, 1e-5)),
       "resnet": dict(fwd=(1e-4, 1e-5), grad=(1e-3, 5e-5), steps=(1e-4, 1e-5))}


def _models(kind):
    pt.seed(0)
    if kind == "lenet":
        return jlenet.LeNet(), tlenet.LeNet(), (8, 1, 28, 28), 10
    return (jresnet.ResNet(jresnet.BottleneckBlock, [1, 1, 1, 1], num_classes=10),
            tresnet.ResNet(tresnet.BottleneckBlock, [1, 1, 1, 1], num_classes=10),
            (8, 3, 32, 32), 10)


def _batches(shape, classes, n=3):
    rng = np.random.default_rng(11)
    return [(rng.normal(size=shape).astype(np.float32),
             rng.integers(0, classes, shape[0]).astype(np.int64)) for _ in range(n)]


def _close(got, want, tol, what):
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("kind", ["lenet", "resnet"])
def test_forward_gradients_and_three_trainer_steps_match_jax(kind):
    jm, tm, shape, classes = _models(kind)
    tm.load_state_dict(vision_params_from_jax(get_state(jm)))
    tol = TOL[kind]
    batches = _batches(shape, classes)
    x, y = batches[0]

    # forward in eval mode (running stats) and the training loss's gradients
    jm.eval()
    tm.eval()
    _close(tm(torch.from_numpy(x)).detach().numpy(), jm(jnp.asarray(x)), tol["fwd"], "eval out")
    state = get_state(jm)

    def jloss(params):
        out, _ = functional_call(jm, {"params": params, "buffers": state["buffers"]},
                                 jnp.asarray(x), training=True)
        return jnn.functional.cross_entropy(out, jnp.asarray(y))

    jl, jg = jax.value_and_grad(jloss)(state["params"])
    step = make_train_step(tm, topt.SGD(0.0), tF.cross_entropy)
    tstate = {"params": {k: p.detach() for k, p in tm.named_parameters()},
              "buffers": {k: b.detach() for k, b in tm.named_buffers()}}
    leaves = {k: p.detach().requires_grad_(True) for k, p in tstate["params"].items()}
    tm.train()
    out = torch.func.functional_call(tm, {**leaves, **{k: b.clone() for k, b in
                                                      tstate["buffers"].items()}},
                                     (torch.from_numpy(x),))
    tl = tF.cross_entropy(out, torch.from_numpy(y))
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    _close(float(tl.detach()), float(jl), tol["fwd"], "loss")
    tg_as_jax = {k: v.numpy().T if v.ndim == 2 else v.numpy() for k, v in tg.items()}
    for k in jg:
        _close(tg_as_jax[k], jg[k], tol["grad"], f"grad {k}")
    # the step leaves its input state alone and returns the moved stats
    new_state, _, _ = step(tstate, topt.SGD(0.0).init(tstate["params"]),
                           (torch.from_numpy(x),), (torch.from_numpy(y),))
    assert all(torch.equal(a, b) for a, b in zip(tstate["buffers"].values(),
                                                 dict(tm.named_buffers()).values()))
    if kind == "resnet":
        assert not torch.equal(new_state["buffers"]["bn1._mean"], tstate["buffers"]["bn1._mean"])
    else:
        assert new_state["buffers"] == {}

    # 3 Trainer steps, Momentum with decay, from the same weights
    jm.train()
    jt = JTrainer(jm, jopt.Momentum(0.01, 0.9, weight_decay=1e-4),
                  jnn.functional.cross_entropy)
    tt = Trainer(tm, topt.Momentum(0.01, 0.9, weight_decay=1e-4), tF.cross_entropy,
                 device="cpu")
    for bx, by in batches:
        jl = jt.train_step(bx, by)
        tl = tt.train_step(bx, by)
        _close(float(tl), float(jl), tol["steps"], "step loss")
    want = vision_params_from_jax(jt.state)
    got = {**tt.state["params"], **tt.state["buffers"]}
    assert sorted(want) == sorted(got)
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), tol["steps"], k)
    if kind == "resnet":  # the running stats moved, as the JAX step moves them
        assert not torch.equal(got["layer4.0.bn3._variance"], torch.ones(2048))
    vel = opt_state_from_jax(jt.opt_state, tt.optimizer)["velocity"]
    for k in vel:
        _close(tt.opt_state["velocity"][k].numpy(), vel[k].numpy(), tol["grad"], f"v {k}")
    # sync_model writes params and buffers back into the module
    tt.sync_model()
    for k, v in tm.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_resnet50_names_and_parameter_count_match_jax():
    pt.seed(0)
    js = get_state(jresnet.resnet50())
    tm = tresnet.resnet50(generator=torch.Generator().manual_seed(0))
    assert [k for k, _ in tm.named_parameters()] == list(js["params"])
    assert [k for k, _ in tm.named_buffers()] == list(js["buffers"])
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(v.shape)) for v in js["params"].values()) == 25557032
    for k, v in js["params"].items():
        shape = tuple(v.shape)[::-1] if len(v.shape) == 2 else tuple(v.shape)
        assert tuple(dict(tm.named_parameters())[k].shape) == shape, k
    for name in ("resnet18", "resnet34", "resnet101", "resnet152"):
        j, t = getattr(jresnet, name)(num_classes=7), getattr(tresnet, name)(num_classes=7)
        assert sum(p.numel() for p in t.parameters()) == \
            sum(int(np.prod(v.shape)) for v in get_state(j)["params"].values()), name


def test_o1_trainer_on_a_linear_model_matches_jax_amp_trainer():
    """Port ``Trainer(amp="O1")`` vs JAX ``Trainer(amp=True)``: the forward
    within 1e-5 at the first step (the same bf16-rounded products), the
    updates after 5 Adam steps within rtol 2e-2 of JAX's (the port's
    bf16 cotangent), and both far from the f32 run's updates' rounding."""
    pt.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 2))
    tm = tnn.Sequential(tnn.Linear(8, 32), tnn.ReLU(), tnn.Linear(32, 2))
    w0 = vision_params_from_jax(get_state(jm))
    tm.load_state_dict(w0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    jt = JTrainer(jm, jopt.Adam(5e-3), jnn.functional.cross_entropy, amp=True)
    tt = Trainer(tm, topt.Adam(5e-3), tF.cross_entropy, amp="O1", device="cpu")
    jl = [float(jt.train_step(x, y)) for _ in range(5)]
    tl = [float(tt.train_step(x, y)) for _ in range(5)]
    np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    want = vision_params_from_jax(jt.state)
    for k, v in tt.state["params"].items():
        dw, dj = (v - w0[k]).numpy(), (want[k] - w0[k]).numpy()
        assert np.linalg.norm(dw - dj) <= 2e-2 * np.linalg.norm(dj), k


def test_o2_trainer_stores_bf16_params_that_equal_their_masters():
    tm = tresnet.ResNet(tresnet.BasicBlock, [1, 1, 1, 1], num_classes=4,
                        generator=torch.Generator().manual_seed(1))
    tt = Trainer(tm, topt.Momentum(0.05, 0.9), tF.cross_entropy, amp="O2", device="cpu")
    assert isinstance(tt.optimizer, topt.MasterWeights)
    x, y = _batches((4, 3, 32, 32), 4, n=1)[0]
    before = {k: b.clone() for k, b in tt.state["buffers"].items()}
    losses = [float(tt.train_step(x, y)) for _ in range(3)]
    assert np.isfinite(losses).all()
    for k, p in tt.state["params"].items():
        assert p.dtype == torch.bfloat16 and torch.equal(
            p, tt.opt_state["master"][k].to(torch.bfloat16)), k
    for k, b in tt.state["buffers"].items():
        assert b.dtype == torch.float32
        if k.endswith("_mean"):
            assert not torch.equal(b, before[k]), k
