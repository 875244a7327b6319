"""``parallel.pipeline`` (``LayerDesc``, ``PipelineLayer``,
``PipelineTrainer``) and ``parallel.pipeline_1f1b`` against the JAX
package, on the CPU.

The JAX reference tests ``test_1f1b_matches_f_then_b_trajectory``,
``test_pipeline_forward_matches_serial`` and
``test_pipeline_sync_model_roundtrip`` fail on jax 0.9.0, so the port's
trainer is held against JAX's SERIAL model: ``PipelineLayer.forward``
under ``executor.Trainer`` (``jax.grad`` and the JAX optimizer) with the
mean-over-micro-batches loss, from the same weights (the JAX layers'
params, ``Linear`` weights transposed). ``interleave`` is also held
against JAX's own ``PipelineTrainer``, whose test passes. Tolerances:
losses rtol 1e-5 / atol 1e-6 a step (the JAX test's 1e-3 is for its
pipelined sums), params after the steps rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.executor import Trainer as JTrainer
from paddle_tpu.parallel import pipeline as jpipe
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.nn import Dropout, Linear
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.parallel import LayerDesc, PipelineLayer, PipelineTrainer

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 0.2


class JBlock(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc = jnn.Linear(d, d)

    def forward(self, x):
        return jax.nn.relu(self.fc(x)) + x


class Block(tnn.Module):
    def __init__(self, d, p=0.0):
        super().__init__()
        self.fc = Linear(d, d)
        self.drop = Dropout(p)

    def forward(self, x):
        return self.drop(torch.relu(self.fc(x))) + x


def _jax_model(seed, d=8, stages=4):
    pt.seed(seed)
    return jpipe.PipelineLayer([jpipe.LayerDesc(JBlock, d) for _ in range(stages)],
                               embed=jnn.Linear(4, d), head=jnn.Linear(d, 3))


def _port_weights(named):
    """JAX named params → the port's state dict (``Linear`` weights [out, in])."""
    return {k: torch.from_numpy(np.array(np.asarray(v).T if np.ndim(v) == 2 else v))
            for k, v in named.items()}


def _pair(seed=0, d=8, stages=4, p=0.0):
    """(JAX PipelineLayer, the port's PipelineLayer with its weights)."""
    jm = _jax_model(seed, d, stages)
    tm = PipelineLayer([LayerDesc(Block, d, p) for _ in range(stages)], embed=Linear(4, d),
                       head=Linear(d, 3))
    tm.load_state_dict(_port_weights(dict(jm.named_parameters())))
    return jm, tm


def _micro_mean_loss(micro):
    def loss(out, yy):
        m = out.shape[0] // micro
        return jnp.mean(jnp.stack([jnn.functional.cross_entropy(out[i * m:(i + 1) * m],
                                                                yy[i * m:(i + 1) * m])
                                   for i in range(micro)]))
    return loss


def _data(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def _trainer(tm, mesh_shape, M, schedule="f_then_b", V=1, lr=LR):
    return PipelineTrainer(tm, SGD(lr), F.cross_entropy, make_mesh(mesh_shape, device="cpu"),
                           num_micro=M, schedule=schedule, num_virtual=V, device="cpu")


def _against_serial(tm, jm, tr, M, x, y, steps):
    serial = JTrainer(jm, jopt.SGD(LR), _micro_mean_loss(M))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    for i in range(steps):
        lp = float(tr.train_step(xt, yt))
        ls = float(serial.train_step(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(lp, ls, err_msg=f"step {i}", **LOSS_TOL)
    tr.sync_model()
    want = _port_weights({k: np.asarray(v) for k, v in serial.state["params"].items()})
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), err_msg=k, **PARAM_TOL)


def test_serial_forward_matches_jax():
    jm, tm = _pair(3)
    x, _ = _data(8)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("schedule", ["f_then_b", "1f1b"])
def test_schedules_match_jax_serial_trajectory(schedule):
    jm, tm = _pair(0)
    x, y = _data(16)
    tr = _trainer(tm, {"dp": 2, "pp": 4}, 4, schedule)
    _against_serial(tm, jm, tr, 4, x, y, steps=4)


@pytest.mark.parametrize("S,V,M", [(2, 2, 3), (2, 3, 5), (4, 2, 6), (4, 2, 7), (2, 2, 4),
                                   (4, 4, 5)])
def test_interleave_arbitrary_micro_matches_jax_serial(S, V, M):
    """The JAX test's grid over (pp, virtual chunks, micro count), M not a
    multiple of S but in one control: the padded tail is skipped."""
    jm, tm = _pair(0, stages=S * V)
    rng = np.random.default_rng(S * 100 + V * 10 + M)
    n = M * (8 // S)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    tr = _trainer(tm, {"dp": 8 // S, "pp": S}, M, "interleave", V)
    _against_serial(tm, jm, tr, M, x, y, steps=3)
    assert tr.last_max_stash <= 2 * S * V


def test_interleave_matches_jax_pipeline_trainer():
    """The JAX trainer's own interleave (8 stages on 4 ranks, its passing
    test's setup), step for step."""
    jm, tm = _pair(0, stages=8)
    x, y = _data(16)
    jtr = jpipe.PipelineTrainer(_jax_model(0, stages=8), jopt.SGD(LR),
                                jnn.functional.cross_entropy,
                                jmesh.make_mesh({"dp": 2, "pp": 4}), num_micro=4,
                                schedule="interleave", num_virtual=2)
    tr = _trainer(tm, {"dp": 2, "pp": 4}, 4, "interleave", 2)
    for i in range(3):
        lj = float(jtr.train_step(jnp.asarray(x), jnp.asarray(y)))
        lp = float(tr.train_step(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))))
        np.testing.assert_allclose(lp, lj, err_msg=f"step {i}", **LOSS_TOL)


@pytest.mark.parametrize("schedule", ["f_then_b", "1f1b"])
def test_dp_sharded_batch_and_replicated_axis(schedule):
    """dp shards each micro-batch (the loss is the mean of the shards'
    means); an extra mesh axis (mp) replicates the work without counting
    it twice."""
    jm, tm = _pair(1, stages=2)
    x, y = _data(24, seed=4)
    tr = _trainer(tm, {"dp": 3, "pp": 2, "mp": 2}, 4, schedule)
    _against_serial(tm, jm, tr, 4, x, y, steps=3)


@pytest.mark.parametrize("schedule", ["f_then_b", "1f1b", "interleave"])
def test_save_load_resume(tmp_path, schedule):
    V = 2 if schedule == "interleave" else 1
    x, y = _data(16)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    a = _trainer(_pair(0, stages=4 * V)[1], {"dp": 2, "pp": 4}, 4, schedule, V)
    for _ in range(2):
        a.train_step(xt, yt)
    a.save(str(tmp_path / schedule))
    la = [float(a.train_step(xt, yt)) for _ in range(2)]
    b = _trainer(_pair(1, stages=4 * V)[1], {"dp": 2, "pp": 4}, 4, schedule, V)
    b.load(str(tmp_path / schedule))
    assert b.global_step == 2
    lb = [float(b.train_step(xt, yt)) for _ in range(2)]
    assert lb == la


def test_save_load_resume_with_a_meta_optimizer_chain(tmp_path):
    """The chain's state (GradientMerge's accumulator and count, AMP's
    LossScaleState) checkpoints and restores like a base optimizer's."""
    from paddle_tpu_torch.distributed import DistributedStrategy, apply_strategy

    def chain():
        return apply_strategy(SGD(LR), DistributedStrategy(
            amp=True, gradient_merge=True, gradient_merge_configs={"k_steps": 2}))

    x, y = _data(16)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    mesh = make_mesh({"pp": 4}, device="cpu")
    a = PipelineTrainer(_pair(0)[1], chain(), F.cross_entropy, mesh, 4, schedule="1f1b",
                        device="cpu")
    for _ in range(3):        # ends between a held and an apply step
        a.train_step(xt, yt)
    a.save(str(tmp_path / "chain"))
    la = [float(a.train_step(xt, yt)) for _ in range(3)]
    b = PipelineTrainer(_pair(1)[1], chain(), F.cross_entropy, mesh, 4, schedule="1f1b",
                        device="cpu")
    b.load(str(tmp_path / "chain"))
    assert int(b.opt_state["inner"]["count"]) == 1
    assert float(b.opt_state["scaler"].loss_scale) == float(a.opt_state["scaler"].loss_scale)
    assert [float(b.train_step(xt, yt)) for _ in range(3)] == la


def test_sync_model_roundtrip():
    jm, tm = _pair(3)
    x, y = _data(4, seed=3)
    tr = _trainer(tm, {"pp": 4, "mp": 2}, 2, lr=0.1)
    tr.train_step(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    model = tr.sync_model()
    assert model is tm
    out = model(torch.from_numpy(x))
    assert out.shape == (4, 3)
    for i, stage in enumerate(model.stages):
        assert torch.equal(stage.fc.weight, tr.params["stages"]["params"]["fc.weight"][i])
    assert torch.equal(model.head.bias, tr.params["aux"]["head"]["params"]["bias"])


@pytest.mark.parametrize("S,V,M", [(4, 1, 16), (2, 2, 9), (4, 2, 12)])
def test_1f1b_live_stash_is_bounded(S, V, M):
    """At M ≫ S a rank never holds more than 2·S·V stashed inputs."""
    _, tm = _pair(0, stages=S * V)
    x, y = _data(2 * M)
    tr = _trainer(tm, {"pp": S}, M, "interleave" if V > 1 else "1f1b", V)
    tr.train_step(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    assert 0 < tr.last_max_stash <= 2 * S * V < M * V


def test_1f1b_recompute_replays_the_dropout_mask(monkeypatch):
    """At dropout 0.1 every recomputed forward draws the mask of its first
    forward: per rank the masks drawn without grad (the forwards) and with
    grad (the recomputes) are the same multiset, and the items' masks
    differ from one another."""
    import threading

    from paddle_tpu_torch.nn import functional as tF

    drawn = {}
    orig = tF.dropout

    def spy(x, p=0.5, training=True, generator=None):
        out = orig(x, p, training, generator)
        key = (threading.current_thread().name, torch.is_grad_enabled())
        drawn.setdefault(key, []).append((out.detach() == 0).numpy().tobytes())
        return out

    monkeypatch.setattr(tF, "dropout", spy)
    _, tm = _pair(0, stages=4, p=0.1)
    x, y = _data(16)
    tr = _trainer(tm, {"pp": 2}, 4, "interleave", 2)
    loss = tr.train_step(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    assert np.isfinite(float(loss))
    ranks = {name for name, _ in drawn}
    assert len(ranks) == 2
    for name in ranks:
        fwd, rec = drawn[(name, False)], drawn[(name, True)]
        assert len(fwd) == len(rec) == 4 * 2
        assert sorted(fwd) == sorted(rec)
        assert len(set(fwd)) > 1


def test_stage_count_must_match_the_schedule():
    _, tm = _pair(0, stages=4)
    with pytest.raises(EnforceNotMet):
        _trainer(tm, {"pp": 2}, 2, "1f1b")
    with pytest.raises(EnforceNotMet):
        _trainer(tm, {"pp": 4}, 2, "interleave", 2)
