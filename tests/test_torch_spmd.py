"""``parallel.spmd.SpmdTrainer`` against the JAX package's, on the CPU.

The JAX trainer runs on the 8 CPU devices of ``tests/conftest.py``, the
port's on logical ranks of one CPU mesh; models and data come from the
same numpy-seeded weights (``test_torch_comm_fusion``'s ``Dense`` stack,
JAX's ``[in, out]`` layout). Tolerances:

- against the port's own ``executor.Trainer`` (the JAX test's single-device
  oracle): losses rtol 2e-4, params rtol 2e-3 / atol 2e-5, as the JAX
  test holds its own;
- against JAX's ``SpmdTrainer``: losses rtol 1e-5, params atol 1e-5 (XLA
  sums its matmuls and all-reduces in its own order);
- save/load within the port: bitwise; JAX's state carried into the port
  and stepped: losses rtol 1e-5, params atol 1e-5;
- ERNIE with fused int8: the port's ``attn_impl="flash"`` (the plain
  B5–B7 on the CPU, bf16 operands) against JAX's einsum trainer, 2 SGD
  steps: losses rtol 2e-4, each tensor's update within 5e-2 of JAX's by
  norm with the key bias left out (``test_torch_ernie.py``'s flash
  bounds; its true gradient is 0).
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.distributed import comm_fusion as jcf
from paddle_tpu.parallel import SpmdTrainer as JSpmd
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (ernie_params_from_jax, spmd_opt_state_from_jax,
                                      spmd_state_from_jax)
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.distributed.comm_fusion import CommFusionConfig
from paddle_tpu_torch.executor import Trainer
from paddle_tpu_torch.io.checkpoint import load_train_state
from paddle_tpu_torch.parallel import DataParallel, SpmdTrainer, make_sharding_rules
from paddle_tpu_torch.parallel.spmd import RankSlices
from test_torch_comm_fusion import one_intra_op_thread  # noqa: F401  (the fixture)
from test_torch_comm_fusion import ce, data, jax_mlp, params_of, port_mlp

W = (8, 16, 3)


def _both(stage, shape, opt=("SGD", 0.1), comm=None, steps=5, batch_axes=("dp", "sharding"),
          strategy=None):
    """(the JAX run, a fresh port trainer from its start)."""
    from paddle_tpu.distributed import DistributedStrategy as JStrategy
    from paddle_tpu_torch.distributed import DistributedStrategy

    jm = jax_mlp(0, W)
    tm = port_mlp(jm, W)
    jtr = JSpmd(jm, getattr(jopt, opt[0])(opt[1]), jnn.functional.cross_entropy,
                jmesh.make_mesh(shape), zero_stage=stage, batch_axes=batch_axes,
                comm=None if comm is None else jcf.CommFusionConfig(**comm),
                strategy=None if strategy is None else JStrategy(**strategy))
    x, y = data()
    losses = [float(jtr.train_step(x, y)) for _ in range(steps)]
    tr = SpmdTrainer(tm, getattr(topt, opt[0])(opt[1]), ce, make_mesh(shape, device="cpu"),
                     zero_stage=stage, batch_axes=batch_axes,
                     comm=None if comm is None else CommFusionConfig(**comm),
                     strategy=None if strategy is None else DistributedStrategy(**strategy),
                     device="cpu")
    return jtr, losses, tr


@pytest.mark.parametrize("zero_stage", [0, 1, 2, 3])
def test_spmd_matches_single_device_and_jax(zero_stage):
    """dp=2 × sharding=4 at each stage: 5 SGD steps follow the serial
    Trainer and JAX's SpmdTrainer (tolerances above)."""
    shape = {"dp": 2, "sharding": 4}
    jtr, jl, tr = _both(zero_stage, shape)
    single = Trainer(port_mlp(jax_mlp(0, W), W), topt.SGD(0.1), ce, device="cpu")
    x, y = (torch.from_numpy(a) for a in data())
    losses = []
    for _ in range(5):
        l1, l2 = float(single.train_step(x, y)), float(tr.train_step(x, y))
        np.testing.assert_allclose(l1, l2, rtol=2e-4)
        losses.append(l2)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    got = params_of(tr)
    jend = jax.device_get(jtr.state["params"])
    for k, v in single.state["params"].items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=2e-3, atol=2e-5, err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(jend[k]), rtol=0, atol=1e-5, err_msg=k)


def test_sharding_rules_equal_jax():
    """``make_sharding_rules`` gives JAX's PartitionSpecs as layout tuples
    at every stage (params and Adam's state)."""
    jm = jax_mlp(0, W)
    jst = jnn.get_state(jm)
    tm = port_mlp(jm, W)
    params = {k: p.detach() for k, p in tm.named_parameters()}
    jmesh_ = jmesh.make_mesh({"dp": 2, "sharding": 4})
    mesh = make_mesh({"dp": 2, "sharding": 4}, device="cpu")
    for stage in (0, 1, 2, 3):
        jp, jo = jspmd.make_sharding_rules(jmesh_, jst["params"], jopt.Adam().init(jst["params"]),
                                           stage)
        tp, to = make_sharding_rules(mesh, params, topt.Adam().init(params), stage)
        for k in params:
            assert tp[k] == tuple(jp[k].spec), (stage, k)
            assert to["m"][k] == tuple(jo["slots"]["m"][k].spec), (stage, k)
        assert to["step"] == tuple(jo["step"].spec) == ()


def test_zero_state_is_sharded():
    """Stage 1 on sharding=8: Adam's slot of the [16, 3] weight is 8 slices
    of 2 rows (the 'sharding' axis on its largest divisible dim)."""
    tr = SpmdTrainer(port_mlp(jax_mlp(0, W), W), topt.Adam(1e-2), ce,
                     make_mesh({"dp": 1, "sharding": 8}, device="cpu"), zero_stage=1,
                     device="cpu")
    x, y = (torch.from_numpy(a) for a in data())
    tr.train_step(x, y)
    m = tr.opt_state["m"]["2.weight"]
    assert isinstance(m, RankSlices) and m.dim == 0 and len(m.parts) == 8
    assert all(tuple(p.shape) == (2, 3) for p in m.parts) and tuple(m.full().shape) == (16, 3)
    assert isinstance(tr.state["params"]["2.weight"], torch.Tensor)   # params whole


def test_zero3_params_sharded():
    tr = SpmdTrainer(port_mlp(jax_mlp(0, W), W), topt.SGD(0.1), ce,
                     make_mesh({"dp": 1, "sharding": 8}, device="cpu"), zero_stage=3,
                     device="cpu")
    w = tr.state["params"]["0.weight"]     # [8, 16]: cut on its 16 columns
    assert isinstance(w, RankSlices) and len(w.parts) == 8 and w.dim == 1
    assert all(tuple(p.shape) == (8, 2) for p in w.parts)
    x, y = (torch.from_numpy(a) for a in data())
    assert np.isfinite(float(tr.train_step(x, y)))
    assert isinstance(tr.state["params"]["0.weight"], RankSlices)


@pytest.mark.parametrize("stage,comm", [(1, None), (2, dict(quant="int8", block_size=64))],
                         ids=["stage1_gspmd", "stage2_fused_int8"])
def test_spmd_trainer_save_load_resume(tmp_path, stage, comm):
    """A trainer of another seed loads the snapshot (global layout) and
    continues the trajectory bitwise."""
    mesh = make_mesh({"dp": 2, "sharding": 4}, device="cpu")
    x, y = (torch.from_numpy(a) for a in data(32))

    def build(seed):
        return SpmdTrainer(port_mlp(jax_mlp(seed, W), W), topt.Adam(1e-2), ce, mesh,
                           zero_stage=stage, device="cpu",
                           comm=None if comm is None else CommFusionConfig(**comm))

    a = build(0)
    for _ in range(3):
        a.train_step(x, y)
    a.save(str(tmp_path / "snap"))
    la = [float(a.train_step(x, y)) for _ in range(3)]
    b = build(5)
    b.load(str(tmp_path / "snap"))
    assert b.global_step == 3
    assert [float(b.train_step(x, y)) for _ in range(3)] == la


CHAIN = dict(dgc=True, dgc_configs={"rampup_begin_step": 100}, amp=True,
             amp_configs={"init_loss_scaling": 8.0}, gradient_merge=True,
             gradient_merge_configs={"k_steps": 2})


@pytest.mark.parametrize("stage,comm,opt,strategy", [
    (1, None, ("Adam", 1e-2), None), (3, None, ("Adam", 1e-2), None),
    (2, dict(), ("Adam", 1e-2), None), (0, dict(max_buckets=2), ("Momentum", 0.1), CHAIN)],
    ids=["stage1", "stage3", "stage2_fused", "fused_amp_gm_dgc_chain"])
def test_jax_snapshot_resumes_in_the_port(tmp_path, stage, comm, opt, strategy):
    """JAX saves after 3 steps, the port loads the file through
    ``convert.spmd_*_from_jax`` (the chain's per-rank GM and DGC state and
    AMP's scaler included) and both take 3 more (tolerances above)."""
    shape = {"dp": 2, "sharding": 4}
    jtr, _, tr = _both(stage, shape, opt=opt, comm=comm, steps=3, strategy=strategy)
    jtr.save(str(tmp_path / "snap"))
    snap = load_train_state(str(tmp_path / "snap"))
    tr.restore(spmd_state_from_jax(snap["state"], params_from_jax=ernie_params_from_jax),
               spmd_opt_state_from_jax(snap["opt"], tr, snap["state"]["params"],
                                       params_from_jax=ernie_params_from_jax), snap["step"])
    assert tr.global_step == 3
    x, y = data()
    want = [float(jtr.train_step(x, y)) for _ in range(3)]
    got = [float(tr.train_step(torch.from_numpy(x), torch.from_numpy(y))) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jend = jax.device_get(jtr.state["params"])
    for k, v in params_of(tr).items():
        np.testing.assert_allclose(v, np.asarray(jend[k]), rtol=0, atol=1e-5, err_msg=k)


def test_data_parallel_wrapper_builds_the_trainer():
    dp = DataParallel(port_mlp(jax_mlp(0, W), W))
    tr = dp.trainer(topt.SGD(0.1), ce, make_mesh({"dp": 2}, device="cpu"), device="cpu")
    assert isinstance(tr, SpmdTrainer) and tr.model is dp.model
    x, y = (torch.from_numpy(a) for a in data())
    assert np.isfinite(float(tr.train_step(x, y)))


def test_ernie_fused_int8_flash_follows_jax_einsum():
    """A small ERNIE over dp=4, fused int8 with error feedback: the port's
    flash path (plain B5–B7) against JAX's einsum trainer, 2 SGD steps."""
    from paddle_tpu.models import ernie as jernie
    from paddle_tpu_torch.models import ernie
    from test_torch_ernie import SMALL, _key_bias_dropped

    pt.seed(0)
    jm = jernie.Ernie(jernie.ErnieConfig(**SMALL))
    w0 = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = ernie.Ernie(ernie.ErnieConfig(**SMALL, attn_impl="flash"))
    tm.load_state_dict(ernie_params_from_jax(w0))
    rng = np.random.default_rng(5)
    ids = rng.integers(0, SMALL["vocab_size"], (8, 16)).astype(np.int32)
    labels = rng.integers(0, SMALL["vocab_size"], (8, 16)).astype(np.int32)
    cfg = dict(quant="int8", block_size=64, max_buckets=4)

    def jloss(out, lab):
        return jnn.functional.cross_entropy(out.reshape(-1, out.shape[-1]), lab.reshape(-1))

    def tloss(out, lab):
        return torch.nn.functional.cross_entropy(out.reshape(-1, out.shape[-1]),
                                                 lab.reshape(-1).long())

    jtr = JSpmd(jm, jopt.SGD(0.5), jloss, jmesh.make_mesh({"dp": 4}, devices=jax.devices()[:4]),
                batch_axes=("dp",), comm=jcf.CommFusionConfig(**cfg))
    tr = SpmdTrainer(tm, topt.SGD(0.5), tloss, make_mesh({"dp": 4}, device="cpu"),
                     batch_axes=("dp",), comm=CommFusionConfig(**cfg), device="cpu")
    jl = [float(jtr.train_step(ids, labels)) for _ in range(2)]
    tl = [float(tr.train_step(torch.from_numpy(ids).long(), torch.from_numpy(labels)))
          for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    jend = jax.device_get(jtr.state["params"])
    got = params_of(tr)
    for k, p0 in w0.items():
        want = _key_bias_dropped(k, np.asarray(jend[k]) - p0, SMALL)
        mine = _key_bias_dropped(k, got[k] - p0, SMALL)
        assert np.linalg.norm(mine - want) <= 5e-2 * np.linalg.norm(want), k
