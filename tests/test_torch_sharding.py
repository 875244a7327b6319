"""``parallel.sharding`` (ShardingStage1-3, ``group_sharded_parallel``)
against the JAX package's, on the CPU: the JAX test's cases on a
dp=2 × sharding=4 mesh (JAX's 8 CPU devices; the port's logical ranks),
the same numpy-seeded weights (JAX's ``[in, out]`` layout, a test-local
two-layer MLP) and batches.

Tolerances: against the port's serial ``executor.Trainer`` the JAX
test's own (losses rtol 2e-4, atol 2e-5); against JAX's stages, 5 Adam
steps: losses rtol 1e-5, params atol 1e-5 (XLA sums in its own order).
ZeRO-2's comm pattern (JAX reads it from the compiled HLO) is held by
recording the collectives each rank of the stage-2 step enters
(``ops.collectives`` patched in ``parallel.spmd``).
"""

import threading

import jax
import numpy as np
import pytest
import torch
from torch import nn as tnn

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.parallel import sharding as jsharding
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import ernie_params_from_jax
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.executor import Trainer
from paddle_tpu_torch.ops import collectives as coll
from paddle_tpu_torch.parallel import spmd
from paddle_tpu_torch.parallel.sharding import (ShardingStage1, ShardingStage2, ShardingStage3,
                                                group_sharded_parallel)
from paddle_tpu_torch.parallel.spmd import RankSlices
from test_torch_comm_fusion import Dense, ce, params_of
from test_torch_comm_fusion import one_intra_op_thread  # noqa: F401  (the fixture)

SHAPE = {"dp": 2, "sharding": 4}
STAGES = {1: ShardingStage1, 2: ShardingStage2, 3: ShardingStage3}


class _JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = jnn.Linear(16, 64)
        self.l2 = jnn.Linear(64, 4)

    def forward(self, x):
        return self.l2(jnn.functional.relu(self.l1(x)))


class _MLP(tnn.Module):
    def __init__(self):
        super().__init__()
        self.l1 = Dense(16, 64)
        self.l2 = Dense(64, 4)

    def forward(self, x):
        return self.l2(torch.relu(self.l1(x)))


def _pair(seed=0):
    pt.seed(seed)
    jm = _JMLP()
    tm = _MLP()
    tm.load_state_dict(ernie_params_from_jax(dict(jm.named_parameters())))
    return jm, tm


def _data(rng, n=64):
    y = rng.integers(0, 4, n)
    x = rng.normal(0, 0.2, (n, 16)).astype(np.float32)
    x[np.arange(n), y] += 2.0
    return x, y.astype(np.int32)


def _mesh():
    return make_mesh(SHAPE, device="cpu")


def _t(x, y):
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_trains(stage):
    _, tm = _pair(0)
    tr = STAGES[stage](tm, topt.Adam(5e-3)).trainer(ce, _mesh(), device="cpu")
    rng = np.random.default_rng(0)
    losses = [float(tr.train_step(*_t(*_data(rng)))) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_stage3_params_actually_sharded():
    """l1's [16, 64] weight: 4 slices of 16 columns at stage 3 (JAX's
    spec puts 'sharding' on its dim 1); whole at stage 1."""
    _, tm = _pair(0)
    tr = ShardingStage3(tm, topt.Adam(1e-3)).trainer(ce, _mesh(), device="cpu")
    w = tr.state["params"]["l1.weight"]
    assert isinstance(w, RankSlices) and w.dim == 1 and [tuple(p.shape) for p in w.parts] == \
        [(16, 16)] * 4
    _, tm1 = _pair(0)
    tr1 = ShardingStage1(tm1, topt.Adam(1e-3)).trainer(ce, _mesh(), device="cpu")
    assert isinstance(tr1.state["params"]["l1.weight"], torch.Tensor)


def test_opt_state_sharded_from_stage1():
    _, tm = _pair(0)
    tr = ShardingStage1(tm, topt.Adam(1e-3)).trainer(ce, _mesh(), device="cpu")
    sliced = [v for slot in ("m", "v") for v in tr.opt_state[slot].values()
              if isinstance(v, RankSlices)]
    assert sliced and all(len(v.parts) == 4 and v.parts[0].shape[v.dim] * 4 ==
                          v.full().shape[v.dim] for v in sliced)
    assert isinstance(tr.opt_state["step"], torch.Tensor)


def test_group_sharded_parallel_levels():
    _, tm = _pair(0)
    opt = topt.Adam(1e-3)
    assert group_sharded_parallel(tm, opt, "os").stage == 1
    assert group_sharded_parallel(tm, opt, "os_g").stage == 2
    assert group_sharded_parallel(tm, opt, "p_g_os").stage == 3
    for level in ("os", "os_g", "p_g_os"):
        assert jsharding.group_sharded_parallel(_JMLP(), jopt.Adam(1e-3), level).stage == \
            group_sharded_parallel(tm, opt, level).stage
    with pytest.raises(InvalidArgumentError, match="level"):
        group_sharded_parallel(tm, opt, "bogus")
    with pytest.raises(InvalidArgumentError, match="sharding"):
        ShardingStage1(tm, opt).trainer(ce, make_mesh({"dp": 8}, device="cpu"), device="cpu")


def test_stages_match_single_device_trajectory():
    """Stage 2 (the reduce-scatter step) = the serial trainer (the JAX
    test's oracle and tolerance)."""
    rng = np.random.default_rng(3)
    batches = [_t(*_data(rng)) for _ in range(5)]
    _, tm = _pair(7)
    tr = ShardingStage2(tm, topt.Adam(1e-3)).trainer(ce, _mesh(), device="cpu")
    _, tm1 = _pair(7)
    single = Trainer(tm1, topt.Adam(1e-3), ce, device="cpu")
    np.testing.assert_allclose([float(tr.train_step(x, y)) for x, y in batches],
                               [float(single.train_step(x, y)) for x, y in batches],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_follows_jax(stage):
    """5 Adam steps of each stage against JAX's same stage."""
    jm, tm = _pair(1)
    jtr = jsharding._STAGES[stage](jm, jopt.Adam(1e-2)).trainer(
        jnn.functional.cross_entropy, jmesh.make_mesh(SHAPE))
    tr = STAGES[stage](tm, topt.Adam(1e-2)).trainer(ce, _mesh(), device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(5):
        x, y = _data(rng)
        np.testing.assert_allclose(float(tr.train_step(*_t(x, y))), float(jtr.train_step(x, y)),
                                   rtol=1e-5)
    jend = jax.device_get(jtr.state["params"])
    for k, v in params_of(tr).items():
        np.testing.assert_allclose(v, np.asarray(jend[k]), rtol=0, atol=1e-5, err_msg=k)


class _Recorder:
    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        fn = getattr(coll, name)
        if name not in ("psum", "psum_scatter", "all_gather"):
            return fn

        def wrapped(x, axis, *a, **k):
            with self._lock:
                self.calls.append((coll._context().rank, name, axis, x.numel()))
            return fn(x, axis, *a, **k)

        return wrapped


def test_stage2_reduce_scatters_its_grads(monkeypatch):
    """ZeRO-2's pattern: every rank reduce-scatters each divisible
    gradient over 'sharding' (never all-reduces it whole) and all-gathers
    each updated param; stage 1 (the GSPMD path) enters no collective."""
    rec = _Recorder()
    monkeypatch.setattr(spmd, "coll", rec)
    x, y = _t(*_data(np.random.default_rng(0), 16))
    for level in ("os_g", "os"):
        rec.calls.clear()
        _, tm = _pair(0)
        group_sharded_parallel(tm, topt.Adam(1e-3), level).trainer(
            ce, _mesh(), device="cpu").train_step(x, y)
        if level == "os":
            assert rec.calls == []
            continue
        for r in range(8):
            mine = [c[1:] for c in rec.calls if c[0] == r and c[2] == "sharding"]
            ops = [op for op, _, _ in mine]
            # l1.weight [16, 64], l1.bias [64], l2.weight [64, 4]: divisible; l2.bias [4] too
            assert ops.count("psum_scatter") >= 2 and ops.count("all_gather") >= 2, ops
            big = [op for op, _, n in mine if n >= 64]
            assert "psum" not in big, mine
