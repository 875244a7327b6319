"""``distributed.comm_fusion`` and the pre-reduction contract of
``distributed.meta_optimizers`` against the JAX package, on the CPU.

The port's ranks are threads over one device (``ops.collectives.run_ranks``);
JAX's are the 8 CPU devices ``tests/conftest.py`` gives it. Inputs come
from numpy seeds; models whose layouts must match JAX's leaf for leaf
(bucket layouts, int8 blocks) are a test-local ``Dense`` stack with JAX's
``[in, out]`` weights, so the weights cross as they are.

Tolerances:
- layouts, packing, int8 codes and scales: equal (bitwise) to JAX's;
- fused fp32 against the port's own unfused per-tensor rung: bitwise
  (both sum the ranks in rank order), as JAX's own gate holds it;
- the port against JAX (3 steps): fp32 and the GSPMD path rtol 1e-5 on
  losses, atol 1e-5 on params (XLA's matmuls and all-reduce associate
  their own sums); bf16 on the wire: losses rtol 1e-4, params atol 2e-4
  (one bf16 ulp a reduced element where JAX's CPU backend sums the
  chunks in f32); int8 with error feedback: losses rtol 1e-4, params
  atol 1e-3 (a code that rounds the other way on a last-bit gradient
  difference moves its element by a block's scale);
- JAX state carried into the port (``convert.spmd_*_from_jax``) and
  stepped: as its rung above.

The JAX tests that read compiled HLO (bucket count, int8 bytes, the bf16
wire, held GradientMerge steps, ZeRO-2's reduce-scatter) have no HLO to
read here: their counterparts record which collectives each rank's
reducer enters (``_Recorder`` patched over ``comm_fusion.coll``), with
each payload's dtype and element count, and assert the same contract,
byte counts by ``tools/hlo_bytes.py``'s ring model.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P
from torch import nn as tnn

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import mesh as jmesh
from paddle_tpu.distributed import DistributedStrategy as JStrategy
from paddle_tpu.distributed import comm_fusion as jcf
from paddle_tpu.distributed import meta_optimizers as jmo
from paddle_tpu.parallel import SpmdTrainer as JSpmd
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import (ernie_params_from_jax, spmd_opt_state_from_jax,
                                      spmd_state_from_jax)
from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.distributed import DistributedStrategy, comm_fusion as cf
from paddle_tpu_torch.distributed import meta_optimizers as tmo
from paddle_tpu_torch.distributed.comm_fusion import (CommFusionConfig, DpGradReducer,
                                                      _dequant_int8, _pack_bucket, _quant_int8,
                                                      _unpack_bucket, build_layout)
from paddle_tpu_torch.ops import collectives as coll
from paddle_tpu_torch.parallel import SpmdTrainer
from paddle_tpu_torch.parallel.spmd import RankSlices


# -- models and data -------------------------------------------------------------------------

class Dense(tnn.Module):
    """``x @ w + b`` with JAX's ``[in, out]`` weight (names and order as
    the JAX ``nn.Linear``'s), so a stack's leaves match JAX's."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = tnn.Parameter(torch.zeros(n_in, n_out))
        self.bias = tnn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.weight + self.bias


def jax_mlp(seed=0, widths=(8, 64, 64, 3)):
    pt.seed(seed)
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        layers += [jnn.Linear(a, b), jnn.ReLU()]
    return jnn.Sequential(*layers[:-1])


def port_mlp(jmodel, widths=(8, 64, 64, 3)):
    """The port's twin of ``jax_mlp``, holding the JAX model's weights."""
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        layers += [Dense(a, b), tnn.ReLU()]
    m = tnn.Sequential(*layers[:-1])
    m.load_state_dict(ernie_params_from_jax(dict(jmodel.named_parameters())))
    return m


def ce(out, y):
    return torch.nn.functional.cross_entropy(out, y.long())


def data(n=64, din=8, dout=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, din)).astype(np.float32),
            rng.integers(0, dout, n).astype(np.int32))


def jax_run(comm, steps=3, opt=None, strategy=None, shape=None, stage=0, batch_axes=("dp",),
            seed=0, x=None, y=None):
    """A JAX SpmdTrainer's start, its losses and its end params."""
    mesh = jmesh.make_mesh(shape or {"dp": 8})
    model = jax_mlp(seed)
    start = {k: np.asarray(v) for k, v in model.named_parameters()}
    tr = JSpmd(model, opt or jopt.SGD(0.1), jnn.functional.cross_entropy, mesh,
               zero_stage=stage, batch_axes=batch_axes, comm=comm, strategy=strategy)
    if x is None:
        x, y = data()
    losses = [float(tr.train_step(x, y)) for _ in range(steps)]
    end = {k: np.asarray(v) for k, v in jax.device_get(tr.state["params"]).items()}
    return {"start": start, "losses": losses, "end": end, "trainer": tr, "model": model}


def port_trainer(jmodel, comm, opt=None, strategy=None, shape=None, stage=0,
                 batch_axes=("dp",)):
    return SpmdTrainer(port_mlp(jmodel), opt or topt.SGD(0.1), ce,
                       make_mesh(shape or {"dp": 8}, device="cpu"), zero_stage=stage,
                       batch_axes=batch_axes, comm=comm, strategy=strategy, device="cpu")


def params_of(tr):
    return {k: v.numpy() for k, v in tr.full_state()[0]["params"].items()}


def close_to_jax(tr, run, steps, loss_rtol, atol, x=None, y=None):
    if x is None:
        x, y = data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    losses = [float(tr.train_step(x, y)) for _ in range(steps)]
    np.testing.assert_allclose(losses, run["losses"][:steps], rtol=loss_rtol)
    got = params_of(tr)
    for k, want in run["end"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=atol, err_msg=k)


class _Recorder:
    """Stands in for ``ops.collectives`` inside ``comm_fusion``: records
    (rank, op, dtype, elements) of every call each rank's reducer makes."""

    OPS = ("psum", "psum_scatter", "all_to_all", "all_gather")

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        fn = getattr(coll, name)
        if name not in self.OPS:
            return fn

        def wrapped(x, *a, **k):
            with self._lock:
                self.calls.append((coll._context().rank, name, cf.dtype_name(x.dtype), x.numel(),
                                   x.element_size()))
            return fn(x, *a, **k)

        return wrapped

    def rank(self, r, min_bytes=1024):
        """Rank r's data-plane calls (scalar flag psums dropped, as
        ``hlo_bytes.grad_collectives`` drops them)."""
        return [c[1:] for c in self.calls if c[0] == r and c[3] * c[4] >= min_bytes]


def wire_bytes(calls, n):
    """``tools/hlo_bytes.py``'s ring estimate of a participant's bytes:
    all-reduce 2(n-1)/n of the payload, reduce-scatter and all-to-all
    (n-1)/n of the operand, all-gather (n-1)/n of the result."""
    f = (n - 1) / n
    total = 0.0
    for op, _, numel, size in calls:
        b = numel * size
        total += {"psum": 2 * f * b, "psum_scatter": f * b, "all_to_all": f * b,
                  "all_gather": f * b * n}[op]
    return total


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The rank threads are the parallelism: torch's intra-op pool under
    8 of them only oversubscribes the cores (2x slower here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(cf, "coll", rec)
    return rec


# -- layout and quantization units -------------------------------------------------------------

LAYOUT_CASES = {
    "caps_dtype_groups": (tuple([((64, 64), "float32")] * 6 + [((128,), "int32")] * 2), 4,
                          dict(bucket_mb=0.02, max_buckets=5)),
    "grows_cap": (tuple([((1024,), "float32")] * 64), 2, dict(bucket_mb=0.001, max_buckets=3)),
    "dtypes_exceed_max_buckets": ((((4,), "float32"), ((4,), "bfloat16"), ((4,), "int32")), 2,
                                  dict(max_buckets=1)),
    "int8_block_pad": ((((3, 5), "float32"), ((7,), "float32"), ((0,), "float32")), 4,
                       dict(quant="int8", block_size=16)),
}


def _layout_tuple(layout):
    return [(b.dtype, b.seg_total, b.quantizable,
             [(s.index, tuple(s.shape), s.dtype, s.size, s.seg_len, s.offset) for s in b.slots])
            for b in layout.buckets]


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_equals_jax_and_is_cached(case):
    """Equal to JAX's slot for slot; per-dtype buckets, every leaf once,
    within max_buckets (or one a dtype, the floor); one object a key."""
    meta, K, kw = LAYOUT_CASES[case]
    layout = build_layout(meta, K, CommFusionConfig(**kw))
    assert _layout_tuple(layout) == _layout_tuple(jcf.build_layout(meta, K, jcf.CommFusionConfig(
        **kw)))
    for b in layout.buckets:
        assert len({s.dtype for s in b.slots}) == 1
    assert sorted(s.index for b in layout.buckets for s in b.slots) == list(range(len(meta)))
    n_dtypes = len({d for _, d in meta})
    assert len(layout.buckets) <= max(kw.get("max_buckets", 8), n_dtypes)
    assert build_layout(meta, K, CommFusionConfig(**kw)) is layout
    assert build_layout(meta, K * 2, CommFusionConfig(**kw)) is not layout


@pytest.mark.parametrize("shapes", [[(3, 5), (7,), (1,), (2, 3, 4)], [(3, 2), (0,)]],
                         ids=["odd_shapes", "zero_size_leaf"])
def test_pack_unpack_roundtrip_equals_jax(shapes):
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    meta = tuple((tuple(a.shape), "float32") for a in arrs)
    for cfg in (dict(), dict(quant="int8", block_size=8)):
        layout = build_layout(meta, 4, CommFusionConfig(**cfg))
        jlayout = jcf.build_layout(meta, 4, jcf.CommFusionConfig(**cfg))
        out = [None] * len(arrs)
        for b, jb in zip(layout.buckets, jlayout.buckets):
            buf = _pack_bucket([torch.from_numpy(a) for a in arrs], b, 4)
            assert buf.shape == (4, b.seg_total)
            np.testing.assert_array_equal(
                buf.numpy(), np.asarray(jcf._pack_bucket([jnp.asarray(a) for a in arrs], jb, 4)))
            for s, leaf in zip(b.slots, _unpack_bucket(buf, b, 4)):
                out[s.index] = leaf
        for a, got in zip(arrs, out):
            assert got.shape == a.shape
            np.testing.assert_array_equal(got.numpy(), a)


@pytest.mark.parametrize("kind", ["normal", "half_way", "zeros_and_tiny"])
def test_int8_codes_and_scales_bitwise_equal_jax(kind):
    rng = np.random.default_rng(1)
    if kind == "normal":
        x = (rng.normal(size=(4, 256)) * 10).astype(np.float32)
    elif kind == "half_way":   # x·(1/scale) lands on .5: half to even decides
        x = np.tile(np.arange(-127, 129, dtype=np.float32) / 2, (2, 1))
        x[:, 0] = 127.0
    else:
        x = (rng.normal(size=(3, 128)) * 1e-30).astype(np.float32)
        x[0] = 0.0
    q, sc = _quant_int8(torch.from_numpy(x), 64)
    jq, jsc = jcf._quant_int8(jnp.asarray(x), 64)
    assert q.dtype == torch.int8 and tuple(sc.shape) == tuple(jsc.shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    deq = _dequant_int8(q, sc, 64).numpy()
    np.testing.assert_array_equal(deq, np.asarray(jcf._dequant_int8(jq, jsc, 64)))
    # the JAX test's bound: each error within a block's scale, zeros exact
    amax = np.abs(x).reshape(x.shape[0], -1, 64).max(-1)
    err = np.abs(x - deq).reshape(x.shape[0], -1, 64)
    assert (err <= amax[..., None] / 127.0 + 1e-6).all()
    assert (deq[np.abs(x) == 0] == 0).all()


# -- fused fp32 against the per-tensor rung (bitwise), and against JAX -------------------------

def _lenet_pair():
    from paddle_tpu.models import LeNet as JLeNet
    from paddle_tpu_torch.convert import vision_params_from_jax
    from paddle_tpu_torch.models import LeNet

    pt.seed(0)
    jm = JLeNet(num_classes=10)
    tm = LeNet(num_classes=10)
    tm.load_state_dict(vision_params_from_jax(jnn.get_state(jm)))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 1, 28, 28)).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int32)
    return jm, tm, ((x,), y), jnn.functional.cross_entropy, ce


def _deepfm_pair():
    from paddle_tpu.models.ctr import CtrConfig as JCfg, DeepFM as JDeepFM
    from paddle_tpu_torch.convert import ctr_params_from_jax
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM

    kw = dict(num_sparse_slots=6, num_dense=5, embedx_dim=4, dnn_hidden=(32, 16))
    pt.seed(0)
    jm = JDeepFM(JCfg(**kw))
    tm = DeepFM(CtrConfig(**kw))
    tm.load_state_dict(ctr_params_from_jax(dict(jm.named_parameters())))
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(32, 6, 5)).astype(np.float32) * 0.1
    dense = rng.normal(size=(32, 5)).astype(np.float32)
    y = (rng.random(32) < 0.4).astype(np.float32)

    def bce(out, t):
        return torch.nn.functional.binary_cross_entropy_with_logits(out.reshape(t.shape), t)

    return jm, tm, ((emb, dense), y), jnn.functional.binary_cross_entropy_with_logits, bce


@pytest.mark.parametrize("pair,fused_cfg", [(_lenet_pair, dict(bucket_mb=0.05, max_buckets=4)),
                                            (_deepfm_pair, dict(max_buckets=2))],
                         ids=["lenet", "deepfm_dense"])
def test_fused_fp32_bit_identical_to_per_tensor(pair, fused_cfg):
    """Fusion alone changes no number: 3 fused steps equal 3 unfused ones
    bitwise; the first loss equals JAX's within rtol 1e-5."""
    import copy

    jm, tm, (inputs, y), jloss, tloss = pair()
    mesh = make_mesh({"dp": 8}, device="cpu")
    trs = [SpmdTrainer(copy.deepcopy(tm), topt.SGD(0.05), tloss, mesh, batch_axes=("dp",),
                       comm=CommFusionConfig(**cfg), device="cpu")
           for cfg in (dict(fuse=False), fused_cfg)]
    t_in = tuple(torch.from_numpy(a) for a in inputs)
    for _ in range(3):
        lb, lf = (tr.train_step(t_in, torch.from_numpy(y)) for tr in trs)
        assert torch.equal(lb, lf)
    for k, v in params_of(trs[0]).items():
        np.testing.assert_array_equal(v, params_of(trs[1])[k], err_msg=k)
    jtr = JSpmd(jm, jopt.SGD(0.05), jloss, jmesh.make_mesh({"dp": 8}), batch_axes=("dp",),
                comm=jcf.CommFusionConfig(**fused_cfg))
    first = SpmdTrainer(copy.deepcopy(tm), topt.SGD(0.05), tloss, mesh, batch_axes=("dp",),
                        comm=CommFusionConfig(**fused_cfg), device="cpu")
    np.testing.assert_allclose(float(first.train_step(t_in, torch.from_numpy(y))),
                               float(jtr.train_step(inputs, y)), rtol=1e-5)


def test_fused_matches_single_device_trainer():
    """dp=2 × sharding=4, fused: the serial trajectory (local mean +
    mean-reduce = the global mean), rtol 1e-6."""
    from paddle_tpu_torch.executor import Trainer

    jm = jax_mlp(0, (8, 16, 3))
    x, y = (torch.from_numpy(a) for a in data())
    serial = Trainer(port_mlp(jm, (8, 16, 3)), topt.SGD(0.1), ce, device="cpu")
    fused = SpmdTrainer(port_mlp(jm, (8, 16, 3)), topt.SGD(0.1), ce,
                        make_mesh({"dp": 2, "sharding": 4}, device="cpu"),
                        comm=CommFusionConfig(), device="cpu")
    for _ in range(5):
        np.testing.assert_allclose(float(serial.train_step(x, y)),
                                   float(fused.train_step(x, y)), rtol=1e-6)


@pytest.mark.parametrize("quant", ["none", "bf16", "int8"])
def test_fused_rungs_follow_jax(quant):
    """fp32, bf16 and int8 (error feedback carried) against JAX's fused
    trainer over dp=8, at the tolerances of the module docstring."""
    cfg = dict(max_buckets=2, quant=quant, block_size=64)
    run = jax_run(jcf.CommFusionConfig(**cfg))
    tr = port_trainer(run["model"], CommFusionConfig(**cfg))
    tol = {"none": (1e-5, 1e-5), "bf16": (1e-4, 2e-4), "int8": (1e-4, 1e-3)}[quant]
    close_to_jax(tr, run, 3, *tol)


# -- int8 with error feedback ------------------------------------------------------------------

def _mnist_like(rng, n):
    protos = (np.random.default_rng(99).random((10, 28, 28)) < 0.2).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = protos[y] + rng.normal(0, 0.25, (n, 28, 28)).astype(np.float32)
    return torch.from_numpy(x[:, None].astype(np.float32)), torch.from_numpy(y)


def test_int8_error_feedback_trains_lenet_to_fp32_accuracy():
    """The JAX acceptance: int8 with error feedback lands within 0.5 % of
    fp32's eval accuracy on the LeNet/MNIST-shaped task (60 steps)."""
    from paddle_tpu_torch.models import LeNet

    mesh = make_mesh({"dp": 8}, device="cpu")
    rng = np.random.default_rng(0)
    batches = [_mnist_like(rng, 64) for _ in range(4)]
    xte, yte = _mnist_like(np.random.default_rng(7), 256)
    torch.manual_seed(0)
    init = LeNet(num_classes=10).state_dict()

    def run(comm):
        m = LeNet(num_classes=10)
        m.load_state_dict(init)
        tr = SpmdTrainer(m, topt.Momentum(0.05, 0.9), ce, mesh, batch_axes=("dp",), comm=comm,
                         device="cpu")
        for i in range(60):
            tr.train_step(*batches[i % len(batches)])
        with torch.no_grad():
            return float((tr.sync_model()(xte).argmax(-1) == yte).float().mean())

    acc_fp32 = run(CommFusionConfig())
    acc_int8 = run(CommFusionConfig(quant="int8", block_size=128, error_feedback=True))
    assert acc_fp32 > 0.85, acc_fp32
    assert acc_int8 >= acc_fp32 - 0.005, (acc_int8, acc_fp32)


def test_int8_error_feedback_residual_is_carried():
    """The residual lives in the optimizer state, one a rank
    (``RankSlices`` of 8, stacked [8, …] whole), starts at zero, and after a
    step equals JAX's residual within 1e-5 but where a code rounded the
    other way (at most 0.1 % of elements, each within 1e-3)."""
    run = jax_run(jcf.CommFusionConfig(quant="int8", block_size=64), steps=1)
    tr = port_trainer(run["model"], CommFusionConfig(quant="int8", block_size=64))
    ef = tr.opt_state["ef"]
    assert ef and all(isinstance(v, RankSlices) and len(v.parts) == 8 for v in ef.values())
    assert all(bool((v.full() == 0).all()) for v in ef.values())
    x, y = (torch.from_numpy(a) for a in data())
    tr.train_step(x, y)
    assert any(bool((v.full() != 0).any()) for v in tr.opt_state["ef"].values())
    jef = jax.device_get(run["trainer"].opt_state["ef"])
    for k, v in tr.opt_state["ef"].items():
        assert tuple(v.full().shape) == np.asarray(jef[k]).shape == (8, 8 * (v.parts[0].numel()
                                                                              // 8))
        diff = np.abs(v.full().numpy() - np.asarray(jef[k]))
        # a code that rounded the other way moves its residual by up to a scale
        assert (diff > 1e-5).mean() <= 1e-3 and diff.max() <= 1e-3, diff.max()


# -- the wire, recorded --------------------------------------------------------------------------

def _record_step(recorder, comm, strategy=None, stage=0, shape=None, batch_axes=("dp",),
                 opt=None, steps=1):
    tr = port_trainer(jax_mlp(0), comm, opt=opt, strategy=strategy, shape=shape, stage=stage,
                      batch_axes=batch_axes)
    x, y = (torch.from_numpy(a) for a in data())
    per_step = []
    for _ in range(steps):
        recorder.calls.clear()
        tr.train_step(x, y)
        per_step.append(recorder.rank(0))
    return per_step if steps > 1 else per_step[0]


def test_bucket_count_and_int8_byte_acceptance(recorder):
    """At most max_buckets gradient collectives (one psum a bucket), never
    more than the per-tensor rung; int8 hands every collective int8 codes
    (and f32 scales) and moves ≥ 3.5× fewer bytes than fused fp32."""
    fused = _record_step(recorder, CommFusionConfig(max_buckets=2))
    assert 1 <= len(fused) <= 2 and {c[0] for c in fused} == {"psum"}, fused
    unfused = _record_step(recorder, CommFusionConfig(fuse=False))
    assert len(fused) <= len(unfused)
    int8 = _record_step(recorder, CommFusionConfig(quant="int8", max_buckets=2, block_size=64))
    assert {c[1] for c in int8 if c[3] == 1} == {"int8"}, int8
    assert {c[1] for c in int8} <= {"int8", "float32"}
    wb_f32, wb_int8 = wire_bytes(fused, 8), wire_bytes(int8, 8)
    assert wb_f32 >= 3.5 * wb_int8, (wb_f32, wb_int8)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused_rung"])
def test_fp16_allreduce_routes_bf16_onto_the_wire(recorder, fuse):
    """With fp16_allreduce in the chain every gradient collective's
    payload is bf16, fused or on the unfused per-tensor rung; without it
    f32."""
    comm = CommFusionConfig(max_buckets=2, fuse=fuse)
    half = _record_step(recorder, comm, strategy=DistributedStrategy(fp16_allreduce=True))
    assert half and {c[1] for c in half} == {"bfloat16"}, half
    plain = _record_step(recorder, comm)
    assert {c[1] for c in plain} == {"float32"}, plain


def test_strategy_fuse_all_reduce_ops_enables_fusion(recorder):
    strat = DistributedStrategy(fuse_all_reduce_ops=True, comm_fusion_configs={
        "max_buckets": 2, "quant": "int8", "block_size": 64})
    calls = _record_step(recorder, None, strategy=strat)
    assert {c[1] for c in calls if c[3] == 1} == {"int8"}, calls


def test_zero2_fused_reduce_scatters_and_never_all_reduces_a_bucket(recorder):
    calls = _record_step(recorder, CommFusionConfig(max_buckets=2), stage=2,
                         shape={"dp": 1, "sharding": 8}, batch_axes=("dp", "sharding"),
                         opt=topt.Adam(1e-2))
    ops = [c[0] for c in calls]
    assert "psum_scatter" in ops and "all_gather" in ops and "psum" not in ops, ops


def test_gradient_merge_held_steps_enter_no_collective(recorder):
    """GM k=2 over DGC and fp16: the held step enters no gradient
    collective, the applying one does; the chain trains."""
    strat = DistributedStrategy(dgc=True, fp16_allreduce=True, gradient_merge=True,
                                gradient_merge_configs={"k_steps": 2})
    held, applied = _record_step(recorder, CommFusionConfig(max_buckets=2), strategy=strat,
                                 opt=topt.Momentum(0.1), steps=2)
    assert held == [] and applied, (held, applied)
    tr = port_trainer(jax_mlp(0), CommFusionConfig(max_buckets=2), opt=topt.Momentum(0.1),
                      strategy=strat)
    x, y = (torch.from_numpy(a) for a in data())
    first = float(tr.train_step(x, y))
    for _ in range(6):
        last = float(tr.train_step(x, y))
    assert np.isfinite(last) and last < first


# -- ZeRO over the fused shards -----------------------------------------------------------------

def test_zero1_fused_shards_slots_and_matches_stage0():
    """Stage 1 fused keeps Adam's slots as flat 1/8 shards (each rank's
    part 1/8 of the padded leaf) and follows fused stage 0 bitwise; both
    follow JAX's stage-1 run at the fp32 tolerance."""
    shape = {"dp": 2, "sharding": 4}
    run = jax_run(jcf.CommFusionConfig(), steps=4, opt=jopt.Adam(1e-2), shape=shape, stage=1,
                  batch_axes=("dp", "sharding"))
    z0, z1 = (port_trainer(run["model"], CommFusionConfig(), opt=topt.Adam(1e-2), shape=shape,
                           stage=s, batch_axes=("dp", "sharding")) for s in (0, 1))
    x, y = (torch.from_numpy(a) for a in data())
    for _ in range(4):
        assert torch.equal(z0.train_step(x, y), z1.train_step(x, y))
    for k, v in params_of(z0).items():
        np.testing.assert_array_equal(v, params_of(z1)[k], err_msg=k)
    for k, leaf in z1.opt_state["inner"]["m"].items():
        assert isinstance(leaf, RankSlices) and len(leaf.parts) == 8 and leaf.dim == 0
        assert leaf.full().dim() == 1 and leaf.parts[0].numel() * 8 == leaf.full().numel()
    for k, want in run["end"].items():
        np.testing.assert_allclose(params_of(z1)[k], want, rtol=0, atol=1e-5, err_msg=k)


# -- the chain under the pre-reduction contract -------------------------------------------------

def test_composition_order_and_reducer_wiring():
    reducer = DpGradReducer(("dp",), (4,), CommFusionConfig(quant="int8", block_size=64))
    strat = DistributedStrategy(dgc=True, fp16_allreduce=True, localsgd=True,
                                localsgd_configs={"k_steps": 2}, gradient_merge=True,
                                gradient_merge_configs={"k_steps": 2})
    chain = tmo.apply_strategy(topt.Momentum(0.1), strat, reducer=reducer)
    want = [tmo.GradientMergeOptimizer, tmo.LocalSGDOptimizer, tmo.FP16AllReduceOptimizer,
            tmo.DGCMomentumOptimizer, tmo.FusedAllReduceOptimizer, topt.SGD]
    jchain = jmo.apply_strategy(jopt.Momentum(0.1), JStrategy(
        dgc=True, fp16_allreduce=True, localsgd=True, localsgd_configs={"k_steps": 2},
        gradient_merge=True, gradient_merge_configs={"k_steps": 2}),
        reducer=jcf.DpGradReducer(("dp",), (4,), jcf.CommFusionConfig(quant="int8",
                                                                      block_size=64)))
    node, jnode = chain, jchain
    for cls in want:
        assert isinstance(node, cls) and type(jnode).__name__ == cls.__name__
        node, jnode = getattr(node, "inner", None), getattr(jnode, "inner", None)
    assert reducer.installed and chain.inner.axis == ("dp",)
    st = chain.init({"w": torch.ones(8, 8)})
    tags = chain.state_layout(st)
    assert set(tags["acc"].values()) == {"local"}
    inner3 = tags["inner"]["inner"]["inner"]
    assert set(inner3["u"].values()) == set(inner3["v"].values()) == {"local"}
    assert set(inner3["inner"]["ef"].values()) == {"local"}
    assert inner3["inner"]["inner"] == {"step": "rep"}


def _full_stack(mod, opt_mod, strat_cls, reducer):
    strat = strat_cls(dgc=True, dgc_configs={"rampup_begin_step": 100}, fp16_allreduce=True,
                      localsgd=True, localsgd_configs={"k_steps": 2}, gradient_merge=True,
                      gradient_merge_configs={"k_steps": 2})
    return mod.apply_strategy(opt_mod.Momentum(0.5, momentum=0.0), strat, reducer=reducer)


def test_full_stack_dgc_fp16_localsgd_gm_semantics():
    """DGC → fp16 → localsgd → gm on 4 ranks with per-rank state: held GM
    steps change nothing, applied steps update locally (ranks diverge),
    the second applied step re-syncs them — and every rank's params after
    each step equal JAX's shard_map run within 1e-6."""
    R = 4
    g = np.arange(R * 32, dtype=np.float32).reshape(R, 4, 8) / 100.0
    # JAX
    jchain = _full_stack(jmo, jopt, JStrategy,
                         jcf.DpGradReducer(("dp",), (R,), jcf.CommFusionConfig()))
    params0 = {"w": jnp.ones((4, 8), jnp.float32)}
    expand = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(np.broadcast_to(np.asarray(x), (R,) + np.asarray(x).shape).copy()),
        t)
    jp, js = expand(params0), expand(jchain.init(params0))

    def jstep(p, s, gr):
        sq = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)  # noqa: E731
        ex = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)  # noqa: E731
        np_, ns_ = jchain.update({"w": gr[0]}, sq(s), sq(p))
        return ex(np_), ex(ns_)

    fn = jax.jit(shard_map(jstep, mesh=JMesh(np.array(jax.devices()[:R]), ("dp",)),
                           in_specs=(P("dp"), P("dp"), P("dp")), out_specs=(P("dp"), P("dp")),
                           check_vma=False))
    jw = []
    for _ in range(4):
        jp, js = fn(jp, js, jnp.asarray(g))
        jw.append(np.asarray(jp["w"]))
    # the port: each rank its own params and state
    chain = _full_stack(tmo, topt, DistributedStrategy,
                        DpGradReducer(("dp",), (R,), CommFusionConfig()))
    st0 = chain.init({"w": torch.ones(4, 8)})
    ps = [{"w": torch.ones(4, 8)} for _ in range(R)]
    sts = [st0] * R
    mesh = make_mesh({"dp": R}, device="cpu")
    tw = []
    for _ in range(4):
        out = coll.run_ranks(mesh, lambda r: chain.update({"w": torch.from_numpy(g[r])}, sts[r],
                                                          ps[r]))
        ps, sts = [o[0] for o in out], [o[1] for o in out]
        tw.append(np.stack([p["w"].numpy() for p in ps]))
    w0 = np.ones((R, 4, 8), np.float32)
    assert np.array_equal(tw[0], w0)                       # held
    assert not np.allclose(tw[1][0], tw[1][1])             # local steps diverge
    assert np.array_equal(tw[2], tw[1])                    # held again
    for r in range(1, R):                                  # localsgd's sync
        np.testing.assert_allclose(tw[3][r], tw[3][0], rtol=1e-6)
    for t, j in zip(tw, jw):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_gm_fused_matches_serial_gm():
    """GM k=2 over the fused dp path = the serial GM trainer on the whole
    batch (rtol 1e-6)."""
    from paddle_tpu_torch.executor import Trainer

    strat = DistributedStrategy(gradient_merge=True, gradient_merge_configs={"k_steps": 2})
    jm = jax_mlp(0, (8, 16, 3))
    x, y = (torch.from_numpy(a) for a in data())
    serial = Trainer(port_mlp(jm, (8, 16, 3)), tmo.apply_strategy(topt.SGD(0.1), strat), ce,
                     device="cpu")
    fused = SpmdTrainer(port_mlp(jm, (8, 16, 3)), topt.SGD(0.1), ce,
                        make_mesh({"dp": 8}, device="cpu"), batch_axes=("dp",),
                        comm=CommFusionConfig(), strategy=strat, device="cpu")
    for _ in range(4):
        np.testing.assert_allclose(float(serial.train_step(x, y)), float(fused.train_step(x, y)),
                                   rtol=1e-6)


def test_localsgd_rejected_on_fused_trainer():
    with pytest.raises(Exception, match="localsgd"):
        port_trainer(jax_mlp(0), CommFusionConfig(), strategy=DistributedStrategy(localsgd=True))


def test_amp_nonfinite_skip_is_uniform_across_ranks():
    """One rank's NaN makes every rank skip: params stay, the scale halves,
    the next clean step applies."""
    strat = DistributedStrategy(amp=True, amp_configs={"init_loss_scaling": 1024.0,
                                                       "decr_every_n_nan_or_inf": 1})
    tr = port_trainer(jax_mlp(0), CommFusionConfig(), strategy=strat)
    x, y = data()
    p0 = params_of(tr)
    bad = x.copy()
    bad[:8] = np.nan          # rank 0's shard only
    tr.train_step(torch.from_numpy(bad), torch.from_numpy(y))
    for k, v in params_of(tr).items():
        np.testing.assert_array_equal(v, p0[k], err_msg=k)
    assert float(tr.opt_state["scaler"].loss_scale) == 512.0
    assert np.isfinite(float(tr.train_step(torch.from_numpy(x), torch.from_numpy(y))))


def test_fused_trainer_save_load_resume(tmp_path):
    """Per-rank residuals and flat-shard slots survive the snapshot: a
    trainer of another seed, loaded, continues the trajectory bitwise."""
    shape = {"dp": 2, "sharding": 4}
    comm = CommFusionConfig(quant="int8", block_size=64)

    def build(seed):
        torch.manual_seed(seed)
        return SpmdTrainer(tnn.Linear(8, 3), topt.Adam(1e-2), ce,
                           make_mesh(shape, device="cpu"), zero_stage=1, comm=comm,
                           device="cpu")

    x, y = (torch.from_numpy(a) for a in data(32))
    a = build(0)
    for _ in range(3):
        a.train_step(x, y)
    a.save(str(tmp_path / "snap"))
    la = [float(a.train_step(x, y)) for _ in range(3)]
    b = build(5)
    b.load(str(tmp_path / "snap"))
    assert b.global_step == 3
    assert [float(b.train_step(x, y)) for _ in range(3)] == la


def test_jax_state_resumes_in_the_port():
    """Save-side JAX, load-side port: a JAX fused int8 ZeRO-1 trainer's
    state after 2 steps (flat shard slots, per-rank residuals) carried by
    ``convert.spmd_*_from_jax`` into a port trainer; 2 more steps on both
    agree at the int8 tolerance."""
    shape = {"dp": 2, "sharding": 4}
    cfg = dict(quant="int8", block_size=64)
    run = jax_run(jcf.CommFusionConfig(**cfg), steps=2, opt=jopt.Adam(1e-2), shape=shape,
                  stage=1, batch_axes=("dp", "sharding"))
    jtr = run["trainer"]
    tr = port_trainer(jax_mlp(7), CommFusionConfig(**cfg), opt=topt.Adam(1e-2), shape=shape,
                      stage=1, batch_axes=("dp", "sharding"))
    jstate = jax.device_get(jtr.state)
    tr.restore(spmd_state_from_jax(jstate, params_from_jax=ernie_params_from_jax),
               spmd_opt_state_from_jax(jax.device_get(jtr.opt_state), tr, jstate["params"],
                                       params_from_jax=ernie_params_from_jax), step=2)
    x, y = data()
    want = [float(jtr.train_step(x, y)) for _ in range(2)]
    end = {k: np.asarray(v) for k, v in jax.device_get(jtr.state["params"]).items()}
    got = [float(tr.train_step(torch.from_numpy(x), torch.from_numpy(y))) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for k, v in params_of(tr).items():
        np.testing.assert_allclose(v, end[k], rtol=0, atol=1e-3, err_msg=k)


def test_dp1_path_unchanged():
    """A batch group of one rank ignores comm: the GSPMD path, no reducer."""
    tr = port_trainer(jax_mlp(0), CommFusionConfig(), shape={"dp": 1, "sharding": 1, "mp": 8},
                      batch_axes=("dp", "sharding"))
    assert not hasattr(tr, "reducer")
    assert np.isfinite(float(tr.train_step(torch.zeros(8, 8), torch.zeros(8, dtype=torch.int32))))


def test_reducer_wire_override_and_suspend():
    """``wire_dtype`` narrows the reduced mean to bf16 precision (and equals
    JAX's within one bf16 ulp), ``suspended()`` returns the local
    gradients untouched, the plain mean equals JAX's within rtol 1e-6."""
    g = np.linspace(0.001, 1.0, 8 * 16, dtype=np.float32).reshape(8, 16)
    r = DpGradReducer(("dp",), (8,), CommFusionConfig())

    def rank(i):
        tree = {"g": torch.from_numpy(g[i])}
        plain, _ = r.reduce(tree, {})
        with r.wire_dtype(torch.bfloat16):
            cast, _ = r.reduce(tree, {})
        with r.suspended():
            local, _ = r.reduce(tree, {})
        return plain["g"], cast["g"], local["g"]

    out = coll.run_ranks(make_mesh({"dp": 8}, device="cpu"), rank)
    jr = jcf.DpGradReducer(("dp",), (8,), jcf.CommFusionConfig())

    def f(gr):
        tree = {"g": gr[0]}
        with jr.wire_dtype(jnp.bfloat16):
            cast, _ = jr.reduce(tree, {})
        return cast["g"][None]

    jcast = np.asarray(jax.jit(shard_map(f, mesh=JMesh(np.array(jax.devices()), ("dp",)),
                                         in_specs=(P("dp"),), out_specs=P("dp"),
                                         check_vma=False))(jnp.asarray(g)))
    expect = g.mean(0)
    for i, (plain, cast, local) in enumerate(out):
        np.testing.assert_allclose(plain.numpy(), expect, rtol=1e-6)
        np.testing.assert_allclose(cast.numpy(), expect, rtol=2e-2)
        assert float((cast - torch.from_numpy(expect)).abs().max()) > 0
        ulp = np.abs(jcast[i]).astype(np.float32) * 2.0 ** -7
        assert (np.abs(cast.numpy() - jcast[i]) <= ulp).all()
        np.testing.assert_array_equal(local.numpy(), g[i])
