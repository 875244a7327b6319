"""The port's second slice: streaming CTR training over the persistent hot
tier (``CtrStreamTrainer`` + ``HotEmbeddingTier``), on the CPU.

Three groups:

- the dynamic key map's host mirror against the JAX package's, array for
  array, after the same inserts, removes and rebuilds (exact);
- the slice against the JAX trainer, from converted weights on the same
  MultiSlot lines (the harness of ``tests/test_hot_tier.py``: S=3, D=2,
  dim 8, DNN (8,), batch 64, 256 records). Losses agree to rtol 1e-5;
  dense params to rtol 1e-4 / atol 1e-6 and table rows to rtol 1e-4 /
  atol 1e-5. The rows are not bitwise because the dense matmuls (and
  their gradients, which become the pushed embedding gradients) run in
  another order through XLA's and PyTorch's CPU BLAS, and XLA contracts
  the dense Adam update into FMAs; the difference compounds over steps;
- the parity contract INSIDE the port, bitwise: the hot-tier trainer
  equals the tier-less trainer (dense params, Adam state, table rows mod
  ``delta_score``, save column 2, which folds per flush instead of per
  push), with and without eviction churn; ``kernels="auto"`` equals
  ``"unfused"``; flush → drop → resume stays exact.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.data.dataset import InMemoryDataset as JaxDataset
from paddle_tpu.data.dataset import SlotDesc as JaxSlotDesc
from paddle_tpu.models.ctr import CtrConfig as JaxCtrConfig
from paddle_tpu.models.ctr import DeepFM as JaxDeepFM
from paddle_tpu.ps.device_hash import DynamicDeviceKeyMap as JaxMap
from paddle_tpu.ps.hot_tier import HotTierConfig as JaxHotTierConfig
from paddle_tpu.ps.ps_trainer import CtrStreamTrainer as JaxTrainer
from paddle_tpu.ps.table import MemorySparseTable as JaxTable
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.device_hash import DynamicDeviceKeyMap, split_keys
from paddle_tpu_torch.ps.hot_tier import HotTierConfig
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

S, D, DIM, BATCH = 3, 2, 8, 64
_DELTA_COL = 2  # save-layout delta_score: folds per flush, not per push
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ROW_TOL = dict(rtol=1e-4, atol=1e-5)


# -- the dynamic key map ----------------------------------------------------


def _assert_map_equal(j: JaxMap, t: DynamicDeviceKeyMap):
    for name in ("hi", "lo", "row"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert (int(t.seed), t.nbuckets, t.rebuilds, t.used, t.tombstones) == \
        (int(j.seed), j.nbuckets, j.rebuilds, j.used, j.tombstones)
    dev = t.device_state()
    np.testing.assert_array_equal(dev["hi"].numpy().view(np.uint32), j.hi)
    np.testing.assert_array_equal(dev["lo"].numpy().view(np.uint32), j.lo)
    np.testing.assert_array_equal(dev["row"].numpy(), j.row)
    assert int(dev["seed"]) & 0xFFFFFFFF == int(j.seed)


@pytest.mark.parametrize("layout", [dict(), dict(banks=4),
                                    dict(bucket_slots=1, probe_buckets=1)])
def test_dynamic_map_mirror_equals_jax(layout):
    """Same inserts, removes (tombstones + patch path), re-inserts and a
    grow rebuild → identical arrays, seed, size and rebuild count; the
    device state tracks the mirror through patches and rebuilds."""
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(1, 2**63, 200).astype(np.uint64))[:96]
    rows = np.arange(len(keys), dtype=np.int32)
    j, t = JaxMap(128, **layout), DynamicDeviceKeyMap(128, device="cpu", **layout)
    _assert_map_equal(j, t)
    for m in (j, t):
        m.insert(keys[:64], rows[:64])
    _assert_map_equal(j, t)
    for m in (j, t):
        m.remove(keys[:64:3])
        m.insert(keys[64:], rows[64:])
    _assert_map_equal(j, t)
    for m in (j, t):
        m._rebuild(grow=True)
    _assert_map_equal(j, t)
    np.testing.assert_array_equal(t.lookup_host(keys), j.lookup_host(keys))
    hi, lo = split_keys(keys)
    got = t.lookup(torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), j.lookup_host(keys))


def test_dynamic_map_over_capacity_raises():
    m = DynamicDeviceKeyMap(4, device="cpu")
    with pytest.raises(Exception, match="over capacity"):
        m.insert(np.arange(1, 7, dtype=np.uint64), np.arange(6, dtype=np.int32))


# -- the trainer harness ------------------------------------------------------


def _lines(n=256, seed=0, nid=48):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ids = rng.integers(0, nid, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                              + [f"1 {label}"]))
    return lines


def _dataset(cls, desc, lines):
    slots = ([desc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [desc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [desc("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=0)
    ds.load_from_lines(lines)
    return ds


_NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
              dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


def _table(initial_range=None):
    """A 4-shard host table. Pass ``initial_range=0.0`` when rows may
    cross ``embedx_threshold`` while resident: the host creates embedx
    with uniform(±initial_range) noise, the device from zeros (the JAX
    package's documented parity precondition)."""
    if initial_range is None:
        return MemorySparseTable(TableConfig(shard_num=4))
    return MemorySparseTable(TableConfig(shard_num=4, accessor_config=AccessorConfig(
        sgd=SGDRuleConfig(initial_range=initial_range))))


def _trainer(table, hot=None):
    model = DeepFM(CtrConfig(S, D, DIM, (8,)), generator=torch.Generator().manual_seed(0))
    return CtrStreamTrainer(model, Adam(1e-2), table, embedx_dim=DIM, hot_tier=hot,
                            device="cpu", **_NAMES)


def _rows(table):
    k, v = table.snapshot_items()
    i = np.argsort(k)
    return k[i], v[i]


def _assert_rows_equal_mod_delta(ta, tb):
    ka, va = _rows(ta)
    kb, vb = _rows(tb)
    np.testing.assert_array_equal(ka, kb)
    keep = [c for c in range(va.shape[1]) if c != _DELTA_COL]
    np.testing.assert_array_equal(va[:, keep], vb[:, keep])


def _assert_dense_equal(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.opt_state["step"], b.opt_state["step"])
    for slot in ("m", "v"):
        for k in a.opt_state[slot]:
            assert torch.equal(a.opt_state[slot][k], b.opt_state[slot][k]), (slot, k)


def test_slice_matches_jax_trainer():
    """Two epochs of the JAX hot-tier stream trainer and the port's, from
    the same weights, on the same lines (tolerances: module docstring)."""
    lines = _lines()
    jtable = JaxTable(JaxTableConfig(shard_num=4, backend="python"))
    pt.seed(0)
    j = JaxTrainer(JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=DIM,
                                          dnn_hidden=(8,))),
                   jax_optimizer.Adam(1e-2), jtable, embedx_dim=DIM,
                   hot_tier=JaxHotTierConfig(capacity=256), **_NAMES)
    ttable = _table()
    t = _trainer(ttable, HotTierConfig(capacity=256))
    t.params = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
    t.opt_state = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, j.opt_state))
    jds = _dataset(JaxDataset, JaxSlotDesc, lines)
    tds = _dataset(InMemoryDataset, SlotDesc, lines)
    for _ in range(2):
        jr = j.train_from_dataset(jds, batch_size=BATCH)
        tr = t.train_from_dataset(tds, batch_size=BATCH)
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=LOSS_RTOL)
        assert tr["steps"] == jr["steps"] == 4
        for key in ("hits", "misses", "cold_fetches", "occupancy", "evictions"):
            assert tr["hot_tier"][key] == jr["hot_tier"][key], key
    j.hot_tier.flush()
    t.hot_tier.flush()
    want = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
    for k, w in want.items():
        np.testing.assert_allclose(t.params[k].numpy(), w.numpy(), err_msg=k, **PARAM_TOL)
    jk, jv = jtable.snapshot_items()
    jv = jv[np.argsort(jk)]
    tk, tv = _rows(ttable)
    np.testing.assert_array_equal(tk, np.sort(jk))
    np.testing.assert_allclose(tv, jv, **ROW_TOL)


@pytest.mark.parametrize("nid,capacity", [(48, 256), (400, 224)],
                         ids=["resident", "eviction_churn"])
def test_hot_tier_equals_tierless_trainer(nid, capacity):
    """The parity contract, bitwise: with the tier (and through eviction
    churn at capacity 224, barely above one batch's 192 keys) the loss,
    dense params, Adam state and every table row but delta_score equal
    the tier-less trainer's."""
    lines = _lines(nid=nid)
    ta, tb = _table(), _table()
    a, b = _trainer(ta), _trainer(tb, HotTierConfig(capacity=capacity))
    ra = a.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=BATCH)
    rb = b.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=BATCH)
    b.hot_tier.flush()
    assert ra["loss"] == rb["loss"]
    _assert_dense_equal(a, b)
    _assert_rows_equal_mod_delta(ta, tb)
    st = rb["hot_tier"]
    assert st["misses"] > 0 and st["hits"] > 0
    if capacity == 224:
        assert st["evictions"] > 0 and st["writebacks"] > 0
    else:
        assert st["evictions"] == 0


def test_fused_equals_unfused():
    """``kernels="auto"`` (hot_probe_gather + hot_scatter_apply) and
    ``"unfused"`` (dynamic_map_lookup + cache_pull + cache_push) train
    bit-identically, through eviction churn."""
    lines = _lines(nid=400)
    ta, tb = _table(), _table()
    a = _trainer(ta, HotTierConfig(capacity=224, kernels="auto"))
    b = _trainer(tb, HotTierConfig(capacity=224, kernels="unfused"))
    for _ in range(2):
        ra = a.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=BATCH)
        rb = b.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=BATCH)
        assert ra["loss"] == rb["loss"]
    for k in a.hot_tier.state:
        assert torch.equal(a.hot_tier.state[k], b.hot_tier.state[k]), k
    _assert_dense_equal(a, b)
    a.hot_tier.flush()
    b.hot_tier.flush()
    _assert_rows_equal_mod_delta(ta, tb)
    assert a.hot_tier.stats()["kernels"] == "auto"


def test_capacity_below_batch_working_set_raises():
    t = _trainer(_table(), HotTierConfig(capacity=64))  # < 64*3 keys
    with pytest.raises(Exception, match="capacity"):
        t.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, _lines(nid=400)),
                             batch_size=BATCH)


def test_flush_drop_resume_exact():
    """Epoch 1, flush, drop the resident set, epoch 2 (refilled from the
    cold table) ≡ two epochs of the tier-less trainer."""
    lines = _lines(nid=120)
    ta, tb = _table(0.0), _table(0.0)
    a, b = _trainer(ta), _trainer(tb, HotTierConfig(capacity=256))
    for epoch in range(2):
        a.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=BATCH)
        rb = b.train_from_dataset(_dataset(InMemoryDataset, SlotDesc, lines), batch_size=BATCH)
        assert b.hot_tier.flush() > 0
        if epoch == 0:
            b.hot_tier.drop()
            assert b.hot_tier.stats()["occupancy"] == 0
    assert rb["hot_tier"]["cold_fetches"] >= 2
    _assert_dense_equal(a, b)
    _assert_rows_equal_mod_delta(ta, tb)


def test_mesh_and_communicator_raise():
    """A mesh is accepted (the sharded tier; its tests are in
    ``test_torch_sharded_hot_tier.py``); measured placement constructs
    (forcing pull-ahead 0) and, as in JAX, raises beside a hot tier: the
    tier owns its table's residency. (The communicator is ported:
    ``test_torch_stream_rpc.py``; placement's runs:
    ``test_torch_placement.py``.)"""
    from paddle_tpu_torch.core.enforce import PreconditionNotMetError
    from paddle_tpu_torch.core.mesh import make_mesh

    t = _trainer(_table(), HotTierConfig(capacity=256, mesh=make_mesh({"ps": 2}, device="cpu")))
    assert t.hot_tier.stats()["shards"] == 2
    model = DeepFM(CtrConfig(S, D, DIM, (8,)))
    mgr = object()
    placed = CtrStreamTrainer(model, Adam(), _table(), placement=mgr, pull_ahead=2,
                              device="cpu", **_NAMES)
    assert placed.placement is mgr and placed.pull_ahead == 0
    with pytest.raises(PreconditionNotMetError, match="placement and hot_tier"):
        CtrStreamTrainer(model, Adam(), _table(), placement=mgr,
                         hot_tier=HotTierConfig(capacity=256), device="cpu", **_NAMES)


@pytest.mark.parametrize("hot", [False, True], ids=["local_table", "hot_tier"])
def test_amp_trainer_matches_jax_under_auto_cast(hot):
    """``CtrStreamTrainer(amp=True)`` against the JAX stream trainer whose
    jitted steps are first called inside ``amp.auto_cast()`` (the JAX
    trainer takes no ``amp``; its steps follow a call-site context), two
    epochs from the same weights. Tolerances: losses rtol 1e-3; dense
    params and the table's rows within 1e-2 of each tensor's (column's)
    largest value: the port rounds the tower's cotangent to bf16
    (ROADMAP Queue C)."""
    from paddle_tpu import amp as jamp

    lines = _lines(seed=4)
    jtable = JaxTable(JaxTableConfig(shard_num=4, backend="python"))
    pt.seed(0)
    j = JaxTrainer(JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=DIM,
                                          dnn_hidden=(8,))),
                   jax_optimizer.Adam(1e-2), jtable, embedx_dim=DIM,
                   hot_tier=JaxHotTierConfig(capacity=256) if hot else None, **_NAMES)
    ttable = _table()
    model = DeepFM(CtrConfig(S, D, DIM, (8,)))
    t = CtrStreamTrainer(model, Adam(1e-2), ttable, embedx_dim=DIM,
                         hot_tier=HotTierConfig(capacity=256) if hot else None,
                         device="cpu", amp=True, **_NAMES)
    t.params = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
    t.opt_state = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, j.opt_state))
    t0 = {k: v.clone() for k, v in t.params.items()}
    jds = _dataset(JaxDataset, JaxSlotDesc, lines)
    tds = _dataset(InMemoryDataset, SlotDesc, lines)
    for _ in range(2):
        with jamp.auto_cast():
            jr = j.train_from_dataset(jds, batch_size=BATCH)
        tr = t.train_from_dataset(tds, batch_size=BATCH)
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-3)
    if hot:
        j.hot_tier.flush()
        t.hot_tier.flush()
    want = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
    for k, w in want.items():
        assert float((t.params[k] - w).abs().max()) <= 1e-2 * float(w.abs().max()), k
    jk, jv = jtable.snapshot_items()
    jv = jv[np.argsort(jk)]
    tk, tv = _rows(ttable)
    np.testing.assert_array_equal(tk, np.sort(jk))
    scale = np.maximum(np.abs(jv).max(axis=0), 1e-30)
    assert (np.abs(tv - jv).max(axis=0) <= 1e-2 * scale).all()
    # amp took effect: from the same start, one epoch in f32 ends elsewhere
    ends = {}
    for amp in (False, True):
        r = CtrStreamTrainer(DeepFM(CtrConfig(S, D, DIM, (8,))), Adam(1e-2), _table(),
                             embedx_dim=DIM, device="cpu", amp=amp, **_NAMES)
        r.params = {k: v.clone() for k, v in t0.items()}
        r.train_from_dataset(tds, batch_size=BATCH)
        ends[amp] = r.params["dnn.layers.0.weight"]
    assert not torch.equal(ends[False], ends[True])
