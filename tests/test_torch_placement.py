"""Measured placement in the port (``paddle_tpu_torch.distributed.placement``
with ``CtrStreamTrainer(placement=...)``), the cases of
``tests/test_placement.py`` held against the JAX package.

- ``DensitySeries`` and ``PlacementPolicy``: the same sample sequences give
  the same window (n, min, max), the same EWMA (exactly: both are float64
  Python arithmetic) and the same decisions as the JAX classes, over the
  JAX tests' sequences and seeded random ones at three configurations.
- The manager over a real 2-shard cluster: the fence gates an armed swap;
  ``flush()`` leaves the PS digest equal to the local rows' digest.
- The acceptance: a swap to the collective plane at a live grow's epoch
  fence, training there, and back at a manual fence ends BITWISE equal to
  an oracle that never resharded or swapped (rows, digest, dense params),
  as the JAX test claims for JAX. The collective plane keeps its rows in
  ``NativeMemorySparseTable``, the servers' engine: rows it creates (the
  default ``initial_range`` draws from the key) and every update match a
  server's bit for bit. The same run in JAX (the port from the JAX model's
  converted weights) gives the same swap journal and table size, and rows
  and dense params at the tolerances of ``tests/test_torch_reshard.py``
  (rows rtol 1e-4 / atol 1e-5, params rtol 1e-4 / atol 1e-6): the two
  dense towers round in another order, so the digests of the two packages
  cannot be compared.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

import paddle_tpu as pt
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.data.dataset import InMemoryDataset as JaxDataset
from paddle_tpu.data.dataset import SlotDesc as JaxSlotDesc
from paddle_tpu.distributed import placement as jax_placement
from paddle_tpu.models.ctr import CtrConfig as JaxCtrConfig
from paddle_tpu.models.ctr import DeepFM as JaxDeepFM
from paddle_tpu.ps import communicator as jax_comm
from paddle_tpu.ps import ha as jax_ha
from paddle_tpu.ps import reshard as jax_reshard
from paddle_tpu.ps.ps_trainer import CtrStreamTrainer as JaxTrainer
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import ctr_params_from_jax
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.distributed.placement import (DensitySeries, PlacementConfig,
                                                    PlacementManager, PlacementPolicy)
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.obs import registry as obs_registry
from paddle_tpu_torch.obs.registry import Registry
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import ha
from paddle_tpu_torch.ps.communicator import SyncCommunicator
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.reshard import ReshardController
from paddle_tpu_torch.ps.rpc import NativePsServer, RpcPsClient
from paddle_tpu_torch.ps.table import NativeMemorySparseTable, TableConfig, row_digest

pytestmark = pytest.mark.usefixtures("jax_native")

MASK = 0xFFFFFFFFFFFFFFFF
S, D = 3, 2
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
_NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
              dense_slots=[f"d{i}" for i in range(D)], label_slot="label")
_PROBE = np.unique((np.arange(0, 48, dtype=np.uint64)[None, :]
                    + (np.arange(S, dtype=np.uint64)[:, None] << np.uint64(32))).reshape(-1))


def _series_state(s):
    return (s.n, s.ewma, s.wmin, s.wmax)


def _fed(cls, values, window=16):
    s = cls(window=window)
    for v in values:
        s.update(v)
    return s


# -- DensitySeries -------------------------------------------------------------------


def test_density_series_window_and_ewma():
    vals = (0.2, 0.4, 0.9, 0.1, 0.5)
    s = _fed(DensitySeries, vals, window=4)
    assert s.n == 4 and s.wmin == 0.1 and s.wmax == 0.9
    e = 0.2  # seeded from the FIRST sample, alpha 0.2
    for v in vals[1:]:
        e = 0.8 * e + 0.2 * v
    assert abs(s.ewma - e) < 1e-12
    assert _series_state(s) == _series_state(_fed(jax_placement.DensitySeries, vals, 4))


def test_density_series_restart_rebase():
    """A fresh series re-bases: the first post-restart sample seeds the
    EWMA and the window, and the bound gauges follow."""
    reg = Registry()
    g = reg.gauge("ps_client_density", table="0", dir="push")
    gmin = reg.gauge("ps_client_density_min", table="0", dir="push")
    gmax = reg.gauge("ps_client_density_max", table="0", dir="push")
    s1 = DensitySeries(gauge=g, gmin=gmin, gmax=gmax, window=8)
    for v in (0.01, 0.02, 0.99):
        s1.update(v)
    assert gmin.value == 0.01 and gmax.value == 0.99
    s2 = DensitySeries(gauge=g, gmin=gmin, gmax=gmax, window=8)
    s2.update(0.7)
    assert s2.ewma == 0.7 and s2.n == 1
    assert gmin.value == 0.7 and gmax.value == 0.7 and g.value == 0.7


def test_density_series_feeds_registry_family():
    """The client's push lands in ``ps_client_density`` (and its window's
    min/max gauges) through the table's push series."""
    srv = NativePsServer()
    try:
        cli = RpcPsClient([f"127.0.0.1:{srv.port}"])
        cli.create_sparse_table(0, TableConfig())
        keys = np.arange(1, 33, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        push = np.zeros((len(keys), 12), np.float32)
        push[:, 1] = 1.0
        push[:, 3:] = 0.5  # a fully dense gradient block
        cli.push_sparse(0, keys, push)
        s = cli.density_series(0, "push")
        assert s is not None and s.n == 1 and s.ewma == 1.0
        snap = obs_registry.REGISTRY.snapshot()["metrics"]
        vals = {tuple(sorted(r["labels"].items())): r["value"]
                for r in snap["ps_client_density"]["series"]}
        assert vals[(("dir", "push"), ("table", "0"))] == 1.0
        assert "ps_client_density_min" in snap and "ps_client_density_max" in snap
        cli.close()
    finally:
        srv.stop()
        srv.close()


# -- the policy ----------------------------------------------------------------------


def _decide_both(cfg_kw, placement, values, window=16):
    got = PlacementPolicy(PlacementConfig(**cfg_kw)).decide(
        placement, None if values is None else _fed(DensitySeries, values, window))
    want = jax_placement.PlacementPolicy(jax_placement.PlacementConfig(**cfg_kw)).decide(
        placement, None if values is None else _fed(jax_placement.DensitySeries, values, window))
    assert got == want, (cfg_kw, placement, got, want)
    return got


def test_policy_min_samples_gate():
    kw = dict(min_samples=8)
    assert _decide_both(kw, "ps", [0.9] * 7) is None
    assert _decide_both(kw, "ps", [0.9] * 8) == "collective"
    assert _decide_both(kw, "ps", None) is None


def test_policy_densifying_caution_window_min():
    """One sparse batch inside the window blocks a densify even when the
    EWMA clears the bar."""
    kw = dict(densify_threshold=0.6, sparsify_threshold=0.25, min_samples=4)
    dense_burst = [0.9] * 10 + [0.1] + [0.9] * 5
    assert _fed(DensitySeries, dense_burst).ewma > 0.6
    assert _decide_both(kw, "ps", dense_burst) is None
    assert _decide_both(kw, "ps", [0.9] * 16) == "collective"


def test_policy_hysteresis_band():
    kw = dict(densify_threshold=0.6, sparsify_threshold=0.25, min_samples=4)
    assert _decide_both(kw, "ps", [0.4] * 8) is None
    assert _decide_both(kw, "collective", [0.4] * 8) is None
    assert _decide_both(kw, "collective", [0.05] * 8) == "ps"
    assert _decide_both(kw, "ps", [0.05] * 8) is None


@pytest.mark.parametrize("cfg_kw", [dict(), dict(densify_threshold=0.5, min_samples=4),
                                    dict(densify_threshold=0.9, sparsify_threshold=0.1,
                                         min_samples=2)],
                         ids=["default", "phase19", "wide_band"])
def test_policy_decisions_equal_jax_on_seeded_sequences(cfg_kw):
    """Seeded sample streams (steady dense, steady sparse, mixed, bursty)
    through both packages' series: after every sample the window, the EWMA
    and the decision in both placements are the JAX package's."""
    rng = np.random.default_rng(19)
    streams = [rng.uniform(0.8, 1.0, 40), rng.uniform(0.0, 0.2, 40), rng.uniform(0, 1, 40),
               np.where(rng.random(40) < 0.1, 0.05, 0.95)]
    decided = set()
    for vals in streams:
        port = DensitySeries(window=8)
        ref = jax_placement.DensitySeries(window=8)
        pol = PlacementPolicy(PlacementConfig(**cfg_kw))
        jpol = jax_placement.PlacementPolicy(jax_placement.PlacementConfig(**cfg_kw))
        for v in vals:
            port.update(v)
            ref.update(v)
            assert _series_state(port) == _series_state(ref)
            for where in ("ps", "collective"):
                d = pol.decide(where, port)
                assert d == jpol.decide(where, ref)
                decided.add(d)
    assert {"collective", "ps", None} <= decided


# -- the manager over a real cluster --------------------------------------------------


def _lines(n, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        ids = rng.integers(0, 48, S)
        dense = rng.normal(size=D)
        label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
        lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                              + [f"1 {label}"]))
    return lines


def _data(n, seed=0, cls=InMemoryDataset, desc=SlotDesc):
    slots = ([desc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [desc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [desc("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=0)
    ds.load_from_lines(_lines(n, seed))
    return ds


def _stream_trainer(cli, placement=None, params=None):
    comm = SyncCommunicator(cli)
    comm.start()
    tr = CtrStreamTrainer(DeepFM(CtrConfig(S, D, 8, (8,)),
                                 generator=torch.Generator().manual_seed(0)),
                          Adam(1e-2), None, communicator=comm, table_id=0, embedx_dim=8,
                          placement=placement, device="cpu", **_NAMES)
    if params is not None:
        tr.params = params
        tr.opt_state = tr.optimizer.init(tr.params)
    return tr, comm


def test_fence_gates_the_swap():
    """An armed swap does not execute until an epoch fence passes; the
    first poll after ``fence()`` applies it at the batch boundary."""
    with ha.HACluster(num_shards=2, replication=1, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, TableConfig(table_id=0, shard_num=4))
        mgr = PlacementManager(cli, 0, PlacementConfig(min_samples=4, auto=False))
        tr, comm = _stream_trainer(cli, mgr)
        tr.train_from_dataset(_data(128), batch_size=64)
        mgr.arm("collective")
        tr.train_from_dataset(_data(128, seed=1), batch_size=64)
        assert mgr.placement == "ps"  # no fence yet
        mgr.fence()
        tr.train_from_dataset(_data(128, seed=2), batch_size=64)
        assert mgr.placement == "collective"
        assert isinstance(mgr.local_table, NativeMemorySparseTable)
        assert [e["to"] for e in mgr.events] == ["collective"]
        comm.stop()


def test_flush_keeps_checkpoint_cut_complete():
    """While resident, ``flush()`` writes every local row back: the PS
    digest equals the local rows' digest; ``reset_to_ps`` (the restore
    path) drops the residence without a write-back."""
    with ha.HACluster(num_shards=2, replication=1, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, TableConfig(table_id=0, shard_num=4))
        mgr = PlacementManager(cli, 0, PlacementConfig(min_samples=4, auto=False,
                                                       require_fence=False))
        tr, comm = _stream_trainer(cli, mgr)
        tr.train_from_dataset(_data(192), batch_size=64)
        mgr.arm("collective")
        tr.train_from_dataset(_data(192, seed=1), batch_size=64)
        assert mgr.placement == "collective"
        assert mgr.flush() > 0
        k, v = mgr.local_table.snapshot_items()
        assert (sum(cli.digest_routed(0)) & MASK) == row_digest(k, v)
        mgr.reset_to_ps()
        assert mgr.placement == "ps" and mgr.local_table is None
        comm.stop()


def _port_run(place, params):
    """The JAX acceptance test's run in the port: 384 lines, (a grow that
    fires the fence and ``on_reshard``,) 384 more on the collective plane,
    (a manual arm and fence,) 192 more; returns the record."""
    with ha.HACluster(num_shards=2, replication=1, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, TableConfig(table_id=0, shard_num=4))
        mgr = ctl = None
        if place:
            ctl = ReshardController(c)
            # the stream's gradient block is fully dense: the densify arms
            # from the measured density, not from a manual arm
            mgr = PlacementManager(cli, 0, PlacementConfig(densify_threshold=0.5,
                                                           min_samples=4), controller=ctl)
        tr, comm = _stream_trainer(cli, mgr, params)
        tr.train_from_dataset(_data(384), batch_size=64)
        ops = {}
        if place:
            assert mgr.placement == "ps" and mgr.armed() == "collective"
            ctl.grow(2)  # the pre-cutover hook is the fence
            tr.on_reshard()  # the batch boundary: applies
            assert mgr.placement == "collective" and cli.num_servers == 4
            cli.reset_op_counts()
        tr.train_from_dataset(_data(384, seed=1), batch_size=64)
        if place:
            ops = cli.reset_op_counts()
            assert mgr.placement == "collective"
            mgr.arm("ps")
            mgr.fence()
        tr.train_from_dataset(_data(192, seed=2), batch_size=64)
        if place:
            assert mgr.placement == "ps"
        comm.barrier()
        rec = {"pulled": cli.pull_sparse(0, _PROBE, create=False),
               "digest": sum(cli.digest_routed(0)) & MASK, "size": cli.size(0),
               "params": {k: v.clone() for k, v in tr.params.items()}, "ops": ops,
               "events": [(e["to"], e["rows"]) for e in mgr.events] if place else []}
        comm.stop()
        return rec


def _jax_placed_run():
    """The same placed run in the JAX package; returns (start params in the
    port's layout, rows, size, params, events)."""
    with jax_ha.HACluster(num_shards=2, replication=1, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, JaxTableConfig(table_id=0, shard_num=4))
        ctl = jax_reshard.ReshardController(c)
        mgr = jax_placement.PlacementManager(cli, 0, jax_placement.PlacementConfig(
            densify_threshold=0.5, min_samples=4), controller=ctl)
        comm = jax_comm.SyncCommunicator(cli)
        comm.start()
        pt.seed(0)
        tr = JaxTrainer(JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=8,
                                               dnn_hidden=(8,))),
                        jax_optimizer.Adam(1e-2), None, communicator=comm, table_id=0,
                        embedx_dim=8, placement=mgr, **_NAMES)
        start = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, tr.params))
        jd = dict(cls=JaxDataset, desc=JaxSlotDesc)
        tr.train_from_dataset(_data(384, **jd), batch_size=64)
        ctl.grow(2)
        tr.on_reshard()
        tr.train_from_dataset(_data(384, seed=1, **jd), batch_size=64)
        mgr.arm("ps")
        mgr.fence()
        tr.train_from_dataset(_data(192, seed=2, **jd), batch_size=64)
        comm.barrier()
        rec = {"pulled": cli.pull_sparse(0, _PROBE, create=False), "size": cli.size(0),
               "params": ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, tr.params)),
               "events": [(e["to"], e["rows"]) for e in mgr.events]}
        comm.stop()
        return start, rec


def test_swap_at_live_reshard_fence_bit_identical_to_oracle():
    """The acceptance: the densify armed from measured density executes at
    a live grow's fence, the middle epoch trains on the collective plane
    with no client sparse op, a manual fence moves the table back, and the
    run ends bitwise equal to its oracle (rows, digest, dense params); the
    JAX run gives the same journal and size, rows and params within the
    stated tolerances."""
    start, want = _jax_placed_run()
    placed = _port_run(True, {k: v.clone() for k, v in start.items()})
    oracle = _port_run(False, {k: v.clone() for k, v in start.items()})
    assert [to for to, _ in placed["events"]] == ["collective", "ps"]
    assert not {k: n for k, n in placed["ops"].items() if "sparse" in k}, placed["ops"]
    assert placed["digest"] == oracle["digest"] and placed["size"] == oracle["size"]
    np.testing.assert_array_equal(placed["pulled"], oracle["pulled"])
    for k, v in oracle["params"].items():
        assert torch.equal(placed["params"][k], v), k
    assert placed["events"] == want["events"] and placed["size"] == want["size"]
    np.testing.assert_allclose(placed["pulled"], want["pulled"], **ROW_TOL)
    for k, w in want["params"].items():
        np.testing.assert_allclose(placed["params"][k].numpy(), w.numpy(), err_msg=k,
                                   **PARAM_TOL)


def test_placed_table_config_is_the_native_engine():
    """The collective plane's table is the servers' engine whatever backend
    the client's table config names (the Python shards would draw other
    initial rows)."""
    with ha.HACluster(num_shards=1, replication=1, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, TableConfig(table_id=0, shard_num=4, backend="python"))
        assert cli.sparse_config(0).backend == "python"
        mgr = PlacementManager(cli, 0, PlacementConfig(auto=False, require_fence=False))
        tr, comm = _stream_trainer(cli, mgr)
        keys = np.arange(1, 65, dtype=np.uint64)
        cli.pull_sparse(0, keys)
        mgr.arm("collective")
        mgr.poll(tr)
        new = np.arange(1000, 1064, dtype=np.uint64)
        local = mgr.local_table.pull_sparse(new, create=True)
        np.testing.assert_array_equal(local, cli.pull_sparse(0, new, create=True))
        comm.stop()
