"""The the_one_ps rung on the CPU: ``CtrStreamTrainer(communicator=...)``
through the port's ``RpcPsClient`` against its ``NativePsServer``s, with
and without the hot tier.

The harness of ``tests/test_hot_tier.py`` (S=3, D=2, dim 8, DNN (8,),
batch 64, 256 records, two servers, a 4-shard CTR table):

- against the JAX trainer over JAX servers, both through a
  ``SyncCommunicator``, from converted weights: losses rtol 1e-5, dense
  params rtol 1e-4 / atol 1e-6, table rows rtol 1e-4 / atol 1e-5 (the
  tolerances of ``test_torch_hot_tier.py``: the dense products run in
  another order through XLA's and PyTorch's CPU BLAS);
- tier over RPC ≡ RPC-only over RPC, bitwise (``SyncCommunicator``, rows
  created with ``initial_range=0``): loss, dense params, Adam state and
  every ``snapshot_items`` column but ``delta_score``, with and without
  eviction churn;
- the warm epoch of the tier over a ``HalfAsyncCommunicator`` makes no
  table RPC and no miss;
- ``pull_ahead=1`` over HalfAsync converges like depth 0 (final losses
  within 0.1, as ``tests/test_rpc_parallel.py``);
- a ``LocalPsClient`` serves as the communicator's client: the trainer
  equals the local-table trainer bitwise, with and without the tier.
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
from paddle_tpu.models.ctr import CtrConfig as JaxCtrConfig
from paddle_tpu.models.ctr import DeepFM as JaxDeepFM
from paddle_tpu.ps import communicator as jax_comm
from paddle_tpu.ps import rpc as jax_rpc
from paddle_tpu.ps.hot_tier import HotTierConfig as JaxHotTierConfig
from paddle_tpu.ps.ps_trainer import CtrStreamTrainer as JaxTrainer
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import adam_state_from_jax, ctr_params_from_jax
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.client import LocalPsClient, PsServerHandle
from paddle_tpu_torch.ps.communicator import HalfAsyncCommunicator, SyncCommunicator
from paddle_tpu_torch.ps.hot_tier import HotTierConfig
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

pytestmark = pytest.mark.usefixtures("jax_native")

S, D, DIM, BATCH = 3, 2, 8, 64
_DELTA_COL = 2  # save-layout delta_score: folds per flush, not per push
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
_NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
              dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


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


def _dataset(lines, cls=InMemoryDataset, desc=SlotDesc):
    slots = ([desc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [desc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [desc("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=0)
    ds.load_from_lines(lines)
    return ds


def _table_config(initial_range=None):
    if initial_range is None:
        return TableConfig(table_id=0, shard_num=4)
    return TableConfig(table_id=0, shard_num=4, accessor_config=AccessorConfig(
        sgd=SGDRuleConfig(initial_range=initial_range)))


class _Cluster:
    """Two servers of ``rpc_mod`` and a client, table 0 created."""

    def __init__(self, rpc_mod=rpc, config=None):
        self.servers = [rpc_mod.NativePsServer(n_trainers=1) for _ in range(2)]
        self.client = rpc_mod.RpcPsClient([f"127.0.0.1:{s.port}" for s in self.servers])
        self.client.create_sparse_table(0, config or _table_config())

    def rows(self):
        k, v = self.client.snapshot_items(0)
        i = np.argsort(k)
        return k[i], v[i]

    def close(self):
        self.client.close()
        for s in self.servers:
            s.close()


def _trainer(comm, hot=None, table=None, pull_ahead=None):
    model = DeepFM(CtrConfig(S, D, DIM, (8,)), generator=torch.Generator().manual_seed(0))
    return CtrStreamTrainer(model, Adam(1e-2), table, communicator=comm, table_id=0,
                            embedx_dim=DIM, pull_ahead=pull_ahead, hot_tier=hot,
                            device="cpu", **_NAMES)


def _assert_dense_equal(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.opt_state["step"], b.opt_state["step"])
    for slot in ("m", "v"):
        for k in a.opt_state[slot]:
            assert torch.equal(a.opt_state[slot][k], b.opt_state[slot][k]), (slot, k)


def _assert_rows_equal_mod_delta(ra, rb):
    np.testing.assert_array_equal(ra[0], rb[0])
    keep = [c for c in range(ra[1].shape[1]) if c != _DELTA_COL]
    np.testing.assert_array_equal(ra[1][:, keep], rb[1][:, keep])


@pytest.mark.parametrize("hot", [False, True], ids=["rpc_only", "hot_tier"])
def test_stream_over_rpc_matches_jax(hot):
    """Two epochs through a SyncCommunicator: the port (its client, its
    servers) against JAX (its client, its servers)."""
    lines = _lines()
    jc, tc = _Cluster(jax_rpc, JaxTableConfig(table_id=0, shard_num=4)), _Cluster()
    try:
        jcomm, tcomm = jax_comm.SyncCommunicator(jc.client), SyncCommunicator(tc.client)
        jcomm.start()
        tcomm.start()
        pt.seed(0)
        j = JaxTrainer(JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=DIM,
                                              dnn_hidden=(8,))),
                       jax_optimizer.Adam(1e-2), None, embedx_dim=DIM, communicator=jcomm,
                       table_id=0, hot_tier=JaxHotTierConfig(capacity=256) if hot else None,
                       **_NAMES)
        t = _trainer(tcomm, HotTierConfig(capacity=256) if hot else None)
        t.params = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
        t.opt_state = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, j.opt_state))
        jds, tds = _dataset(lines, JaxDataset, JaxSlotDesc), _dataset(lines)
        for _ in range(2):
            jr = j.train_from_dataset(jds, batch_size=BATCH)
            tr = t.train_from_dataset(tds, batch_size=BATCH)
            np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=LOSS_RTOL)
            assert tr["steps"] == jr["steps"] == 4
        if hot:
            j.hot_tier.flush()
            t.hot_tier.flush()
        jcomm.stop()
        tcomm.stop()
        want = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
        for k, w in want.items():
            np.testing.assert_allclose(t.params[k].numpy(), w.numpy(), err_msg=k, **PARAM_TOL)
        (jk, jv), (tk, tv) = jc.rows(), tc.rows()
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_allclose(tv, jv, **ROW_TOL)
    finally:
        jc.close()
        tc.close()


@pytest.mark.parametrize("nid,capacity", [(48, 256), (400, 224)],
                         ids=["resident", "eviction_churn"])
def test_tier_over_rpc_equals_rpc_only(nid, capacity):
    """JAX's contract (``tests/test_hot_tier.py``), bitwise on the CPU:
    the tier over RPC equals the RPC-only trainer over RPC."""
    lines = _lines(nid=nid)
    a, b = _Cluster(config=_table_config(0.0)), _Cluster(config=_table_config(0.0))
    try:
        ca, cb = SyncCommunicator(a.client), SyncCommunicator(b.client)
        ca.start()
        cb.start()
        ta, tb = _trainer(ca), _trainer(cb, HotTierConfig(capacity=capacity))
        ra = ta.train_from_dataset(_dataset(lines), batch_size=BATCH)
        rb = tb.train_from_dataset(_dataset(lines), batch_size=BATCH)
        tb.hot_tier.flush()
        ca.stop()
        cb.stop()
        assert ra["loss"] == rb["loss"]
        _assert_dense_equal(ta, tb)
        _assert_rows_equal_mod_delta(a.rows(), b.rows())
        st = rb["hot_tier"]
        assert st["misses"] > 0 and st["hits"] > 0
        if capacity == 224:
            assert st["evictions"] > 0 and st["writebacks"] > 0
    finally:
        a.close()
        b.close()


def test_warm_epoch_makes_no_table_rpc():
    c = _Cluster()
    try:
        comm = HalfAsyncCommunicator(c.client)
        comm.start()
        t = _trainer(comm, HotTierConfig(capacity=512))
        assert t.pull_ahead == 1
        ds = _dataset(_lines(n=512, nid=60))
        first = t.train_from_dataset(ds, batch_size=128)
        st1 = first["hot_tier"]
        assert st1["misses"] > 0 and st1["cold_fetches"] > 0
        assert c.client.reset_op_counts().get("export_full", 0) > 0
        warm = t.train_from_dataset(ds, batch_size=128)
        assert c.client.reset_op_counts() == {}
        st2 = warm["hot_tier"]
        assert st2["misses"] == st1["misses"] and st2["cold_fetches"] == st1["cold_fetches"]
        assert st2["hits"] > st1["hits"]
        assert warm["loss"] < first["loss"]
        n = t.hot_tier.flush()
        comm.stop()
        assert n == st2["occupancy"] == c.client.size(0)
    finally:
        c.close()


def test_pull_ahead_converges_like_depth0():
    lines = _lines(n=1024, nid=400)
    results = {}
    for depth in (1, 0):
        c = _Cluster()
        try:
            comm = HalfAsyncCommunicator(c.client)
            comm.start()
            t = _trainer(comm, pull_ahead=depth)
            assert t.pull_ahead == depth
            ds = _dataset(lines)
            results[depth] = [t.train_from_dataset(ds, batch_size=128)["loss"]
                              for _ in range(3)]
            comm.stop()
            assert not comm._inflight_pulls
        finally:
            c.close()
    for d in (0, 1):
        assert results[d][-1] < results[d][0], results
    assert abs(results[1][-1] - results[0][-1]) < 0.1, results


def test_remote_table_without_communicator_equals_sync_communicator():
    """A ``RemoteSparseTable`` as the trainer's table (pulls and pushes in
    line through the client, as ``tests/test_ps_rpc.py``'s stream test)
    trains bit-identically to a SyncCommunicator over the same client."""
    lines = _lines(nid=400)
    a, b = _Cluster(), _Cluster()
    try:
        comm = SyncCommunicator(b.client)
        comm.start()
        ta = _trainer(None, table=rpc.RemoteSparseTable(a.client, 0, a.client.sparse_config(0)))
        tb = _trainer(comm)
        ra = ta.train_from_dataset(_dataset(lines), batch_size=BATCH)
        rb = tb.train_from_dataset(_dataset(lines), batch_size=BATCH)
        comm.stop()
        assert ra["loss"] == rb["loss"]
        _assert_dense_equal(ta, tb)
        ka, va = a.rows()
        kb, vb = b.rows()
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(va, vb)
        assert ta.table.size() == len(ka) and ta.table.digest() == a.client.digest(0)
    finally:
        a.close()
        b.close()


def test_sync_communicator_forces_depth0():
    c = _Cluster()
    try:
        assert _trainer(SyncCommunicator(c.client), pull_ahead=3).pull_ahead == 0
        assert _trainer(None, table=MemorySparseTable(_table_config())).pull_ahead == 0
    finally:
        c.close()


@pytest.mark.parametrize("hot", [False, True], ids=["rpc_only", "hot_tier"])
def test_local_client_communicator_equals_local_table(hot):
    lines = _lines(nid=400)
    server = PsServerHandle()
    local = MemorySparseTable(_table_config(0.0))
    try:
        server.create_sparse_table(0, _table_config(0.0))
        comm = SyncCommunicator(LocalPsClient(server))
        comm.start()
        cap = HotTierConfig(capacity=224) if hot else None
        a = _trainer(comm, cap)
        b = _trainer(None, HotTierConfig(capacity=224) if hot else None, table=local)
        assert a.hot_tier is None or a.hot_tier.table is server.sparse_tables[0]
        ra = a.train_from_dataset(_dataset(lines), batch_size=BATCH)
        rb = b.train_from_dataset(_dataset(lines), batch_size=BATCH)
        if hot:
            a.hot_tier.flush()
            b.hot_tier.flush()
        comm.stop()
        assert ra["loss"] == rb["loss"]
        _assert_dense_equal(a, b)
        ka, va = server.sparse_tables[0].snapshot_items()
        kb, vb = local.snapshot_items()
        ia, ib = np.argsort(ka), np.argsort(kb)
        np.testing.assert_array_equal(ka[ia], kb[ib])
        np.testing.assert_array_equal(va[ia], vb[ib])
    finally:
        server.close()
        local.close()
