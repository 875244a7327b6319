"""Live resharding in the port (``paddle_tpu_torch.ps.reshard`` over the
port's ``ps.ha``, ``ps.rpc`` and its copy of the C++ service's ``kRetain``
ownership fence), the cases of ``tests/test_reshard.py`` and the checks
across the packages.

Bottom up: the plans (equal to the JAX package's), ``kRetain`` with the
filtered digest and the whole-frame ``kErrWrongShard`` bounce (typed, the
breaker closed), a grow and a shrink under a stale client, the refusals,
checkpoint saves concurrent with a reshard, the hot tier keeping its
resident set, the snapshot attach carrying ownership, migrate lag kept out
of the gauges, the coordinator's gated scan, the SSD remote digest and
``load_cold`` across a grow. Across the packages: per-shard digests,
``rows_moved`` and ownership after a grow and a shrink equal to the JAX
controller's; each package's client re-routing across the other's grow;
the tier across a grow against JAX's run at the tolerances of
``tests/test_torch_stream_rpc.py`` (losses rtol 1e-5, dense params rtol
1e-4 / atol 1e-6, pulled rows rtol 1e-4 / atol 1e-5: the dense products
run in another order through XLA's and PyTorch's CPU BLAS). Port only: the
chaos run under load (grow and shrink, a source primary killed
mid-migration) bitwise equal to its unresharded oracle, an int8 push
bounced across a grow, and ``chip_smoke.py`` phase 17 at a small size.
Comparisons within one package are bitwise.

Lease timing is the cluster's default (heartbeat 0.05 s, TTL 0.4 s); every
wait has a deadline of at least 10 s.
"""

import os
import sys
import threading
import time

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
from paddle_tpu.ps import ha as jax_ha
from paddle_tpu.ps import reshard as jax_reshard
from paddle_tpu.ps import rpc as jax_rpc
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.hot_tier import HotTierConfig as JaxHotTierConfig
from paddle_tpu.ps.ps_trainer import CtrStreamTrainer as JaxTrainer
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import ctr_params_from_jax
from paddle_tpu_torch.core.enforce import PreconditionNotMetError, WrongShardError
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.distributed.elastic import MemoryStore
from paddle_tpu_torch.io.job_checkpoint import JobCheckpointManager
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.obs import flightrec
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import ha, rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.communicator import SyncCommunicator
from paddle_tpu_torch.ps.faultpoints import FaultInjected, arm_faultpoint, disarm_faultpoints
from paddle_tpu_torch.ps.hot_tier import HotTierConfig
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.reshard import (Migration, ReshardController, ReshardError, plan_grow,
                                         plan_shrink)
from paddle_tpu_torch.ps.rpc import RemoteSparseTable
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

pytestmark = pytest.mark.usefixtures("jax_native")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASK = 0xFFFFFFFFFFFFFFFF
WAIT_S = 15.0  # every wait's deadline
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
S, D = 3, 2
_NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
              dense_slots=[f"d{i}" for i in range(D)], label_slot="label")
_PROBE = np.unique((np.arange(0, 48, dtype=np.uint64)[None, :]
                    + (np.arange(S, dtype=np.uint64)[:, None] << np.uint64(32))).reshape(-1))


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    disarm_faultpoints()


def _cfg(**kw):
    return TableConfig(table_id=0, shard_num=4, accessor="ctr",
                       accessor_config=AccessorConfig(sgd=SGDRuleConfig(initial_range=0.0)), **kw)


def _jax_cfg(**kw):
    return JaxTableConfig(table_id=0, shard_num=4, accessor="ctr",
                          accessor_config=JaxAccessorConfig(
                              sgd=JaxSGDRuleConfig(initial_range=0.0)), **kw)


def _seed_rows(cli, n=400, seed=0):
    """Rows 1..n created and pushed once with seeded gradients."""
    rng = np.random.default_rng(seed)
    keys = np.arange(1, n + 1, dtype=np.uint64)
    cli.pull_sparse(0, keys)
    push = np.zeros((n, 12), np.float32)
    push[:, 0] = (keys % 8).astype(np.float32)
    push[:, 1] = 1.0
    push[:, 3:] = rng.normal(0, 0.1, (n, 9)).astype(np.float32)
    cli.push_sparse(0, keys, push)
    return keys


def _push(rng, keys):
    push = np.zeros((len(keys), 12), np.float32)
    push[:, 0] = (keys % 8).astype(np.float32)
    push[:, 1] = 1.0
    push[:, 3:] = rng.normal(0, 0.1, (len(keys), 9)).astype(np.float32)
    return push


def _wait(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


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


def _dataset(lines, cls=InMemoryDataset, desc=SlotDesc):
    slots = ([desc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
             + [desc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
             + [desc("label", is_float=True, max_len=1)])
    ds = cls(slots, seed=0)
    ds.load_from_lines(lines)
    return ds


# -- plans ---------------------------------------------------------------------------


def test_plan_grow_splits_single_source():
    p = plan_grow(2, 2)
    assert (p.old_n, p.new_n) == (2, 4)
    assert p.migrations == (Migration(0, 2, 4, 2), Migration(1, 3, 4, 3))
    p3 = plan_grow(2, 3)  # every new shard still has one source, d % S
    assert all(m.src == m.dst % 2 for m in p3.migrations) and len(p3.migrations) == 4


def test_plan_shrink_halves_only():
    p = plan_shrink(4, 2)
    assert p.migrations == (Migration(2, 0, 4, 2), Migration(3, 1, 4, 3))
    with pytest.raises(PreconditionNotMetError):
        plan_shrink(8, 4)  # chain halvings instead
    with pytest.raises(PreconditionNotMetError):
        plan_shrink(3, 2)


@pytest.mark.parametrize("n,k", [(1, 2), (2, 2), (2, 3), (4, 2)])
def test_plans_equal_the_jax_packages(n, k):
    """``plan_grow(n, k)`` and ``plan_shrink(n, k)`` give the JAX package's
    plans field for field, or both refuse."""
    def fields(plan):
        return (plan.direction, plan.old_n, plan.new_n,
                [(m.src, m.dst, m.modulus, m.residue) for m in plan.migrations])

    assert fields(plan_grow(n, k)) == fields(jax_reshard.plan_grow(n, k))
    try:
        want = fields(jax_reshard.plan_shrink(n, k))
    except Exception as e:  # noqa: BLE001 — the refusal is compared below
        want = type(e).__name__
    try:
        got = fields(plan_shrink(n, k))
    except PreconditionNotMetError as e:
        got = type(e).__name__
    assert got == want


# -- kRetain, the filtered digest, the fence (one server) ------------------------------


@pytest.fixture
def one_server():
    s = rpc.NativePsServer()
    cli = rpc.RpcPsClient([f"127.0.0.1:{s.port}"])
    yield s, cli
    cli.close()
    s.close()


def test_retain_filtered_digest_and_fence(one_server):
    _, cli = one_server
    cli.create_sparse_table(0, _cfg())
    _seed_rows(cli, 100)
    assert cli.ownership(0) == (0, 0)
    d_all, d_even, d_odd = cli.digest_at(0, 0), cli.digest_at(0, 0, 2, 0), cli.digest_at(0, 0, 2, 1)
    assert (d_even + d_odd) & MASK == d_all  # class digests add to the whole
    assert cli.retain(0, 2, 0) == 50
    assert cli.ownership(0) == (2, 0)
    assert cli.size(0) == 50 and cli.digest_at(0, 0) == d_even
    with pytest.raises(WrongShardError):  # a key it does not own: the frame bounces
        cli.pull_sparse(0, np.array([3], np.uint64))
    assert cli.size(0) == 50
    cli.pull_sparse(0, np.array([4], np.uint64))
    assert cli.retain(0, 2, -1) == 0  # fenced out: everything bounces, rows stay
    with pytest.raises(WrongShardError):
        cli.pull_sparse(0, np.array([4], np.uint64))
    assert cli.size(0) == 50


def test_wrong_shard_bounce_rejects_frame_whole(one_server):
    """One key it does not own rejects the whole push before any apply:
    the owned keys do not land either (the replay's exactly-once)."""
    _, cli = one_server
    cli.create_sparse_table(0, _cfg())
    _seed_rows(cli, 10)
    cli.retain(0, 2, 0)
    d0 = cli.digest_at(0, 0)
    push = np.zeros((3, 12), np.float32)
    push[:, 1] = 1.0
    with pytest.raises(WrongShardError):
        cli.push_sparse(0, np.array([2, 4, 5], np.uint64), push)
    assert cli.digest_at(0, 0) == d0


def test_server_epoch_read_and_set(one_server):
    _, cli = one_server
    assert cli.server_epoch(0) == 0
    cli.server_epoch(0, set_to=3)
    assert cli.server_epoch(0) == 3


def test_wrong_shard_is_not_a_transport_error():
    """The server answered: the bounce surfaces after the hop budget (a
    one-shard routing never changes) and the breaker stays closed."""
    with ha.HACluster(num_shards=1, replication=1, sync=False) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        _seed_rows(cli, 10)
        ep = c.primary(0).endpoint
        conn = rpc.make_conn(ep)
        try:
            conn.check(rpc._RETAIN, n=2, aux=0, retries=0)
        finally:
            conn.close()
        with pytest.raises(WrongShardError):
            cli.pull_sparse(0, np.array([3], np.uint64), create=False)
        assert cli._router.breaker(ep).state == ha.CircuitBreaker.CLOSED


def test_transport_death_past_a_shrunk_index_is_a_misroute():
    """A dead connection on a shard index the routing no longer has raises
    ``WrongShardError`` at once instead of waiting out a failover."""
    store = MemoryStore()
    ha.RoutingTable(store, "j").publish(0, [{"primary": "127.0.0.1:1", "backups": []}])
    router = ha.HARouter(store, "j", failover_timeout_s=30.0)
    t = time.monotonic()
    with pytest.raises(WrongShardError):
        rpc.RpcPsClient._raise_if_shrunk(1, router)
    rpc.RpcPsClient._raise_if_shrunk(0, router)  # still routed: no raise
    assert time.monotonic() - t < 1.0


# -- a live grow and shrink under a stale client ---------------------------------------


def test_grow_and_shrink_preserve_rows_and_reroute_clients():
    with ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        keys = _seed_rows(cli)
        rows, d_before = cli.size(0), sum(cli.digest(0)) & MASK
        pulled_before = cli.pull_sparse(0, keys, create=False)
        ctrl = ReshardController(c)
        rec = ctrl.grow(2)
        assert rec["to_shards"] == 4 and c.num_shards == 4 and rec["rows_moved"] == 200
        # the stale client's next op bounces, re-resolves and replays
        np.testing.assert_array_equal(cli.pull_sparse(0, keys, create=False), pulled_before)
        assert cli.num_servers == 4 and cli.size(0) == rows
        assert (sum(cli.digest(0)) & MASK) == d_before
        c.drain()
        assert [cli.ownership(s) for s in range(4)] == [(4, s) for s in range(4)]
        for s in range(4):  # the tapped kRetain reached every backup
            assert len(set(c.digests(0, s).values())) == 1
        cli.push_sparse(0, keys, _push(np.random.default_rng(1), keys))
        c.drain()
        d4, pulled4 = sum(cli.digest(0)) & MASK, cli.pull_sparse(0, keys, create=False)
        rec2 = ctrl.shrink(2)
        assert rec2["to_shards"] == 2 and c.num_shards == 2
        np.testing.assert_array_equal(cli.pull_sparse(0, keys, create=False), pulled4)
        assert cli.num_servers == 2 and cli.size(0) == rows
        assert (sum(cli.digest(0)) & MASK) == d4
        assert [e["direction"] for e in ctrl.events] == ["grow", "shrink"]
        assert len(c.store.list_prefix(f"ps/{c.job_id}/reshard/")) == 2


@pytest.mark.parametrize("kind", ["dense", "geo", "ssd"])
def test_reshard_refuses_tables_it_cannot_move(kind, tmp_path):
    """A PS dense table, a GEO table or an SSD table is refused before
    anything moves: no shard spawned, no routing published."""
    with ha.HACluster(num_shards=2, replication=1, sync=False) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg(**({"storage": "ssd", "ssd_path": str(tmp_path)}
                                           if kind == "ssd" else {})))
        if kind == "dense":
            cli.create_dense_table(1, 16, optimizer="sgd", lr=0.1)
        elif kind == "geo":
            cli.create_geo_table(1, 8)
        epoch = c.routing.read()[0]
        with pytest.raises(ReshardError):
            ReshardController(c).grow(2)
        assert c.num_shards == 2 and c.routing.read()[0] == epoch


def test_cutover_faultpoint_aborts_before_the_flip():
    """A fault at the ``reshard.cutover`` site (after the bootstrap, before
    the gate) leaves the routing unpublished, the migration leases released
    and the new rows retired; the client keeps working on the old topology,
    and a retry grows from it."""
    with ha.HACluster(num_shards=2, replication=1, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        keys = _seed_rows(cli, 100)
        want = cli.pull_sparse(0, keys, create=False)
        arm_faultpoint("reshard.cutover", "drop-frame")
        with pytest.raises(FaultInjected):
            ReshardController(c).grow(2)
        assert c.routing.read()[0] == 0 and len(c.routing.read()[1]) == 2
        assert not any(c.store.list_prefix(ha._obs_prefix(c.job_id, s)) for s in range(2))
        np.testing.assert_array_equal(cli.pull_sparse(0, keys, create=False), want)
        assert cli.num_servers == 2 and c.num_shards == 2
        disarm_faultpoints()
        assert ReshardController(c).grow(2)["to_shards"] == 4
        np.testing.assert_array_equal(cli.pull_sparse(0, keys, create=False), want)
        assert cli.num_servers == 4


def test_journal_gauge_counter_and_flight_recorder():
    """Each operation lands in ``events``, in the store under
    ``ps/<job>/reshard/<n>``, in the ``ps_shard_count`` gauge and the
    ``ps_reshards`` counter, and notifies the flight recorder."""
    notes = []
    with ha.HACluster(num_shards=2, replication=1, sync=True, job_id="journal") as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        _seed_rows(cli, 40)
        ctrl = ReshardController(c)
        real = flightrec.notify
        flightrec.notify = lambda kind, **info: notes.append((kind, info))
        try:
            ctrl.grow(2)
        finally:
            flightrec.notify = real
        assert ctrl._g_shards.value == 4 and ctrl._c_reshards.value == 1
        stored = c.store.list_prefix("ps/journal/reshard/")
        assert list(stored) == ["ps/journal/reshard/1"]
        assert notes[0][0] == "reshard" and notes[0][1]["to_shards"] == 4
        st = ctrl.stats()
        assert st["num_shards"] == 4 and len(st["pause_ms"]) == len(st["bootstrap_s"]) == 1


def test_actuation_context_backups_and_shard_positions():
    with ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        with c.actuation():
            assert c.coordinator._suspended.is_set()
            assert c.control_mu.acquire(blocking=False)  # reentrant for its holder
            c.control_mu.release()
        assert not c.coordinator._suspended.is_set()
        assert [b.endpoint for b in c.backups(0)] == [c.servers[0][1].endpoint]
        with pytest.raises(PreconditionNotMetError):
            c.spawn_shard(5)  # shards are routing positions
        with pytest.raises(PreconditionNotMetError):
            c.retire_shard(0)  # only the trailing shard retires
        row = c.spawn_shard(2, replication=1)
        assert c.num_shards == 3 and len(row) == 1
        assert c.retire_shard(2) == row and c.num_shards == 2
        for r in row:
            r.close()


def test_checkpoint_save_concurrent_with_reshard(tmp_path):
    """Consistent cuts taken while a grow and a shrink run: the pauses nest,
    ``control_mu`` keeps capture and cutover atomic to each other, and
    every published cut restores digest-consistent."""
    with ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        cli = c.client()
        cfg = _cfg()
        cli.create_sparse_table(0, cfg)
        keys = _seed_rows(cli)
        mgr = JobCheckpointManager(str(tmp_path), gate=c.checkpoint_gate())
        mgr.register_sparse("ctr", RemoteSparseTable(cli, 0, cfg))
        ctrl = ReshardController(c)
        errs = []

        def scale():
            try:
                ctrl.grow(2)
                ctrl.shrink(2)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        th = threading.Thread(target=scale, name="test-reshard")
        th.start()
        saves = 0
        try:
            while th.is_alive():
                mgr.save(step=saves, blocking=True)
                saves += 1
        finally:
            th.join()
        assert not errs, errs
        mgr.save(step=saves, blocking=True)
        mgr.stop()
        assert saves >= 1
        restored = JobCheckpointManager(str(tmp_path)).load_latest()
        assert restored.restore_sparse("ctr", MemorySparseTable(cfg)) == len(keys)


def test_capture_after_a_grow_reads_the_new_topology(tmp_path):
    """A capture by a client that only reads (never bounced) after a grow
    still holds every row: the manager re-resolves the routing under its
    gate."""
    with ha.HACluster(num_shards=2, replication=1, sync=True) as c:
        writer = c.client()
        cfg = _cfg()
        writer.create_sparse_table(0, cfg)
        keys = _seed_rows(writer)
        reader = c.client()
        reader.create_sparse_table(0, cfg)
        ReshardController(c).grow(2)
        assert reader.num_servers == 2  # stale until the capture
        mgr = JobCheckpointManager(str(tmp_path), gate=c.checkpoint_gate())
        mgr.register_sparse("ctr", RemoteSparseTable(reader, 0, cfg))
        mgr.save(step=0, blocking=True)
        mgr.stop()
        assert reader.num_servers == 4
        restored = JobCheckpointManager(str(tmp_path)).load_latest()
        assert restored.restore_sparse("ctr", MemorySparseTable(cfg)) == len(keys)


# -- the hot tier across a grow ------------------------------------------------------


def _tier_trainer(comm, params=None):
    tr = CtrStreamTrainer(DeepFM(CtrConfig(S, D, 8, (8,)),
                                 generator=torch.Generator().manual_seed(0)),
                          Adam(1e-2), None, communicator=comm, table_id=0, embedx_dim=8,
                          hot_tier=HotTierConfig(capacity=1 << 11), device="cpu", **_NAMES)
    if params is not None:
        tr.params = params
        tr.opt_state = tr.optimizer.init(tr.params)
    return tr


def _tier_run(reshard, params=None):
    """Two epochs of 512 lines over the tier on a 2 × 1 sync cluster; with
    ``reshard`` a grow and ``tr.on_reshard()`` between them."""
    with ha.HACluster(num_shards=2, replication=1, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        comm = SyncCommunicator(cli)
        comm.start()
        tr = _tier_trainer(comm, params)
        outs = [tr.train_from_dataset(_dataset(_lines(512, 0)), batch_size=128)]
        occ = tr.hot_tier.stats()["occupancy"]
        assert occ > 0
        if reshard:
            ReshardController(c).grow(2)
            tr.on_reshard()  # flush dirty rows, keep residency, re-route
            st = tr.hot_tier.stats()
            assert st["occupancy"] == occ and st["reshards"] == 1
            assert cli.num_servers == 4
        outs.append(tr.train_from_dataset(_dataset(_lines(512, 1)), batch_size=128))
        if reshard:
            assert tr.hot_tier.stats()["occupancy"] >= occ
        tr.hot_tier.flush()
        comm.barrier()
        pulled = cli.pull_sparse(0, _PROBE, create=False)
        comm.stop()
        return outs, tr, pulled


def test_hot_tier_keeps_resident_set_across_reshard():
    """A grow between two tier epochs drops no resident row, and the run
    ends bitwise equal to one without the grow."""
    outs_r, tr_r, pulled_r = _tier_run(reshard=True)
    outs_o, tr_o, pulled_o = _tier_run(reshard=False)
    assert [o["loss"] for o in outs_r] == [o["loss"] for o in outs_o]
    np.testing.assert_array_equal(pulled_r, pulled_o)
    for k in tr_o.params:
        assert torch.equal(tr_r.params[k], tr_o.params[k]), k


def test_tier_across_a_grow_matches_jax():
    """The tier run across a grow in both packages (the port from the JAX
    model's converted weights) agrees at the stated tolerances."""
    with jax_ha.HACluster(num_shards=2, replication=1, sync=True) as jc:
        jcli = jc.client()
        jcli.create_sparse_table(0, _jax_cfg())
        jcomm = jax_comm.SyncCommunicator(jcli)
        jcomm.start()
        pt.seed(0)
        j = JaxTrainer(JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=8,
                                              dnn_hidden=(8,))),
                       jax_optimizer.Adam(1e-2), None, communicator=jcomm, table_id=0,
                       embedx_dim=8, hot_tier=JaxHotTierConfig(capacity=1 << 11), **_NAMES)
        start = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
        jouts = [j.train_from_dataset(_dataset(_lines(512, 0), JaxDataset, JaxSlotDesc),
                                      batch_size=128)]
        jax_reshard.ReshardController(jc).grow(2)
        j.on_reshard()
        assert jcli.num_servers == 4
        jouts.append(j.train_from_dataset(_dataset(_lines(512, 1), JaxDataset, JaxSlotDesc),
                                          batch_size=128))
        j.hot_tier.flush()
        jcomm.barrier()
        jrows = jcli.pull_sparse(0, _PROBE, create=False)
        jparams = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
        jcomm.stop()
    touts, tr, trows = _tier_run(reshard=True, params=start)
    for to, jo in zip(touts, jouts):
        assert to["steps"] == jo["steps"]
        np.testing.assert_allclose(to["loss"], jo["loss"], rtol=LOSS_RTOL)
    for k, w in jparams.items():
        np.testing.assert_allclose(tr.params[k].numpy(), w.numpy(), err_msg=k, **PARAM_TOL)
    np.testing.assert_allclose(trows, jrows, **ROW_TOL)


# -- the replication plane across a reshard ------------------------------------------


def test_ownership_rides_the_snapshot_attach():
    """A backup attached after a grow receives the ownership predicate with
    its snapshot, so a later promotion bounces stale-topology traffic."""
    with ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        _seed_rows(cli)
        ReshardController(c).grow(2)
        c.drain()
        backup = c.backups(0)[0]
        ep = backup.endpoint
        backup.kill()
        fresh = c.restart_replica(0, ep)
        push = np.zeros((1, 12), np.float32)
        push[:, 1] = 1.0

        def synced():
            # each push makes the shipper notice the restart (ship fails,
            # drop, re-attach, snapshot)
            cli.push_sparse(0, np.array([4], np.uint64), push)
            seq = c.primary(0).server.oplog_seq()
            rm = c.primary(0).rm
            acked = rm.lag()["acked"].get(ep, -1) if rm is not None else -1
            return acked >= seq and fresh.server.applied_seq > 0

        _wait(synced, "the fresh backup never synced")
        conn = rpc.make_conn(ep)
        try:
            own = np.frombuffer(conn.check(rpc._RETAIN, n=0)[1], np.int64)
        finally:
            conn.close()
        assert (int(own[0]), int(own[1])) == (4, 0)


def test_migrate_lag_excluded_from_replication_gauges():
    """A migrate target's cursor is left out of the lag gauges and of the
    sync drain, and it takes sparse rows only (no dense state, no step)."""
    import json

    with ha.HACluster(num_shards=1, replication=2, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        _seed_rows(cli, 50)
        cli.global_step(7)
        c.drain()
        target = rpc.NativePsServer()
        tep = f"127.0.0.1:{target.port}"
        tcli = rpc.RpcPsClient([tep])
        key = ha.observer_key(c.job_id, 0, tep)
        try:
            c.store.put(key, json.dumps({"mode": "migrate"}), ttl=10.0)
            rm = c.primary(0).rm
            _wait(lambda: rm.lag()["acked"].get(tep, -1) >= 0, "the migrate target never synced")
            rm.export_metrics()
            assert tep not in rm._lag_gauges and any(ep != tep for ep in rm._lag_gauges)
            rm.drain(5.0)  # returns without the migrate cursor
            assert tcli.digest(0) == cli.digest(0)  # the rows arrived
            assert tcli.global_step(0) == 0  # no step top-up
        finally:
            c.store.delete(key)
            tcli.close()
            target.close()


def test_coordinator_suspend_blocks_scans_under_the_lock():
    """``suspend()`` gates the scan under ``_step_mu``: a suspended
    coordinator neither promotes nor publishes."""
    store = MemoryStore()
    routing = ha.RoutingTable(store, "sus")
    with rpc.NativePsServer() as backup:
        bep = f"127.0.0.1:{backup.port}"
        routing.publish(0, [{"primary": "10.0.0.1:1", "backups": [bep],
                             "replicas": ["10.0.0.1:1", bep]}])
        store.put(f"ps/sus/hb/{bep}", "{}", ttl=30.0)  # only the backup heartbeats
        coord = ha.FailoverCoordinator(store, "sus", grace_s=0.0)
        coord._missing_since["10.0.0.1:1"] = -1e9
        coord.suspend()
        assert coord.step() == 0
        assert routing.read()[1][0]["primary"] == "10.0.0.1:1"
        coord.resume_scans()
        assert coord.step() == 1
        assert routing.read()[1][0]["primary"] == bep


def test_ssd_remote_digest_and_readonly_ownership_read(tmp_path, one_server):
    """An SSD table's remote digest takes the plain kDigest; the ownership
    read stays open on a read-only server while the retain is refused."""
    s, cli = one_server
    cfg = TableConfig(table_id=0, shard_num=2, accessor="ctr", storage="ssd",
                      ssd_path=str(tmp_path))
    cli.create_sparse_table(0, cfg)
    _seed_rows(cli, 40)
    assert RemoteSparseTable(cli, 0, cfg).digest() == cli.digest(0)
    s.set_read_only(True)
    assert cli.ownership(0) == (0, 0)
    with pytest.raises(PreconditionNotMetError):
        cli.retain(0, 2, 0)
    s.set_read_only(False)


def test_load_cold_replays_across_reshard():
    """``load_cold`` from a stale client bounces, re-resolves and replays;
    each row lands once."""
    with ha.HACluster(num_shards=2, replication=1, sync=False) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        _seed_rows(cli, 50)
        ReshardController(c).grow(2)
        assert cli.num_servers == 2
        keys = np.arange(1000, 1200, dtype=np.uint64)
        vals = np.zeros((len(keys), cli._dims(0)[2]), np.float32)
        vals[:, 5] = 0.5
        assert cli.load_cold(0, keys, vals, chunk=32) == len(keys)
        assert cli.num_servers == 4 and cli.size(0) == 50 + len(keys)
        got, found = cli.export_full(0, keys)
        assert found.all() and (got[:, 5] == 0.5).all()


def test_int8_push_bounced_across_grow_keeps_residuals():
    """An int8-wire push from a stale client bounces across a grow and
    replays the same encoded rows: the error-feedback store and the rows
    end bitwise equal to the same push on a cluster that never resharded."""
    def run(reshard):
        with ha.HACluster(num_shards=2, replication=1, sync=True) as c:
            cli = c.client()
            cli.create_sparse_table(0, _cfg(push_wire_dtype="int8", push_wire_block=4))
            keys = _seed_rows(cli, 200)
            if reshard:
                ReshardController(c).grow(2)
                assert cli.num_servers == 2
            rng = np.random.default_rng(5)
            for _ in range(2):
                cli.push_sparse(0, keys, _push(rng, keys))
            assert cli.num_servers == (4 if reshard else 2)
            store = {k: v.copy() for k, v in cli._push_ef[0].items()}
            return store, cli.pull_sparse(0, keys, create=False)

    got_store, got_rows = run(reshard=True)
    want_store, want_rows = run(reshard=False)
    assert sorted(got_store) == sorted(want_store) and len(want_store) == 200
    for k, v in want_store.items():
        assert got_store[k].tobytes() == v.tobytes(), k
    np.testing.assert_array_equal(got_rows, want_rows)


# -- across the packages -------------------------------------------------------------


def _reshard_record(mod_ha, mod_reshard, cfg):
    """Seeded rows and ops through one package's cluster and controller:
    per-shard digest sets, rows moved and ownership after the grow and after
    the shrink."""
    out = []
    with mod_ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, cfg)
        rng = np.random.default_rng(11)
        keys = np.unique(rng.integers(1, 1 << 40, 600).astype(np.uint64))
        cli.pull_sparse(0, keys)
        cli.push_sparse(0, keys, _push(rng, keys))
        ctrl = mod_reshard.ReshardController(c)
        for op in ("grow", "shrink"):
            rec = getattr(ctrl, op)(2)
            cli.push_sparse(0, keys, _push(rng, keys))  # through the bounce
            c.drain()
            out.append({"digests": [sorted(set(c.digests(0, s).values()))
                                    for s in range(c.num_shards)],
                        "rows_moved": rec.get("rows_moved"),
                        "ownership": [cli.ownership(s) for s in range(c.num_shards)],
                        "size": cli.size(0)})
    return out


def test_reshard_digests_rows_moved_and_ownership_match_jax():
    got = _reshard_record(ha, sys.modules["paddle_tpu_torch.ps.reshard"], _cfg())
    want = _reshard_record(jax_ha, jax_reshard, _jax_cfg())
    assert got == want
    assert [len(r["digests"]) for r in got] == [4, 2]
    assert all(len(d) == 1 for r in got for d in r["digests"])  # replicas agree


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_client_reroutes_across_the_other_packages_grow(client_pkg):
    """A port client (its router over the JAX cluster's store) across a JAX
    cluster's grow, and a JAX client across the port's: the stale client
    bounces, re-resolves to four servers and reads every row unchanged."""
    cluster_ha, cluster_reshard, cfg = ((jax_ha, jax_reshard, _jax_cfg())
                                        if client_pkg == "port" else
                                        (ha, sys.modules["paddle_tpu_torch.ps.reshard"], _cfg()))
    cli_rpc, cli_ha, cli_cfg = ((rpc, ha, _cfg()) if client_pkg == "port"
                                else (jax_rpc, jax_ha, _jax_cfg()))
    with cluster_ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        cli = cli_rpc.RpcPsClient(c.routing.primaries(), router=cli_ha.HARouter(c.store, c.job_id))
        try:
            cli.create_sparse_table(0, cli_cfg)
            keys = _seed_rows(cli, 300)
            before = cli.pull_sparse(0, keys, create=False)
            cluster_reshard.ReshardController(c).grow(2)
            np.testing.assert_array_equal(cli.pull_sparse(0, keys, create=False), before)
            assert cli.num_servers == 4
            cli.push_sparse(0, keys, _push(np.random.default_rng(2), keys))
            c.drain()
            assert cli.size(0) == len(keys)
            for s in range(4):
                assert len(set(c.digests(0, s).values())) == 1
        finally:
            cli.close()


# -- the acceptance run: grow and shrink under load, a kill mid-migration -------------


def _chaos_run(reshard):
    """Six epochs of 768 lines at batch 128 through a SyncCommunicator on a
    2 × 2 sync cluster, a drain after every change. With ``reshard``: a
    kill-shard armed on shard 0's primary for its first kSaveAll (the
    migration's snapshot read) and a grow on a thread before epoch 2, the
    grow joined and a shrink started before epoch 4, joined after the last
    epoch."""
    with ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        cli = c.client()
        cli.create_sparse_table(0, _cfg())
        comm = SyncCommunicator(cli)
        base_send, base_pull = comm.send_sparse, cli.pull_sparse

        def send(table_id, keys, values):
            base_send(table_id, keys, values)
            c.drain()

        def pull(*a, **k):
            out = base_pull(*a, **k)
            c.drain()
            return out

        comm.send_sparse, cli.pull_sparse = send, pull
        comm.start()
        tr = CtrStreamTrainer(DeepFM(CtrConfig(S, D, 8, (8,)),
                                     generator=torch.Generator().manual_seed(0)),
                              Adam(1e-2), None, communicator=comm, table_id=0, embedx_dim=8,
                              device="cpu", **_NAMES)
        ctrl, errs, th, losses, steps = ReshardController(c), [], None, [], 0

        def start(fn):
            def run():
                try:
                    fn()
                except BaseException as e:  # noqa: BLE001 — surfaced below
                    errs.append(e)
            t = threading.Thread(target=run, name="test-scaler")
            t.start()
            return t

        for e in range(6):
            if reshard and e == 1:
                c.primary(0).server.arm_fault("kill-shard", cmd=rpc._SAVE_ALL, after=1)
                th = start(lambda: ctrl.grow(2))
            if reshard and e == 3:
                th.join()
                assert not errs, errs
                assert c.num_shards == 4
                th = start(lambda: ctrl.shrink(2))
            out = tr.train_from_dataset(_dataset(_lines(768, e)), batch_size=128)
            losses.append(out["loss"])
            steps += int(out["steps"])
        if th is not None:
            th.join()
            assert not errs, errs
        comm.barrier()
        c.drain()
        if reshard:
            assert c.num_shards == 2
            assert [ev["direction"] for ev in ctrl.events] == ["grow", "shrink"]
            assert c.coordinator.promotions >= 1
            for s in range(2):
                assert len(set(c.digests(0, s).values())) == 1
        rec = {"losses": losses, "pulled": cli.pull_sparse(0, _PROBE, create=False),
               "digest": sum(cli.digest(0)) & MASK, "rows": cli.size(0),
               "steps": steps, "params": tr.params, "opt": tr.opt_state}
        comm.stop()
        return rec


def test_reshard_under_load_with_a_kill_bitwise_equals_oracle():
    """The acceptance run: grow 2 → 4 and shrink back under load, shard 0's
    primary killed mid-migration; no error reaches the trainer, and the run
    ends bitwise equal to one that never resharded in rows, digests, table
    size, dense params, Adam state and losses."""
    chaos = _chaos_run(reshard=True)
    oracle = _chaos_run(reshard=False)
    assert chaos["steps"] == oracle["steps"] == 36
    assert chaos["rows"] == oracle["rows"] and chaos["digest"] == oracle["digest"]
    assert chaos["losses"] == oracle["losses"]
    np.testing.assert_array_equal(chaos["pulled"], oracle["pulled"])
    for k in oracle["params"]:
        assert torch.equal(chaos["params"][k], oracle["params"][k]), k
    for slot in ("m", "v"):
        for k in oracle["opt"][slot]:
            assert torch.equal(chaos["opt"][slot][k], oracle["opt"][slot][k]), (slot, k)


# -- chip_smoke.py phase 17 ----------------------------------------------------------


def test_chip_smoke_phase_17_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 17 end to end on the CPU at a small size
    (2,048 lines, 400 ids a slot, batch 128: 16 batches; a 2^14-row tier):
    leg A's chaos run (grow, shrink, a kill mid-migration) bitwise against
    its oracle, leg B's tier across a grow with no client op in the warm
    epoch, bitwise against its oracle (the phase's own checks; launch
    counts and the B2/B4 checks are the card's only)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    for name, v in (("HA_LINES", 2048), ("HA_IDS", 400), ("HA_BATCH", 128),
                    ("HA_CAP", 1 << 14)):
        monkeypatch.setattr(chip_smoke, name, v)
    counts, b2, b4 = chip_smoke.phase_reshard(torch.device("cpu"), "cpu")
    assert sum(counts.values()) == 0 and b2 == b4 == {}
