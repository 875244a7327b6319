"""PS high availability in the port: replication, failure detection,
failover (``paddle_tpu_torch.ps.ha`` over the port's ``ps.rpc`` and its
copy of the C++ service), the test of ``tests/test_ps_ha.py`` for test, and
across the packages.

Bottom up: the elastic stores and the lease, the fault-point registry
and the circuit breaker (time monkeypatched, never slept), the
oplog/epoch wire protocol on two bare servers, the ``HACluster`` control
loop (heartbeats, coordinator, promotion, client failover, rejoin), then
the acceptance runs: ``CtrStreamTrainer`` killed mid-epoch on a sync
cluster ends bitwise equal to its fault-free run, and the multi-process
SIGKILL over a ``FileStore``. Across the packages: a JAX client through a
port primary to a port backup and the reverse, replication frames shipped
between a primary of one package and a backup of the other, and the
port's kill run against the JAX package's at the tolerances of
``tests/test_torch_stream_rpc.py`` (losses rtol 1e-5, dense params rtol
1e-4 / atol 1e-6, pulled rows rtol 1e-4 / atol 1e-5: the dense products
run in another order through XLA's and PyTorch's CPU BLAS).

Lease timing is the JAX cluster's default (heartbeat 0.05 s, TTL 0.4 s);
every wait has a deadline of at least 10 s.
"""

import os
import struct
import subprocess
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
from paddle_tpu.ps import rpc as jax_rpc
from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
from paddle_tpu.ps.ps_trainer import CtrStreamTrainer as JaxTrainer
from paddle_tpu.ps.sgd_rule import SGDRuleConfig as JaxSGDRuleConfig
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch.convert import ctr_params_from_jax
from paddle_tpu_torch.core.enforce import (NotFoundError, PreconditionNotMetError,
                                           PsTransportError, UnavailableError)
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.ps import faultpoints as fp
from paddle_tpu_torch.ps import ha, rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.communicator import AsyncCommunicator, SyncCommunicator
from paddle_tpu_torch.ps.faultpoints import (FaultInjected, arm_faultpoint, disarm_faultpoints,
                                             faultpoint)
from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig, row_digest

pytestmark = pytest.mark.usefixtures("jax_native")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 15.0  # every wait's deadline
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ROW_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    disarm_faultpoints()


def _acc():
    return AccessorConfig(sgd=SGDRuleConfig(initial_range=0.0))


def _cfg():
    return TableConfig(shard_num=4, accessor_config=_acc())


def _jax_cfg():
    return JaxTableConfig(shard_num=4, accessor_config=JaxAccessorConfig(
        sgd=JaxSGDRuleConfig(initial_range=0.0)))


def _push(rng, keys, width=12):
    push = np.zeros((len(keys), width), np.float32)
    push[:, 0] = (keys % 8).astype(np.float32)
    push[:, 1] = 1.0
    push[:, 3:] = rng.normal(0, 0.1, (len(keys), width - 3)).astype(np.float32)
    return push


def _wait(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


# -- the elastic stores and the lease ----------------------------------------------


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_store_ttl_prefix_and_delete(kind, tmp_path, monkeypatch):
    store = elastic.store_from_spec("memory:" if kind == "memory" else f"file:{tmp_path}")
    now = [1000.0]
    monkeypatch.setattr(elastic.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(elastic.time, "time", lambda: now[0])
    store.put("ps/j/hb/a:1", "x", ttl=0.4)
    store.put("ps/j/hb/b__2", "y")
    store.put("ps/j/route", "doc")
    assert store.get("ps/j/hb/a:1") == "x"
    assert store.list_prefix("ps/j/hb/") == {"ps/j/hb/a:1": "x", "ps/j/hb/b__2": "y"}
    now[0] += 0.5  # past the TTL
    assert store.get("ps/j/hb/a:1") is None
    assert store.list_prefix("ps/j/hb/") == {"ps/j/hb/b__2": "y"}
    store.delete("ps/j/route")
    assert store.get("ps/j/route") is None
    store.delete("ps/j/route")  # deleting a missing key is fine


def test_lease_refresh_and_expiry(monkeypatch):
    store = elastic.MemoryStore()
    now = [0.0]
    monkeypatch.setattr(elastic.time, "monotonic", lambda: now[0])
    lease = elastic.Lease(store, "k", "v", ttl=1.0)
    assert lease.interval == pytest.approx(1.0 / 3.0)
    lease.refresh()
    assert elastic.Lease.alive(store, "k")
    now[0] = 0.9
    lease.refresh("w")  # a refresh pushes the expiry out again
    now[0] = 1.5
    assert store.get("k") == "w"
    now[0] = 2.0
    assert not elastic.Lease.alive(store, "k")
    lease.refresh()
    lease.release()
    assert not elastic.Lease.alive(store, "k")


def test_tcp_store_is_not_ported():
    with pytest.raises(UnavailableError, match="item 8"):
        elastic.TcpElasticStore()
    with pytest.raises(UnavailableError, match="item 8"):
        elastic.store_from_spec("tcp:127.0.0.1:1234")
    with pytest.raises(ValueError):
        elastic.store_from_spec("etcd:x")


# -- the fault-point registry ---------------------------------------------------------


def test_faultpoint_unarmed_is_noop():
    assert faultpoint("nowhere") is None


def test_faultpoint_schedule_after_every_count():
    spec = arm_faultpoint("site", "corrupt-epoch", after=3, every=2, count=2, param=99)
    fired = [i for i in range(10) if faultpoint("site") is not None]
    assert fired == [2, 4]
    assert spec.fired == 2


def test_faultpoint_drop_frame_raises_transport_error():
    arm_faultpoint("site", "drop-frame")
    with pytest.raises(FaultInjected):
        faultpoint("site")
    assert faultpoint("site") is None
    arm_faultpoint("site", "drop-frame", every=1)
    for _ in range(3):
        with pytest.raises(FaultInjected):
            faultpoint("site")


def test_faultpoint_flag_arming(monkeypatch):
    """FLAGS_ps_faultpoints arms lazily at the first probe; the delay is
    observed through a monkeypatched sleep, not slept."""
    slept, me, real_sleep = [], threading.current_thread(), time.sleep
    monkeypatch.setattr(fp, "_flag_loaded", False)
    monkeypatch.setattr(fp.time, "sleep", lambda s: slept.append(s)
                        if threading.current_thread() is me else real_sleep(s))
    set_flags({"ps_faultpoints": "rpc.call=delay-ms:ms=1:after=2;other=drop-frame"})
    try:
        assert faultpoint("rpc.call") is None
        faultpoint("rpc.call")
        assert slept == [0.001]
        with pytest.raises(FaultInjected):
            faultpoint("other")
    finally:
        set_flags({"ps_faultpoints": ""})
        disarm_faultpoints()


def test_faultpoint_cmd_filter_and_kill_callback():
    killed = []
    arm_faultpoint("site", "kill-shard", cmd=4)
    assert faultpoint("site", cmd=3, kill=lambda: killed.append(1)) is None
    assert faultpoint("site", cmd=4, kill=lambda: killed.append(1)) is not None
    assert killed == [1]


def test_rpc_call_site_walks_the_retry_path(pair):
    """An injected drop on ``rpc.call`` is a transport failure the
    connection retries through; past the retries it raises."""
    prim, _, cp, _ = pair
    cp.create_sparse_table(0, _cfg())
    keys = np.arange(1, 20, dtype=np.uint64)
    spec = arm_faultpoint("rpc.call", "drop-frame", cmd=rpc._PULL_SPARSE)
    assert cp.pull_sparse(0, keys).shape == (len(keys), cp._dims(0)[0])
    assert spec.fired == 1
    arm_faultpoint("rpc.call", "close-socket", cmd=rpc._PULL_SPARSE, every=1)
    with pytest.raises(PsTransportError, match="unreachable"):
        cp.pull_sparse(0, keys)


def test_heartbeat_site_kills_the_server():
    store = ha.MemoryStore()
    s = ha.HAServer(store, "hb", 0, hb_interval=0.05, hb_ttl=0.4)
    try:
        arm_faultpoint("ha.heartbeat", "kill-shard", after=2)
        s.start()
        _wait(lambda: s.server.stopped, "the armed heartbeat never killed the server")
        key = ha._hb_key("hb", s.endpoint)
        _wait(lambda: store.get(key) is None, "the dead server's lease never expired")
    finally:
        s.close()


# -- the circuit breaker ---------------------------------------------------------------


def test_breaker_open_half_open_close():
    t = [0.0]
    b = ha.CircuitBreaker(failures=3, cooldown_s=5.0, clock=lambda: t[0])
    assert b.state == b.CLOSED and b.allow()
    for _ in range(3):
        b.record(ok=False)
    assert b.state == b.OPEN
    assert not b.allow()
    t[0] = 4.9
    assert not b.allow()
    t[0] = 5.1
    assert b.allow()
    assert b.state == b.HALF_OPEN
    assert not b.allow()
    b.record(ok=True)
    assert b.state == b.CLOSED and b.allow()
    assert b.opens == 1


def test_breaker_half_open_failure_reopens():
    t = [0.0]
    b = ha.CircuitBreaker(failures=1, cooldown_s=1.0, clock=lambda: t[0])
    b.record(ok=False)
    assert b.state == b.OPEN
    t[0] = 1.5
    assert b.allow()
    b.record(ok=False)
    assert b.state == b.OPEN
    t[0] = 2.0
    assert not b.allow()
    t[0] = 2.6
    assert b.allow()


def test_router_waits_with_jittered_backoff_on_an_injected_clock():
    store = ha.MemoryStore()
    routing = ha.RoutingTable(store, "r")
    routing.publish(0, [{"primary": "a:1", "backups": ["b:2"], "replicas": ["a:1", "b:2"]}])
    t, naps = [0.0], []

    def sleep(s):
        naps.append(s)
        t[0] += s
        if t[0] > 0.5:
            routing.publish(1, [{"primary": "b:2", "backups": [], "replicas": ["a:1", "b:2"]}])

    r = ha.HARouter(store, "r", failover_timeout_s=5.0, clock=lambda: t[0], sleep=sleep,
                    jitter_seed=3)
    assert r.failover(0, "a:1") == "b:2"
    assert len(naps) >= 3 and all(0 < n <= 0.375 for n in naps)
    r2 = ha.HARouter(store, "r", failover_timeout_s=0.3, clock=lambda: t[0],
                     sleep=lambda s: t.__setitem__(0, t[0] + s), jitter_seed=3)
    assert r2.failover(0, "b:2") is None


# -- the oplog / epoch wire protocol (two bare servers) ---------------------------


@pytest.fixture
def pair():
    prim = rpc.NativePsServer(n_trainers=1)
    back = rpc.NativePsServer(n_trainers=1)
    prim.set_replication(True)
    cp = rpc.RpcPsClient([f"127.0.0.1:{prim.port}"])
    cb = rpc.RpcPsClient([f"127.0.0.1:{back.port}"])
    yield prim, back, cp, cb
    cp.close()
    cb.close()
    prim.close()
    back.close()


def _ship_all(prim, back_conn, epoch=0, send=rpc.send_replicate):
    while True:
        seq, frame = prim.oplog_next(timeout_ms=50)
        if seq < 0:
            return
        st = send(back_conn, frame, seq, epoch)
        assert st == seq, (st, seq)


def test_oplog_orders_and_replays_mutations(pair):
    prim, back, cp, cb = pair
    cp.create_sparse_table(0, _cfg())
    cb.create_sparse_table(0, _cfg())
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 3000, 200).astype(np.uint64)
    cp.pull_sparse(0, keys)
    for _ in range(3):
        cp.push_sparse(0, keys, _push(rng, keys))
    seen = []
    bconn = rpc.make_conn(f"127.0.0.1:{back.port}")
    try:
        last = 0
        while True:
            seq, frame = prim.oplog_next(timeout_ms=50)
            if seq < 0:
                break
            assert seq == last + 1, "oplog seq must be gapless"
            last = seq
            _, cmd, _, _, _ = struct.unpack_from("<QIIqi", frame, 0)
            seen.append(cmd)
            assert rpc.send_replicate(bconn, frame, seq, 0) == seq
        assert seen == [rpc._CREATE_SPARSE, rpc._PULL_SPARSE, rpc._PUSH_SPARSE,
                        rpc._PUSH_SPARSE, rpc._PUSH_SPARSE]
        assert cp.digest(0) == cb.digest(0)
        np.testing.assert_array_equal(cp.pull_sparse(0, keys, create=False),
                                      cb.pull_sparse(0, keys, create=False))
        assert (prim.oplog_seq(), prim.oplog_pending(), prim.oplog_dropped()) == (5, 0, 0)
        assert back.applied_seq == 5
    finally:
        bconn.close()


def test_epoch_fencing_rejects_stale_primary(pair):
    prim, back, cp, _ = pair
    cp.create_sparse_table(0, _cfg())
    rng = np.random.default_rng(1)
    keys = np.arange(1, 50, dtype=np.uint64)
    cp.push_sparse(0, keys, _push(rng, keys))
    bconn = rpc.make_conn(f"127.0.0.1:{back.port}")
    try:
        back.set_epoch(7)
        assert back.epoch == 7
        seq, frame = prim.oplog_next(timeout_ms=100)
        assert seq >= 1
        assert rpc.send_replicate(bconn, frame, seq, epoch=3) == -5
        assert rpc.send_replicate(bconn, frame, seq, epoch=7) == seq
        assert rpc.send_replicate(bconn, frame, seq, epoch=7) == seq
        assert rpc.send_replicate(bconn, frame, seq + 5, epoch=7) == -6
    finally:
        bconn.close()


def test_corrupt_epoch_faultpoint_exercises_fence(pair):
    prim, back, cp, _ = pair
    cp.create_sparse_table(0, _cfg())
    back.set_epoch(2)
    bconn = rpc.make_conn(f"127.0.0.1:{back.port}")
    try:
        seq, frame = prim.oplog_next(timeout_ms=100)
        arm_faultpoint("repl.ship", "corrupt-epoch", param=0)
        assert rpc.send_replicate(bconn, frame, seq, epoch=2) == -5
        disarm_faultpoints("repl.ship")
        assert rpc.send_replicate(bconn, frame, seq, epoch=2) == seq
    finally:
        bconn.close()


def test_replicate_accepts_seq_beyond_32_bits(pair):
    prim, back, cp, cb = pair
    cp.create_sparse_table(0, _cfg())
    cb.create_sparse_table(0, _cfg())
    rng = np.random.default_rng(0)
    keys = np.arange(1, 30, dtype=np.uint64)
    cp.push_sparse(0, keys, _push(rng, keys))
    bconn = rpc.make_conn(f"127.0.0.1:{back.port}")
    try:
        big = (1 << 33) + 7
        back.set_epoch(0)
        bconn.check(rpc._REPL_STATE, n=big - 1)
        frames = []
        while True:
            seq, frame = prim.oplog_next(timeout_ms=50)
            if seq < 0:
                break
            frames.append(frame)
        assert rpc.send_replicate(bconn, frames[-1], big, epoch=0) == big
        assert back.applied_seq == big
    finally:
        bconn.close()


def test_replicate_acks_frames_the_primary_also_rejected(pair):
    prim, back, cp, cb = pair
    cp.create_sparse_table(0, _cfg())
    cb.create_sparse_table(0, _cfg())
    bconn = rpc.make_conn(f"127.0.0.1:{back.port}")
    try:
        bad_payload = b"\x00" * 24
        inner = struct.pack("<QIIqiQQ", len(bad_payload), rpc._PUSH_SPARSE, 0, 5, 0, 0,
                            0) + bad_payload
        assert rpc.send_replicate(bconn, inner, 1, epoch=0) == 1
        assert back.applied_seq == 1
        rng = np.random.default_rng(0)
        keys = np.arange(1, 20, dtype=np.uint64)
        cp.push_sparse(0, keys, _push(rng, keys))
        _ship_all(prim, bconn)
        assert cp.digest(0) == cb.digest(0)
    finally:
        bconn.close()


def test_global_step_replicates_and_reads_stay_ungated(pair):
    prim, _, cp, cb = pair
    bconn = rpc.make_conn(f"127.0.0.1:{pair[1].port}")
    try:
        prim.pause_mutations(True)
        assert cp.global_step(0) == 0
        prim.pause_mutations(False)
        assert cp.global_step(5) == 5
        _ship_all(prim, bconn)
        assert cb.global_step(0) == 5
    finally:
        bconn.close()


def test_read_only_and_dense_version(pair):
    """The serving-replica controls: a read-only server bounces training
    mutations, and its dense version counts the applied dense ops."""
    prim, back, cp, _ = pair
    cp.create_sparse_table(0, _cfg())
    cp.create_dense_table(1, dim=4, optimizer="sgd", lr=0.1)
    v0 = prim.dense_version
    cp.push_dense(1, np.ones(4, np.float32))
    assert prim.dense_version == v0 + 1
    prim.set_read_only(True)
    assert prim.read_only
    keys = np.arange(1, 9, dtype=np.uint64)
    with pytest.raises(PreconditionNotMetError, match="read-only"):
        cp.push_sparse(0, keys, _push(np.random.default_rng(0), keys))
    prim.set_read_only(False)
    assert not prim.read_only


def test_foreign_seq_cursor_forces_snapshot_rebase():
    store = ha.MemoryStore()
    routing = ha.RoutingTable(store, "foreign")
    prim = rpc.NativePsServer(n_trainers=1)
    back = rpc.NativePsServer(n_trainers=1)
    pep, bep = f"127.0.0.1:{prim.port}", f"127.0.0.1:{back.port}"
    routing.publish(0, [{"primary": pep, "backups": [bep], "replicas": [pep, bep]}])
    cp = rpc.RpcPsClient([pep])
    cb = rpc.RpcPsClient([bep])
    rm = None
    try:
        prim.set_replication(True)
        cb.create_sparse_table(0, _cfg())
        bconn = rpc.make_conn(bep)
        bconn.check(rpc._REPL_STATE, n=100_000)
        bconn.close()
        cp.create_sparse_table(0, _cfg())
        rng = np.random.default_rng(0)
        keys = rng.integers(1, 2000, 150).astype(np.uint64)
        cp.push_sparse(0, keys, _push(rng, keys))
        rm = ha.ReplicationManager(prim, pep, 0, routing).start()
        _wait(lambda: cp.digest(0) == cb.digest(0), "the foreign cursor was never rebased")
    finally:
        if rm is not None:
            rm.stop()
        cp.close()
        cb.close()
        prim.close()
        back.close()


def test_application_errors_do_not_trip_breaker_or_failover():
    with ha.HACluster(num_shards=1, replication=2, sync=False) as c:
        cli = c.client(failures=2, cooldown_s=60.0, failover_timeout_s=5.0)
        cli.create_sparse_table(0, _cfg())
        ep = c.primary(0).endpoint
        keys = np.arange(1, 10, dtype=np.uint64)
        t0 = time.perf_counter()
        for _ in range(4):
            with pytest.raises(NotFoundError):
                cli.pull_sparse(42, keys)
        assert time.perf_counter() - t0 < 2.0
        assert cli._router.breaker(ep).state == ha.CircuitBreaker.CLOSED
        cli.pull_sparse(0, keys)


def test_shard_op_app_error_releases_half_open_probe():
    server = rpc.NativePsServer(n_trainers=1)
    ep = f"127.0.0.1:{server.port}"
    t = [0.0]

    class StubRouter:
        def __init__(self):
            self.b = ha.CircuitBreaker(failures=1, cooldown_s=0.01, clock=lambda: t[0])

        def routing(self):
            return 0, [ep]

        def allow(self, endpoint):
            return self.b.allow()

        def record(self, endpoint, ok):
            self.b.record(ok)

        def failover(self, shard, bad):
            return None

    router = StubRouter()
    cli = rpc.RpcPsClient([ep], router=router)
    try:
        router.b.record(ok=False)
        assert router.b.state == ha.CircuitBreaker.OPEN
        t[0] = 0.02  # past the cooldown: the next allow() is the probe
        with pytest.raises(NotFoundError):
            cli.digest(99)
        assert router.b.state == ha.CircuitBreaker.CLOSED
        cli.create_sparse_table(0, _cfg())
    finally:
        cli.close()
        server.close()


def test_communicator_stays_failed_after_first_error_surfaces():
    class DoomedClient:
        def push_sparse(self, table_id, keys, values):
            raise PsTransportError("server gone")

        def pull_sparse(self, table_id, keys, create=True, slots=None):
            return np.zeros((len(keys), 1), np.float32)

    comm = AsyncCommunicator(DoomedClient())
    comm.start()
    keys = np.arange(3, dtype=np.uint64)
    comm.send_sparse(0, keys, np.zeros((3, 4), np.float32))
    with pytest.raises(PsTransportError):
        comm.barrier()
    comm.send_sparse(0, keys, np.zeros((3, 4), np.float32))
    t0 = time.perf_counter()
    with pytest.raises(PreconditionNotMetError):
        comm.barrier()
    assert time.perf_counter() - t0 < 15.0
    with pytest.raises(PreconditionNotMetError):
        comm.stop()


def test_server_fault_drop_frame_and_delay(pair):
    prim, _, cp, _ = pair
    cp.create_sparse_table(0, _cfg())
    keys = np.arange(1, 20, dtype=np.uint64)
    prim.arm_fault("drop-frame", cmd=rpc._PULL_SPARSE, after=1)
    out = cp.pull_sparse(0, keys, create=False)
    assert out.shape[0] == len(keys)
    prim.arm_fault("delay-ms", cmd=rpc._PULL_SPARSE, after=1, param=120)
    t0 = time.perf_counter()
    cp.pull_sparse(0, keys, create=False)
    assert time.perf_counter() - t0 >= 0.1


# -- HACluster: replication, failover, rejoin ----------------------------------------


@pytest.fixture
def cluster():
    with ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        yield c


def test_sync_replication_bit_identical_at_barrier(cluster):
    cli = cluster.client()
    cli.create_sparse_table(0, _cfg())
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 5000, 500).astype(np.uint64)
    cli.pull_sparse(0, keys)
    cli.push_sparse(0, keys, _push(rng, keys))
    cluster.drain()
    for shard in range(2):
        dg = cluster.digests(0, shard)
        assert len(dg) == 2 and len(set(dg.values())) == 1, dg


def test_failover_reroutes_pulls_and_pushes(cluster):
    cli = cluster.client()
    cli.create_sparse_table(0, _cfg())
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 5000, 300).astype(np.uint64)
    cli.pull_sparse(0, keys)
    cli.push_sparse(0, keys, _push(rng, keys))
    cluster.drain()
    before = cli.pull_sparse(0, keys, create=False)
    dead = cluster.kill_primary(0)
    after = cli.pull_sparse(0, keys, create=False)
    np.testing.assert_array_equal(before, after)
    assert cluster.wait_promoted(0, dead) != dead
    cli.push_sparse(0, keys, _push(rng, keys))
    cluster.drain()
    assert np.abs(cli.pull_sparse(0, keys, create=False) - before).sum() > 0


def test_barrier_rides_through_promotion(cluster):
    cli = cluster.client()
    cli.create_sparse_table(0, _cfg())
    dead = cluster.kill_primary(0)
    cli.barrier()
    assert cluster.wait_promoted(0, dead) != dead


def test_in_flight_async_pull_replays_across_failover(cluster):
    cli = cluster.client()
    cli.create_sparse_table(0, _cfg())
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 4000, 256).astype(np.uint64)
    cli.pull_sparse(0, keys)
    cli.push_sparse(0, keys, _push(rng, keys))
    cluster.drain()
    want = cli.pull_sparse(0, keys, create=False)
    comm = AsyncCommunicator(cli)
    comm.start()
    try:
        cluster.primary(0).server.arm_fault("kill-shard", cmd=rpc._PULL_SPARSE, after=1)
        fut = comm.pull_sparse_async(0, keys, create=False)
        got = fut.result(timeout=30)
        np.testing.assert_array_equal(got, want)
        assert cluster.coordinator.promotions >= 1
    finally:
        comm.stop()


def test_rejoin_snapshot_and_tail_catch_up(cluster):
    cli = cluster.client()
    cli.create_sparse_table(0, _cfg())
    cli.create_dense_table(1, dim=16, optimizer="adam", lr=0.05)
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 5000, 400).astype(np.uint64)
    cli.pull_sparse(0, keys)
    cli.push_sparse(0, keys, _push(rng, keys))
    cli.push_dense(1, np.ones(16, np.float32))
    cluster.drain()
    dead = cluster.kill_primary(0)
    new_prim = cluster.wait_promoted(0, dead)
    for _ in range(3):
        cli.push_sparse(0, keys, _push(rng, keys))
        cli.push_dense(1, np.ones(16, np.float32))
    cluster.restart_replica(0, dead)
    _wait(lambda: dead in cluster.routing.read()[1][0]["backups"],
          "the restarted replica never rejoined the routing table")
    cli.push_sparse(0, keys, _push(rng, keys))
    cluster.drain()
    dg = cluster.digests(0, 0)
    assert len(dg) == 2 and len(set(dg.values())) == 1, dg
    a = rpc.RpcPsClient([new_prim])
    b = rpc.RpcPsClient([dead])
    a._dense_dims[1] = b._dense_dims[1] = 8
    try:
        np.testing.assert_array_equal(a.pull_dense(1), b.pull_dense(1))
        # the rejoin snapshot restored the dense state whole
        blob = a.dense_snapshot(1, 0)
        assert blob == b.dense_snapshot(1, 0)
        cli.push_dense(1, np.ones(16, np.float32))  # moves the primary on
        cluster.drain()
        a.dense_restore(1, 0, blob)  # and back: the snapshot is the whole state
        assert a.dense_snapshot(1, 0) == blob
        assert a.repl_state(0)[1] == b.repl_state(0)[1] == 1  # both at the new epoch
    finally:
        a.close()
        b.close()


def test_oplog_overflow_falls_back_to_snapshot():
    store = ha.MemoryStore()
    routing = ha.RoutingTable(store, "ovf")
    prim = rpc.NativePsServer(n_trainers=1)
    back = rpc.NativePsServer(n_trainers=1)
    pep, bep = f"127.0.0.1:{prim.port}", f"127.0.0.1:{back.port}"
    routing.publish(0, [{"primary": pep, "backups": [bep], "replicas": [pep, bep]}])
    cp = rpc.RpcPsClient([pep])
    cb = rpc.RpcPsClient([bep])
    rm = None
    try:
        prim.set_replication(True, cap_entries=8)
        cp.create_sparse_table(0, _cfg())
        rng = np.random.default_rng(0)
        keys = rng.integers(1, 3000, 200).astype(np.uint64)
        for _ in range(30):
            cp.push_sparse(0, keys, _push(rng, keys))
        assert prim.oplog_dropped() > 0
        rm = ha.ReplicationManager(prim, pep, 0, routing, oplog_cap=8).start()

        def caught_up():
            lg = rm.lag()
            return lg["acked"].get(bep, -1) >= lg["seq"] and lg["pending"] == 0
        _wait(caught_up, "the overflowed backup never caught up")
        assert cp.digest(0) == cb.digest(0)
        rm.export_metrics()  # the lag gauges read 0 once caught up
    finally:
        if rm is not None:
            rm.stop()
        cp.close()
        cb.close()
        prim.close()
        back.close()


def test_breaker_opens_after_repeated_failures_without_promotion():
    old = get_flags(["pserver_connect_timeout_ms", "pserver_timeout_ms",
                     "pserver_max_retry", "pserver_retry_backoff_ms"])
    set_flags({"pserver_connect_timeout_ms": 200, "pserver_timeout_ms": 300,
               "pserver_max_retry": 1, "pserver_retry_backoff_ms": 10})
    try:
        with ha.HACluster(num_shards=1, replication=1, sync=False) as c:
            cli = c.client(failures=2, cooldown_s=60.0, failover_timeout_s=0.2)
            cli.create_sparse_table(0, _cfg())
            keys = np.arange(1, 20, dtype=np.uint64)
            cli.pull_sparse(0, keys)
            ep = c.primary(0).endpoint
            c.kill_primary(0)
            for _ in range(2):
                with pytest.raises(PreconditionNotMetError):
                    cli.pull_sparse(0, keys, create=False)
            assert cli._router.breaker(ep).state == ha.CircuitBreaker.OPEN
            t0 = time.perf_counter()
            with pytest.raises(PreconditionNotMetError):
                cli.pull_sparse(0, keys, create=False)
            assert time.perf_counter() - t0 < 1.0
    finally:
        set_flags(old)


def test_not_ported_surfaces_raise(cluster):
    cli = cluster.client()
    for call, entry in ((lambda: cluster.client(qos="serve"), "entry 5"),
                        (lambda: cluster.obs_probe(), "entry 6"),
                        (lambda: cli.density_series(0), "item 10"),
                        (lambda: rpc.RpcPsClient([], tenant=(1, b"t")), "entry 4"),
                        (lambda: ha.HARouter(cluster.store, "x", qos="serve"), "entry 5")):
        with pytest.raises(UnavailableError, match=entry):
            call()


# -- e2e: the stream trainer survives a kill-shard, bitwise ------------------------


S, D = 3, 2
_NAMES = dict(sparse_slots=[f"s{i}" for i in range(S)],
              dense_slots=[f"d{i}" for i in range(D)], label_slot="label")


def _lines(n=384, seed=0):
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


_PROBE = np.unique((np.arange(0, 48, dtype=np.uint64)[None, :]
                    + (np.arange(S, dtype=np.uint64)[:, None] << np.uint64(32))).reshape(-1))


def _draining(comm, cluster):
    """Sync replication: drain after every send, so an acked op is on the
    backup before the next lands and a kill loses nothing."""
    base = comm.send_sparse

    def send_and_drain(table_id, keys, values):
        base(table_id, keys, values)
        cluster.drain()

    comm.send_sparse = send_and_drain
    return comm


def _run_stream_trainer(cli, cluster, kill_after_pushes=None, params=None):
    """One deterministic CtrStreamTrainer run of the port against ``cli``'s
    table 0 (DeepFM 3 slots x dim 8, DNN (8,), batch 128, 384 records);
    with ``kill_after_pushes`` shard 0's primary dies on that push."""
    cli.create_sparse_table(0, _cfg())
    if kill_after_pushes is not None:
        cluster.primary(0).server.arm_fault("kill-shard", cmd=rpc._PUSH_SPARSE,
                                            after=kill_after_pushes)
    comm = _draining(SyncCommunicator(cli), cluster)
    comm.start()
    tr = CtrStreamTrainer(DeepFM(CtrConfig(S, D, 8, (8,)),
                                 generator=torch.Generator().manual_seed(0)),
                          Adam(1e-2), None, communicator=comm, table_id=0, embedx_dim=8,
                          device="cpu", **_NAMES)
    if params is not None:
        opt = Adam(1e-2)
        tr = CtrStreamTrainer(DeepFM(CtrConfig(S, D, 8, (8,))), opt, None, communicator=comm,
                              table_id=0, embedx_dim=8, device="cpu", **_NAMES)
        tr.params = params
        tr.opt_state = opt.init(tr.params)
    out = tr.train_from_dataset(_dataset(_lines()), batch_size=128)
    comm.stop()
    assert np.isfinite(out["loss"])
    return out, tr, cli.pull_sparse(0, _PROBE, create=False)


def test_stream_trainer_killed_mid_epoch_ends_bitwise():
    """The acceptance run: a kill-shard armed on shard 0's primary fires
    mid-epoch; training completes through the failover and the final
    pulled rows, dense params and Adam state are bitwise equal to a
    fault-free run."""
    with ha.HACluster(num_shards=2, replication=2, sync=True) as oracle:
        ok_out, ok_tr, ok_rows = _run_stream_trainer(oracle.client(), oracle)
    with ha.HACluster(num_shards=2, replication=2, sync=True) as chaotic:
        out, tr, rows = _run_stream_trainer(chaotic.client(), chaotic, kill_after_pushes=2)
        assert chaotic.coordinator.promotions >= 1
        assert chaotic.servers[0][0].server.stopped
    assert out["steps"] == ok_out["steps"] == 3.0
    assert out["loss"] == ok_out["loss"]
    np.testing.assert_array_equal(rows, ok_rows)
    for k in ok_tr.params:
        assert torch.equal(tr.params[k], ok_tr.params[k]), k
    for slot in ("m", "v"):
        for k in ok_tr.opt_state[slot]:
            assert torch.equal(tr.opt_state[slot][k], ok_tr.opt_state[slot][k]), (slot, k)


def test_stream_kill_run_matches_jax():
    """The same kill run in both packages (JAX: its HACluster, client and
    trainer; the port: its own, from the JAX model's converted weights)
    agrees at the stated tolerances."""
    with jax_ha.HACluster(num_shards=2, replication=2, sync=True) as jc:
        jcli = jc.client()
        jcli.create_sparse_table(0, _jax_cfg())
        jc.primary(0).server.arm_fault("kill-shard", cmd=jax_rpc._PUSH_SPARSE, after=2)
        jcomm = jax_comm.SyncCommunicator(jcli)
        base = jcomm.send_sparse
        jcomm.send_sparse = lambda t, k, v: (base(t, k, v), jc.drain())
        jcomm.start()
        pt.seed(0)
        j = JaxTrainer(JaxDeepFM(JaxCtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=8,
                                              dnn_hidden=(8,))),
                       jax_optimizer.Adam(1e-2), None, communicator=jcomm, table_id=0,
                       embedx_dim=8, **_NAMES)
        start = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
        jout = j.train_from_dataset(_dataset(_lines(), JaxDataset, JaxSlotDesc),
                                    batch_size=128)
        jcomm.stop()
        assert jc.coordinator.promotions >= 1
        jrows = jcli.pull_sparse(0, _PROBE, create=False)
        jparams = ctr_params_from_jax(jax.tree_util.tree_map(np.asarray, j.params))
    with ha.HACluster(num_shards=2, replication=2, sync=True) as tc:
        tout, tr, trows = _run_stream_trainer(tc.client(), tc, kill_after_pushes=2,
                                              params=start)
        assert tc.coordinator.promotions >= 1
    assert tout["steps"] == jout["steps"] == 3.0
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=LOSS_RTOL)
    for k, w in jparams.items():
        np.testing.assert_allclose(tr.params[k].numpy(), w.numpy(), err_msg=k, **PARAM_TOL)
    np.testing.assert_allclose(trows, jrows, **ROW_TOL)


# -- the multi-process SIGKILL over a FileStore ------------------------------------


_HA_SERVER_SCRIPT = """
import sys, time
from paddle_tpu_torch.distributed.elastic import FileStore
from paddle_tpu_torch.ps.ha import HAServer
store = FileStore(sys.argv[1])
s = HAServer(store, sys.argv[2], int(sys.argv[3]), n_trainers=1,
             hb_interval=0.1, hb_ttl=0.6)
s.start()
print("READY", s.endpoint, flush=True)
while not s.server.stopped:
    time.sleep(0.1)
print("DEAD", flush=True)
"""


def test_multiprocess_sigkill_fails_over(tmp_path):
    """Two replicas of one shard in separate processes over a FileStore;
    the primary is SIGKILLed mid-traffic, the parent's coordinator promotes
    the backup, and pulls keep answering from the replicated state
    (drained before the kill by ``drain_remote``)."""
    store_dir = str(tmp_path / "store")
    store = elastic.FileStore(store_dir)
    procs, eps = [], []
    try:
        for _ in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _HA_SERVER_SCRIPT, store_dir, "mp", "0"],
                stdout=subprocess.PIPE, text=True, cwd=ROOT))
        for p in procs:
            line = p.stdout.readline().strip()
            assert line.startswith("READY"), line
            eps.append(line.split()[1])
        routing = ha.RoutingTable(store, "mp")
        routing.publish(0, [{"primary": eps[0], "backups": [eps[1]], "replicas": eps}])
        coord = ha.FailoverCoordinator(store, "mp", grace_s=0.2, poll_s=0.05).start()
        try:
            cli = rpc.RpcPsClient([eps[0]], router=ha.HARouter(store, "mp"))
            cli.create_sparse_table(0, _cfg())
            rng = np.random.default_rng(0)
            keys = rng.integers(1, 4000, 300).astype(np.uint64)
            cli.pull_sparse(0, keys)
            cli.push_sparse(0, keys, _push(rng, keys))
            ha.drain_remote(eps[0], [eps[1]])
            want = cli.pull_sparse(0, keys, create=False)
            procs[0].kill()
            got = cli.pull_sparse(0, keys, create=False)
            np.testing.assert_array_equal(got, want)
            assert routing.read()[1][0]["primary"] == eps[1]
            cli.push_sparse(0, keys, _push(rng, keys))
            assert np.abs(cli.pull_sparse(0, keys, create=False) - want).sum() > 0
            cli.close()
        finally:
            coord.stop()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=WAIT_S)
            p.stdout.close()


def test_digest_matches_local_oracle():
    server = rpc.NativePsServer(n_trainers=1)
    cli = rpc.RpcPsClient([f"127.0.0.1:{server.port}"])
    local = MemorySparseTable(_cfg())
    try:
        cli.create_sparse_table(0, _cfg())
        rng = np.random.default_rng(3)
        keys = np.unique(rng.integers(1, 2000, 300).astype(np.uint64))
        slots = (keys % 8).astype(np.int32)
        push = _push(rng, keys)
        push[:, 0] = slots
        cli.pull_sparse(0, keys, slots=slots)
        cli.push_sparse(0, keys, push)
        local.pull_sparse(keys, slots=slots)
        local.push_sparse(keys, push)
        (remote_digest,) = cli.digest(0)
        assert remote_digest == local.digest() == cli.digest_at(0, 0)
        vals, found = local.export_full(keys)
        assert found.all()
        assert remote_digest == row_digest(keys, vals)
    finally:
        local.close()
        cli.close()
        server.close()


def test_self_conn_lazy_connect_outside_lock(monkeypatch):
    """ReplicationManager._self builds its connection outside ``_mu``;
    racing callers get one shared connection and the loser's stray is
    closed."""

    class FakeConn:
        def __init__(self):
            self.closed = False

        def close(self):
            self.closed = True

    built = []

    def fake_make_conn(endpoint):
        c = FakeConn()
        built.append(c)
        barrier.wait(timeout=5)
        return c

    monkeypatch.setattr(ha, "make_conn", fake_make_conn)
    srv = ha.ReplicationManager.__new__(ha.ReplicationManager)
    srv._mu = threading.Lock()
    srv._self_conn = None
    srv.endpoint = "127.0.0.1:0"
    barrier = threading.Barrier(2)
    got = []
    ts = [threading.Thread(target=lambda: got.append(srv._self()), name=f"racer-{i}")
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert len(got) == 2 and got[0] is got[1]
    assert len(built) == 2
    winner = got[0]
    strays = [c for c in built if c is not winner]
    assert len(strays) == 1 and strays[0].closed
    assert not winner.closed
    assert srv._self() is winner and len(built) == 2


# -- across the packages ----------------------------------------------------------------


def _ops(cli, cfg, digest_pkg_rows=True):
    """The op sequence the cross-package replication tests run: create,
    pull-create, two pushes, a dense table and a push to it."""
    cli.create_sparse_table(0, cfg)
    cli.create_dense_table(1, dim=10, optimizer="adam", lr=0.05)
    rng = np.random.default_rng(9)
    keys = rng.integers(1, 6000, 400).astype(np.uint64)
    cli.pull_sparse(0, keys)
    for _ in range(2):
        cli.push_sparse(0, keys, _push(rng, keys))
    cli.push_dense(1, np.linspace(-1, 1, 10).astype(np.float32))
    return keys


@pytest.mark.parametrize("cluster_pkg", ["port", "jax"])
def test_client_of_one_package_replicates_through_the_other(cluster_pkg):
    """A JAX client through a port primary to a port backup, and a port
    client through a JAX primary to a JAX backup: every replica's digest
    is equal, and equal to the port-only run's."""
    with ha.HACluster(num_shards=2, replication=2, sync=True) as ref:
        rcli = ref.client()
        keys = _ops(rcli, _cfg())
        ref.drain()
        want = [ref.digests(0, s) for s in range(2)]
        want_rows = rcli.pull_sparse(0, keys, create=False)
    mod_ha, cli_rpc, cfg = ((ha, jax_rpc, _jax_cfg()) if cluster_pkg == "port"
                            else (jax_ha, rpc, _cfg()))
    with mod_ha.HACluster(num_shards=2, replication=2, sync=True) as c:
        cli = cli_rpc.RpcPsClient(c.routing.primaries())
        try:
            _ops(cli, cfg)
            c.drain()
            for s in range(2):
                dg = c.digests(0, s)
                assert len(dg) == 2 and set(dg.values()) == set(want[s].values()), (dg, want)
            np.testing.assert_array_equal(cli.pull_sparse(0, keys, create=False), want_rows)
        finally:
            cli.close()


@pytest.mark.parametrize("primary_pkg,backup_pkg", [("port", "jax"), ("jax", "port")])
def test_replication_frames_cross_packages(primary_pkg, backup_pkg):
    """The oplog frames of a primary of one package, shipped by the other
    package's ``send_replicate``, apply on a backup of the other: one
    protocol."""
    mods = {"port": rpc, "jax": jax_rpc}
    pm, bm = mods[primary_pkg], mods[backup_pkg]
    prim, back = pm.NativePsServer(n_trainers=1), bm.NativePsServer(n_trainers=1)
    prim.set_replication(True)
    cp = pm.RpcPsClient([f"127.0.0.1:{prim.port}"])
    cb = bm.RpcPsClient([f"127.0.0.1:{back.port}"])
    bconn = bm.make_conn(f"127.0.0.1:{back.port}")
    try:
        cfg = _cfg() if pm is rpc else _jax_cfg()
        cfg.push_wire_dtype = "int8"  # quantized frames ride the same oplog
        keys = _ops(cp, cfg)
        cb.create_sparse_table(0, _cfg() if bm is rpc else _jax_cfg())
        _ship_all(prim, bconn, send=bm.send_replicate)
        assert cp.digest(0) == cb.digest(0)
        assert back.applied_seq == prim.oplog_seq()
        np.testing.assert_array_equal(cp.pull_sparse(0, keys, create=False),
                                      cb.pull_sparse(0, keys, create=False))
    finally:
        bconn.close()
        cp.close()
        cb.close()
        prim.close()
        back.close()


def test_chip_smoke_phase_16_on_the_cpu(monkeypatch):
    """``chip_smoke.py`` phase 16 end to end on the CPU at a small size
    (2,048 lines, 400 ids a slot, batch 128: 16 batches; a 2^14-row tier):
    leg A's byte formula, residual drain and replica digests, leg B's two
    arms bitwise against their oracles, the rejoin, the checkpoint cuts,
    and leg C's four SIGKILL-able server processes bitwise against leg B's
    RPC-only oracle (the phase's own checks; launch counts and the B2/B4
    checks are the card's only)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    for name, v in (("HA_LINES", 2048), ("HA_IDS", 400), ("HA_BATCH", 128),
                    ("HA_CAP", 1 << 14)):
        monkeypatch.setattr(chip_smoke, name, v)
    counts, b2, b4 = chip_smoke.phase_ha(torch.device("cpu"), "cpu")
    assert sum(counts.values()) == 0 and b2 == b4 == {}


def test_ha_and_wire_flags_match_the_jax_package():
    """The HA module's flags and the error-feedback cap: the JAX names and
    defaults."""
    from paddle_tpu.core.flags import get_flags as jax_get_flags

    names = ["ps_replication_factor", "ps_ha_oplog_cap", "ps_ha_heartbeat_ms",
             "ps_ha_lease_ttl_ms", "ps_ha_failover_grace_ms", "ps_breaker_failures",
             "ps_breaker_cooldown_ms", "ps_ha_failover_timeout_ms", "ps_push_ef_max_rows"]
    assert get_flags(names) == jax_get_flags(names)
