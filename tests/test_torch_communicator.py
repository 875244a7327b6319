"""The port's communicator (``paddle_tpu_torch.ps.communicator``) against
the JAX package's, on the CPU.

- The same queued pushes through the port's Async/HalfAsync communicator
  and port client (port servers) and through the JAX ones (JAX servers)
  land bit-equal rows and dense values: the batches are queued before
  ``start()``, so both merge loops take the same groups.
- The GEO communicator's mean-merged deltas drain equal (exact).
- ``SyncCommunicator.pull_sparse_async`` raises in both packages;
  ``barrier()`` waits for in-flight pulls and fetches; a push that fails
  on the background thread raises at ``barrier()``/``stop()`` and keeps
  the communicator failed.
"""

import threading
import time

import numpy as np
import pytest

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

from paddle_tpu_torch.core.enforce import NotFoundError, PreconditionNotMetError
from paddle_tpu_torch.ps import communicator as comm_mod
from paddle_tpu_torch.ps import rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.table import TableConfig

pytestmark = pytest.mark.usefixtures("jax_native")


def _jax():
    from paddle_tpu.ps import communicator as jax_comm
    from paddle_tpu.ps import rpc as jax_rpc
    from paddle_tpu.ps.accessor import AccessorConfig as JaxAccessorConfig
    from paddle_tpu.ps.table import TableConfig as JaxTableConfig

    return jax_comm, jax_rpc, (JaxTableConfig, JaxAccessorConfig)


class _Cluster:
    def __init__(self, rpc_mod, n=2):
        self.servers = [rpc_mod.NativePsServer(n_trainers=1) for _ in range(n)]
        self.client = rpc_mod.RpcPsClient([f"127.0.0.1:{s.port}" for s in self.servers])

    def close(self):
        self.client.close()
        for s in self.servers:
            s.close()


def _batches(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = rng.integers(1, 400, 256).astype(np.uint64)
        push = np.zeros((len(keys), 12), np.float32)
        push[:, 0] = (keys % 7).astype(np.float32)
        push[:, 1] = 1.0
        push[:, 2] = (rng.random(len(keys)) < 0.3).astype(np.float32)
        push[:, 3:] = rng.normal(0, 0.1, (len(keys), 9)).astype(np.float32)
        out.append((keys, push, rng.normal(size=5).astype(np.float32)))
    return out


def _run(comm_module, rpc_module, configs, kind, batches):
    c = _Cluster(rpc_module)
    try:
        table_config, acc_config = configs
        c.client.create_sparse_table(0, table_config(
            table_id=0, shard_num=4, accessor_config=acc_config(embedx_dim=8), seed=1))
        c.client.create_dense_table(1, dim=5, optimizer="adam", lr=0.01)
        comm = getattr(comm_module, kind)(c.client)
        for keys, push, grad in batches:  # queued before start: one merge group
            comm.send_sparse(0, keys, push)
            comm.send_dense(1, grad)
        comm.start()
        comm.barrier()
        comm.stop()
        k, v = c.client.snapshot_items(0)
        i = np.argsort(k)
        return k[i], v[i], c.client.pull_dense(1), c.client.digest(0)
    finally:
        c.close()


@pytest.mark.parametrize("kind", ["AsyncCommunicator", "HalfAsyncCommunicator",
                                  "SyncCommunicator"])
def test_merged_pushes_land_equal_rows(kind):
    """Rows, dense values and digests bit-equal to the JAX communicator's
    over JAX servers (Sync pushes each batch inline, in both)."""
    jax_comm, jax_rpc, jax_configs = _jax()
    batches = _batches()
    ours = _run(comm_mod, rpc, (TableConfig, AccessorConfig), kind, batches)
    theirs = _run(jax_comm, jax_rpc, jax_configs, kind, batches)
    for a, b in zip(ours[:3], theirs[:3]):
        np.testing.assert_array_equal(a, b)
    assert ours[3] == theirs[3]
    assert len(ours[0]) > 300


def test_geo_communicator_matches_jax():
    jax_comm, jax_rpc, _ = _jax()
    rng = np.random.default_rng(3)
    sends = [(rng.integers(1, 50, 20).astype(np.uint64),
              rng.normal(size=(20, 4)).astype(np.float32)) for _ in range(4)]
    got = []
    for cm, rm in ((comm_mod, rpc), (jax_comm, jax_rpc)):
        c = _Cluster(rm)
        try:
            c.client.create_geo_table(2, dim=4)
            geo = cm.GeoCommunicator(c.client, geo_step=2)
            for keys, delta in sends:
                geo.send_sparse_delta(2, keys, delta)
            k, d = c.client.pull_geo(2)
            i = np.argsort(k)
            got.append((k[i], d[i]))
        finally:
            c.close()
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_sync_communicator_refuses_pull_ahead():
    jax_comm, _, _ = _jax()
    for cm in (comm_mod, jax_comm):
        with pytest.raises(RuntimeError, match="strictly ordered"):
            cm.SyncCommunicator(object()).pull_sparse_async(0, np.arange(3, dtype=np.uint64))


def test_barrier_drains_in_flight_pulls():
    c = _Cluster(rpc)
    try:
        c.client.create_sparse_table(0, TableConfig(shard_num=4))
        comm = comm_mod.HalfAsyncCommunicator(c.client)
        comm.start()
        gate = threading.Event()

        def slow():
            gate.wait(5)
            time.sleep(0.05)
            return "fetched"

        fetch = comm.fetch_async(slow)
        pull = comm.pull_sparse_async(0, np.arange(1, 65, dtype=np.uint64))
        threading.Timer(0.05, gate.set).start()
        comm.barrier()
        assert fetch.done() and pull.done()
        assert fetch.result() == "fetched" and pull.result().shape == (64, 11)
        comm.stop()
    finally:
        c.close()


@pytest.mark.parametrize("join", ["barrier", "stop"])
def test_failed_background_push_raises_at_join(join):
    """A push to a table the servers do not have fails on the push thread;
    the join raises it, and later joins with work queued keep raising."""
    c = _Cluster(rpc)
    try:
        comm = comm_mod.AsyncCommunicator(c.client)
        comm.start()
        keys = np.arange(1, 9, dtype=np.uint64)
        comm.send_sparse(99, keys, np.zeros((8, 12), np.float32))
        deadline = time.monotonic() + 5
        while not comm._push_thread_dead and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(NotFoundError):
            getattr(comm, join)()
        comm.send_sparse(99, keys, np.zeros((8, 12), np.float32))
        with pytest.raises(PreconditionNotMetError, match="push thread died"):
            comm.check_error()
    finally:
        c.close()
