"""The port's the_one_ps transport (``paddle_tpu_torch.ps.rpc``) on the CPU.

The cases of ``tests/test_ps_rpc.py`` that the port covers, the port's
client against the port's in-process servers (two on 127.0.0.1, ephemeral
ports), each with its tolerance:

- sparse pull/push against the port's local ``MemorySparseTable``
  (atol 1e-6: the server's C++ rule and the table's numpy rule round the
  same f32 operations; rows created with ``initial_range=0``);
- the dense optimizers against ``MemoryDenseTable`` (SGD exact, Adam atol
  1e-6) and the GEO table (exact);
- save/load to a fresh cluster, export/import of full rows, the barrier
  with two trainers, a missing table, a dead server (exact);
- the SSD table over RPC (spill, stats, compact, restart replay) and the
  bulk ``load_cold`` with a server-side gzip save and load (exact; the
  text round trip within rtol 1e-6 / atol 1e-9, as the JAX test);
- the wire across the packages: the same operations through the JAX
  client against the port's servers and through the port's client
  against the JAX servers give bit-equal rows and equal digests.

Clients close before their servers (a connection to a stopped server
waits out its deadline).
"""

import threading
import time

import numpy as np
import pytest

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

from paddle_tpu_torch.core.enforce import (NotFoundError, PreconditionNotMetError,
                                           PsTransportError)
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.ps import rpc
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import MemoryDenseTable, MemorySparseTable, TableConfig

pytestmark = pytest.mark.usefixtures("jax_native")


def _acc(**kw):
    return AccessorConfig(sgd=SGDRuleConfig(initial_range=0.0), **kw)


class _Cluster:
    """``n`` servers of one package and a client of either."""

    def __init__(self, server_mod, client_mod, n=2, n_trainers=1):
        self.servers = [server_mod.NativePsServer(n_trainers=n_trainers) for _ in range(n)]
        self.endpoints = [f"127.0.0.1:{s.port}" for s in self.servers]
        self.client = client_mod.RpcPsClient(self.endpoints)

    def close(self):
        self.client.close()
        for s in self.servers:
            s.close()


@pytest.fixture
def cluster():
    c = _Cluster(rpc, rpc)
    yield c.servers, c.client
    c.close()


def _push_rows(rng, keys, width, show=2.0):
    push = np.zeros((len(keys), width), np.float32)
    push[:, 0] = (keys % 26).astype(np.float32)
    push[:, 1] = show
    push[:, 2] = 1.0
    push[:, 3:] = rng.normal(0, 0.1, (len(keys), width - 3)).astype(np.float32)
    return push


def test_sparse_pull_push_matches_local_table(cluster):
    _, cli = cluster
    cli.create_sparse_table(0, TableConfig(shard_num=4, accessor_config=_acc()))
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 5000, 300).astype(np.uint64)   # with duplicates
    slots = (keys % 26).astype(np.int32)
    assert (cli.pull_sparse(0, keys, slots=slots) == 0).all()
    push = _push_rows(rng, keys, 12)
    cli.push_sparse(0, keys, push)
    local = MemorySparseTable(TableConfig(shard_num=4, accessor_config=_acc()))
    try:
        local.pull_sparse(keys, slots)
        local.push_sparse(keys, push)
        np.testing.assert_allclose(cli.pull_sparse(0, keys, create=False),
                                   local.pull_sparse(keys, create=False), atol=1e-6)
        assert cli.size(0) == local.size()
    finally:
        local.close()
    assert cli.op_counts == {"pull_sparse": 2, "push_sparse": 1}
    assert cli.reset_op_counts() == {"pull_sparse": 2, "push_sparse": 1}
    assert cli.op_counts == {}


def test_dense_optimizers_and_geo(cluster):
    from paddle_tpu.ps.table import MemoryDenseTable as JaxDenseTable

    _, cli = cluster
    cli.create_dense_table(1, dim=7, optimizer="sgd", lr=0.5)
    cli.set_dense(1, np.arange(7, dtype=np.float32))
    cli.push_dense(1, np.ones(7, np.float32))
    np.testing.assert_array_equal(cli.pull_dense(1), np.arange(7) - 0.5)
    cli.create_dense_table(2, dim=3, optimizer="adam", lr=0.1)
    ref, jref = MemoryDenseTable(3, "adam", 0.1), JaxDenseTable(3, "adam", 0.1)
    for _ in range(3):
        cli.push_dense(2, np.ones(3, np.float32))
        ref.push_dense(np.ones(3, np.float32))
        jref.push_dense(np.ones(3, np.float32))
    np.testing.assert_allclose(cli.pull_dense(2), ref.pull_dense(), atol=1e-6)
    np.testing.assert_array_equal(ref.pull_dense(), jref.pull_dense())

    cli.create_geo_table(3, dim=4)
    cli.push_geo(3, np.array([7, 8], np.uint64), np.ones((2, 4), np.float32))
    cli.push_geo(3, np.array([7], np.uint64), 3 * np.ones((1, 4), np.float32))
    k, d = cli.pull_geo(3)
    assert dict(zip(k.tolist(), d[:, 0].tolist())) == {7: 2.0, 8: 1.0}  # mean per key
    assert len(cli.pull_geo(3)[0]) == 0  # drained


def test_save_load_roundtrip(cluster, tmp_path):
    _, cli = cluster
    cfg = TableConfig(shard_num=4, accessor_config=_acc())
    cli.create_sparse_table(0, cfg)
    rng = np.random.default_rng(1)
    keys = rng.integers(1, 2000, 200).astype(np.uint64)
    cli.push_sparse(0, keys, _push_rows(rng, keys, 12))
    before = cli.pull_sparse(0, keys, create=False)
    n = cli.save(0, str(tmp_path), 0)
    assert n == cli.size(0)
    other = _Cluster(rpc, rpc)
    try:
        other.client.create_sparse_table(0, cfg)
        assert other.client.load(0, str(tmp_path)) == n
        np.testing.assert_allclose(other.client.pull_sparse(0, keys, create=False), before,
                                   atol=1e-6)
    finally:
        other.close()
    # the files are a local table's checkpoint too
    local = MemorySparseTable(cfg)
    try:
        assert local.load(str(tmp_path)) == n
        np.testing.assert_allclose(local.pull_sparse(keys, create=False), before, atol=1e-6)
    finally:
        local.close()


def test_export_import_full(cluster):
    _, cli = cluster
    cli.create_sparse_table(0, TableConfig(shard_num=4, accessor_config=_acc()))
    keys = np.array([11, 22, 33], np.uint64)
    push = np.zeros((3, 12), np.float32)
    push[:, 1] = 1.0
    push[:, 3:] = 0.2
    cli.push_sparse(0, keys, push)
    vals, found = cli.export_full(0, np.array([11, 22, 99], np.uint64))
    assert found.tolist() == [True, True, False]
    assert (vals[2] == 0).all()
    cli.create_sparse_table(5, TableConfig(shard_num=4, accessor_config=_acc()))
    cli.import_full(5, keys, cli.export_full(0, keys)[0])
    np.testing.assert_array_equal(cli.export_full(5, keys)[0], cli.export_full(0, keys)[0])
    created, found = cli.export_full(5, np.array([44], np.uint64), create=True)
    assert found[0] and cli.size(5) == 4  # inserted in the same visit


def _listen_address(port):
    """The local address a listening TCP socket on ``port`` is bound to,
    as /proc/net/tcp writes it (hex, host order: 0100007F is 127.0.0.1)."""
    with open("/proc/net/tcp") as f:
        rows = [line.split() for line in f.readlines()[1:]]
    return [r[1].split(":")[0] for r in rows
            if r[3] == "0A" and int(r[1].split(":")[1], 16) == port]


def test_server_listens_on_loopback_unless_asked():
    """The service has no authentication: a server listens on 127.0.0.1
    unless the caller names another address; an address that does not
    parse fails the bind (exact)."""
    servers = [rpc.NativePsServer(), rpc.NativePsServer(host="0.0.0.0")]
    try:
        assert _listen_address(servers[0].port) == ["0100007F"]
        assert _listen_address(servers[1].port) == ["00000000"]
        cli = rpc.RpcPsClient([f"127.0.0.1:{s.port}" for s in servers])
        cli.barrier()
        cli.close()
    finally:
        for s in servers:
            s.close()
    with pytest.raises(PreconditionNotMetError, match="failed to bind"):
        rpc.NativePsServer(host="localhost")


def test_barrier_blocks_until_both_trainers():
    server = rpc.NativePsServer(n_trainers=2)
    clients = [rpc.RpcPsClient([f"127.0.0.1:{server.port}"]) for _ in range(2)]
    released = []

    def arrive(i, delay):
        time.sleep(delay)
        clients[i].barrier()
        released.append(time.monotonic())

    try:
        ts = [threading.Thread(target=arrive, args=(i, 0.1 * i)) for i in range(2)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert len(released) == 2
        assert min(released) - t0 >= 0.09  # nobody left before the last arrival
    finally:
        for c in clients:
            c.close()
        server.close()


def test_missing_table_and_dead_server_raise(cluster):
    servers, cli = cluster
    with pytest.raises(NotFoundError):
        cli.pull_sparse(42, np.array([1], np.uint64))
    cli.create_sparse_table(0, TableConfig(shard_num=4))
    with pytest.raises(NotFoundError):  # known to the client, not to the servers
        cli._conns[0].check(3, 42, n=0, payload=(np.zeros(0, np.uint64),))
    saved = get_flags(["pserver_max_retry", "pserver_retry_backoff_ms"])
    set_flags({"pserver_max_retry": 2, "pserver_retry_backoff_ms": 1})
    try:
        for s in servers:
            s.close()
        with pytest.raises(PsTransportError, match="unreachable after 2 attempt"):
            cli.pull_sparse(0, np.arange(1, 9, dtype=np.uint64))
    finally:
        set_flags(saved)


def test_concurrent_calls_on_one_client_lose_no_update(cluster):
    """Many threads share one client (as the pull workers and the push
    thread do): every push lands once and every pull reads whole frames.
    A short switch interval makes the threads interleave inside calls."""
    import sys

    _, cli = cluster
    cli.create_sparse_table(0, TableConfig(shard_num=4, accessor_config=_acc()))
    keys = np.arange(1, 513, dtype=np.uint64)
    push = np.zeros((len(keys), 12), np.float32)
    push[:, 1] = 1.0  # show
    n_threads, rounds, bad = 24, 10, []

    def work(i):
        for _ in range(rounds):
            cli.push_sparse(0, keys, push)
            got = cli.pull_sparse(0, keys, create=True)
            if got.shape != (len(keys), 11) or not (got[:, 0] >= 1).all():
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert not bad
    shows = cli.export_full(0, keys)[0][:, 3]
    np.testing.assert_array_equal(shows, np.full(len(keys), n_threads * rounds, np.float32))


def test_wire_dtypes_other_than_fp32_raise():
    """The wires the JAX package has (pull fp16; push fp16 and int8 with a
    block in [1, 65535]) are accepted; any other encoding raises when the
    client creates the table, as in JAX (``tests/test_torch_sparse_wire.py``
    holds what the accepted wires carry)."""
    c = _Cluster(rpc, rpc)
    try:
        for bad in ({"pull_wire_dtype": "int8"}, {"pull_wire_dtype": "bf16"},
                    {"push_wire_dtype": "bf16"},
                    {"push_wire_dtype": "int8", "push_wire_block": 0}):
            with pytest.raises(PreconditionNotMetError, match="wire"):
                c.client.create_sparse_table(1, TableConfig(**bad))
        for tid, ok in enumerate(({"pull_wire_dtype": "fp16"}, {"push_wire_dtype": "fp16"},
                                  {"push_wire_dtype": "int8", "push_wire_block": 7}), 1):
            c.client.create_sparse_table(tid, TableConfig(**ok))
            assert c.client.sparse_config(tid).pull_wire_dtype == ok.get("pull_wire_dtype",
                                                                         "fp32")
    finally:
        c.close()


def test_flags_match_the_jax_package():
    """Same names and defaults as JAX; ``FLAGS_<name>`` overrides at
    definition (checked in a fresh interpreter)."""
    import os
    import subprocess
    import sys

    import paddle_tpu.ps.communicator  # noqa: F401  (these define the JAX flags)
    import paddle_tpu.ps.rpc  # noqa: F401
    from paddle_tpu.core.flags import get_flags as jax_get_flags
    from paddle_tpu_torch.ps import communicator  # noqa: F401

    names = ["pserver_connect_timeout_ms", "pserver_timeout_ms", "pserver_max_retry",
             "pserver_retry_backoff_ms", "pserver_long_call_timeout_ms",
             "pserver_barrier_timeout_ms", "ps_rpc_parallel",
             "communicator_max_merge_var_num", "communicator_send_queue_size",
             "communicator_is_sgd_optimizer",
             "communicator_pull_ahead"]
    ours = get_flags(names)
    assert ours == jax_get_flags(names)
    assert all(type(v) is type(jax_get_flags([k])[k]) for k, v in ours.items())
    env = dict(os.environ, FLAGS_ps_rpc_parallel="off", FLAGS_pserver_max_retry="7")
    out = subprocess.run(
        [sys.executable, "-c", "from paddle_tpu_torch.ps import rpc; "
         "from paddle_tpu_torch.core.flags import get_flags; "
         "print(get_flags(['ps_rpc_parallel', 'pserver_max_retry']))"],
        env=env, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "{'ps_rpc_parallel': False, 'pserver_max_retry': 7}"


def test_ssd_table_over_rpc(tmp_path):
    """Server-side SSD tables: tier moves keep values, a restart on the
    same directories replays the cold rows."""
    cfg = TableConfig(shard_num=4, accessor_config=_acc(embedx_dim=4, embedx_threshold=0.0),
                      storage="ssd", ssd_path=str(tmp_path / "tiers"))
    c = _Cluster(rpc, rpc)
    try:
        cli = c.client
        cli.create_sparse_table(0, cfg)
        rng = np.random.default_rng(1)
        keys = np.unique(rng.integers(1, 2000, 500).astype(np.uint64))
        cli.push_sparse(0, keys, _push_rows(rng, keys, 8, show=1.0))
        want = cli.pull_sparse(0, keys, create=False)
        assert np.abs(want).sum() > 0
        total = cli.size(0)
        assert cli.spill(0, hot_budget=0) == total
        st = cli.table_stats(0)
        assert st["cold_rows"] == total and st["hot_rows"] == 0
        np.testing.assert_array_equal(cli.pull_sparse(0, keys, create=False), want)
        assert cli.table_stats(0)["hot_rows"] == total
        cli.spill(0, hot_budget=0)
        assert cli.compact(0) >= 0
    finally:
        c.close()
    c = _Cluster(rpc, rpc)  # same server order: same subdirectories
    try:
        c.client.create_sparse_table(0, cfg)
        st = c.client.table_stats(0)
        assert st["cold_rows"] == total and st["hot_rows"] == 0
        np.testing.assert_array_equal(c.client.pull_sparse(0, keys, create=False), want)
    finally:
        c.close()


def test_load_cold_and_server_side_save(tmp_path):
    """Chunked ``load_cold`` into server-side SSD tiers, a server-side gzip
    save, fresh servers on fresh directories, ``load_local``; the
    server-written gzip files load into the port's local table too."""
    acc = _acc(embedx_dim=4, embedx_threshold=0.0)
    n = 20_000
    keys = np.arange(1, n + 1, dtype=np.uint64)
    rng = np.random.default_rng(2)
    ckpt = str(tmp_path / "ckpt")
    c = _Cluster(rpc, rpc)
    try:
        cli = c.client
        cli.create_sparse_table(0, TableConfig(shard_num=4, accessor_config=acc, storage="ssd",
                                               ssd_path=str(tmp_path / "tiers_a")))
        full_dim = cli._dims(0)[2]
        assert full_dim == 13  # 7 + adagrad(1) + embedx 4 + adagrad(1)
        vals = np.zeros((n, full_dim), np.float32)
        vals[:, 0] = keys % 8
        vals[:, 3] = 1.0
        vals[:, 5] = rng.normal(0, 0.01, n).astype(np.float32)
        vals[:, 7] = 1.0
        vals[:, 8:12] = rng.normal(0, 0.01, (n, 4)).astype(np.float32)
        assert cli.load_cold(0, keys, vals, chunk=4096) == n
        st = cli.table_stats(0)
        assert st["cold_rows"] == n and st["hot_rows"] == 0
        sample = rng.choice(keys, 500, replace=False)
        idx = sample.astype(np.int64) - 1
        got, found = cli.export_full(0, sample)
        assert found.all()
        np.testing.assert_array_equal(got, vals[idx])
        assert cli.save_local(0, ckpt, mode=0, converter="gzip") == n
    finally:
        c.close()
    c = _Cluster(rpc, rpc)
    try:
        c.client.create_sparse_table(0, TableConfig(shard_num=4, accessor_config=acc,
                                                    storage="ssd",
                                                    ssd_path=str(tmp_path / "tiers_b")))
        assert c.client.load_local(0, ckpt) == n
        got2, found2 = c.client.export_full(0, sample)
        assert found2.all()
        np.testing.assert_allclose(got2, vals[idx], rtol=1e-6, atol=1e-9)
    finally:
        c.close()
    local = MemorySparseTable(TableConfig(shard_num=4, accessor_config=acc))
    try:
        assert local.load(ckpt) == n
        lv, lfound = local.export_full(sample)
        assert lfound.all()
        np.testing.assert_array_equal(lv, got2)
    finally:
        local.close()


def _wire_ops(cli):
    """The same operations whatever the client and servers: creates,
    pulls with slots, duplicate-key pushes, full-row import, dense and geo
    traffic. Returns (sorted keys, rows, digests, dense, geo)."""
    acc = AccessorConfig(embedx_dim=8, embedx_threshold=1.0)
    cfg = dict(table_id=0, shard_num=4, accessor="ctr", accessor_config=acc, seed=3)
    if type(cli).__module__.startswith("paddle_tpu_torch"):
        cli.create_sparse_table(0, TableConfig(**cfg))
    else:
        from paddle_tpu.ps.table import TableConfig as JaxTableConfig

        cli.create_sparse_table(0, JaxTableConfig(**cfg))
    rng = np.random.default_rng(7)
    for _ in range(3):
        keys = rng.integers(1, 3000, 512).astype(np.uint64)
        cli.pull_sparse(0, keys, create=True, slots=(keys % 26).astype(np.int32))
        cli.push_sparse(0, keys, _push_rows(rng, keys, 12, show=1.0))
    extra = np.arange(10_000, 10_064, dtype=np.uint64)
    rows = rng.normal(0, 0.1, (64, cli._dims(0)[2])).astype(np.float32)
    rows[:, 0] = 3
    cli.import_full(0, extra, rows)
    cli.create_dense_table(1, dim=9, optimizer="adam", lr=0.01)
    for _ in range(2):
        cli.push_dense(1, rng.normal(size=9).astype(np.float32))
    cli.create_geo_table(2, dim=4)
    cli.push_geo(2, np.array([5, 6, 5], np.uint64), rng.normal(size=(3, 4)).astype(np.float32))
    gk, gd = cli.pull_geo(2)
    k, v = cli.snapshot_items(0)
    i = np.argsort(k)
    j = np.argsort(gk)
    return k[i], v[i], cli.digest(0), cli.pull_dense(1), (gk[j], gd[j])


def test_wire_across_packages():
    """JAX client → port servers, port client → JAX servers and port →
    port: bit-equal rows, equal per-server digests, dense and geo values."""
    from paddle_tpu.ps import rpc as jax_rpc

    results = []
    for servers, client in ((rpc, jax_rpc), (jax_rpc, rpc), (rpc, rpc)):
        c = _Cluster(servers, client)
        try:
            results.append(_wire_ops(c.client))
        finally:
            c.close()
    ref = results[0]
    assert len(ref[0]) > 1000
    for got in results[1:]:
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_array_equal(got[4][0], ref[4][0])
        np.testing.assert_array_equal(got[4][1], ref[4][1])
