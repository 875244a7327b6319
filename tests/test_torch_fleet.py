"""The port's fleet surface against the JAX package's, in one process.

- ``PaddleCloudRoleMaker`` from the PaddleCloud env and
  ``UserDefinedRoleMaker``: every role query equal to JAX's;
- ``DistributedStrategy``: ``to_dict`` and the mode properties equal;
- ``load_ps_config`` in all five ``sync_mode``s from a dict and from a YAML
  file: every ``PsJobConfig`` field, the ``TableConfig`` fields the port
  carries, the ``AccessorConfig``, the strategy's ``to_dict`` and the model
  config equal to JAX's; null blocks, a bad mode, an unbound SSD knob;
  ``make_optimizer`` (a class JAX has and the port not yet raises
  ``UnavailableError``, an unknown class the enforce error);
- the local-transport ``Fleet`` scenarios of ``tests/test_fleet.py``
  against a JAX ``Fleet`` (Python-shard tables): rows bit-equal after the
  Sync, Async and Geo communicators;
- ``save_persistables`` of one package loaded by the other's
  ``load_model``, both ways (rows bit-equal);
- the transport pick (a cluster role, from the env or a
  ``UserDefinedRoleMaker`` that names servers, takes "rpc" and builds the
  PS service, or raises; JAX's falls back), the ``TCPStore`` that
  ``fleet.util`` rides, ``init_server`` on the
  endpoint's host and port, ``fleet.util.get_file_shard`` from the role
  maker, ``distributed_optimizer`` with no flag and with each dense flag
  (the JAX ``apply_strategy`` chain; with ``reducer=`` it raises).

Tolerance: exact (config and table rows); the dense chains' 3 updates
rtol 1e-6 / atol 1e-7.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

from paddle_tpu import distributed as jdist
from paddle_tpu.ps import config as jconfig
from paddle_tpu.ps.table import TableConfig as JaxTableConfig
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.core.enforce import (EnforceNotMet, InvalidArgumentError,
                                           PreconditionNotMetError)
from paddle_tpu_torch.ps import config as tconfig
from paddle_tpu_torch.ps.table import TableConfig

pytestmark = pytest.mark.usefixtures("jax_native")

_ROLE_ENV = ("TRAINING_ROLE", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
             "PADDLE_TRAINER_ENDPOINTS", "PADDLE_PSERVERS_IP_PORT_LIST", "POD_IP",
             "PADDLE_PORT", "PADDLE_UTIL_STORE_PORT")


@pytest.fixture(autouse=True)
def clean_role_env(monkeypatch):
    for k in _ROLE_ENV:
        monkeypatch.delenv(k, raising=False)


def _role_view(rm):
    return (rm.is_worker(), rm.is_server(), rm.is_first_worker(), rm.worker_index(),
            rm.server_index(), rm.worker_num(), rm.server_num(), rm.get_trainer_endpoints(),
            rm.get_pserver_endpoints())


@pytest.mark.parametrize("env", [
    {},
    {"TRAINING_ROLE": "TRAINER", "PADDLE_TRAINER_ID": "2", "PADDLE_TRAINERS_NUM": "4",
     "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6170,10.0.0.1:6171,10.0.0.2:6170,10.0.0.2:6171",
     "PADDLE_PSERVERS_IP_PORT_LIST": "10.0.0.1:8001,10.0.0.2:8001"},
    {"TRAINING_ROLE": "pserver", "POD_IP": "10.0.0.2", "PADDLE_PORT": "8001",
     "PADDLE_PSERVERS_IP_PORT_LIST": "10.0.0.1:8001,10.0.0.2:8001", "PADDLE_TRAINERS_NUM": "2"},
    {"TRAINING_ROLE": "PSERVER", "POD_IP": "10.0.0.9", "PADDLE_PORT": "1",
     "PADDLE_PSERVERS_IP_PORT_LIST": "10.0.0.1:8001"},
], ids=["defaults", "trainer", "pserver", "pserver_not_listed"])
def test_paddle_cloud_role_maker_matches_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _role_view(tdist.PaddleCloudRoleMaker()) == _role_view(jdist.PaddleCloudRoleMaker())


def test_role_maker_rejects_a_bad_role(monkeypatch):
    monkeypatch.setenv("TRAINING_ROLE", "HETER")
    with pytest.raises(InvalidArgumentError):
        tdist.PaddleCloudRoleMaker()


@pytest.mark.parametrize("role", ["WORKER", "SERVER"])
def test_user_defined_role_maker_matches_jax(role):
    kw = dict(current_id=1, worker_num=3, server_endpoints=["a:1", "b:2"],
              trainer_endpoints=["c:3"])
    t = tdist.UserDefinedRoleMaker(role=getattr(tdist.Role, role), **kw)
    j = jdist.UserDefinedRoleMaker(role=getattr(jdist.Role, role), **kw)
    assert _role_view(t) == _role_view(j)
    assert [int(r) for r in tdist.Role] == [int(r) for r in jdist.Role]


@pytest.mark.parametrize("kw", [
    {}, {"a_sync": True}, {"a_sync": True, "geo_sgd_mode": True, "geo_configs": {"geo_step": 7}},
    {"lamb": True, "amp": True, "ps_transport": "rpc"}])
def test_strategy_to_dict_matches_jax(kw):
    t, j = tdist.DistributedStrategy(**kw), jdist.DistributedStrategy(**kw)
    assert t.to_dict() == j.to_dict()
    assert (t.is_geo_mode, t.is_sync_mode) == (j.is_geo_mode, j.is_sync_mode)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


# -- ps/config.py ---------------------------------------------------------------

_MODES = ("sync", "async", "geo", "heter", "gpubox")
_TABLE_FIELDS = ("table_id", "shard_num", "accessor", "seed", "backend", "storage", "ssd_path",
                 "converter", "pull_wire_dtype", "push_wire_dtype", "ssd_value_dtype",
                 "ssd_block_compress", "ssd_admission_threshold", "ssd_admission_sketch_kb",
                 "ssd_bg_compact", "ssd_io_budget_mbps")


def _cfg(mode, **extra_runner):
    return {"hyper_parameters": {"optimizer": {"class": "adam", "learning_rate": 0.0005},
                                 "sparse_inputs_slots": 4, "sparse_feature_number": 1001,
                                 "sparse_feature_dim": 5, "dense_input_dim": 2,
                                 "fc_sizes": [16, 8]},
            "runner": {"sync_mode": mode, "thread_num": 4, "geo_step": 9, **extra_runner},
            "table_parameters": {"converter": "gzip", "ssd_value_dtype": "fp16"}}


def _assert_job_equal(t, j):
    for f in dataclasses.fields(j):
        if f.name in ("table", "strategy"):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for name in _TABLE_FIELDS:
        assert getattr(t.table, name) == getattr(j.table, name), name
    ta, ja = (dataclasses.asdict(x.table.accessor_config) for x in (t, j))
    assert ta == ja
    assert t.strategy.to_dict() == j.strategy.to_dict()
    assert dataclasses.asdict(t.make_model_config()) == dataclasses.asdict(j.make_model_config())
    assert type(t.make_optimizer()).__name__ == type(j.make_optimizer()).__name__ == "Adam"


@pytest.mark.parametrize("mode", _MODES)
def test_load_ps_config_dict_matches_jax(mode):
    _assert_job_equal(tconfig.load_ps_config(_cfg(mode)), jconfig.load_ps_config(_cfg(mode)))


@pytest.mark.parametrize("mode", _MODES)
def test_load_ps_config_yaml_matches_jax(tmp_path, mode):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / f"{mode}.yaml"
    path.write_text(yaml.safe_dump(_cfg(mode)))
    t, j = tconfig.load_ps_config(str(path)), jconfig.load_ps_config(str(path))
    _assert_job_equal(t, j)
    assert t.sync_mode == mode


def test_load_ps_config_null_blocks_and_bad_mode():
    nulls = {"hyper_parameters": {"optimizer": None, "fc_sizes": None, "sparse_feature_dim": 3},
             "runner": None, "table_parameters": None}
    _assert_job_equal(tconfig.load_ps_config(nulls), jconfig.load_ps_config(nulls))
    for bad in ({"hyper_parameters": None}, {"runner": {}}):
        with pytest.raises(EnforceNotMet, match="hyper_parameters"):
            tconfig.load_ps_config(bad)
    with pytest.raises(InvalidArgumentError, match="sync_mode"):
        tconfig.load_ps_config(_cfg("bogus"))
    with pytest.raises(EnforceNotMet, match="sparse_feature_dim"):
        tconfig.load_ps_config({"hyper_parameters": {"sparse_feature_dim": 1}})
    # the port's accessor registry holds "ctr" only: another name fails at config time
    with pytest.raises(KeyError, match="accessor"):
        tconfig.load_ps_config({"hyper_parameters": {}, "runner": {"accessor_class": "tensor"}})


@pytest.mark.parametrize("knob,value", [("ssd_block_compress", True),
                                        ("ssd_admission_threshold", 2),
                                        ("ssd_bg_compact", True),
                                        ("ssd_admission_sketch_kb", 256),
                                        ("ssd_io_budget_mbps", 64.0)])
def test_load_ps_config_refuses_an_unbound_ssd_knob(knob, value):
    """The SSD tier's scale knobs, once refused by the port, now load: each
    one off its default gives the JAX package's ``TableConfig``, field for
    field."""
    cfg = _cfg("async")
    cfg["table_parameters"][knob] = value
    t, j = tconfig.load_ps_config(cfg), jconfig.load_ps_config(cfg)
    assert getattr(t.table, knob) == getattr(j.table, knob) == value
    assert dataclasses.asdict(t.table) == dataclasses.asdict(j.table)
    _assert_job_equal(t, j)


@pytest.mark.parametrize("name,want", [("sgd", "SGD"), ("Momentum", "Momentum"),
                                       ("ADAMW", "AdamW")])
def test_make_optimizer_matches_jax(name, want):
    cfg = _cfg("async")
    cfg["hyper_parameters"]["optimizer"]["class"] = name
    t, j = tconfig.load_ps_config(cfg), jconfig.load_ps_config(cfg)
    assert type(t.make_optimizer()).__name__ == type(j.make_optimizer()).__name__ == want


@pytest.mark.parametrize("name,want", [("Adagrad", "Adagrad"), ("rmsprop", "RMSProp"),
                                       ("Lamb", "Lamb")])
def test_make_optimizer_not_ported_raises_unavailable(name, want):
    """These classes were refused while the port lacked them; the port now
    builds the JAX class, and 3 updates from the same start agree with
    JAX's (rtol 2e-6 / atol 1e-7, as ``test_torch_optimizers.py``). An
    unknown class still raises."""
    cfg = _cfg("async")
    cfg["hyper_parameters"]["optimizer"]["class"] = name
    jo = jconfig.load_ps_config(cfg).make_optimizer()
    to = tconfig.load_ps_config(cfg).make_optimizer()
    assert type(to).__name__ == type(jo).__name__ == want
    rng = np.random.default_rng(5)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    jp, tp = dict(p0), {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        jp, js = jo.update(g, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=2e-6, atol=1e-7)
    cfg["hyper_parameters"]["optimizer"]["class"] = "Bogus"
    with pytest.raises(EnforceNotMet, match="unknown optimizer"):
        tconfig.load_ps_config(cfg).make_optimizer()


# -- the local-transport Fleet against JAX's ---------------------------------------

def _push_vals(n, dim=8, show=1.0):
    pv = np.zeros((n, 4 + dim), np.float32)
    pv[:, 1] = show
    pv[:, 3:] = 0.1 * np.arange(1 + dim, dtype=np.float32)
    return pv


def _fleets(strategy_kw):
    j = jdist.Fleet().init(jdist.UserDefinedRoleMaker(role=jdist.Role.WORKER),
                                strategy=jdist.DistributedStrategy(**strategy_kw))
    t = tdist.Fleet().init(tdist.UserDefinedRoleMaker(role=tdist.Role.WORKER),
                                strategy=tdist.DistributedStrategy(**strategy_kw))
    return j, t


def _tables(j, t):
    j.register_sparse_table(0, JaxTableConfig(shard_num=2, backend="python"))
    table = t.register_sparse_table(0, TableConfig(shard_num=2, backend="python"))
    return table


def test_fleet_init_and_tables_match_jax():
    j, t = _fleets({})
    table = _tables(j, t)
    assert t.transport == j.transport == "local"
    assert t.is_worker() and not t.is_server() and t.is_first_worker()
    t.init_server()
    t.run_server()
    keys = np.asarray([1, 2, 3], np.uint64)
    np.testing.assert_array_equal(t.client.pull_sparse(0, keys), j.client.pull_sparse(0, keys))
    assert table.size() == 3


def _send_five(fleets, seed=0):
    """The same five seeded batches, each sent through every fleet's (or
    communicator's) ``send_sparse`` in turn."""
    rng = np.random.default_rng(seed)
    for _ in range(5):
        keys = rng.integers(1, 40, 16).astype(np.uint64)
        vals = _push_vals(len(keys))
        vals[:, 4:] *= rng.normal(size=(len(keys), 8)).astype(np.float32)
        for f in fleets:
            (f.communicator if hasattr(f, "communicator") else f).send_sparse(0, keys, vals)


def _merge_one_batch_a_push():
    """Both packages' merge loops take one queued batch a push, so the
    split of the five batches into pushes is the same on both sides (a
    merge folds whatever it finds queued, up to the flag, so with the
    default of 20 the split follows the threads' timing: C8). Restores
    the flag on exit."""
    import contextlib

    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as tflags

    @contextlib.contextmanager
    def ctx():
        was = [m.get_flags(["communicator_max_merge_var_num"]) for m in (jflags, tflags)]
        for m in (jflags, tflags):
            m.set_flags({"communicator_max_merge_var_num": 1})
        try:
            yield
        finally:
            for m, w in zip((jflags, tflags), was):
                m.set_flags(w)

    return ctx()


@pytest.mark.parametrize("kw,cls", [({"a_sync": False}, "SyncCommunicator"),
                                    ({"a_sync": True}, "AsyncCommunicator"),
                                    ({"a_sync": True, "a_sync_configs": {"k_steps": 0}},
                                     "HalfAsyncCommunicator")])
def test_fleet_communicator_modes_land_jax_rows(kw, cls):
    j, t = _fleets(kw)
    _tables(j, t)
    with _merge_one_batch_a_push():
        try:
            for f in (j, t):
                f.init_server()
                f.init_worker()
            assert type(t.communicator).__name__ == type(j.communicator).__name__ == cls
            _send_five((j, t))
            for f in (j, t):
                f.barrier_worker()
            # the port's barrier holds until every push landed (C7); the JAX
            # package's can return while its merge loop still pushes the last
            # batch, so wait for its merged-batch counter, which counts a
            # batch after its push returned
            merged = j.communicator._c_merged
            deadline = time.monotonic() + 30
            while merged.value < 5:
                assert time.monotonic() < deadline, "the JAX communicator never pushed 5 batches"
                time.sleep(0.005)
            assert t.communicator.merged_batches == 5
            keys = np.arange(1, 40, dtype=np.uint64)
            np.testing.assert_array_equal(t.client.pull_sparse(0, keys, create=False),
                                          j.client.pull_sparse(0, keys, create=False))
        finally:
            j.stop_worker()
            t.stop_worker()


def test_fleet_communicator_rows_depend_on_the_merge_split():
    """What C8 was: the rows after the five batches depend on how a merge
    loop splits them into pushes. The port fed five single pushes and the
    JAX package fed one merged push (all five queued before its loop
    starts) land different rows; the JAX package fed the port's split
    lands the port's rows bit for bit."""
    from paddle_tpu.ps import communicator as jcomm

    keys = np.arange(1, 40, dtype=np.uint64)
    rows = {}
    for split in ("single", "merged"):
        j, t = _fleets({"a_sync": True})
        _tables(j, t)
        try:
            j.init_server()
            t.init_server()
            if split == "single":
                with _merge_one_batch_a_push():
                    t.init_worker()
                    comm = jcomm.AsyncCommunicator(j.client)
                comm.start()
                _send_five((t, comm))
            else:
                t.init_worker()
                comm = jcomm.AsyncCommunicator(j.client)
                _send_five((comm,))  # queued before start: one merged push
                comm.start()
            comm.barrier()
            t.barrier_worker()
            comm.stop()
            rows[split] = (t.client.pull_sparse(0, keys, create=False),
                           j.client.pull_sparse(0, keys, create=False))
        finally:
            t.stop_worker()
    np.testing.assert_array_equal(rows["single"][0], rows["single"][1])
    assert not np.array_equal(rows["single"][0], rows["merged"][1]), \
        "five single pushes and one merged push landed the same rows"
    assert float(np.abs(rows["single"][0] - rows["merged"][1]).max()) > 1e-6


def test_fleet_geo_communicator_matches_jax():
    kw = dict(a_sync=True, geo_sgd_mode=True, geo_configs={"geo_step": 2})
    j, t = _fleets(kw)
    try:
        for f in (j, t):
            f.register_geo_table(1, dim=4)
            f.init_server()
            f.init_worker()
        assert type(t.communicator).__name__ == "GeoCommunicator"
        keys = np.asarray([9, 4], np.uint64)
        for scale in (1.0, 3.0):
            for f in (j, t):
                f.communicator.send_sparse_delta(1, keys, np.full((2, 4), scale, np.float32))
        (tk, td), (jk, jd) = t.client.pull_geo(1), j.client.pull_geo(1)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(td, 2.0)  # the mean of the two deltas
    finally:
        j.stop_worker()
        t.stop_worker()


def test_fleet_geo_barrier_returns_after_deltas():
    """In geo mode ``fleet.barrier_worker()`` and the communicator's own
    ``barrier()`` return after ``send_sparse_delta`` (the geo deltas are
    not queued on the merge loop, so there is nothing to wait for), and
    ``check_error()`` stays quiet. A hang fails at the join's timeout."""
    kw = dict(a_sync=True, geo_sgd_mode=True, geo_configs={"geo_step": 3})
    j, t = _fleets(kw)
    try:
        for f in (j, t):
            f.register_geo_table(1, dim=4)
            f.init_server()
            f.init_worker()
        keys = np.asarray([9, 4], np.uint64)
        for f in (j, t):
            f.communicator.send_sparse_delta(1, keys, np.ones((2, 4), np.float32))
        for f in (j, t):
            errors = []

            def join(f=f):
                try:
                    f.barrier_worker()
                    f.communicator.barrier()
                    f.communicator.check_error()
                except BaseException as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            th = threading.Thread(target=join, daemon=True)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive(), f"{type(f.communicator).__module__}: geo barrier hung"
            assert errors == []
    finally:
        j.stop_worker()
        t.stop_worker()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_persistables_cross_load(tmp_path, writer):
    j, t = _fleets({})
    _tables(j, t)
    src, dst = (t, j) if writer == "port" else (j, t)
    keys = np.asarray([11, 12, 1 << 40], np.uint64)
    src.client.push_sparse(0, keys, _push_vals(3, show=4.0))
    assert src.save_persistables(str(tmp_path), mode=0) == {0: 3}
    assert dst.load_model(str(tmp_path)) == {0: 3}
    np.testing.assert_array_equal(dst.client.pull_sparse(0, keys, create=False),
                                  src.client.pull_sparse(0, keys, create=False))
    np.testing.assert_array_equal(t.client.pull_sparse(0, keys, create=False)[:, 0], 4.0)


def test_fleet_util_file_shard_from_the_role_maker():
    files = [f"f{i}" for i in range(10)]
    f = tdist.Fleet()
    with pytest.raises(PreconditionNotMetError, match="fleet.init"):
        f.util.get_file_shard(files)
    f.init(tdist.UserDefinedRoleMaker(current_id=2, worker_num=3))
    assert f.util.get_file_shard(files) == ["f2", "f5", "f8"]
    assert f.util.get_file_shard(files, 0, 3) == jdist.fleet.util.get_file_shard(files, 0, 3)
    assert f.util.all_reduce(np.ones(3)).tolist() == [1.0, 1.0, 1.0]  # no store: identity
    f.util.barrier()


# -- transport, server bind, optimizer ------------------------------------------------

def _cluster_env(monkeypatch, role, port):
    monkeypatch.setenv("TRAINING_ROLE", role)
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", f"127.0.0.1:{port}")
    monkeypatch.setenv("POD_IP", "127.0.0.1")
    monkeypatch.setenv("PADDLE_PORT", str(port))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cluster_role_takes_rpc_and_serves_on_its_endpoint(monkeypatch):
    port = _free_port()
    _cluster_env(monkeypatch, "PSERVER", port)
    f = tdist.Fleet().init()
    assert f.transport == "rpc" and f.is_server()
    f.init_server()
    try:
        assert f._rpc_server.port == port
        from paddle_tpu_torch.ps.rpc import RpcPsClient

        cli = RpcPsClient([f"127.0.0.1:{port}"])
        cli.create_sparse_table(0, TableConfig(shard_num=2))
        assert cli.size(0) == 0
        cli.stop_servers()
        cli.close()
        f.run_server()  # returns: the server was stopped
    finally:
        f.stop_server()
    monkeypatch.delenv("TRAINING_ROLE")
    assert tdist.Fleet().init().transport == "local"  # endpoints alone: no cluster


def test_user_defined_cluster_role_takes_rpc_without_the_env(monkeypatch):
    """The role maker decides the cluster, not ``TRAINING_ROLE``: a
    ``UserDefinedRoleMaker`` that names servers takes ``"rpc"`` in a
    process without the env (JAX's ``Fleet`` would take ``"local"``)."""
    port = _free_port()
    eps = [f"127.0.0.1:{port}"]
    server = tdist.Fleet().init(tdist.UserDefinedRoleMaker(role=tdist.Role.SERVER,
                                                            server_endpoints=eps))
    assert server.transport == "rpc" and server._role_maker.is_cluster()
    server.init_server()
    try:
        assert server._rpc_server.port == port
    finally:
        server.stop_server()
    for rm in (tdist.UserDefinedRoleMaker(worker_num=2, server_endpoints=eps),
               tdist.UserDefinedRoleMaker(server_endpoints=eps)):
        assert tdist.Fleet().init(rm).transport == "rpc"
    assert tdist.Fleet().init(tdist.UserDefinedRoleMaker(worker_num=2)).transport == "local"
    assert not tdist.PaddleCloudRoleMaker().is_cluster()
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", eps[0])
    assert not tdist.PaddleCloudRoleMaker().is_cluster()  # endpoints alone
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    assert tdist.PaddleCloudRoleMaker().is_cluster()


def test_tcp_store_set_get_add_wait_delete_barrier():
    """The store ``fleet.util`` rides: one master, two clients, exact
    values; a ``wait`` past its timeout raises."""
    from paddle_tpu_torch.distributed.collective import TCPStore

    master = TCPStore(is_master=True, timeout=5.0)
    other = TCPStore(port=master.port, timeout=5.0)
    try:
        assert master.get("k") is None
        other.set("k", "v")
        assert master.get("k") == "v"
        assert [master.add("n", 2), other.add("n", 3)] == [2, 5]
        th = threading.Thread(target=lambda: (time.sleep(0.1), other.set("late", "1")))
        th.start()
        master.wait(["late"])
        th.join()
        assert master.delete("k") and not master.delete("k")
        with pytest.raises(PreconditionNotMetError, match="timed out"):
            other.wait(["never"], timeout=0.2)
        done = []
        th = threading.Thread(target=lambda: (other.barrier("b", 2), done.append(1)))
        th.start()
        master.barrier("b", 2)
        th.join(5.0)
        assert done == [1]
        th = threading.Thread(target=lambda: other.barrier("b", 2))  # a reused name
        th.start()
        master.barrier("b", 2)
        th.join(5.0)
        assert not th.is_alive()
    finally:
        other.close()
        master.close()


def test_init_server_binds_the_endpoint_host(monkeypatch):
    seen = {}

    class Recorder:
        def __init__(self, port=0, n_trainers=1, host="127.0.0.1"):
            seen.update(port=port, n_trainers=n_trainers, host=host)

    from paddle_tpu_torch.ps import rpc

    monkeypatch.setattr(rpc, "NativePsServer", Recorder)
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "10.1.2.3:8001,10.1.2.4:8002")
    monkeypatch.setenv("POD_IP", "10.1.2.4")
    monkeypatch.setenv("PADDLE_PORT", "8002")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    tdist.Fleet().init().init_server()
    assert seen == {"port": 8002, "n_trainers": 3, "host": "10.1.2.4"}


def test_cluster_role_without_the_ps_library_raises(monkeypatch):
    """The divergence from JAX's ``"auto"``: no silent local fallback."""
    from paddle_tpu.ps import rpc as jrpc
    from paddle_tpu_torch.ops._build import BuildError
    from paddle_tpu_torch.ps import native

    _cluster_env(monkeypatch, "TRAINER", _free_port())

    def fail():
        raise BuildError("g++ missing")

    monkeypatch.setattr(native, "load_ssd", fail)
    with pytest.raises(BuildError):
        tdist.Fleet().init()
    monkeypatch.setattr(jrpc, "rpc_available", lambda: False)
    assert jdist.Fleet().init().transport == "local"  # JAX falls back
    local = tdist.Fleet().init(strategy=tdist.DistributedStrategy(ps_transport="local"))
    assert local.transport == "local"


def test_distributed_optimizer_without_a_flag_returns_the_optimizer(tmp_path):
    from paddle_tpu_torch.io.inference import load_inference_model
    from paddle_tpu_torch.optimizer import Adam

    f = tdist.Fleet().init(tdist.UserDefinedRoleMaker())
    opt = Adam(1e-3)
    assert f.distributed_optimizer(opt) is opt
    assert f.distributed_optimizer(opt, tdist.DistributedStrategy(a_sync=True)) is opt
    # with a reducer and no flag: the fused reduction around the optimizer, as JAX's
    from paddle_tpu.distributed import comm_fusion as jcf
    from paddle_tpu.distributed import meta_optimizers as jmo
    from paddle_tpu.optimizer import Adam as JAdam
    from paddle_tpu_torch.distributed.comm_fusion import DpGradReducer
    from paddle_tpu_torch.distributed.meta_optimizers import FusedAllReduceOptimizer

    red = DpGradReducer(("dp",), (2,))
    fused = f.distributed_optimizer(opt, reducer=red)
    want = jmo.apply_strategy(JAdam(1e-3), jdist.DistributedStrategy(),
                              reducer=jcf.DpGradReducer(("dp",), (2,)))
    assert isinstance(fused, FusedAllReduceOptimizer) and fused.inner is opt
    assert type(fused).__name__ == type(want).__name__ and red.installed
    # save_inference_model is ported: it exports through io.inference
    w = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    f.save_inference_model(str(tmp_path / "m"), lambda p, x: x @ p["w"], {"w": w},
                           (torch.ones(4, 3),))
    got = load_inference_model(str(tmp_path / "m"), device="cpu")(np.ones((5, 3), np.float32))
    assert torch.equal(got, torch.ones(5, 3) @ w)


DENSE_FLAGS = ["lars", "lamb", "dgc", "amp", "recompute", "gradient_merge", "localsgd",
               "fp16_allreduce", "asp"]


@pytest.mark.parametrize("flag", DENSE_FLAGS)
def test_distributed_optimizer_dense_flag_raises(flag):
    """A dense flag with ``reducer=`` (a ``DpGradReducer`` over dp=2)
    builds JAX's pre-reduction chain, class for class, and 3 updates on
    two ranks with their own gradients follow JAX's rank by rank (rtol
    1e-6, atol 1e-7; fp16_allreduce's bf16 wire atol 1e-4: where JAX's
    CPU backend sums the bf16 chunks in f32 a reduced element can land one
    bf16 ulp away)."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed import comm_fusion as jcf
    from paddle_tpu.distributed import meta_optimizers as jmo
    from paddle_tpu_torch.distributed.comm_fusion import DpGradReducer
    from paddle_tpu_torch.optimizer import Momentum
    from test_torch_meta_optimizers import run_ranks_both

    f = tdist.Fleet().init(tdist.UserDefinedRoleMaker())
    red = DpGradReducer(("dp",), (2,))
    to = f.distributed_optimizer(Momentum(0.1), tdist.DistributedStrategy(**{flag: True}),
                                 reducer=red)
    jo = jmo.apply_strategy(jopt.Momentum(0.1), jdist.DistributedStrategy(**{flag: True}),
                            reducer=jcf.DpGradReducer(("dp",), (2,)))

    def chain(o):
        names = []
        while o is not None:
            names.append(type(o).__name__)
            o = getattr(o, "inner", None)
        return names

    assert chain(to) == chain(jo) and "FusedAllReduceOptimizer" in chain(to) and red.installed
    jp, _, tps, _ = run_ranks_both(jo, to)
    atol = 1e-4 if flag == "fp16_allreduce" else 1e-7
    for r, tp in enumerate(tps):
        for k, v in tp.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jp[k])[r], rtol=1e-6, atol=atol,
                                       err_msg=f"{flag}: rank {r} {k}")


@pytest.mark.parametrize("flag", DENSE_FLAGS)
def test_distributed_optimizer_dense_flag_matches_jax(flag):
    """``fleet.distributed_optimizer`` with one dense flag builds the JAX
    chain (``meta_optimizers.apply_strategy``): the same wrapper classes,
    and 3 updates from the same params and gradients agree with JAX's
    within rtol 1e-6 / atol 1e-7. The updates run inside ``run_ranks`` on a
    dp mesh of one rank (LocalSGD's average is an axis collective); the
    JAX LocalSGD's pmean over that one rank is the identity."""
    import jax.numpy as jnp

    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed import meta_optimizers as jmo
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.ops import collectives as coll
    from paddle_tpu_torch.optimizer import Momentum

    f = tdist.Fleet().init(tdist.UserDefinedRoleMaker())
    topt = f.distributed_optimizer(Momentum(0.1), tdist.DistributedStrategy(**{flag: True}))
    jopt_ = jmo.apply_strategy(jopt.Momentum(0.1), jdist.DistributedStrategy(**{flag: True}))

    def chain(o):
        names = []
        while o is not None:
            names.append(type(o).__name__)
            o = getattr(o, "inner", None)
        return names

    assert chain(topt) == chain(jopt_) and len(chain(topt)) >= 1
    node = jopt_
    while node is not None:
        if isinstance(node, jmo.LocalSGDOptimizer):
            node._sync = lambda t: t
        node = getattr(node, "inner", None)
    rng = np.random.default_rng(5)
    p0 = {"w": rng.normal(size=(4, 8)).astype(np.float32),
          "b": rng.normal(size=(8,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt_.init(jp)
    for g in grads:
        jp, js = jopt_.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)

    def run(rank):
        tp = {k: torch.from_numpy(v) for k, v in p0.items()}
        ts = topt.init(tp)
        for g in grads:
            tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        return tp

    tp = coll.run_ranks(make_mesh({"dp": 1}, device="cpu"), run)[0]
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=f"{flag}: {k}")


def test_fleet_calls_before_init_raise():
    f = tdist.Fleet()
    with pytest.raises(PreconditionNotMetError, match="fleet.init"):
        f.is_worker()
    assert isinstance(tdist.fleet, tdist.Fleet)
