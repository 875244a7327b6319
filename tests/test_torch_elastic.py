"""The port's elastic training against the JAX package's: ``TCPStore``
leases on the master's clock and its prefix ``list`` (the two packages
speak one wire), ``TcpElasticStore``/``store_from_spec("tcp:…")``,
``ElasticManager.watch_once`` over the same scripted membership on a fake
clock, ``launch.elastic_launch_local`` (a restart with the env rewritten,
giving up below ``min_np``, the timeout), and the scale-in and scale-out
jobs of ``tests/test_elastic_e2e.py``/``test_elastic_scale_out.py`` over
the port's ``NativePsServer`` on the ``file`` and ``tcp`` backends, each
held to the exactly-once show counter."""

import importlib
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

from paddle_tpu_torch.distributed.collective import TCPStore
from paddle_tpu_torch.distributed.elastic import (FileStore, Lease, TcpElasticStore,
                                                  store_from_spec)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("paddle_tpu", "paddle_tpu_torch")


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


def test_file_store_put_is_atomic_for_readers(tmp_path):
    """A ``FileStore`` put renames a whole file over the key's: a reader
    racing 2,000 lease renewals never sees the key missing (a truncated
    file read as an expired lease made a fleet's lease watch drop a live
    member), the temporary files never show in ``list_prefix``, and the
    same keys and values read back as the JAX package's ``FileStore``
    gives for the same puts."""
    import threading

    from paddle_tpu.distributed.elastic import FileStore as JaxFileStore

    store = FileStore(str(tmp_path / "port"))
    store.put("ps/j/obs/m0", "lease-0", ttl=60.0)
    done, misses, seen = threading.Event(), [0], set()

    def reader():
        while not done.is_set():
            if store.get("ps/j/obs/m0") is None:
                misses[0] += 1
            seen.update(store.list_prefix("ps/j/"))

    th = threading.Thread(target=reader)
    th.start()
    try:
        for i in range(2000):
            store.put("ps/j/obs/m0", f"lease-{i}", ttl=60.0)
    finally:
        done.set()
        th.join()
    assert misses[0] == 0 and seen == {"ps/j/obs/m0"}
    port2, jstore = FileStore(str(tmp_path / "port2")), JaxFileStore(str(tmp_path / "jax"))
    for s in (port2, jstore):
        s.put("a/b", "1")
        s.put("a/c", "2", ttl=60.0)
        s.delete("a/b")
    assert port2.list_prefix("a/") == jstore.list_prefix("a/") == {"a/c": "2"}
    assert os.listdir(tmp_path / "port2") == os.listdir(tmp_path / "jax") == ["a%2Fc"]


def test_tcp_store_leases_expire_on_the_master_clock():
    master = TCPStore(is_master=True, timeout=5.0)
    client = TCPStore(port=master.port, timeout=5.0)
    try:
        client.set("nodes/a", "1", ttl=0.3)
        client.set("nodes/b", "2")
        master.set("other", "x")
        assert master.get("nodes/a") == "1"
        assert client.list("nodes/") == {"nodes/a": "1", "nodes/b": "2"}
        # a lease outlives its ttl on no client: the master's clock decides
        _wait_until(lambda: master.get("nodes/a") is None, timeout=5.0)
        assert client.get("nodes/a") is None
        assert client.list("nodes/") == {"nodes/b": "2"}
        with pytest.raises(Exception, match="timed out"):
            client.wait(["nodes/a"], timeout=0.3)
        client.wait(["nodes/b"], timeout=1.0)
        # a plain set turns a lease into a permanent key again
        client.set("nodes/a", "3", ttl=0.2)
        client.set("nodes/a", "4")
        time.sleep(0.3)
        assert client.get("nodes/a") == "4"
        assert client.delete("nodes/a") and client.get("nodes/a") is None
    finally:
        client.close()
        master.close()


@pytest.mark.parametrize("master_pkg", PKGS)
def test_tcp_store_lease_wire_is_shared_with_jax(master_pkg):
    """Either package's master serves the other's client: the same leases
    and the same prefix listing."""
    coll = {p: importlib.import_module(f"{p}.distributed.collective") for p in PKGS}
    other = PKGS[1 - PKGS.index(master_pkg)]
    master = coll[master_pkg].TCPStore(is_master=True, timeout=5.0)
    client = coll[other].TCPStore(port=master.port, timeout=5.0)
    try:
        client.set("elastic/j/nodes/h0", "beat", ttl=0.3)
        master.set("elastic/j/nodes/h1", "beat", ttl=30.0)
        assert client.list("elastic/j/nodes/") == master.list("elastic/j/nodes/") == {
            "elastic/j/nodes/h0": "beat", "elastic/j/nodes/h1": "beat"}
        _wait_until(lambda: "elastic/j/nodes/h0" not in master.list("elastic/j/"), 5.0)
        assert client.list("elastic/j/nodes/") == {"elastic/j/nodes/h1": "beat"}
    finally:
        client.close()
        master.close()


def test_tcp_elastic_store_and_spec_hold_a_lease():
    master = TcpElasticStore(is_master=True)
    peer = store_from_spec(f"tcp:127.0.0.1:{master.port}")
    try:
        assert isinstance(peer, TcpElasticStore)
        lease = Lease(peer, "ha/shard0", "primary", ttl=0.4, interval=0.1).start()
        assert master.get("ha/shard0") == "primary"
        time.sleep(0.6)   # refreshed past its ttl
        assert Lease.alive(master, "ha/shard0")
        lease.stop()      # crash semantics: the key expires
        _wait_until(lambda: not Lease.alive(master, "ha/shard0"), 5.0)
        peer.put("x/1", "a", ttl=30.0)
        peer.put("x/2", "b")
        assert master.list_prefix("x/") == {"x/1": "a", "x/2": "b"}
        peer.delete("x/1")
        assert master.list_prefix("x/") == {"x/2": "b"}
    finally:
        peer.close()
        master.close()
    with pytest.raises(ValueError):
        store_from_spec("etcd:x")


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


def _watch_script(pkg, monkeypatch):
    """One scripted membership history through ``pkg``'s ElasticManager on a
    fake clock; the statuses, world sizes and endpoint lists it gave."""
    el = importlib.import_module(f"{pkg}.distributed.elastic")
    clock = _Clock()
    monkeypatch.setattr(el, "time", types.SimpleNamespace(monotonic=clock.monotonic,
                                                          time=clock.time))
    store = el.MemoryStore()
    mgr = el.ElasticManager(store, "job", np=3, host="h0", heartbeat_ttl=4.0,
                            elastic_timeout=10.0, min_np=2, max_np=4)
    out = []

    def beat(*hosts, ttl=4.0):
        for h in hosts:
            store.put(mgr.member_key(h), json.dumps({"host": h}), ttl=ttl)

    def tick(dt=0.0):
        clock.t += dt
        out.append(("status", mgr.watch_once().value, mgr.np, mgr.alive_hosts()))

    beat("h0", "h1", "h2", ttl=100.0)
    tick()                                  # healthy
    store.delete(mgr.member_key("h2"))
    tick(1.0)                               # grace
    tick(11.0)                              # shrink
    out.append(("adopt", mgr.adopt_world(), store.get("elastic/job/endpoints")))
    beat("h2", "h3", "h4", ttl=100.0)
    tick()                                  # 5 > max_np: ignore the extras
    store.delete(mgr.member_key("h4"))
    tick(0.5)                               # scale out to 4
    out.append(("adopt", mgr.adopt_world(), store.get("elastic/job/endpoints")))
    el.set_desired_np(store, "job", 9)      # clamped to max_np
    tick()
    el.set_desired_np(store, "job", 3)
    tick(0.5)                               # 4 alive > np 3
    store.delete(el.desired_np_key("job"))
    for h in ("h1", "h2", "h3"):
        store.delete(mgr.member_key(h))
    beat("h5", ttl=4.0)                     # a lease that lapses
    tick(0.1)
    tick(5.0)                               # h5 expired: 1 < min_np, grace
    tick(11.0)                              # below min_np past the timeout
    out.append(("desired", mgr.desired_np(), mgr.adopt_desired_np()))
    return out


def test_watch_once_status_sequence_matches_jax(monkeypatch):
    runs = [_watch_script(p, monkeypatch) for p in PKGS]
    assert runs[1] == runs[0]
    statuses = [r[1] for r in runs[1] if r[0] == "status"]
    assert statuses == ["hold", "hold", "restart", "hold", "restart", "hold", "restart",
                        "hold", "hold", "error"], statuses


_TRAINER = textwrap.dedent("""
    import os, sys, time

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    n = int(os.environ["PADDLE_TRAINERS_NUM"])
    eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == n, (eps, n)
    work = sys.argv[1]
    crash_marker = os.path.join(work, "crashed_once")
    if rank == 1 and not os.path.exists(crash_marker):
        open(crash_marker, "w").close()
        os._exit(17)
    for item in range(10):
        if item % n == rank:
            p = os.path.join(work, f"item_{item}")
            if not os.path.exists(p):
                with open(p, "w") as f:
                    f.write(f"np={n} eps={len(eps)}")
            time.sleep(0.05)
    """)


def test_port_elastic_launch_restarts_with_the_env_rewritten(tmp_path):
    from paddle_tpu_torch.distributed.launch import JobSpec, elastic_launch_local

    script = tmp_path / "trainer.py"
    script.write_text(_TRAINER)
    work = tmp_path / "work"
    work.mkdir()
    rc = elastic_launch_local(JobSpec([str(script), str(work)], nproc=2,
                                      log_dir=str(tmp_path / "logs")),
                              min_np=1, max_np=2, heartbeat_interval=0.1, heartbeat_ttl=0.5,
                              elastic_timeout=0.5, timeout=60)
    assert rc == 0
    assert (work / "crashed_once").exists()
    done = sorted(p.name for p in work.glob("item_*"))
    assert len(done) == 10, done
    # the dead rank's items ran in the relaunched world of one
    assert (work / "item_1").read_text() == "np=1 eps=1"
    logs = sorted(p.name for p in (tmp_path / "logs").iterdir())
    assert logs == ["trainer_0.g0.log", "trainer_0.g1.log", "trainer_1.g0.log"], logs


def test_port_elastic_launch_gives_up_and_times_out(tmp_path):
    from paddle_tpu_torch.distributed.launch import JobSpec, elastic_launch_local

    crash = tmp_path / "always_crash.py"
    crash.write_text("import os; os._exit(3)\n")
    assert elastic_launch_local(JobSpec([str(crash)], nproc=2), min_np=2, max_np=2,
                                heartbeat_interval=0.1, heartbeat_ttl=0.4,
                                elastic_timeout=0.4, max_restarts=2, timeout=60) == 1
    pidfile = tmp_path / "pid"
    hang = tmp_path / "hang.py"
    hang.write_text(f"import os, time\nopen({str(pidfile)!r}, 'w').write(str(os.getpid()))\n"
                    "time.sleep(60)\n")
    t0 = time.monotonic()
    assert elastic_launch_local(JobSpec([str(hang)], nproc=1), heartbeat_interval=0.1,
                                timeout=1.5) == 124
    assert time.monotonic() - t0 < 20
    pid = int(pidfile.read_text())
    with pytest.raises(OSError):   # the generation was reaped
        os.kill(pid, 0)


_SERVER_SCRIPT = """
import time
from paddle_tpu_torch.ps.rpc import NativePsServer
s = NativePsServer(port=0, n_trainers=1)
print("READY", s.port, flush=True)
time.sleep(3600)
"""

_COMMON = """
import json, os, sys, time
import numpy as np
from paddle_tpu_torch.distributed.elastic import ElasticManager, ElasticStatus, store_from_spec
from paddle_tpu_torch.ps.accessor import AccessorConfig
from paddle_tpu_torch.ps.rpc import RpcPsClient
from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
from paddle_tpu_torch.ps.table import TableConfig

store_spec, store_dir, endpoint, host, n_passes = sys.argv[1:6]
P, NPART = int(n_passes), 2
rank = int(host.split("-")[1])
store = store_from_spec(store_spec)
cfg = TableConfig(shard_num=4, accessor_config=AccessorConfig(
    sgd=SGDRuleConfig(initial_range=0.0)))
cli = RpcPsClient([endpoint])
cli.create_sparse_table(0, cfg)
push_dim = 12


def keys_of(part):
    return (1 + part * 1000 + np.arange(50)).astype(np.uint64)


def train(p, part):
    keys = keys_of(part)
    cli.pull_sparse(0, keys)
    push = np.zeros((len(keys), push_dim), np.float32)
    push[:, 1] = 1.0            # show += 1: the exactly-once oracle
    push[:, 3:] = 0.01 * (p + 1)
    cli.push_sparse(0, keys, push)
    store.put(f"done/{p}/{part}", "1")


def ckpt_dir(p):
    return os.path.join(store_dir, f"table_ckpt_{p}")
"""

# scale in: the victim (worker-1) stalls mid-pass 2 and is SIGKILLed; the
# leader's watch sees it go, adopts the world of one, reloads the last
# complete pass's checkpoint and replays both partitions from there
_SCALE_IN = _COMMON + """
em = ElasticManager(store, "job", np=2, host=host, heartbeat_interval=0.2,
                    heartbeat_ttl=1.2, elastic_timeout=1.0, min_np=1, max_np=2)
em.start()
gate = time.time() + 30
while len(em.alive_hosts()) < 2 and time.time() < gate:
    time.sleep(0.1)
assert len(em.alive_hosts()) == 2, em.alive_hosts()
em._last_change = time.monotonic()

if rank == 1:
    for p in range(P):
        if p == 2:
            cli.pull_sparse(0, keys_of(1))
            store.put("victim_at_pass", "2")
            time.sleep(3600)
        train(p, 1)
        while int(store.get("completed") or -1) < p:
            time.sleep(0.05)
    sys.exit(0)

my_parts = [0]
p = 0
while p < P:
    for part in my_parts:
        train(p, part)
    redo = False
    while not all(store.get(f"done/{p}/{part}") for part in range(NPART)):
        st = em.watch_once()
        if st == ElasticStatus.RESTART:
            assert em.adopt_world() == 1
            store.put("scaled_in", "1")
            my_parts = list(range(NPART))
            lp = int(store.get("completed") or -1)
            if lp >= 0:
                cli.load(0, ckpt_dir(lp))
            p = lp
            redo = True
            break
        assert st != ElasticStatus.ERROR, "dropped below min_np"
        time.sleep(0.05)
    if not redo:
        cli.save(0, ckpt_dir(p))
        store.put("completed", str(p))
    p += 1
em.stop()
cli.stop_servers()
cli.close()
print("LEADER_DONE", flush=True)
"""

# scale out: the leader starts alone with both partitions; at pass 3 it
# waits for the joiner's heartbeat, adopts the world of two and hands it
# partition 1 from that pass on
_SCALE_OUT = _COMMON + """
em = ElasticManager(store, "job", np=1 if rank == 0 else 2, host=host,
                    heartbeat_interval=0.2, heartbeat_ttl=1.2, elastic_timeout=1.0,
                    min_np=1, max_np=2)
em.start()
if rank == 1:
    gate = time.time() + 60
    while store.get("parts/worker-1") is None and time.time() < gate:
        time.sleep(0.05)
    assert store.get("parts/worker-1") == "1", "never assigned a partition"
    start_pass = int(store.get("resume_from"))
    for p in range(start_pass, P):
        train(p, 1)
        store.put("joiner_passes", str(p - start_pass + 1))
        while int(store.get("completed") or -1) < p:
            time.sleep(0.05)
    em.stop()
    cli.close()
    print("JOINER_DONE", flush=True)
    sys.exit(0)

my_parts = [0, 1]
scaled = False
for p in range(P):
    if not scaled:
        if p == 3:
            gate = time.time() + 60
            while em.watch_once() != ElasticStatus.RESTART:
                assert time.time() < gate, "joiner never announced"
                time.sleep(0.05)
            st = ElasticStatus.RESTART
        else:
            st = em.watch_once()
        if st == ElasticStatus.RESTART:
            assert em.adopt_world() == 2
            store.put("scaled_out", "1")
            store.put("resume_from", str(p))
            store.put("parts/worker-1", "1")
            my_parts = [0]
            scaled = True
    for part in my_parts:
        train(p, part)
    if scaled:
        gate = time.time() + 60
        while not store.get(f"done/{p}/1"):
            assert time.time() < gate, f"joiner stalled at pass {p}"
            time.sleep(0.05)
    cli.save(0, ckpt_dir(p))
    store.put("completed", str(p))
assert scaled, "job finished without scaling out"
em.stop()
time.sleep(0.5)
cli.stop_servers()
cli.close()
print("LEADER_DONE", flush=True)
"""


def _show_counts(ckpt):
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    rows = {}
    for s in range(meta["shard_num"]):
        path = os.path.join(ckpt, f"part-{s:05d}.shard")
        if os.path.exists(path):
            with open(path) as f:
                for ln in f:
                    parts = ln.split()
                    if parts:
                        rows[int(parts[0])] = float(parts[4])   # the show column
    return rows


def _elastic_job(tmp_path, backend, script, scenario):
    n_passes = 6
    store_dir = str(tmp_path / "store")
    master = None
    if backend == "file":
        store_spec, store = f"file:{store_dir}", FileStore(store_dir)
    else:
        master = store = TcpElasticStore(is_master=True)
        store_spec = f"tcp:127.0.0.1:{master.port}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    server = subprocess.Popen([sys.executable, "-c", _SERVER_SCRIPT], stdout=subprocess.PIPE,
                              text=True, cwd=REPO, env=env)
    procs = [server]

    def spawn(host):
        p = subprocess.Popen([sys.executable, "-c", script, store_spec, store_dir, endpoint,
                              host, str(n_passes)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
        procs.append(p)
        return p

    try:
        line = server.stdout.readline().strip()
        assert line.startswith("READY"), line
        endpoint = f"127.0.0.1:{line.split()[1]}"
        scenario(store, spawn)
        rows = _show_counts(os.path.join(store_dir, f"table_ckpt_{n_passes - 1}"))
        expect = {int(k) for part in range(2) for k in (1 + part * 1000 + np.arange(50))}
        assert set(rows) == expect, (len(rows), len(expect))
        bad = {k: v for k, v in rows.items() if v != n_passes}
        assert not bad, f"{len(bad)} keys with a wrong show count: {list(bad.items())[:5]}"
        return store
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if master is not None:
            master.close()


@pytest.mark.parametrize("backend", ["file", "tcp"])
def test_port_elastic_scale_in_lands_each_pass_once(tmp_path, backend):
    def scenario(store, spawn):
        leader, victim = spawn("worker-0"), spawn("worker-1")
        deadline = time.monotonic() + 60
        while store.get("victim_at_pass") is None:
            assert time.monotonic() < deadline, "victim never reached pass 2"
            assert victim.poll() is None, victim.communicate()[0]
            time.sleep(0.1)
        victim.kill()
        victim.wait()
        out, _ = leader.communicate(timeout=120)
        assert leader.returncode == 0 and "LEADER_DONE" in out, out
        assert store.get("scaled_in") == "1", "the leader never scaled in"

    _elastic_job(tmp_path, backend, _SCALE_IN, scenario)


@pytest.mark.parametrize("backend", ["file", "tcp"])
def test_port_elastic_scale_out_lands_each_pass_once(tmp_path, backend):
    def scenario(store, spawn):
        leader = spawn("worker-0")
        deadline = time.monotonic() + 60
        while int(store.get("completed") or -1) < 1:
            assert time.monotonic() < deadline, "the leader made no progress"
            assert leader.poll() is None, leader.communicate()[0]
            time.sleep(0.1)
        joiner = spawn("worker-1")
        out, _ = leader.communicate(timeout=120)
        assert leader.returncode == 0 and "LEADER_DONE" in out, out
        jout, _ = joiner.communicate(timeout=60)
        assert joiner.returncode == 0 and "JOINER_DONE" in jout, jout
        assert store.get("scaled_out") == "1"
        assert int(store.get("joiner_passes") or 0) >= 1
        assert json.loads(store.get("elastic/job/endpoints") or "[]") == ["worker-0",
                                                                          "worker-1"]

    _elastic_job(tmp_path, backend, _SCALE_OUT, scenario)
