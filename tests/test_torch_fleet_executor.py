"""The port's fleet executor (``paddle_tpu_torch.distributed.fleet_executor``)
against the JAX package's: the same task graphs on the same feeds give
the same sink outputs; credit bounds, fan-in, the amplifier, timeouts and
errors behave alike; the ``RemoteMessageBus`` carries a pipeline between
two buses in one process and between two processes, with and without
HMAC, and fails closed on a mismatched secret."""

import importlib
import os
import pickle
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("paddle_tpu", "paddle_tpu_torch")


def _fe(pkg):
    return importlib.import_module(f"{pkg}.distributed.fleet_executor")


def _free_ports(n):
    ports = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    return ports


def _chain(fe, n, buf):
    # source 0 -> x2 (1) -> +1 (2) -> sink 3
    T = fe.TaskNode
    return [T(0, role="source", max_run_times=n, downstreams=[(1, buf)]),
            T(1, fn=lambda x: x * 2, max_run_times=n, upstreams=[0], downstreams=[(2, buf)]),
            T(2, fn=lambda x: x + 1, max_run_times=n, upstreams=[1], downstreams=[(3, buf)]),
            T(3, role="sink", max_run_times=n, upstreams=[2])]


def _fan_in(fe):
    T = fe.TaskNode
    return [T(0, role="source", max_run_times=4, downstreams=[(2, 2)]),
            T(1, role="source", max_run_times=4, downstreams=[(2, 2)]),
            T(2, fn=lambda a, b: a + b, max_run_times=4, upstreams=[0, 1],
              downstreams=[(3, 2)]),
            T(3, role="sink", max_run_times=4, upstreams=[2])]


def _amplifier(fe):
    T = fe.TaskNode
    return [T(0, role="source", max_run_times=8, downstreams=[(1, 8)]),
            T(1, fn=lambda xs: sum(xs), role="amplifier", period=4, max_run_times=8,
              upstreams=[0], downstreams=[(2, 2)]),
            T(2, role="sink", max_run_times=2, upstreams=[1])]


GRAPHS = {
    "chain_credit2": (lambda fe: _chain(fe, 8, 2), {0: list(range(8))}),
    "chain_credit1": (lambda fe: _chain(fe, 6, 1), {0: list(range(6))}),
    "fan_in": (_fan_in, {0: [1, 2, 3, 4], 1: [10, 20, 30, 40]}),
    "amplifier": (_amplifier, {0: list(range(8))}),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fleet_executor_graph_gives_jax_outputs(graph):
    build, feeds = GRAPHS[graph]
    outs = [_fe(p).FleetExecutor(build(_fe(p))).run(feeds, timeout=30.0) for p in PKGS]
    assert outs[1] == outs[0], outs


def test_message_bus_routes_and_refuses_like_jax():
    for pkg in PKGS:
        fe = _fe(pkg)
        bus = fe.MessageBus()
        q = bus.register(1)
        bus.send(fe.InterceptorMessage(0, 1, fe.MessageType.DATA_IS_READY, "x"))
        assert q.get_nowait().payload == "x"
        with pytest.raises(Exception):
            bus.send(fe.InterceptorMessage(0, 99, fe.MessageType.DATA_IS_READY))
        with pytest.raises(Exception):
            bus.register(1)
        with pytest.raises(Exception):
            fe.FleetExecutor([fe.TaskNode(0, role="source"), fe.TaskNode(0, role="sink")])


def test_credit_bounds_in_flight_and_records_the_peak():
    """buffer_size 1 into a slow consumer: the producer is never more than
    one micro-batch ahead in either package, and the port's interceptors
    record each edge's in-flight peak within its credits."""
    for pkg in PKGS:
        fe = _fe(pkg)
        lock = threading.Lock()
        outstanding = {"n": 0, "max": 0}

        def produce(x):
            with lock:
                outstanding["n"] += 1
                outstanding["max"] = max(outstanding["max"], outstanding["n"])
            return x

        def consume(x):
            time.sleep(0.01)
            with lock:
                outstanding["n"] -= 1
            return x

        T = fe.TaskNode
        nodes = [T(0, role="source", fn=produce, max_run_times=6, downstreams=[(1, 1)]),
                 T(1, fn=consume, max_run_times=6, upstreams=[0], downstreams=[(2, 1)]),
                 T(2, role="sink", max_run_times=6, upstreams=[1])]
        carrier = fe.Carrier(nodes, {0: list(range(6))})
        carrier.start()
        carrier.wait(30.0)
        assert carrier.sinks[0].outputs == list(range(6))
        assert outstanding["max"] <= 2, (pkg, outstanding)
        if pkg == "paddle_tpu_torch":
            assert carrier.interceptors[0].peak_in_flight == {1: 1}
            assert carrier.interceptors[1].peak_in_flight == {2: 1}


def test_amplifier_partial_window_and_timeout_and_error_like_jax():
    for pkg in PKGS:
        fe = _fe(pkg)
        T = fe.TaskNode
        partial = [T(0, role="source", max_run_times=6, downstreams=[(1, 6)]),
                   T(1, role="amplifier", period=4, max_run_times=6, upstreams=[0],
                     downstreams=[(2, 2)]),
                   T(2, role="sink", max_run_times=1, upstreams=[1])]
        with pytest.raises(Exception, match="multiple of period"):
            fe.FleetExecutor(partial).run({0: list(range(6))}, timeout=5.0)
        starved = [T(0, role="source", max_run_times=2, downstreams=[(1, 2)]),
                   T(1, fn=lambda x: x, max_run_times=4, upstreams=[0], downstreams=[(2, 2)]),
                   T(2, role="sink", max_run_times=4, upstreams=[1])]
        with pytest.raises(Exception, match="timed out"):
            fe.FleetExecutor(starved).run({0: [0, 1]}, timeout=1.0)

        def boom(x):
            raise ValueError("boom")

        failing = [T(0, role="source", max_run_times=1, downstreams=[(1, 1)]),
                   T(1, fn=boom, max_run_times=1, upstreams=[0], downstreams=[(2, 1)]),
                   T(2, role="sink", max_run_times=1, upstreams=[1])]
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="boom"):
            fe.FleetExecutor(failing).run({0: [1]}, timeout=30.0)
        assert time.monotonic() - t0 < 5.0


def test_torch_section_per_micro_batch_like_a_jitted_one():
    """A ComputeInterceptor driving a torch step (the port's usual case)
    gives what the JAX package's jitted section gives on the same feeds."""
    import jax
    import jax.numpy as jnp

    feeds = {0: [np.ones(4, np.float32) * i for i in range(3)]}
    section = jax.jit(lambda x: jnp.sum(x * 2.0))
    fns = {"paddle_tpu": lambda x: float(section(jnp.asarray(x))),
           "paddle_tpu_torch": lambda x: float(torch.sum(torch.from_numpy(x) * 2.0))}
    outs = []
    for pkg in PKGS:
        fe = _fe(pkg)
        T = fe.TaskNode
        nodes = [T(0, role="source", max_run_times=3, downstreams=[(1, 2)]),
                 T(1, fn=fns[pkg], max_run_times=3, upstreams=[0], downstreams=[(2, 2)]),
                 T(2, role="sink", max_run_times=3, upstreams=[1])]
        outs.append(fe.FleetExecutor(nodes).run(feeds, timeout=60.0))
    assert outs[0] == outs[1] == {2: [0.0, 8.0, 16.0]}


@pytest.mark.parametrize("secret", [None, b"job-shared-key"], ids=["plain", "hmac"])
def test_remote_bus_loopback_pipeline(secret):
    from paddle_tpu_torch.distributed.fleet_executor import Carrier, RemoteMessageBus, TaskNode

    ports = _free_ports(2)
    addrs = {0: ("127.0.0.1", ports[0]), 1: ("127.0.0.1", ports[1])}
    placement = {0: 0, 1: 1, 2: 1}
    n = 4
    nodes = [TaskNode(0, role="source", max_run_times=n, downstreams=[(1, 2)]),
             TaskNode(1, fn=lambda x: x * 3 + 10, max_run_times=n, upstreams=[0],
                      downstreams=[(2, 2)]),
             TaskNode(2, role="sink", max_run_times=n, upstreams=[1])]
    bus0 = RemoteMessageBus(0, addrs, placement, secret=secret)
    bus1 = RemoteMessageBus(1, addrs, placement, secret=secret)
    c0 = Carrier(nodes, feeds={0: list(range(n))}, bus=bus0, local_ids=[0])
    c1 = Carrier(nodes, bus=bus1, local_ids=[1, 2])
    c1.start()
    c0.start()
    c1.wait(timeout=30.0)
    c0.wait(timeout=30.0)
    assert c1.sinks[0].outputs == [10, 13, 16, 19]
    assert c0.interceptors[0].peak_in_flight[1] <= 2
    bus0.close()
    bus1.close()


def test_remote_bus_drops_unsigned_and_mismatched_frames_before_unpickling():
    """A raw unsigned frame at a secret-protected listener is dropped and
    its connection closed before ``pickle.loads`` (its reducer never
    runs); two ranks with different secrets deliver nothing."""
    from paddle_tpu_torch.distributed.fleet_executor import (InterceptorMessage, MessageType,
                                                             RemoteMessageBus)

    (port,) = _free_ports(1)
    bus = RemoteMessageBus(0, {0: ("127.0.0.1", port)}, {0: 0}, secret=b"right-key")
    inbox = bus.register(7)
    hits = []

    class Poison:
        def __reduce__(self):
            return (hits.append, ("executed",))

    body = pickle.dumps(InterceptorMessage(1, 7, MessageType.DATA_IS_READY, Poison()),
                        protocol=pickle.HIGHEST_PROTOCOL)
    with socket.create_connection(("127.0.0.1", port), timeout=5.0) as s:
        s.sendall(struct.pack("<I", len(body)) + body)
        s.settimeout(5.0)
        assert s.recv(1) == b""
    assert hits == [] and inbox.empty()
    bus.close()

    ports = _free_ports(2)
    addrs = {0: ("127.0.0.1", ports[0]), 1: ("127.0.0.1", ports[1])}
    placement = {0: 0, 7: 1}
    bus0 = RemoteMessageBus(0, addrs, placement, secret=b"key-A")
    bus1 = RemoteMessageBus(1, addrs, placement, secret=b"key-B")
    inbox = bus1.register(7)
    bus0.send(InterceptorMessage(0, 7, MessageType.DATA_IS_READY, "x"))
    time.sleep(0.3)
    assert inbox.empty()
    bus0.close()
    bus1.close()


def test_remote_bus_dead_peer_stops_fast_and_unknown_ids_close():
    from paddle_tpu_torch.distributed.fleet_executor import (Carrier, InterceptorMessage,
                                                             MessageType, RemoteMessageBus,
                                                             TaskNode)

    ports = _free_ports(2)
    addrs = {0: ("127.0.0.1", ports[0]), 1: ("127.0.0.1", ports[1])}
    nodes = [TaskNode(0, role="source", max_run_times=1, downstreams=[(1, 1)]),
             TaskNode(1, role="sink", max_run_times=1, upstreams=[0])]
    bus = RemoteMessageBus(0, addrs, {0: 0, 1: 1}, connect_timeout=30.0)
    carrier = Carrier(nodes, feeds={0: [0]}, bus=bus, local_ids=[0])
    t0 = time.monotonic()
    carrier.stop()   # rank 1 never started
    assert time.monotonic() - t0 < 10.0
    bus.close()

    (port,) = _free_ports(1)
    bus = RemoteMessageBus(0, {0: ("127.0.0.1", port)}, {0: 0}, register_grace=0.5)
    body = pickle.dumps(InterceptorMessage(1, 999, MessageType.DATA_IS_READY, None),
                        protocol=pickle.HIGHEST_PROTOCOL)
    with socket.create_connection(("127.0.0.1", port), timeout=5.0) as s:
        s.sendall(struct.pack("<I", len(body)) + body)
        s.settimeout(20.0)
        assert s.recv(1) == b""
    deadline = time.monotonic() + 5.0
    while bus.last_error is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert bus.last_error is not None and "999" in bus.last_error
    bus.close()


_WORKER = textwrap.dedent("""
    import sys, time
    import torch
    from paddle_tpu_torch.distributed.fleet_executor import Carrier, RemoteMessageBus, TaskNode

    rank, port0, port1 = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    secret = sys.argv[4].encode() if len(sys.argv) > 4 else None
    N = 6
    send_times = []

    def stamp(i):
        send_times.append(time.monotonic())
        return torch.full((3,), float(i))      # a CPU tensor crosses the wire

    def slow_double(x):
        time.sleep(0.05)
        return (2 * x).tolist()

    nodes = [TaskNode(0, role="source", fn=stamp, max_run_times=N, downstreams=[(1, 1)]),
             TaskNode(1, role="compute", fn=slow_double, max_run_times=N, upstreams=[0],
                      downstreams=[(2, 2)]),
             TaskNode(2, role="sink", max_run_times=N, upstreams=[1])]
    placement = {0: 0, 1: 1, 2: 1}
    bus = RemoteMessageBus(rank, {0: ("127.0.0.1", port0), 1: ("127.0.0.1", port1)},
                           placement, secret=secret)
    carrier = Carrier(nodes, feeds={0: list(range(N))}, bus=bus,
                      local_ids=[t for t, r in placement.items() if r == rank])
    carrier.start()
    carrier.wait(timeout=60.0)
    if rank == 1:
        assert carrier.sinks[0].outputs == [[2.0 * i] * 3 for i in range(N)], carrier.sinks[0].outputs
    else:
        span = send_times[-1] - send_times[0]
        assert len(send_times) == N, send_times
        assert span >= 0.05 * (N - 2), f"no backpressure: span={span:.3f}s"
        assert carrier.interceptors[0].peak_in_flight == {1: 1}
    bus.close()
    print("WORKER_OK", rank, flush=True)
""")


@pytest.mark.parametrize("secret", [None, "job-key"], ids=["plain", "hmac"])
def test_remote_bus_across_two_processes(tmp_path, secret):
    """Source in one process, compute and sink in another: the credit
    returns cross the wire, so a 1-credit edge into a slow compute spaces
    the source's sends (the backpressure assertion is in the worker)."""
    ports = _free_ports(2)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    extra = [secret] if secret else []
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(ports[0]),
                               str(ports[1]), *extra], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
            assert f"WORKER_OK {r}" in out, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
