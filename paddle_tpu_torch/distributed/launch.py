"""Process launcher: ``python -m paddle_tpu_torch.distributed.launch``.

The port's own copy of ``paddle_tpu.distributed.launch``. The
reference's ``python/paddle/distributed/launch`` spawns trainer and
server subprocesses with role env vars; here, as in its PS test harness
(test_dist_fleet_base.py:311 _run_cluster), every process runs on this
host:

    python -m paddle_tpu_torch.distributed.launch --servers 2 \
        --nproc_per_node 2 [--master_port P] [--log_dir DIR] job.py [ARGS...]

Server ``r`` listens on ``127.0.0.1:P+100+r`` and trainer ``i`` is
named ``127.0.0.1:P+1+i``; each process gets the env the role makers read
(``TRAINING_ROLE``, ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_PSERVERS_IP_PORT_LIST``,
``POD_IP``/``PADDLE_PORT`` for a server) plus ``JobSpec.env``. The
launcher waits for the trainers, then sends SIGTERM to the servers (a
job's trainer 0 stops them first, after a closing barrier), and returns
the first non-zero trainer exit code.

:func:`elastic_launch_local` supervises the trainers instead: it
heartbeats each live (or cleanly finished) rank into an
:class:`~.elastic.ElasticManager`'s store and, when a rank dies, kills the
survivors and relaunches the world with ``PADDLE_TRAINERS_NUM`` and the
endpoint env rewritten to the new size.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

__all__ = ["JobSpec", "elastic_launch_local", "launch_local", "main"]


class JobSpec:
    """A local job: ``script`` (argv after the interpreter) run by ``nproc``
    trainers and ``servers`` PS servers, ports from ``coordinator_port``,
    each process's output to ``log_dir``, ``env`` added to every process's."""

    def __init__(self, script: List[str], nproc: int = 1, servers: int = 0,
                 coordinator_port: int = 12355, log_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None) -> None:
        self.script = script
        self.nproc = nproc
        self.servers = servers
        self.coordinator_port = coordinator_port
        self.log_dir = log_dir
        self.env = env or {}


def _proc_env(spec: JobSpec, role: str, rank: int) -> Dict[str, str]:
    env = dict(os.environ)
    env.update(spec.env)
    trainer_eps = ",".join(
        f"127.0.0.1:{spec.coordinator_port + 1 + i}" for i in range(spec.nproc))
    server_eps = ",".join(
        f"127.0.0.1:{spec.coordinator_port + 100 + i}" for i in range(spec.servers))
    env.update({
        "TRAINING_ROLE": role,
        "PADDLE_TRAINERS_NUM": str(spec.nproc),
        "PADDLE_TRAINER_ENDPOINTS": trainer_eps,
        "PADDLE_PSERVERS_IP_PORT_LIST": server_eps,
        "PADDLE_COORDINATOR": f"127.0.0.1:{spec.coordinator_port}",
        "PADDLE_WORLD_SIZE": str(spec.nproc),
    })
    if role == "TRAINER":
        env["PADDLE_TRAINER_ID"] = str(rank)
        env["PADDLE_RANK"] = str(rank)
    else:
        env["PADDLE_PORT"] = str(spec.coordinator_port + 100 + rank)
        env["POD_IP"] = "127.0.0.1"
        env["PADDLE_SERVER_ID"] = str(rank)
    return env


def _spawn(spec: JobSpec, role: str, rank: int,
           log_suffix: str = "") -> subprocess.Popen:
    """One trainer/server subprocess with its role env; its output goes to
    ``<log_dir>/<role>_<rank><log_suffix>.log`` when ``spec.log_dir`` is
    set."""
    env = _proc_env(spec, role, rank)
    stdout = None
    if spec.log_dir:
        os.makedirs(spec.log_dir, exist_ok=True)
        stdout = open(os.path.join(
            spec.log_dir, f"{role.lower()}_{rank}{log_suffix}.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable] + spec.script, env=env,
            stdout=stdout, stderr=subprocess.STDOUT if stdout else None)
    finally:
        if stdout is not None:
            stdout.close()  # the child holds its own duplicate fd


def _terminate(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()


def launch_local(spec: JobSpec, timeout: Optional[float] = None) -> int:
    """Spawn servers then trainers on localhost; wait for trainers, then
    terminate servers (the PS controller sequence). Returns 0 when every
    trainer exits cleanly; the first trainer to exit non-zero ends the job
    at once (the others, which would wait on it in a collective, are
    terminated) and its code is returned. ``timeout`` raises
    ``subprocess.TimeoutExpired``; every process is reaped on every exit
    path.

    ``--servers 0 --nproc_per_node K`` is a collective job of K trainers:
    each gets the env ``distributed.collective.ParallelEnv`` reads
    (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
    ``PADDLE_TRAINER_ENDPOINTS``, whose entry 0 is the default rendezvous
    of ``init_parallel_env``; ``PADDLE_MASTER`` in ``JobSpec.env`` names
    another)."""
    procs: List[subprocess.Popen] = []
    server_procs: List[subprocess.Popen] = []

    try:
        for r in range(spec.servers):
            server_procs.append(_spawn(spec, "PSERVER", r))
        for r in range(spec.nproc):
            procs.append(_spawn(spec, "TRAINER", r))
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(spec.script, timeout)
            time.sleep(0.05)
    finally:
        _terminate(procs + server_procs)


def elastic_launch_local(
    spec: JobSpec,
    min_np: Optional[int] = None,
    max_np: Optional[int] = None,
    heartbeat_interval: float = 0.3,
    heartbeat_ttl: float = 1.0,
    elastic_timeout: float = 1.5,
    max_restarts: int = 3,
    timeout: Optional[float] = None,
) -> int:
    """The elastic controller loop (fleet/elastic/manager.py:439-532 and
    the launcher's restart path). The supervisor heartbeats each live or
    cleanly exited rank into a :class:`~.elastic.MemoryStore` and acts on
    the :class:`~.elastic.ElasticManager`'s decision: HOLD keeps running,
    RESTART kills the survivors and relaunches every trainer with the
    world size and endpoint env rewritten to the new membership, ERROR
    (below ``min_np``) gives up. Trainers are expected to resume from
    their own checkpoints or done-markers: a restart re-executes them.

    Returns 0 when a generation of trainers all exit cleanly, 1 on ERROR
    or a spent restart budget, 124 on ``timeout``. Every exit path reaps
    the current generation and the servers."""
    from .elastic import ElasticManager, ElasticStatus, MemoryStore

    min_np = min_np if min_np is not None else spec.nproc
    max_np = max_np if max_np is not None else spec.nproc
    store = MemoryStore()
    deadline = time.monotonic() + timeout if timeout else None
    np_now = spec.nproc
    restarts = 0

    server_procs: List[subprocess.Popen] = []
    trainers: List[subprocess.Popen] = []

    try:
        for r in range(spec.servers):
            server_procs.append(_spawn(spec, "PSERVER", r))

        while True:
            gen_spec = JobSpec(spec.script, nproc=np_now, servers=spec.servers,
                               coordinator_port=spec.coordinator_port,
                               log_dir=spec.log_dir, env=spec.env)
            trainers = [_spawn(gen_spec, "TRAINER", r, f".g{restarts}")
                        for r in range(np_now)]
            mgr = ElasticManager(store, job_id="launch", np=np_now, host="supervisor",
                                 heartbeat_interval=heartbeat_interval,
                                 heartbeat_ttl=heartbeat_ttl,
                                 elastic_timeout=elastic_timeout,
                                 min_np=min_np, max_np=max_np)
            decision = None
            while True:
                if deadline and time.monotonic() > deadline:
                    return 124
                for r, p in enumerate(trainers):
                    # a clean exit keeps its membership (that rank's share
                    # is done, not dead); a crash stops the heartbeat
                    if p.poll() is None or p.poll() == 0:
                        store.put(mgr.member_key(f"rank{r}"), "1", ttl=heartbeat_ttl)
                if all(p.poll() == 0 for p in trainers):
                    return 0  # the generation completed
                status = mgr.watch_once()
                if status is ElasticStatus.RESTART:
                    # the live or finished ranks, clamped to [min_np, max_np]
                    decision = max(mgr.adopt_world(), 1)
                    break
                if status is ElasticStatus.ERROR:
                    return 1  # unrecoverable below min_np
                if (all(p.poll() is not None for p in trainers)
                        and any(p.poll() != 0 for p in trainers)
                        and status is ElasticStatus.HOLD):
                    # the whole generation is gone before the ttl expired:
                    # skip the grace wait and restart at once
                    decision = max(min_np, 1)
                    break
                time.sleep(heartbeat_interval)

            _terminate(trainers)  # kill the survivors; relaunch the world
            for r in range(np_now):
                store.delete(mgr.member_key(f"rank{r}"))
            restarts += 1
            if restarts > max_restarts:
                return 1
            np_now = decision
    finally:
        _terminate(trainers + server_procs)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch trainers (and PS servers) on this host.")
    ap.add_argument("--nproc_per_node", type=int, default=1)
    ap.add_argument("--servers", type=int, default=0)
    ap.add_argument("--master_port", type=int, default=12355)
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("script", nargs=argparse.REMAINDER,
                    help="training script and its args")
    args = ap.parse_args(argv)
    script = [a for a in args.script if a != "--"]
    if not script:
        ap.error("missing training script")
    return launch_local(JobSpec(script, nproc=args.nproc_per_node,
                                servers=args.servers,
                                coordinator_port=args.master_port,
                                log_dir=args.log_dir))


if __name__ == "__main__":
    sys.exit(main())
