"""Process launcher: ``python -m paddle_tpu_torch.distributed.launch``.

The port's own copy of ``paddle_tpu.distributed.launch`` without
``elastic_launch_local`` (ROADMAP Queue A item 8, ``elastic``). The
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
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

__all__ = ["JobSpec", "launch_local", "main"]


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


def _spawn(spec: JobSpec, role: str, rank: int) -> subprocess.Popen:
    """One trainer/server subprocess with its role env; its output goes to
    ``<log_dir>/<role>_<rank>.log`` when ``spec.log_dir`` is set."""
    env = _proc_env(spec, role, rank)
    stdout = None
    if spec.log_dir:
        os.makedirs(spec.log_dir, exist_ok=True)
        stdout = open(os.path.join(
            spec.log_dir, f"{role.lower()}_{rank}.log"), "w")
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
    terminate servers (the PS controller sequence). Returns the first
    nonzero trainer exit code, else 0."""
    procs: List[subprocess.Popen] = []
    server_procs: List[subprocess.Popen] = []

    try:
        for r in range(spec.servers):
            server_procs.append(_spawn(spec, "PSERVER", r))
        for r in range(spec.nproc):
            procs.append(_spawn(spec, "TRAINER", r))
        deadline = time.monotonic() + timeout if timeout else None
        rc = 0
        for p in procs:
            left = max(0.1, deadline - time.monotonic()) if deadline else None
            code = p.wait(timeout=left)
            rc = rc or code
        return rc
    finally:
        _terminate(procs + server_procs)


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
