"""Run a K-process ``torch.distributed`` job on this host and collect
what each process wrote: the harness of the multi-process tests.

:func:`run_job` starts ``argv`` (a script and its arguments, run by this
interpreter) as ``nproc`` trainer processes through the port's own
launcher (``distributed.launch.launch_local``, no servers), with the env
``distributed.collective.ParallelEnv`` reads, rendezvous through a
``file://`` store in ``workdir`` (no TCP port to race for), one intra-op
thread a process (``OMP_NUM_THREADS=1``) and each process's output in
``workdir/logs``. The launcher kills every process that is still running
when the job ends, fails or times out, so none outlives the call.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

__all__ = ["job_env", "run_job"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def job_env(workdir: str, extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The env a job's processes get on top of the launcher's: the store,
    one intra-op thread, the checkout on ``PYTHONPATH``."""
    env = {"PADDLE_MASTER": f"file://{os.path.join(os.path.abspath(workdir), 'store')}",
           "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(p for p in (_REPO, os.environ.get("PYTHONPATH"))
                                         if p)}
    env.update(extra or {})
    return env


def run_job(argv: Sequence[str], nproc: int, workdir: str, timeout: float,
            env: Optional[Dict[str, str]] = None) -> List[str]:
    """Run the job; raise ``AssertionError`` with the processes' logs if
    it fails or times out. Returns each process's log, by rank."""
    import subprocess

    from ..distributed.launch import JobSpec, launch_local

    os.makedirs(workdir, exist_ok=True)
    logs = os.path.join(workdir, "logs")
    spec = JobSpec(list(argv), nproc=nproc, servers=0, log_dir=logs,
                   env=job_env(workdir, env))
    try:
        rc = launch_local(spec, timeout=timeout)
        err = None if rc == 0 else f"exit code {rc}"
    except subprocess.TimeoutExpired:
        err = f"timed out after {timeout} s"
    out = []
    for r in range(nproc):
        path = os.path.join(logs, f"trainer_{r}.log")
        out.append(open(path).read() if os.path.exists(path) else "")
    if err is not None:
        tails = "\n".join(f"--- rank {r} ---\n{t[-3000:]}" for r, t in enumerate(out))
        raise AssertionError(f"the {nproc}-process job {list(argv)} failed: {err}\n{tails}")
    return out
