"""PS high availability: for now, the consistent-cut gate of a job checkpoint.

The port's own copy of ``paddle_tpu.ps.ha.CheckpointGate``. The rest of
the JAX module — ``HACluster``, replication, failover, the breaker, the
coordinator — comes with HA (ROADMAP Queue A item 3, entry 2), and with
it the gate's ``cluster=`` form.
"""

from __future__ import annotations

from typing import Optional

from ..core.enforce import UnavailableError, enforce

__all__ = ["CheckpointGate"]


class CheckpointGate:
    """Mutation gate for a consistent job snapshot
    (``io.job_checkpoint.JobCheckpointManager``): on entry every server
    pauses mutations (``NativePsServer.pause_mutations``: writers block
    within their IO deadline, reads such as the save-all export and the
    digest go on, and the pause nests), so the capture streams one cut
    off the paused servers. Exit resumes mutations even when the capture
    raised.

    ``servers`` is the list of in-process ``NativePsServer`` handles.
    ``cluster=`` (an ``HACluster``: the routed primaries, a replication
    drain first for a sync cluster) raises :class:`UnavailableError`
    until HA is ported (its ``drain``/``drain_timeout`` come with it)."""

    def __init__(self, cluster=None, servers: Optional[list] = None) -> None:
        if cluster is not None:
            raise UnavailableError(
                "CheckpointGate(cluster=...) needs ps/ha.py's HACluster, which is not "
                "ported yet (ROADMAP Queue A item 3, entry 2); pass servers=[...]")
        enforce(servers is not None, "CheckpointGate needs servers=[...]")
        self.servers = list(servers)
        self._paused: list = []

    def __enter__(self) -> "CheckpointGate":
        paused = []
        try:
            for srv in self.servers:
                srv.pause_mutations(True)
                paused.append(srv)
        except BaseException:
            for srv in reversed(paused):
                srv.pause_mutations(False)
            raise
        self._paused = paused
        return self

    def __exit__(self, *exc) -> None:
        paused, self._paused = self._paused, []
        for srv in reversed(paused):
            srv.pause_mutations(False)
