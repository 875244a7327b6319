"""ServingReplica: a read-only, oplog-subscribed PS replica.

The port's own copy of ``paddle_tpu.serving.replica``. The replica is a
plain :class:`~paddle_tpu_torch.ps.rpc.NativePsServer` with two twists:

- **read-only attach mode** (``pss_set_read_only``): the training data
  plane (pushes, GEO, shrink, create-exports, bulk load) bounces with
  ``kErrReadOnly`` and insert-on-miss pulls are downgraded to plain
  reads, so serve traffic can never diverge the replica from its
  primary. The replication/bootstrap plane stays open — it is how the
  replica stays fresh.
- **observer registration**: instead of appearing in the routing
  document (where the coordinator could promote it), the replica holds
  a TTL'd lease under ``ps/<job>/obs/<shard>/<endpoint>``. The shard
  primary's :class:`~paddle_tpu_torch.ps.ha.ReplicationManager` polls that
  prefix and attaches observers with the exact backup machinery —
  full snapshot for late joiners, oplog tail, epoch fence-up — so a
  replica that subscribes mid-job converges to the primary bit-for-bit
  and then rides the change feed continuously.

Failover: when the primary dies, the feed stops (the replica keeps
serving its last-applied state — ``status()["since_last_apply_s"]``
exposes the staleness blip); once the coordinator promotes a backup,
the NEW primary's shipper finds the observer lease, fences the replica
up to the new epoch and re-attaches it (snapshot if its cursor is
foreign to the new ring), and the feed resumes.

Dense towers: every applied dense mutation bumps the server's
``dense_version`` counter; the replica's watcher thread triggers the
registered dense callbacks off that counter — a values-only refresh
driven by the feed, not a wall-clock polling loop re-reading table
bytes. :class:`DenseTowerPublisher` / :class:`DenseTowerSync` are the
two halves of that path for a params tree (nested dicts of tensors or
arrays), flattened as the JAX package's ``ravel_pytree`` flattens the same
tree (``convert.ravel_tree``), so both packages publish the same vector.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..convert import ravel_tree
from ..core.enforce import enforce
from ..core.flags import flag
from ..distributed.elastic import Lease
from ..ps.ha import observer_key
from ..ps.rpc import NativePsServer, RemoteSparseTable, RpcPsClient
from ..ps.table import TableConfig

__all__ = ["ServingReplica", "DenseTowerPublisher", "DenseTowerSync",
           "make_serve_client"]


def make_serve_client(replicas: "List[ServingReplica]") -> RpcPsClient:
    """Serve-QoS client spanning one replica PER TRAINING SHARD (keys
    route by ``key % num_servers`` — the replica set must mirror the
    training shard count, replica i subscribed to shard i)."""
    eps = []
    for i, r in enumerate(sorted(replicas, key=lambda r: r.shard)):
        enforce(r.shard == i,
                f"serve client needs one replica per shard 0..n-1, got "
                f"shards {[x.shard for x in replicas]}")
        eps.append(r.endpoint)
    return RpcPsClient(eps, qos="serve")


class ServingReplica:
    """One shard's serving replica. Construct against the training
    job's elastic ``store``/``job_id`` (the same pair the HA cluster
    uses); the shard primary attaches it within one routing poll."""

    def __init__(self, store, job_id: str, shard: int = 0,
                 host: str = "127.0.0.1", port: int = 0,
                 hb_interval: Optional[float] = None,
                 hb_ttl: Optional[float] = None,
                 watch_interval_s: float = 0.002,
                 on_dense_update: Optional[Callable] = None) -> None:
        self.store = store
        self.job_id = job_id
        self.shard = int(shard)
        self.server = NativePsServer(port=port, n_trainers=1, host=host)
        self.server.set_read_only(True)
        self.endpoint = f"{host}:{self.server.port}"
        ttl = (hb_ttl if hb_ttl is not None
               else int(flag("ps_ha_lease_ttl_ms")) / 1000.0)
        interval = (hb_interval if hb_interval is not None
                    else int(flag("ps_ha_heartbeat_ms")) / 1000.0)
        self._lease = Lease(store, observer_key(job_id, shard, self.endpoint),
                            json.dumps({"shard": self.shard,
                                        "role": "observer"}),
                            ttl=ttl, interval=interval).start()
        self._watch_interval = watch_interval_s
        self._on_dense: List[Callable] = []
        if on_dense_update is not None:
            self._on_dense.append(on_dense_update)
        #: feed-freshness bookkeeping (the watcher maintains these)
        self._last_seq = self.server.applied_seq
        self._last_epoch = self.server.epoch
        self._last_dense = self.server.dense_version
        self._last_apply_t = time.perf_counter()
        self.epoch_changes = 0       # promotions survived (re-attaches)
        self.dense_refreshes = 0     # dense callbacks delivered
        #: bounded: a long-lived replica must not grow error state
        self.sync_errors: deque = deque(maxlen=64)
        self._clients: List[RpcPsClient] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, daemon=True,
            name=f"serve-replica:{self.endpoint}")
        self._thread.start()

    # -- feed watcher ------------------------------------------------------

    def on_dense_update(self, cb: Callable) -> None:
        """Register ``cb(replica)`` to run whenever the feed applies a
        dense mutation (kPushDense/kSetDense/kDenseRestore). Callbacks
        run on the watcher thread — keep them cheap (a pull_dense +
        set_params is the intended shape); errors land in
        ``sync_errors`` (bounded) without killing the watcher."""
        self._on_dense.append(cb)

    def _watch(self) -> None:
        while not self._stop.wait(self._watch_interval):
            if self.server.stopped:
                return
            seq = self.server.applied_seq
            if seq != self._last_seq:
                self._last_seq = seq
                self._last_apply_t = time.perf_counter()
            ep = self.server.epoch
            if ep != self._last_epoch:
                self._last_epoch = ep
                self.epoch_changes += 1
            dv = self.server.dense_version
            if dv != self._last_dense:
                self._last_dense = dv
                for cb in list(self._on_dense):
                    try:
                        cb(self)
                        self.dense_refreshes += 1
                    except Exception as e:  # noqa: BLE001 — recorded, bounded
                        self.sync_errors.append(f"{type(e).__name__}: {e}")

    # -- read surface ------------------------------------------------------

    @property
    def applied_seq(self) -> int:
        return self.server.applied_seq

    def client(self, qos: str = "serve") -> RpcPsClient:
        """A client whose ONLY endpoint is this replica — every read
        lands here, zero training-PS RPCs by construction."""
        cli = RpcPsClient([self.endpoint], qos=qos)
        self._clients.append(cli)
        return cli

    def serve_view(self, table_id: int, config: TableConfig,
                   client: Optional[RpcPsClient] = None) -> RemoteSparseTable:
        """Table-shaped read view over this replica (the cold store a
        serving ``HotEmbeddingTier`` wraps). ``config`` must match the
        training-side create (same accessor metadata); the create here
        is idempotent on the replica — it already holds the table via
        the feed — and only teaches the client the dims."""
        cli = client if client is not None else self.client()
        cli.create_sparse_table(table_id, config)
        return RemoteSparseTable(cli, table_id, config)

    def status(self) -> Dict:
        """The freshness/attachment surface the SLO monitors scrape.
        ``since_last_apply_s`` is time since the feed last applied an
        entry — near the push interval under traffic, and the direct
        exposure of the staleness blip while a failover is in flight
        (pair with the primary's ``oplog_seq`` to distinguish an idle
        feed from a severed one)."""
        return {
            "endpoint": self.endpoint,
            "shard": self.shard,
            "read_only": self.server.read_only,
            "applied_seq": self.server.applied_seq,
            "epoch": self.server.epoch,
            "dense_version": self.server.dense_version,
            "since_last_apply_s": round(
                time.perf_counter() - self._last_apply_t, 6),
            "epoch_changes": self.epoch_changes,
            "dense_refreshes": self.dense_refreshes,
            "sync_errors": len(self.sync_errors),
        }

    # -- lifecycle ---------------------------------------------------------

    def kill(self) -> None:
        """Crash simulation (chaos harness): the server and watcher die
        NOW but the lease is NOT released — it expires by TTL, exactly
        what a SIGKILL'd replica looks like to the fleet's lease watch
        and the primary's shipper."""
        self._stop.set()
        self._thread.join(timeout=5)
        self._lease.stop()          # heartbeat dies; key expires by TTL
        for cli in self._clients:
            try:
                cli.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self.server.stop()
        self.server.close()

    def stop(self) -> None:
        """Graceful detach: the observer lease is deleted NOW (the
        primary's shipper drops us on its next poll), then the server
        stops. A crash skips all this — the lease expires by TTL."""
        self._stop.set()
        self._thread.join(timeout=5)
        self._lease.release()
        for cli in self._clients:
            try:
                cli.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self.server.stop()

    def close(self) -> None:
        self.stop()
        self.server.close()

    def __enter__(self) -> "ServingReplica":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# dense-tower delta path (values-only, feed-triggered)
# ---------------------------------------------------------------------------

class DenseTowerPublisher:
    """Trainer-side half: flatten the dense params tree once and publish
    values-only updates through a PS dense table (``kSetDense``, a
    replicated mutation, so the change feed carries it to every replica).
    The flat vector is the JAX package's for the same tree: dict keys in
    sorted order, each leaf row-major (``convert.ravel_tree``). A CTR
    model's port params go in as ``convert.ctr_params_to_jax(params)
    ["params"]`` (the JAX layout), and ``convert.ctr_params_from_jax`` turns
    what the sink receives back into the port's."""

    def __init__(self, client, table_id: int, example_params) -> None:
        flat, unravel = ravel_tree(example_params)
        self._client = client
        self.table_id = int(table_id)
        self.dim = int(flat.size)
        self._unravel = unravel
        # "sum" keeps the server-side table a dumb value holder — we
        # only ever set_dense whole vectors, never push grads into it
        client.create_dense_table(self.table_id, self.dim, optimizer="sum")

    def publish(self, params) -> None:
        flat, _ = ravel_tree(params)
        self._client.set_dense(self.table_id, flat)

    @property
    def unravel(self):
        """flat [dim] f32 → params tree of CPU tensors (hand to
        DenseTowerSync)."""
        return self._unravel


class DenseTowerSync:
    """Replica-side half: registered as a dense watcher on the
    :class:`ServingReplica` — when the feed applies a dense change,
    pull the flat vector from the REPLICA (a local read) and hand the
    rebuilt tree to ``sink`` (``predictor.set_params``, a frontend's
    infer params, ...). Triggered off ``dense_version``, so an idle
    feed costs zero pulls."""

    def __init__(self, replica: ServingReplica, table_id: int, dim: int,
                 unravel, sink: Callable) -> None:
        self._client = replica.client()
        # idempotent create teaches this client the dim; the table
        # itself arrived over the feed
        self._client.create_dense_table(int(table_id), int(dim),
                                        optimizer="sum")
        self.table_id = int(table_id)
        self._unravel = unravel
        self._sink = sink
        self.syncs = 0
        # monotone sink guard: the constructor's initial refresh runs
        # on THIS thread while the watcher may deliver a feed-triggered
        # one concurrently — without ordering, an older pull could sink
        # LAST and leave the predictor stale until the next publish
        self._sunk_version = -1
        self._sink_mu = threading.Lock()
        replica.on_dense_update(self._refresh)
        self._refresh(replica)  # initial state (table may predate us)

    def _refresh(self, replica) -> None:
        # the pulled values reflect dense_version >= the value read
        # BEFORE the pull, so sinking under a never-decreasing stamp
        # can repeat content but never regress it
        ver = replica.server.dense_version
        flat = self._client.pull_dense(self.table_id)
        with self._sink_mu:
            if ver < self._sunk_version:
                return
            self._sunk_version = ver
            self._sink(self._unravel(flat))
            self.syncs += 1
