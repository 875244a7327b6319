"""Online serving plane: oplog-subscribed read replicas and a batched
low-latency frontend.

The port's own copy of the first part of ``paddle_tpu.serving``. The
training side ships every mutation through a seq-numbered replication
oplog (``ps.ha``); this package uses that stream as a change feed, so
serving freshness rides replication:

- :class:`~paddle_tpu_torch.serving.replica.ServingReplica`: a read-only
  ``NativePsServer`` that registers a TTL'd observer lease; the primaries'
  ``ReplicationManager`` attaches it as it attaches a backup (snapshot,
  oplog tail, epoch fence), but the coordinator never promotes it. Dense
  towers refresh off the feed's ``dense_version`` counter
  (:class:`DenseTowerPublisher`, :class:`DenseTowerSync`).
- :class:`~paddle_tpu_torch.serving.frontend.ServingFrontend`:
  micro-batching (up to ``max_batch`` or ``max_delay_us``), a bounded
  admission queue with load shedding, two priority classes and
  per-request deadlines.
- :mod:`~paddle_tpu_torch.serving.lookup`: ``CachedLookup`` serves
  resident rows through a read-only ``HotEmbeddingTier`` (bounded
  staleness, no call on warm keys); ``ReplicaLookup`` reads the replica's
  table.

Every read goes to the replica: serving makes no training-PS call by
construction, and the serve-path clients run in their own QoS class
(``ps.rpc`` ``qos="serve"``: short deadlines, breakers of their own).

The fleet layer turns one replica into a tier:
:class:`~paddle_tpu_torch.serving.router.ServingRouter` balances requests
over N members (bounded-load consistent hashing on the sparse key block
for cached-lookup affinity, power-of-two choices for dense-only traffic,
hedging with dedupe on a measured budget, failure reroute);
:class:`~paddle_tpu_torch.serving.fleet.ServingFleet` owns membership off
the TTL'd observer leases (drain restarts, warm-handoff joins, crash
removal); :class:`~paddle_tpu_torch.serving.rollout.RolloutManager` makes a
model push a routed event (canary band, promote, digest-pinned rollback).

The pipeline layer chains retrieval into ranking behind one deadline:
:class:`~paddle_tpu_torch.serving.pipeline.PipelineFrontend` carves a
request's budget into stage budgets (the candidate fan-out over the fleet
with an early top-K cut, then ranking coalesced across requests: one
gather and one stacked ranker call for many requests), and
:mod:`~paddle_tpu_torch.serving.member_host` runs each fleet member in a
process of its own (``spawn_member``), reachable only by its endpoint.
"""

from .fleet import FleetConfig, FleetController, FleetMember, ServingFleet
from .frontend import (DeadlineExceeded, FrontendConfig, PendingResult, RequestRejected,
                       ServingFrontend)
from .lookup import CachedLookup, ReplicaLookup
from .member_host import RemoteFrontend, RemoteModel, spawn_member
from .metrics import FreshnessProbe, LatencyRecorder
from .pipeline import PipelineConfig, PipelineFrontend
from .replica import DenseTowerPublisher, DenseTowerSync, ServingReplica, make_serve_client
from .rollout import DenseModel, RolloutConfig, RolloutManager
from .router import RoutedRequest, RouterConfig, ServingRouter

__all__ = [
    "ServingReplica",
    "ServingFrontend",
    "FrontendConfig",
    "PendingResult",
    "RequestRejected",
    "DeadlineExceeded",
    "ReplicaLookup",
    "CachedLookup",
    "DenseTowerPublisher",
    "DenseTowerSync",
    "make_serve_client",
    "LatencyRecorder",
    "FreshnessProbe",
    "ServingRouter",
    "RouterConfig",
    "RoutedRequest",
    "ServingFleet",
    "FleetConfig",
    "FleetMember",
    "FleetController",
    "RolloutManager",
    "RolloutConfig",
    "DenseModel",
    "PipelineFrontend",
    "PipelineConfig",
    "spawn_member",
    "RemoteFrontend",
    "RemoteModel",
]
