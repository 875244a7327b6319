"""Multi-tenant PS cloud: many models on one ``HACluster`` with enforced
isolation.

The port's own copy of ``paddle_tpu.ps.tenancy``. Production clusters run
many jobs against one shared parameter-server fleet (Wide&Deep next to
DeepFM and ERNIE on the same servers); this module is that scenario's
control plane over the service's tenancy handlers:

- **Namespaces** (the service's ``kTenantShift``): a tenant's tables live
  under table ids whose high byte is the tenant id. The namespace is
  enforced on the wire: a connection binds to its tenant with
  ``kTenantHello`` and the server bounces any frame addressing another
  tenant's table with ``kErrWrongTenant``, before the pause gate, the
  ownership fence and the oplog tap, so a refused frame changed state
  nowhere. The request header never grows; the tag rides bits the 32-bit
  table id always had.
- **Priority classes and weighted admission**: each tenant has a token
  bucket per shard (cost 1 a frame + 1 a key). Over budget, serve-class
  (pclass 0) frames queue briefly on the server; batch classes shed at
  once with ``kErrThrottled`` and a retry-after hint. Other tenants'
  buckets are untouched.
- **Enforced quotas**: PS rows and SSD bytes are metered from the live
  engines and row-creating commands refuse with ``kErrQuota`` at the cap;
  another tenant's rows are never evicted to make room. Hot-tier slots cap
  per tenant inside ``HotEmbeddingTier`` (``HotTierConfig.tenant_slots``).
- **Per-tenant control plane**: tenant-labelled gauges of bounded
  cardinality (at most 256 tenants: the id is one byte), per-tenant SLO
  rules (:func:`tenant_slo_rules`), scoped flight-recorder bundles
  (:func:`tenant_flight_recorder`) and a per-tenant autoscaler lever (an
  ``Autoscaler`` subscribed to one tenant's rules: ``ps.autoscale``'s
  ``tenant=``).
"""

# lock discipline (the JAX module's): the directory's _mu is a leaf, never
# held across calls into rpc/ha (register and usage do their wire work
# outside it and only fence the tenant map itself)
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np

from ..core import sync as _sync
from ..core.enforce import enforce
from ..obs import registry as _obs_registry
from ..obs.flightrec import FlightRecorder
from .rpc import RpcPsClient, make_conn

__all__ = [
    "TENANT_SHIFT", "KEY_TENANT_SHIFT", "MAX_TENANTS",
    "tenant_table_id", "split_table_id", "namespace_keys",
    "tenant_of_keys", "Tenant", "TenantDirectory", "tenant_slo_rules",
    "tenant_flight_recorder",
]

#: table-id namespace shift (the service's kTenantShift, ``rpc._TENANT_SHIFT``):
#: table_id = (tenant << TENANT_SHIFT) | local_id
TENANT_SHIFT = 24
#: key namespace shift for shared caches and tiers: the top byte of a u64
#: feature key carries the tenant (the hot tier's per-tenant caps read it);
#: the server itself needs no key namespacing, its tables are namespaced
KEY_TENANT_SHIFT = 56
#: tenant ids are one byte; 0 is the operator plane
MAX_TENANTS = 255


def tenant_table_id(tenant: int, local_id: int) -> int:
    """The wire table id of ``local_id`` inside ``tenant``'s namespace."""
    enforce(0 < tenant <= MAX_TENANTS, f"tenant id must be 1..{MAX_TENANTS}, got {tenant}")
    enforce(0 <= local_id < (1 << TENANT_SHIFT),
            f"local table id must fit below the tenant tag, got {local_id}")
    return (int(tenant) << TENANT_SHIFT) | int(local_id)


def split_table_id(table_id: int) -> tuple:
    """(tenant, local_id) of a wire table id (tenant 0 = operator)."""
    return (int(table_id) >> TENANT_SHIFT) & 0xff, int(table_id) & ((1 << TENANT_SHIFT) - 1)


def namespace_keys(tenant: int, keys: np.ndarray) -> np.ndarray:
    """Stamp ``tenant`` into the top byte of u64 feature keys (the shared
    hot-tier layout). The keys' top byte must be free (callers mask their
    feature hashes to 56 bits)."""
    enforce(0 < tenant <= MAX_TENANTS, f"tenant id must be 1..{MAX_TENANTS}, got {tenant}")
    k = np.asarray(keys, np.uint64)
    mask = np.uint64((1 << KEY_TENANT_SHIFT) - 1)
    return (k & mask) | (np.uint64(tenant) << np.uint64(KEY_TENANT_SHIFT))


def tenant_of_keys(keys: np.ndarray) -> np.ndarray:
    """Tenant ids of namespaced u64 keys (their top byte)."""
    return (np.asarray(keys, np.uint64) >> np.uint64(KEY_TENANT_SHIFT)).astype(np.int64)


@dataclasses.dataclass
class Tenant:
    """One tenant's declared envelope: what the operator installs on every
    server replica and what the meter reports against."""

    name: str
    tid: int                      # 1..255, the namespace tag
    #: 0 = serve (over-budget requests queue briefly), >= 1 = batch
    #: (over-budget requests shed at once with a retry-after hint)
    pclass: int = 1
    #: token-bucket refill in cost units/s per shard (1 a frame + 1 a key);
    #: 0 = unmetered
    rate: float = 0.0
    #: bucket depth (burst allowance) per shard
    burst: float = 0.0
    #: max resident rows across the namespace per shard (0 = no cap)
    max_rows: int = 0
    #: max SSD file bytes across the namespace per shard (0 = no cap)
    max_ssd_bytes: int = 0
    #: hot-tier slot cap (feeds ``HotTierConfig.tenant_slots``; 0 = no cap;
    #: advisory here, the tier enforces it)
    hot_slots: int = 0
    #: hello credential; empty is legal (id-only isolation)
    token: bytes = b""

    def __post_init__(self) -> None:
        enforce(0 < self.tid <= MAX_TENANTS,
                f"tenant id must be 1..{MAX_TENANTS}, got {self.tid}")

    def table_id(self, local_id: int) -> int:
        return tenant_table_id(self.tid, local_id)


def _install(endpoint: str, t: Tenant) -> None:
    conn = make_conn(endpoint)
    try:
        conn.tenant_config(t.tid, pclass=t.pclass, rate=t.rate, burst=t.burst,
                           max_rows=t.max_rows, max_ssd_bytes=t.max_ssd_bytes, token=t.token)
    finally:
        conn.close()


class TenantDirectory:
    """Operator-side tenant registry for one :class:`~.ha.HACluster`.

    ``register`` installs or updates a tenant on every replica of every
    shard (backups too: ``kTenantConfig`` is accepted in read-only mode, so
    a failover promotes a server that already enforces the same envelope).
    ``client`` hands out tenant-bound clients: every connection they ever
    build, failover and reshard replacements included, says hello before
    its first data frame. ``usage`` sums the per-shard meters.

    The directory is a small registry under one leaf lock; admission and
    quotas live on the servers."""

    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self._mu = _sync.Lock()  # leaf
        self._tenants: Dict[str, Tenant] = {}
        # tenant-labelled meter gauges, bound at register time (the cold
        # path); refresh_usage() only sets them
        self._g_rows: Dict[str, object] = {}
        self._g_ssd: Dict[str, object] = {}
        self._g_throttled: Dict[str, object] = {}

    # -- registration ------------------------------------------------------

    def _all_endpoints(self) -> List[str]:
        return [r.endpoint for row in self.cluster.servers for r in row
                if not r.server.stopped]

    def register(self, tenant: Tenant) -> Tenant:
        """Install (or update) ``tenant`` on every live replica."""
        with self._mu:
            for existing in self._tenants.values():
                enforce(existing.tid != tenant.tid or existing.name == tenant.name,
                        f"tenant id {tenant.tid} already registered as {existing.name!r}")
            self._tenants[tenant.name] = tenant
            reg = _obs_registry.REGISTRY
            if tenant.name not in self._g_rows:
                for gauges, family in ((self._g_rows, "tenant_rows"),
                                       (self._g_ssd, "tenant_ssd_bytes"),
                                       (self._g_throttled, "tenant_throttled")):
                    gauges[tenant.name] = reg.gauge(family, max_series=MAX_TENANTS + 1,
                                                    tenant=tenant.name)
        for ep in self._all_endpoints():
            _install(ep, tenant)
        return tenant

    def sync_server(self, endpoint: str) -> int:
        """Push every registered tenant to one server (a restarted replica
        rejoins with an empty tenant registry). Returns the number pushed."""
        with self._mu:
            tenants = list(self._tenants.values())
        for t in tenants:
            _install(endpoint, t)
        return len(tenants)

    def get(self, name: str) -> Tenant:
        with self._mu:
            return self._tenants[name]

    def tenants(self) -> List[Tenant]:
        with self._mu:
            return list(self._tenants.values())

    # -- tenant-scoped clients ---------------------------------------------

    def client(self, name: str, qos: str = "train", with_router: bool = True,
               **router_kw) -> RpcPsClient:
        """A router-wired client bound to ``name``'s namespace: the servers
        enforce the namespace, budget and quotas on everything it sends."""
        t = self.get(name)
        cli = RpcPsClient(self.cluster.routing.primaries(),
                          router=(self.cluster.router(qos=qos, **router_kw)
                                  if with_router else None),
                          qos=qos, tenant=(t.tid, t.token))
        self.cluster._clients.append(cli)
        return cli

    # -- the meter ---------------------------------------------------------

    def usage(self, name: str) -> Dict[str, int]:
        """``name``'s meter summed over every primary: resident rows, SSD
        bytes, shed and refused counts."""
        t = self.get(name)
        total = {"rows": 0, "ssd_bytes": 0, "throttled": 0, "quota_refused": 0}
        for shard in range(self.cluster.num_shards):
            conn = make_conn(self.cluster.primary(shard).endpoint)
            try:
                u = conn.tenant_usage(t.tid)
            finally:
                conn.close()
            for k in total:
                total[k] += int(u[k])
        return total

    def refresh_usage(self) -> Dict[str, Dict[str, int]]:
        """Read every tenant's meter and export it through the
        tenant-labelled gauges. Returns {tenant name: usage dict}."""
        out = {}
        for t in self.tenants():
            u = self.usage(t.name)
            out[t.name] = u
            with self._mu:
                self._g_rows[t.name].set(u["rows"])
                self._g_ssd[t.name].set(u["ssd_bytes"])
                self._g_throttled[t.name].set(u["throttled"])
        return out


# ---------------------------------------------------------------------------
# per-tenant control plane
# ---------------------------------------------------------------------------


def tenant_slo_rules(tenant: str, pull_p99_s: float = 0.05,
                     throttled_per_s: float = 50.0) -> List:
    """Per-tenant SLO rules (``obs.slo``), labelled ``{"tenant": name}`` so
    one tenant's burn can neither fire nor clear a neighbour's rule.
    Subscribe them to the tenant's ``Autoscaler`` (``config.up_rules`` and
    ``tenant=``) for the per-tenant scaling lever, and to a scoped flight
    recorder for tenant-only bundles.

    - ``{tenant}_pull_p99``: threshold on the tenant-labelled pull
      latency gauge family ``tenant_pull_s``.
    - ``{tenant}_throttle_rate``: the tenant is shed faster than
      ``throttled_per_s`` — its own overload (or an under-provisioned
      budget), surfaced on ITS control plane, not the neighbours'.
    """
    from ..obs.slo import SloRule

    return [
        SloRule(name=f"{tenant}_pull_p99", family="tenant_pull_s",
                kind="threshold", threshold=pull_p99_s, agg="max",
                labels={"tenant": tenant},
                windows=((10.0, 1.0),), min_count=3),
        SloRule(name=f"{tenant}_throttle_rate", family="tenant_throttled",
                kind="threshold", threshold=throttled_per_s, agg="rate",
                field="rate", labels={"tenant": tenant},
                windows=((10.0, 1.0),), min_count=3),
    ]


def tenant_flight_recorder(out_dir: str, tenant: str, **kw) -> FlightRecorder:
    """A flight recorder whose bundles are scoped to one tenant: a bundle
    directory of its own and an alert filter on the tenant label, so a
    tenant's postmortem never carries a neighbour's alerts."""
    return FlightRecorder(os.path.join(out_dir, f"tenant_{tenant}"),
                          scope={"tenant": tenant}, **kw)
