"""SLO-driven autoscaling: the loop that makes the cluster breathe
with traffic.

The port's own copy of ``paddle_tpu.ps.autoscale``. :mod:`..obs.slo`
gives the control SIGNAL — multi-window burn-rate alerts over step-time
p95, serving p99, replication lag — and :mod:`.reshard` (or a serving
fleet's controller) the ACTUATOR. The :class:`Autoscaler` closes the
loop:

- **input** — push subscriptions on the :class:`~..obs.slo.SloWatchdog`
  (``on_fire``/``on_clear``, delivered outside the watchdog lock) for
  the configured ``up_rules``; optionally a
  :class:`~..obs.timeseries.MetricRing` for point probes (the
  journal's context snapshot records the step-time p95 and per-table
  wire-byte rate at decision time).
- **policy** — classic hysteresis so one noisy window cannot flap the
  shard set:

  * scale UP when an up-rule alert is ACTIVE, the up-cooldown has
    passed, and ``shards × factor ≤ max_shards``;
  * scale DOWN only after EVERY up-rule has been clear for
    ``clear_hold_s`` (quiet-hold), the down-cooldown has passed, and
    ``shards / factor ≥ min_shards`` — the asymmetric pair (fast up,
    reluctant down) every production autoscaler converges on.

- **actuation** — ``controller.grow(factor)`` / ``shrink(factor)`` on
  the autoscaler's own worker thread (a cutover must never run inside
  the watchdog's evaluate tick); a failed operation is journaled,
  counted, and cooled down like a success (no hot-looping a broken
  reshard).
- **trainer count** — when ``config.trainer_np`` is set (a
  ``shards → np`` map) the autoscaler publishes the target world size
  through :func:`~..distributed.elastic.set_desired_np`; every node's
  ElasticManager adopts it on its next watch tick and the launcher's
  normal HOLD/RESTART machinery does the actual scaling (trainer
  scaling IS a restart in the reference model).
- **journal** — every decision (including refusals at the bounds and
  failures) appends to ``events`` AND to the elastic store under
  ``ps/<job>/scale/<n>`` — the cluster's scale-event history.

``step()`` is public and deterministic (injectable ``clock``); the
worker thread just loops it — the SloWatchdog/Sampler testing pattern.
"""

from __future__ import annotations

import dataclasses
import json
# lock discipline (read by testing.sched.load_lock_order):
# LOCK LEAF: _mu
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..core import sync as _sync
from ..distributed import elastic as _elastic
from ..obs import registry as _obs_registry
from ..obs import trace as _obs_trace

__all__ = ["AutoscaleConfig", "Autoscaler"]


@dataclasses.dataclass
class AutoscaleConfig:
    """Hysteresis/bounds knobs. The defaults are deliberately
    conservative; callers and tests inject fast ones."""

    min_shards: int = 1
    max_shards: int = 8
    #: grow/shrink step (shrink is per-halving, so keep it 2 unless
    #: the reshard planner grows more shapes)
    factor: int = 2
    #: SLO rules whose ACTIVE alert means "the cluster is too small"
    up_rules: Tuple[str, ...] = ("step_time_p95", "serving_p99",
                                 "replication_lag")
    #: min seconds between consecutive scale-UPs (one reshard must get
    #: a chance to absorb the load before the next fires)
    cooldown_up_s: float = 30.0
    #: min seconds between a scale event and a scale-DOWN
    cooldown_down_s: float = 60.0
    #: quiet-hold: EVERY up-rule clear for this long before a down —
    #: the hysteresis band that keeps a sawtoothing signal from
    #: flapping the shard set
    clear_hold_s: float = 20.0
    #: optional shards → trainer-np map; when set (and the autoscaler
    #: has a store + elastic job id) each scale event also publishes
    #: the trainer-world target via elastic.set_desired_np
    trainer_np: Optional[Callable[[int], int]] = None
    elastic_job_id: Optional[str] = None


class Autoscaler:
    """See the module docstring. ``controller`` is a
    :class:`~.reshard.ReshardController`; ``watchdog`` (optional) is
    subscribed on construction; without one, feed alerts through
    :meth:`notify_fire`/:meth:`notify_clear` (tests, foreign alert
    sources)."""

    def __init__(self, controller, watchdog=None,
                 config: Optional[AutoscaleConfig] = None,
                 ring=None,
                 clock: Callable[[], float] = time.monotonic,
                 poll_s: float = 0.25,
                 tenant: Optional[str] = None,
                 proposer=None) -> None:
        self.controller = controller
        self.config = config or AutoscaleConfig()
        #: when a Reconciler (ps/reconcile.py) is wired in, this loop
        #: is a spec PROPOSER: a scale decision writes the desired
        #: shard count through proposer.propose_shards and the single
        #: serialized actuator runs the reshard. Without one (None,
        #: standalone deployments) the legacy direct-actuation branch
        #: in _execute stays live.
        self.proposer = proposer
        #: tenant whose SLO lever this instance answers to (multi-tenant
        #: clusters run one Autoscaler per tenant, each subscribed to
        #: that tenant's labeled rules — ps/tenancy.py tenant_slo_rules;
        #: None = the single-tenant whole-cluster scaler, unchanged).
        #: Journal entries carry the tag so incident triage can tell
        #: whose wave moved the fleet.
        self.tenant = tenant
        self.ring = ring
        self._clock = clock
        self.poll_s = float(poll_s)
        self._mu = _sync.Lock()
        self._active_up: set = set()
        now = clock()
        #: when the up-rule set last became (or started) empty — the
        #: quiet-hold clock; None while an up-rule is active
        self._quiet_since: Optional[float] = now
        self._last_scale_t: Optional[float] = None
        self._wake = _sync.Event()
        self._stop = _sync.Event()
        self._thread: Optional[threading.Thread] = None
        #: decision journal (executed, refused-at-bound, failed)
        self.events: deque = deque(maxlen=512)
        self.errors = 0
        self._seq = 0
        job = str(controller.cluster.job_id)
        self._c_up = _obs_registry.REGISTRY.counter(
            "autoscaler_scale_events", direction="up", job=job)
        self._c_down = _obs_registry.REGISTRY.counter(
            "autoscaler_scale_events", direction="down", job=job)
        if watchdog is not None:
            watchdog.on_fire(self.notify_fire)
            watchdog.on_clear(self.notify_clear)

    # -- alert input (SloWatchdog on_fire/on_clear) -----------------------

    def notify_fire(self, alert) -> None:
        if alert.rule not in self.config.up_rules:
            return
        with self._mu:
            self._active_up.add(alert.rule)
            self._quiet_since = None
        self._wake.set()

    def notify_clear(self, alert) -> None:
        if alert.rule not in self.config.up_rules:
            return
        with self._mu:
            self._active_up.discard(alert.rule)
            if not self._active_up:
                self._quiet_since = self._clock()

    def active_up_rules(self) -> List[str]:
        with self._mu:
            return sorted(self._active_up)

    # -- journal -----------------------------------------------------------

    def _journal(self, event: dict) -> None:
        # `wall_s` is the cross-subsystem alignment key: flight-recorder
        # bundle manifests stamp the same field, so incident triage can
        # line a scale decision up against a tenant's bundle without
        # consulting the elastic-store sequence (which only orders
        # entries, it doesn't place them in time). `t` is the legacy
        # alias kept for existing journal consumers.
        wall = _obs_trace.wall_s()
        event = dict(event, t=wall, wall_s=wall)
        if self.tenant is not None:
            event["tenant"] = self.tenant
        self.events.append(event)
        self._seq += 1
        cluster = self.controller.cluster
        cluster.store.put(f"ps/{cluster.job_id}/scale/{self._seq}",
                          json.dumps(event))

    def _context(self) -> dict:
        """Decision-time snapshot for the journal: why did it scale."""
        ctx: Dict[str, object] = {"active_rules": self.active_up_rules()}
        if self.ring is not None:
            p95 = self.ring.last_value("trainer_step_time_s", "p95")
            if p95 is not None:
                ctx["step_time_p95_s"] = round(float(p95), 6)
            wire = self.ring.last_value("ps_client_wire_bytes", "rate",
                                        reduce="sum")
            if wire is not None:
                ctx["wire_bytes_per_s"] = round(float(wire), 1)
        return ctx

    # -- the decision ------------------------------------------------------

    def step(self, now: Optional[float] = None) -> Optional[str]:
        """One decision pass; returns "up"/"down" when a scale ran,
        None otherwise. Deterministic under an injected clock — the
        worker thread just loops this (the Sampler.tick pattern)."""
        cfg = self.config
        now = self._clock() if now is None else float(now)
        with self._mu:
            burning = bool(self._active_up)
            quiet_since = self._quiet_since
        n = self.controller.cluster.num_shards
        if burning:
            if self._last_scale_t is not None and \
                    now - self._last_scale_t < cfg.cooldown_up_s:
                return None
            if n * cfg.factor > cfg.max_shards:
                self._journal({"kind": "scale_refused", "direction": "up",
                               "shards": n, "reason": "max_shards",
                               **self._context()})
                # refusals cool down too: the bound will not move, and
                # re-journaling it every poll tick is log spam
                self._last_scale_t = now
                return None
            return self._execute("up", n, n * cfg.factor)
        # quiet: consider coming back down
        if n <= cfg.min_shards or n % cfg.factor != 0 or \
                n // cfg.factor < cfg.min_shards:
            return None
        if quiet_since is None or now - quiet_since < cfg.clear_hold_s:
            return None
        if self._last_scale_t is not None and \
                now - self._last_scale_t < cfg.cooldown_down_s:
            return None
        return self._execute("down", n, n // cfg.factor)

    def _execute(self, direction: str, from_n: int, to_n: int
                 ) -> Optional[str]:
        cfg = self.config
        if self.proposer is not None:
            return self._propose(direction, from_n, to_n)
        try:
            if direction == "up":
                # standalone mode: no reconciler wired, this loop is the sole actuator
                rec = self.controller.grow(cfg.factor)
                self._c_up.inc()
            else:
                rec = self.controller.shrink(cfg.factor)
                self._c_down.inc()
        except Exception as e:  # noqa: BLE001 — journaled, cooled down
            self.errors += 1
            self._journal({"kind": "scale_failed", "direction": direction,
                           "from_shards": from_n, "to_shards": to_n,
                           "error": f"{type(e).__name__}: {e}",
                           **self._context()})
            self._last_scale_t = self._clock()
            return None
        self._last_scale_t = self._clock()
        self._journal({"kind": "scale", "direction": direction,
                       "from_shards": from_n, "to_shards": to_n,
                       "cutover_pause_ms": rec.get("cutover_pause_ms"),
                       "bootstrap_s": rec.get("bootstrap_s"),
                       **self._context()})
        if cfg.trainer_np is not None and cfg.elastic_job_id is not None:
            want_np = int(cfg.trainer_np(to_n))
            _elastic.set_desired_np(self.controller.cluster.store,
                                    cfg.elastic_job_id, want_np)
            self._journal({"kind": "trainer_target", "np": want_np,
                           "shards": to_n})
        return direction

    def _propose(self, direction: str, from_n: int, to_n: int
                 ) -> Optional[str]:
        """Proposer mode: write the desired shard count into the
        ClusterSpec and let the reconciler's actuator run the reshard.
        The cooldown starts at PROPOSAL time (the decision, not the
        cutover, is what hysteresis paces); SpecStore's no-op dedup
        keeps an idempotent re-proposal from churning spec versions."""
        cfg = self.config
        try:
            spec = self.proposer.propose_shards(to_n, origin="autoscaler")
        except Exception as e:  # noqa: BLE001 — journaled, cooled down
            self.errors += 1
            self._journal({"kind": "scale_failed", "direction": direction,
                           "from_shards": from_n, "to_shards": to_n,
                           "error": f"{type(e).__name__}: {e}",
                           **self._context()})
            self._last_scale_t = self._clock()
            return None
        (self._c_up if direction == "up" else self._c_down).inc()
        self._last_scale_t = self._clock()
        self._journal({"kind": "scale_proposed", "direction": direction,
                       "from_shards": from_n, "to_shards": to_n,
                       "spec_version": spec.version,
                       **self._context()})
        return direction

    # -- worker ------------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = _sync.Thread(target=self._loop, daemon=True,
                                            name="ps-autoscaler")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            # alert transitions wake the loop immediately; otherwise
            # poll at the (injectable) cadence for cooldown/quiet-hold
            # expirations — a reshard runs HERE, never on the
            # watchdog's evaluating thread
            self._wake.wait(self.poll_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.step()
            except Exception:  # noqa: BLE001 — step journals its own
                self.errors += 1

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30)

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
