"""SLO watchdog: declarative rules + multi-window burn-rate evaluation.

The port's own copy of ``paddle_tpu.obs.slo``. A rule names a signal in the job time-series ring and an objective:

- ``kind="burn_rate"`` (histogram families — step-time p95, serving
  p99, push→servable freshness): the objective is "at most ``budget``
  of observations above ``threshold`` seconds". Each window evaluates
  the observed bad fraction over its trailing span; the rule FIRES when
  ``bad_fraction >= budget * burn`` in EVERY window — the classic
  long-window-for-significance / short-window-for-freshness pair: the
  long window keeps one hiccup from paging, the short window lets the
  alert CLEAR as soon as the job recovers instead of dragging the whole
  long window behind it.
- ``kind="threshold"`` (gauges / counter rates — replication lag,
  breaker opens, checkpoint staleness): the window of per-tick values
  reduces by ``agg`` (max / mean / last / rate-sum) and compares
  against ``threshold`` via ``op``; every window must violate.
  ``agg="age"`` reads a wall-timestamp gauge and alarms on
  ``now - value`` (checkpoint staleness).

Firing appends an :class:`Alert` into a bounded log, increments
``slo_alerts`` / flips ``slo_alert_active`` in the registry (alerts are
metrics too — the job history shows its own alert curve), and notifies
the flight recorder (kind ``slo_alert``) so a postmortem bundle can be
armed on it. A firing rule stays ACTIVE (no re-fire spam) until every
window clears, then re-arms.

The watchdog either attaches to a :class:`~.timeseries.Sampler`
(evaluates on exactly the tick that just landed) or runs
:meth:`evaluate` from its own thread/test harness with an injectable
``now``.
"""

from __future__ import annotations

import dataclasses
# lock discipline (read by testing.sched.load_lock_order):
# `_mu` guards rule/alert state only and is a LEAF; subscriber
# callbacks + flight-recorder notifies fire OUTSIDE it.
# LOCK LEAF: _mu
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import sync as _sync
from . import flightrec as _flightrec
from . import registry as _registry
from .timeseries import MetricRing, Sampler
from .trace import wall_s

__all__ = ["SloRule", "Alert", "SloWatchdog", "default_rules",
           "cold_tier_rules", "recsys_rules"]


@dataclasses.dataclass
class SloRule:
    """One declarative objective over one ring signal."""

    name: str
    family: str
    kind: str = "burn_rate"            # burn_rate | threshold
    labels: Optional[Dict[str, str]] = None  # subset match
    threshold: float = 0.0
    #: burn_rate only: tolerated bad fraction (the error budget)
    budget: float = 0.01
    #: (window_s, burn_factor) pairs — ALL must be burning to fire.
    #: threshold rules read only window_s (factor ignored).
    windows: Tuple[Tuple[float, float], ...] = ((60.0, 1.0), (10.0, 1.0))
    #: threshold only: max | mean | last | rate | age
    agg: str = "max"
    #: threshold only: ">" (violate above) or "<" (violate below)
    op: str = ">"
    #: minimum observations (burn_rate) / ticks (threshold) per window
    min_count: int = 1
    #: threshold rules read this ring field (gauges: "value"/"max";
    #: counters: "rate"/"delta")
    field: Optional[str] = None

    def __post_init__(self) -> None:
        if self.kind not in ("burn_rate", "threshold"):
            raise ValueError(f"SloRule kind {self.kind!r}")
        if self.op not in (">", "<"):
            raise ValueError(f"SloRule op {self.op!r}")
        if not self.windows:
            raise ValueError("SloRule needs at least one window")

    # -- evaluation --------------------------------------------------------

    def _burning(self, ring: MetricRing, window_s: float, factor: float,
                 now: float) -> Tuple[bool, float]:
        if self.kind == "burn_rate":
            bad, count = ring.bad_fraction(self.family, self.threshold,
                                           window_s, self.labels, now=now)
            if count < self.min_count:
                return False, 0.0
            burn = bad / max(self.budget, 1e-12)
            return burn >= factor, burn
        field = self.field or ("rate" if self.agg == "rate" else "value")
        reduce = "sum" if self.agg == "rate" else "max"
        vals = ring.window_values(self.family, field, window_s,
                                  self.labels, reduce=reduce, now=now)
        if len(vals) < self.min_count:
            return False, 0.0
        if self.agg == "rate":
            v = sum(vals) / len(vals)          # mean per-tick rate
        elif self.agg == "mean":
            v = sum(vals) / len(vals)
        elif self.agg == "last":
            v = vals[-1]
        elif self.agg == "age":
            v = now - vals[-1]
        else:  # max
            v = max(vals)
        bad = v > self.threshold if self.op == ">" else v < self.threshold
        return bad, v

    def evaluate(self, ring: MetricRing, now: float
                 ) -> Tuple[bool, Dict[str, Any]]:
        """(fires?, per-window detail) — fires only when EVERY window is
        burning/violating."""
        detail: Dict[str, Any] = {}
        fires = True
        for window_s, factor in self.windows:
            burning, value = self._burning(ring, window_s, factor, now)
            detail[f"w{window_s:g}s"] = round(float(value), 6)
            fires = fires and burning
        return fires, detail


@dataclasses.dataclass
class Alert:
    """One firing record (bounded log + flight-recorder tail)."""

    rule: str
    family: str
    t: float                      # wall seconds (trace.wall_s axis)
    threshold: float
    kind: str
    windows: Dict[str, float]     # per-window burn/value at fire time
    labels: Optional[Dict[str, str]] = None
    cleared_t: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class SloWatchdog:
    """Evaluates its rules against ``ring`` — either attached to a
    sampler (per tick) or driven explicitly. Not a thread of its own by
    default: the sampler IS the cadence; ``start()`` exists for rings
    fed from elsewhere."""

    def __init__(self, ring: MetricRing,
                 rules: Sequence[SloRule] = (),
                 log_cap: int = 512,
                 period_s: float = 1.0) -> None:
        self.ring = ring
        self.rules: List[SloRule] = []
        self._handles: Dict[str, Tuple[Any, Any]] = {}
        self._active: Dict[str, Alert] = {}
        self._mu = _sync.Lock()
        self._log: deque = deque(maxlen=int(log_cap))
        self._stop = _sync.Event()
        self._thread: Optional[threading.Thread] = None
        #: own-thread evaluation cadence (start() default), a
        #: constructor knob; sampler-attached watchdogs never use it
        self.period_s = float(period_s)
        self.evaluations = 0
        # push-style subscriptions (the controller input for
        # ps/autoscale.py): fire/clear transition callbacks, invoked
        # OUTSIDE the watchdog lock — the flight-recorder hook
        # contract: a subscriber that blocks (or reshards a cluster)
        # must never serialize rule evaluation behind itself
        self._on_fire: List[Any] = []
        self._on_clear: List[Any] = []
        self.subscriber_errors = 0
        for r in rules:
            self.add_rule(r)

    def on_fire(self, fn) -> "SloWatchdog":
        """Subscribe to rule FIRE transitions: ``fn(alert)`` runs on
        the evaluating thread, outside the lock, once per transition
        (an already-active rule does not re-notify). Subscriber
        exceptions are counted (``subscriber_errors``) and swallowed —
        a broken controller must not kill the watchdog."""
        self._on_fire.append(fn)
        return self

    def on_clear(self, fn) -> "SloWatchdog":
        """Subscribe to rule CLEAR transitions: ``fn(alert)`` with the
        original alert (``cleared_t`` now set). Same contract as
        :meth:`on_fire`."""
        self._on_clear.append(fn)
        return self

    def _notify(self, subs: List[Any], alert: Alert) -> None:
        for fn in list(subs):
            try:
                fn(alert)
            except Exception:  # noqa: BLE001 — subscriber owns its errors
                self.subscriber_errors += 1

    def add_rule(self, rule: SloRule) -> "SloWatchdog":
        with self._mu:
            if any(r.name == rule.name for r in self.rules):
                raise ValueError(f"duplicate SLO rule {rule.name!r}")
            self.rules.append(rule)
            # pre-bound per-rule handles (cold path): alerts are metrics
            self._handles[rule.name] = (
                _registry.REGISTRY.counter("slo_alerts", rule=rule.name),
                _registry.REGISTRY.gauge("slo_alert_active", rule=rule.name))
        return self

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Alert]:
        """One pass over every rule; returns alerts that fired NOW
        (state transitions only — an already-active rule returns
        nothing until it clears and re-fires)."""
        now = wall_s() if now is None else float(now)
        fired: List[Alert] = []
        with self._mu:
            rules = list(self.rules)
        self.evaluations += 1
        for rule in rules:
            fires, detail = rule.evaluate(self.ring, now)
            counter, gauge = self._handles[rule.name]
            fired_alert = cleared_alert = None
            with self._mu:
                active = self._active.get(rule.name)
                if fires and active is None:
                    alert = Alert(rule=rule.name, family=rule.family,
                                  t=now, threshold=rule.threshold,
                                  kind=rule.kind, windows=detail,
                                  labels=rule.labels)
                    self._active[rule.name] = alert
                    self._log.append(alert)
                    fired.append(alert)
                    fired_alert = alert
                elif not fires and active is not None:
                    active.cleared_t = now
                    del self._active[rule.name]
                    cleared_alert = active
            # transitions notify OUTSIDE _mu (flight-recorder contract)
            if fired_alert is not None:
                counter.inc()
                gauge.set(1.0)
                _flightrec.notify("slo_alert", rule=rule.name,
                                  family=rule.family, windows=detail,
                                  threshold=rule.threshold)
                self._notify(self._on_fire, fired_alert)
            elif not fires:
                gauge.set(0.0)
                if cleared_alert is not None:
                    self._notify(self._on_clear, cleared_alert)
        return fired

    # -- introspection -----------------------------------------------------

    def alerts(self) -> List[Dict[str, Any]]:
        with self._mu:
            return [a.as_dict() for a in self._log]

    def active(self) -> List[str]:
        with self._mu:
            return sorted(self._active)

    # -- wiring ------------------------------------------------------------

    def attach(self, sampler: Sampler) -> "SloWatchdog":
        """Evaluate on every sampler tick (the usual wiring — rules see
        exactly the data that just landed, no second cadence)."""
        sampler.on_sample(lambda t: self.evaluate(now=t))
        return self

    def start(self, period_s: Optional[float] = None) -> "SloWatchdog":
        """Own evaluation thread, for rings fed by something other than
        a local sampler. ``period_s`` defaults to the constructor's."""
        period = self.period_s if period_s is None else float(period_s)
        if self._thread is None:
            self._stop.clear()

            def loop() -> None:
                while not self._stop.wait(period):
                    self.evaluate()

            self._thread = _sync.Thread(target=loop, daemon=True,
                                            name="slo-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)


def default_rules(step_p95_s: float = 1.0,
                  serving_p99_s: float = 0.05,
                  freshness_p95_s: float = 0.25,
                  repl_lag_entries: float = 1000.0,
                  checkpoint_age_s: float = 600.0,
                  fleet_p99_s: Optional[float] = None,
                  hedge_rate_per_s: float = 100.0,
                  long_s: float = 60.0, short_s: float = 10.0
                  ) -> List[SloRule]:
    """The stock rule set over the families the framework already
    emits (tune thresholds per job). Breaker
    opens and failover promotions alert on ANY occurrence — each one
    is an incident, not a budget. Burn-rate rules require at least
    ``1/budget`` observations per window: a bad-fraction estimate from
    fewer can't distinguish one startup spike (the first step's
    multi-second compile) from a real burn."""
    w = ((long_s, 1.0), (short_s, 1.0))

    def n(budget):
        # strictly MORE than 1/budget observations: at exactly 1/budget
        # a single outlier (the first step's compile, one scheduler
        # stall) lands bad_fraction == budget and burn == factor — a
        # healthy run must not sit on the firing boundary
        return int(round(1.0 / budget)) + 1

    return [
        SloRule("step_time_p95", "trainer_step_time_s", threshold=step_p95_s,
                budget=0.05, windows=w, min_count=n(0.05)),
        SloRule("serving_p99", "serving_latency_s",
                labels={"recorder": "frontend_request"},
                threshold=serving_p99_s, budget=0.01, windows=w,
                min_count=n(0.01)),
        SloRule("freshness_p95", "serving_latency_s",
                labels={"recorder": "freshness"},
                threshold=freshness_p95_s, budget=0.05, windows=w,
                min_count=n(0.05)),
        SloRule("breaker_open", "ps_breaker_open", kind="threshold",
                field="delta", agg="rate", threshold=0.0,
                windows=((long_s, 1.0),)),
        SloRule("failover_promotion", "ha_promotions", kind="threshold",
                field="delta", agg="rate", threshold=0.0,
                windows=((long_s, 1.0),)),
        SloRule("replication_lag", "ps_replication_lag_entries",
                kind="threshold", agg="max", threshold=repl_lag_entries,
                windows=((short_s, 1.0),)),
        # the reconciler diffing observed != desired for this many
        # consecutive ticks means an actuation is wedged (or a proposer
        # wrote unreachable state) — the reconciler also dumps a
        # flight-recorder bundle with the spec diff when it crosses its
        # own stall threshold; the rule makes the condition page
        SloRule("reconcile_stall", "reconcile_stall_ticks",
                kind="threshold", agg="max", threshold=8.0,
                windows=((short_s, 1.0),), min_count=1),
        SloRule("checkpoint_staleness", "job_checkpoint_last_wall_s",
                kind="threshold", agg="age", threshold=checkpoint_age_s,
                windows=((short_s, 1.0),)),
        # -- fleet aggregates: the ROUTER's end-to-end view
        # (submit → first winning completion across reroutes/hedges) is
        # the user-facing latency — a single replica's p99 can be green
        # while the fleet's is burning on reroute tails. The hedge-rate
        # rule catches a fleet quietly paying for its tail in duplicate
        # work: hedges are normal at the margin, pathological in bulk
        # (a member with a degraded p95 pulls every request past its
        # budget).
        SloRule("fleet_serving_p99", "serving_latency_s",
                labels={"recorder": "router_request"},
                threshold=(serving_p99_s if fleet_p99_s is None
                           else fleet_p99_s),
                budget=0.01, windows=w, min_count=n(0.01)),
        SloRule("fleet_hedge_rate", "serving_hedges",
                labels={"outcome": "launched"}, kind="threshold",
                field="delta", agg="rate", threshold=hedge_rate_per_s,
                windows=((short_s, 1.0),)),
    ]


def recsys_rules(e2e_p99_s: float = 0.25,
                 stage_retrieval_p99_s: Optional[float] = None,
                 freshness_training_p95_s: float = 2.0,
                 long_s: float = 60.0, short_s: float = 10.0
                 ) -> List[SloRule]:
    """Fleet rules for the retrieval→ranking pipeline, on top
    of :func:`default_rules`:

    - ``recsys_e2e_p99`` — the USER-facing objective: end-to-end
      pipeline latency (retrieval fan-out through coalesced ranking,
      the ``recorder="recsys_e2e"`` series the
      :class:`~paddle_tpu_torch.serving.pipeline.PipelineFrontend` emits)
      must keep its p99 inside the request budget. This is the rule
      the autoscaler's ``up_rules`` should name for a serving fleet —
      per-member p99s can all be green while budget-carving skew burns
      the end-to-end budget.
    - ``recsys_stage_retrieval_p99`` — the triage split: when
      ``recsys_e2e_p99`` fires, this says which stage ate the budget
      (``serving_stage_latency_s{stage=retrieval}`` burning → the
      fan-out/hedging side; quiet → the ranking coalescer). Defaults
      to the retrieval share of the e2e budget.
    - ``freshness_under_training`` — push→servable freshness measured
      WHILE a CtrStreamTrainer is pushing to the served tables. A
      deliberately looser threshold than the idle-feed
      ``freshness_p95`` rule: under training load the oplog feed
      carries real traffic and the replica applies between serve
      batches, so the idle bound would page on every training burst.
    """
    w = ((long_s, 1.0), (short_s, 1.0))

    def n(budget):
        return int(round(1.0 / budget)) + 1

    if stage_retrieval_p99_s is None:
        stage_retrieval_p99_s = 0.6 * e2e_p99_s
    return [
        SloRule("recsys_e2e_p99", "serving_latency_s",
                labels={"recorder": "recsys_e2e"},
                threshold=e2e_p99_s, budget=0.01, windows=w,
                min_count=n(0.01)),
        SloRule("recsys_stage_retrieval_p99", "serving_stage_latency_s",
                labels={"stage": "retrieval"},
                threshold=stage_retrieval_p99_s, budget=0.01, windows=w,
                min_count=n(0.01)),
        SloRule("freshness_under_training", "serving_latency_s",
                labels={"recorder": "freshness"},
                threshold=freshness_training_p95_s, budget=0.05,
                windows=w, min_count=n(0.05)),
    ]


def cold_tier_rules(backlog_shards: float = 0.5,
                    bg_wait_ms_per_s: float = 500.0,
                    index_bytes_per_row: float = 16.0,
                    long_s: float = 120.0) -> List[SloRule]:
    """SSD cold-tier rules over the ``ssd_*`` families that
    SsdSparseTable.obs_probe exports. The first two triage the same symptom (disk bytes
    climbing) into opposite causes:

    - ``cold_compaction_starved`` — the deferred-compaction backlog
      stays nonzero across the window: shards keep being marked dirty
      but the worker never drains them. If ``ssd_io_bg_wait_ms`` is
      ALSO burning the budget is the bottleneck; otherwise the worker
      is wedged or stopped.
    - ``cold_io_budget_tight`` — the compactor spends more than
      ``bg_wait_ms_per_s`` ms per second parked on the token bucket:
      compaction cannot keep up AT THIS BUDGET. Raise the budget (or
      schedule compaction off-peak) before the log-garbage ratio grows.
    - ``cold_index_bloat`` — measured index bytes/row above the design
      ceiling: the open-addressing table degenerated (mass deletes
      without a rebuild) or the shard row estimate drifted.
    """
    w = ((long_s, 1.0),)
    return [
        SloRule("cold_compaction_starved", "ssd_bg_backlog",
                kind="threshold", agg="mean", threshold=backlog_shards,
                windows=w, min_count=3),
        SloRule("cold_io_budget_tight", "ssd_io_bg_wait_ms",
                kind="threshold", field="delta", agg="rate",
                threshold=bg_wait_ms_per_s, windows=w, min_count=3),
        SloRule("cold_index_bloat", "ssd_index_bytes_per_row",
                kind="threshold", agg="max",
                threshold=index_bytes_per_row, windows=w, min_count=3),
    ]
