"""Discrete-event policy simulator for the declarative control plane
(the port's own copy of ``paddle_tpu.ps.simulate``): replay committed SLO/metric traces against the REAL
Autoscaler + Reconciler at 1000-shard scale, with no real cluster and
no real time.

Why it exists: a reconciler policy (hysteresis windows, cooldowns,
bounds) is cheap to misconfigure and expensive to discover — a
hysteresis inversion that flaps a 1000-shard fleet is an outage, not a
code review comment. Every control component here is INJECTABLE-clock
by construction (Autoscaler.step(now=), Reconciler.step(now=),
SpecStore over a MemoryStore), so the simulator drives the exact
production decision code — the same :func:`~.spec.plan_transitions`
diff, the same cooldown arithmetic — against a synthetic cluster whose
"step time" is an analytic function of offered load and shard count.
Only the ACTUATION is simulated (a grow is a counter bump plus a
modeled pause, not a data migration).

Two committed traces replay out of the box:

- :func:`diurnal_wave_profile` — RESHARD.json's measured diurnal wave
  (a trace the repo keeps as input): offered load is reconstructed from the artifact's
  ``step_time_p95_ms`` / ``shard_count`` curves via the same linear
  model the bench used (``step_ms = warm_ms × max(1, load/shards)``),
  normalized to the calm baseline and re-scaled to any fleet size.
- :func:`flash_crowd_profile` — RECSYS_E2E.json's serving profile
  (base→peak diurnal ramp plus a ``spike_x`` flash crowd), promoted to
  a shard-load curve.

The simulation loop is synchronous and single-threaded: one tick =
advance the virtual clock, evaluate offered load, derive the step-time
signal, run the (windowed) alert rule, feed the autoscaler, let it
PROPOSE, and let the reconciler actuate. Wall-clock cost is a few
microseconds per tick — a five-day diurnal cycle at 1000 shards
replays in well under a minute.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional, Tuple

from ..distributed.elastic import MemoryStore
from .autoscale import AutoscaleConfig, Autoscaler
from .reconcile import Reconciler

__all__ = [
    "SimClock", "SimCluster", "SimController", "SimResult",
    "diurnal_wave_profile", "flash_crowd_profile", "simulate",
]


class SimClock:
    """The virtual clock every simulated component runs on."""

    def __init__(self, t0: float = 0.0) -> None:
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t


class SimCluster:
    """Duck-typed stand-in for HACluster: exactly the surface the
    Autoscaler/Reconciler read (``num_shards``, ``job_id``, ``store``,
    ``replication``)."""

    def __init__(self, shards: int, job_id: str = "sim",
                 replication: int = 1) -> None:
        self.store = MemoryStore()
        self.job_id = job_id
        self.replication = replication
        self._n = int(shards)

    @property
    def num_shards(self) -> int:
        return self._n


class SimController:
    """Duck-typed ReshardController: grow/shrink mutate the simulated
    shard count instantly and record a modeled cutover pause (the
    RESHARD.json-measured p95, scaled by how many shards move). The
    clock is NOT advanced here — a real cutover pauses writers, it
    does not stop the world; the pause lands in the SLO accounting of
    the ticks it spans."""

    def __init__(self, cluster: SimCluster, clock: SimClock,
                 bootstrap_s_per_shard: float = 0.17,
                 cutover_pause_ms: float = 124.5) -> None:
        self.cluster = cluster
        self.clock = clock
        self.bootstrap_s_per_shard = bootstrap_s_per_shard
        self.cutover_pause_ms = cutover_pause_ms
        self.ops: List[dict] = []
        #: actuation completes at this virtual time (bootstrap runs in
        #: the background of the simulated cluster)
        self.busy_until = 0.0

    def _op(self, direction: str, to_n: int) -> dict:
        from_n = self.cluster._n
        boot_s = self.bootstrap_s_per_shard * abs(to_n - from_n)
        self.cluster._n = to_n
        self.busy_until = self.clock.now() + boot_s
        rec = {"kind": "reshard", "direction": direction,
               "from_shards": from_n, "to_shards": to_n,
               "t": self.clock.now(), "bootstrap_s": boot_s,
               "cutover_pause_ms": self.cutover_pause_ms}
        self.ops.append(rec)
        return rec

    def grow(self, factor: int, replication: Optional[int] = None) -> dict:
        return self._op("grow", self.cluster._n * int(factor))

    def shrink(self, divisor: int = 2) -> dict:
        return self._op("shrink", self.cluster._n // int(divisor))


# ---------------------------------------------------------------------------
# trace → load profile
# ---------------------------------------------------------------------------

def _interp(curve: List[Tuple[float, float]], t: float) -> float:
    """Piecewise-linear lookup into a ``[[t, v], ...]`` metric curve."""
    if not curve:
        return 0.0
    if t <= curve[0][0]:
        return float(curve[0][1])
    for (t0, v0), (t1, v1) in zip(curve, curve[1:]):
        if t <= t1:
            if t1 == t0:
                return float(v1)
            w = (t - t0) / (t1 - t0)
            return float(v0) + w * (float(v1) - float(v0))
    return float(curve[-1][1])


def diurnal_wave_profile(reshard_json_path: str, *,
                         base_shards: int,
                         time_scale: float = 20.0,
                         peak_rel: float = 6.0):
    """RESHARD.json's diurnal wave as ``(duration_s, load_fn)``.

    The bench modeled trainer step time as
    ``step_ms = warm_ms × max(1, load/shards)``, so offered load in
    shard-equivalents is ``rel(t) = step_ms(t)/warm_ms × shards(t)``
    normalized by the calm baseline. ``time_scale`` stretches the
    bench's seconds-long wave to control-plane time scales (stock
    cooldowns are tens of seconds); the default maps the measured
    load plateau (~1.1 trace-seconds) inside one stock hysteresis
    window (clear_hold + cooldown_down), the regime the stock policy
    is tuned for — stretch it further to study plateau-longer-than-
    hysteresis behavior. ``peak_rel`` clamps the relative peak: the
    bench's transient spikes (measured p95 through a cutover pause)
    are not sustained offered load.
    """
    doc = json.load(open(reshard_json_path))
    warm = float(doc["warm_ms_per_step"])
    step_curve = [(float(t), float(v))
                  for t, v in doc["curves"]["step_time_p95_ms"]]
    shard_curve = [(float(t), float(v))
                   for t, v in doc["curves"]["shard_count"]]
    t_end = max(step_curve[-1][0], shard_curve[-1][0])
    base = float(doc["curves"]["shard_count"][0][1])
    t_first = step_curve[0][0]

    def raw_rel(t: float) -> float:
        if t < t_first:
            # before the first p95 window closed the bench was warming
            # up calm — extrapolating the first sample (which includes
            # the cold start) backwards would fake a load plateau
            return 1.0
        step_ms = _interp(step_curve, t)
        shards = max(1.0, _interp(shard_curve, t))
        return max(0.25, min(peak_rel, (step_ms / warm) * shards / base))

    def rel(t: float) -> float:
        # short moving average over trace time: the measured p95 spikes
        # through each cutover PAUSE, which is a consequence of scaling,
        # not offered demand — smoothing keeps the demand curve from
        # re-triggering on its own actuation echo
        span, n = 0.12, 5
        return sum(raw_rel(t - span / 2 + span * i / (n - 1))
                   for i in range(n)) / n

    def load_fn(sim_t: float) -> float:
        return base_shards * rel(min(sim_t / time_scale, t_end))

    return t_end * time_scale, load_fn


def flash_crowd_profile(recsys_json_path: str, *,
                        base_shards: int,
                        duration_s: float = 600.0,
                        spike_at: float = 0.55,
                        spike_span: float = 0.15):
    """RECSYS_E2E.json's serving profile as ``(duration_s, load_fn)``:
    a diurnal ramp from ``base_qps`` to ``peak_qps`` with a
    ``spike_x`` flash crowd riding the peak (the bench's open-loop
    replay shape, promoted to shard load)."""
    prof = json.load(open(recsys_json_path))["profile"]
    base_qps = float(prof["base_qps"])
    peak_qps = float(prof["peak_qps"])
    spike_x = float(prof["spike_x"])

    def load_fn(sim_t: float) -> float:
        u = min(1.0, max(0.0, sim_t / duration_s))
        # linear ramp up to the peak over the first half, back down
        ramp = base_qps + (peak_qps - base_qps) * min(u / 0.5, 1.0,
                                                      (1.0 - u) / 0.3)
        qps = max(base_qps, ramp)
        if spike_at <= u < spike_at + spike_span:
            qps *= spike_x
        return base_shards * qps / base_qps

    return duration_s, load_fn


# ---------------------------------------------------------------------------
# the simulation loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SimAlert:
    rule: str


@dataclasses.dataclass
class SimResult:
    timeline: List[dict]
    scale_events: List[dict]
    final_shards: int
    spec_version: int
    over_slo_fraction: float
    wall_s: float
    ticks: int

    def oscillations(self, window_s: Optional[float] = 15.0) -> int:
        """Direction reversals in the scale-event sequence within
        ``window_s`` virtual seconds of each other — the flapping
        signature a hysteresis inversion produces (up, down, up, down
        … while the load is steady). Tracking a genuinely bursty load
        (up at the wave, down after it) reverses direction too, but
        slowly — pass ``window_s=None`` to count ALL reversals."""
        flips = 0
        for a, b in zip(self.scale_events, self.scale_events[1:]):
            if a["direction"] == b["direction"]:
                continue
            if window_s is None or b["t"] - a["t"] <= window_s:
                flips += 1
        return flips

    def max_shards_seen(self) -> int:
        return max((t["shards"] for t in self.timeline), default=0)


def simulate(config: AutoscaleConfig, profile, *,
             base_shards: int = 256,
             warm_ms: float = 6.52,
             threshold_ms: float = 26.08,
             tick_s: float = 1.0,
             fire_after_ticks: int = 3,
             clear_after_ticks: int = 3,
             job_id: str = "sim") -> SimResult:
    """Replay ``profile`` (``(duration_s, load_fn)``) against the REAL
    Autoscaler (proposer mode) + Reconciler under ``config``.

    The step-time signal is the bench's linear model
    (``warm_ms × max(1, load/shards)``); the windowed alert rule fires
    after ``fire_after_ticks`` consecutive over-threshold ticks and
    clears after ``clear_after_ticks`` under it (the multi-window
    burn-rate shape reduced to its hysteresis essentials). Returns the
    tick-resolution :class:`SimResult`.
    """
    duration_s, load_fn = profile
    clock = SimClock()
    cluster = SimCluster(base_shards, job_id=job_id)
    controller = SimController(cluster, clock)
    rec = Reconciler(cluster, controller, poll_s=tick_s,
                     clock=clock.now, sleep=lambda s: clock.advance(s))
    rec.capture()
    scaler = Autoscaler(controller, config=config, clock=clock.now,
                        proposer=rec)
    timeline: List[dict] = []
    over = 0
    hot = cold = 0
    alert_on = False
    wall0 = time.perf_counter()
    ticks = int(duration_s / tick_s)
    for _ in range(ticks):
        t = clock.now()
        load = load_fn(t)
        n = cluster.num_shards
        step_ms = warm_ms * max(1.0, load / n)
        if step_ms > threshold_ms:
            hot += 1
            cold = 0
        else:
            cold += 1
            hot = 0
        if not alert_on and hot >= fire_after_ticks:
            alert_on = True
            scaler.notify_fire(_SimAlert("step_time_p95"))
        elif alert_on and cold >= clear_after_ticks:
            alert_on = False
            scaler.notify_clear(_SimAlert("step_time_p95"))
        if step_ms > threshold_ms:
            over += 1
        # decision (proposes) then actuation (reconciles) — the same
        # two-step the live cluster runs, one virtual tick apart at most
        scaler.step(now=t)
        rec.step(now=t)
        timeline.append({"t": round(t, 3), "load": round(load, 2),
                         "shards": cluster.num_shards,
                         "step_ms": round(step_ms, 3),
                         "alert": alert_on})
        clock.advance(tick_s)
    spec = rec.spec_store.read()
    return SimResult(
        timeline=timeline,
        # the controller's op log carries VIRTUAL timestamps (the
        # autoscaler's own journal stamps wall time for incident triage
        # — meaningless inside a simulation)
        scale_events=[dict(op) for op in controller.ops],
        final_shards=cluster.num_shards,
        spec_version=0 if spec is None else spec.version,
        over_slo_fraction=over / max(1, ticks),
        wall_s=time.perf_counter() - wall0,
        ticks=ticks)
