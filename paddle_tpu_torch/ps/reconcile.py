"""The unified declarative control plane: ONE serialized actuator.

The port's own copy of ``paddle_tpu.ps.reconcile``. The cluster's five control loops (FailoverCoordinator,
ReshardController, Autoscaler, PlacementManager, RolloutManager) grew
pairwise interlocks reactively — ``suspend()``, ``control_mu``, epoch
fences — and no compound transition was safe by construction, only by
whichever lock pair happened to exist. This module replaces the
pairwise discipline with a k8s-style reconciler:

- desired state is a versioned :class:`~paddle_tpu_torch.ps.spec.ClusterSpec`
  in the elastic store; control loops PROPOSE deltas
  (:meth:`propose_shards`, :meth:`propose_canary`, …) instead of
  actuating;
- one actuator thread diffs observed vs desired each tick
  (:func:`~paddle_tpu_torch.ps.spec.plan_transitions` — the same pure
  planner the simulator replays) and sequences the EXISTING primitives
  under ``_act_mu``: reshard cutover, rollout canary/promote/rollback,
  placement arm+fence, the elastic trainer lever;
- every admitted step is digest-verified by the primitive it drives
  (filtered class digests at cutover,
  digest-pinned model loads, digest-checked placement swaps) BEFORE
  the next transition is admitted — an abort journals, dumps a
  flight-recorder bundle with the spec diff in the manifest
  (``spec_abort``), and backs off;
- failover promotion stays an autonomous observed-state REPAIR (the
  coordinator fixes reality to match the spec's shard count; the spec
  names no primary). The reconciler subscribes ``on_promote`` to
  journal the repair and re-observe. During any actuation the
  coordinator is suspended through :meth:`HACluster.begin_actuation` —
  the single compound primitive the old suspend()+control_mu call
  sites collapsed into.

Stall detection: observed ≠ desired for more than ``stall_ticks``
consecutive ticks without a completed transition exports the
``reconcile_stall_ticks`` gauge past the ``reconcile_stall`` SLO rule
(obs/slo.py default_rules) and dumps a postmortem bundle once per
stall episode.
"""

# lock discipline (read by testing.sched.load_lock_order):
# the actuator mutex is taken OUTSIDE every primitive it sequences:
# reshard ops nest _op_mu (then control_mu) under it, and gate-style
# transitions take the cluster actuation (control_mu) directly.
# LOCK ORDER: _act_mu < _op_mu < control_mu
# LOCK LEAF: _mu

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..core import sync as _sync
from ..core.enforce import PreconditionNotMetError, enforce
from ..distributed.elastic import set_desired_np
from ..obs import flightrec as _flightrec
from ..obs import registry as _obs_registry
from .spec import ClusterSpec, SpecStore, Transition, plan_transitions, \
    spec_delta

__all__ = ["Reconciler", "ReconcileError"]


class ReconcileError(RuntimeError):
    pass


class Reconciler:
    """Diffs observed vs desired state and sequences the primitives.

    Duck-typed on purpose so the discrete-event simulator
    (ps/simulate.py) can drive the SAME actuation code against a fake
    cluster: ``cluster`` needs ``num_shards``/``job_id``/``store``,
    ``controller`` needs ``grow(factor)``/``shrink(divisor)``;
    ``rollout``, ``placements`` and the elastic lever are optional.

    ``model_source(version) -> flat ndarray`` resolves a spec'd model
    version to its parameters at canary-open time (the spec carries
    version NUMBERS only).
    """

    def __init__(self, cluster, controller=None, *,
                 rollout=None, model_source: Optional[Callable] = None,
                 placements: Optional[Dict[str, object]] = None,
                 elastic_job_id: Optional[str] = None,
                 trainer_np_fn: Optional[Callable[[int], int]] = None,
                 poll_s: float = 0.05, stall_ticks: int = 40,
                 abort_backoff_s: float = 0.5,
                 clock=time.monotonic, sleep=time.sleep) -> None:
        self.cluster = cluster
        self.controller = controller
        self.rollout = rollout
        self.model_source = model_source
        self.placements = dict(placements or {})
        self.elastic_job_id = elastic_job_id
        self.trainer_np_fn = trainer_np_fn
        self.poll_s = float(poll_s)
        self.stall_ticks = int(stall_ticks)
        self.abort_backoff_s = float(abort_backoff_s)
        self._clock = clock
        self._sleep = sleep
        self.spec_store = SpecStore(cluster.store, cluster.job_id)
        #: THE serialization: every actuation (and nothing else) runs
        #: under it — compound transitions are a sequence of verified
        #: steps through one writer, not racing loops
        self._act_mu = _sync.Lock()
        self._mu = _sync.Lock()  # LOCK LEAF: _mu
        # (_mu guards journal/state only — never held across actuation)
        self._stop = _sync.Event()
        self._wake = _sync.Event()
        self._thread = None
        self.events: deque = deque(maxlen=1024)
        self._seq = 0
        self._stall = 0
        self._stall_dumped = False
        self._aborts = 0
        self._cooldown_until = 0.0
        self._trainer_np_observed: Optional[int] = None
        job = str(cluster.job_id)
        self._g_spec = _obs_registry.REGISTRY.gauge(
            "reconcile_spec_version", job=job)
        self._g_conv = _obs_registry.REGISTRY.gauge(
            "reconcile_converged_version", job=job)
        self._g_stall = _obs_registry.REGISTRY.gauge(
            "reconcile_stall_ticks", job=job)
        self._c_trans = _obs_registry.REGISTRY.counter(
            "reconcile_transitions", job=job)
        self._c_aborts = _obs_registry.REGISTRY.counter(
            "reconcile_aborts", job=job)
        self.spec_store.subscribe(lambda _spec: self._wake.set())
        coord = getattr(cluster, "coordinator", None)
        if coord is not None and hasattr(coord, "on_promote"):
            # chain, don't clobber: on_promote is a single callback slot
            prev = coord.on_promote

            def _chained(si, old_ep, new_ep, _prev=prev):
                if _prev is not None:
                    _prev(si, old_ep, new_ep)
                self._on_promotion(si, new_ep)

            coord.on_promote = _chained

    # -- lifecycle ---------------------------------------------------------

    def capture(self) -> ClusterSpec:
        """Bootstrap the spec from OBSERVED state (version 0) unless one
        already exists. Idempotent; returns the current spec."""
        cur = self.spec_store.read()
        if cur is not None:
            return cur
        obs = self.observe()
        spec = ClusterSpec(
            version=0, shards=obs["shards"],
            replication=int(getattr(self.cluster, "replication", 1)),
            model_version=obs.get("stable_version"),
            canary=obs.get("canary"),
            placements=dict(obs.get("placements", {})),
            trainer_np=obs.get("trainer_np"), origin="capture")
        return self.spec_store.initialize(spec)

    def start(self) -> "Reconciler":
        self.capture()
        self._thread = _sync.Thread(target=self._loop, daemon=True,
                                    name="ps-reconciler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception as e:  # survive; the journal carries it
                self._journal({"kind": "reconcile_error",
                               "error": f"{type(e).__name__}: {e}"})
            self._wake.wait(self.poll_s)
            self._wake.clear()

    # -- proposer API (the five loops write deltas, not actuations) --------

    def propose(self, origin: str, mutate) -> ClusterSpec:
        return self.spec_store.propose(origin, mutate)

    def propose_shards(self, n: int, origin: str = "operator") \
            -> ClusterSpec:
        def mut(s: ClusterSpec) -> None:
            s.shards = int(n)
            if self.trainer_np_fn is not None:
                s.trainer_np = int(self.trainer_np_fn(int(n)))
        return self.propose(origin, mut)

    def propose_trainer_np(self, np_: int, origin: str = "operator") \
            -> ClusterSpec:
        def mut(s: ClusterSpec) -> None:
            s.trainer_np = int(np_)
        return self.propose(origin, mut)

    def propose_canary(self, version: int, fraction: float,
                       origin: str = "rollout") -> ClusterSpec:
        def mut(s: ClusterSpec) -> None:
            s.canary = {"version": int(version),
                        "fraction": float(fraction)}
        return self.propose(origin, mut)

    def propose_promote(self, origin: str = "rollout") -> ClusterSpec:
        def mut(s: ClusterSpec) -> None:
            enforce(s.canary is not None,
                    "propose_promote: no canary in the spec",
                    PreconditionNotMetError)
            s.model_version = int(s.canary["version"])
            s.canary = None
        return self.propose(origin, mut)

    def propose_rollback(self, reason: str = "",
                         origin: str = "rollout") -> ClusterSpec:
        def mut(s: ClusterSpec) -> None:
            s.canary = None
        spec = self.propose(origin, mut)
        if reason:
            self._journal({"kind": "rollback_proposed", "reason": reason,
                           "origin": origin})
        return spec

    def propose_placement(self, table: str, target: str,
                          origin: str = "placement") -> ClusterSpec:
        def mut(s: ClusterSpec) -> None:
            s.placements[str(table)] = target
        return self.propose(origin, mut)

    # -- observation -------------------------------------------------------

    def observe(self) -> dict:
        routing = getattr(self.cluster, "routing", None)
        if routing is not None:
            # the ROUTED topology, not cluster.num_shards: mid-grow the
            # cluster already carries spawned-but-unrouted shard rows
            # (bootstrap targets taking no traffic) — counting them
            # would declare convergence while the cutover is still in
            # flight (CheckpointGate._targets makes the same call)
            _, shards_doc = routing.read()
            obs: dict = {"shards": len(shards_doc)}
        else:
            obs = {"shards": int(self.cluster.num_shards)}
        if self.rollout is not None:
            open_v = self.rollout.canary_open()
            obs["canary"] = (None if open_v is None else
                             {"version": int(open_v),
                              "fraction": float(self.rollout.fraction())})
            obs["stable_version"] = self.rollout.stable_version()
        else:
            obs["canary"] = None
            obs["stable_version"] = None
        obs["placements"] = {tid: pm.placement
                             for tid, pm in self.placements.items()}
        obs["trainer_np"] = self._trainer_np_observed
        return obs

    def _on_promotion(self, shard, endpoint) -> None:
        """Coordinator repaired observed state (lease-expiry promotion):
        journal it and re-observe — the spec itself is unchanged."""
        self._journal({"kind": "observed_repair", "shard": shard,
                       "promoted": endpoint})
        self._wake.set()

    # -- the actuator ------------------------------------------------------

    def step(self, now: Optional[float] = None) -> int:
        """One reconcile pass. Returns the number of COMPLETED
        transitions (0 when converged, in cooldown, or stalled)."""
        now = self._clock() if now is None else now
        spec = self.spec_store.read()
        if spec is None:
            return 0
        self._g_spec.set(float(spec.version))
        obs = self.observe()
        steps = plan_transitions(spec, obs)
        if not steps:
            with self._mu:
                self._stall = 0
                self._stall_dumped = False
            self._g_stall.set(0.0)
            self._g_conv.set(float(spec.version))
            return 0
        if now < self._cooldown_until:
            return 0
        done = 0
        with self._act_mu:
            for tr in steps:
                if tr.kind == "unreachable":
                    self._abort(spec, obs, tr,
                                ReconcileError(
                                    f"unreachable desired state: "
                                    f"{tr.detail}"), now)
                    break
                try:
                    info = self._actuate(tr, spec)
                except Exception as e:
                    self._abort(spec, obs, tr, e, now)
                    break
                self._c_trans.inc()
                self._journal({"kind": "transition", "transition": tr.kind,
                               "detail": dict(tr.detail),
                               "spec_version": spec.version,
                               "info": info})
                done += 1
                # admit the NEXT step only against re-observed reality:
                # a transition that converged the diff ends the pass
                obs = self.observe()
                if not plan_transitions(spec, obs):
                    break
        with self._mu:
            if done:
                self._stall = 0
                self._stall_dumped = False
            elif plan_transitions(spec, self.observe()):
                self._stall += 1
            stall = self._stall
            dumped = self._stall_dumped
            if stall > self.stall_ticks and not dumped:
                self._stall_dumped = True
        self._g_stall.set(float(stall))
        if stall > self.stall_ticks and not dumped:
            self._journal({"kind": "reconcile_stall", "ticks": stall,
                           "spec_version": spec.version,
                           "pending": [t.kind for t in steps]})
            _flightrec.notify(
                "reconcile_stall", job=str(self.cluster.job_id),
                ticks=stall, spec_version=spec.version,
                spec_diff=self._pending_diff(spec, obs))
        return done

    def _pending_diff(self, spec: ClusterSpec, obs: dict) -> dict:
        """Observed-vs-desired divergence for bundle manifests."""
        observed_as_spec = ClusterSpec(
            version=spec.version, shards=obs.get("shards", 0),
            replication=spec.replication,
            model_version=obs.get("stable_version"),
            canary=obs.get("canary"),
            placements=dict(obs.get("placements", {})),
            trainer_np=obs.get("trainer_np"))
        return spec_delta(observed_as_spec, spec)

    def _actuate(self, tr: Transition, spec: ClusterSpec) -> dict:
        if tr.kind in ("reshard_grow", "reshard_shrink"):
            enforce(self.controller is not None,
                    f"spec wants {tr.kind} but no ReshardController is "
                    "wired", ReconcileError)
            if tr.kind == "reshard_grow":
                rec = self.controller.grow(int(tr.detail["factor"]),
                                           replication=spec.replication)
            else:
                rec = self.controller.shrink(int(tr.detail["divisor"]))
            return {k: rec[k] for k in ("to_shards", "cutover_pause_ms")
                    if k in rec}
        if tr.kind in ("canary_open", "canary_promote", "canary_rollback"):
            enforce(self.rollout is not None,
                    f"spec wants {tr.kind} but no RolloutManager is "
                    "wired", ReconcileError)
            if tr.kind == "canary_open":
                enforce(self.model_source is not None,
                        "canary_open needs a model_source to resolve "
                        "spec'd versions", ReconcileError)
                flat = self.model_source(int(tr.detail["version"]))
                v = self.rollout.begin_canary(
                    flat, fraction=float(tr.detail["fraction"]))
                # the split must be exact BEFORE the next transition is
                # admitted (set-before-load already guarantees it; this
                # is the verified-step contract, cheap and explicit)
                enforce(self.rollout.assert_assignments() == 0,
                        "canary assignments drifted at open",
                        ReconcileError)
                return {"version": v}
            if tr.kind == "canary_promote":
                return {"version": self.rollout.promote()}
            return {"version": self.rollout.rollback(
                tr.detail.get("reason", "spec"))}
        if tr.kind == "placement":
            pm = self.placements.get(tr.detail["table"])
            enforce(pm is not None,
                    f"spec names placement for table "
                    f"{tr.detail['table']} but no PlacementManager is "
                    "wired", ReconcileError)
            target = tr.detail["target"]
            if pm.armed() != target:
                pm.arm(target)
            # fence now: the swap applies (digest-verified) at the
            # trainer's next poll — observed state converges then;
            # stall detection covers a trainer that never polls
            pm.fence()
            return {"armed": target}
        if tr.kind == "trainer_np":
            np_ = int(tr.detail["np"])
            if self.elastic_job_id is not None:
                set_desired_np(self.cluster.store, self.elastic_job_id,
                               np_)
            self._trainer_np_observed = np_
            return {"np": np_}
        raise ReconcileError(f"unknown transition kind {tr.kind!r}")

    def _abort(self, spec: ClusterSpec, obs: dict, tr: Transition,
               err: Exception, now: float) -> None:
        with self._mu:
            self._aborts += 1
        self._c_aborts.inc()
        self._cooldown_until = now + self.abort_backoff_s
        self._journal({"kind": "spec_abort", "transition": tr.kind,
                       "detail": dict(tr.detail),
                       "spec_version": spec.version,
                       "error": f"{type(err).__name__}: {err}"})
        _flightrec.notify(
            "spec_abort", job=str(self.cluster.job_id),
            transition=tr.kind, spec_version=spec.version,
            error=f"{type(err).__name__}: {err}",
            spec_diff=self._pending_diff(spec, obs))

    # -- introspection -----------------------------------------------------

    def converged(self) -> bool:
        spec = self.spec_store.read()
        return spec is None or not plan_transitions(spec, self.observe())

    def wait_converged(self, timeout: float = 30.0) -> bool:
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            if self.converged():
                return True
            self._sleep(min(self.poll_s, 0.05))
        return self.converged()

    def stalled_ticks(self) -> int:
        with self._mu:
            return self._stall

    def aborts(self) -> int:
        with self._mu:
            return self._aborts

    def _journal(self, rec: dict) -> None:
        rec = dict(rec)
        rec["wall_s"] = time.time()  # journal wall stamp
        with self._mu:
            self._seq += 1
            seq = self._seq
            self.events.append(rec)
        try:
            self.cluster.store.put(
                f"ps/{self.cluster.job_id}/reconcile/{seq}",
                json.dumps(rec, sort_keys=True, default=str))
        except Exception:
            pass  # journal mirror is best-effort; `events` is canonical
