"""Live model rollout: versioned dense towers with canary routing,
promotion, and digest-pinned rollback.

The port's own copy of ``paddle_tpu.serving.rollout``; a version's
identity is the ``crc32c`` of its flat f32 vector (``io.fs``), as in JAX.

A model push stops being a restart and becomes a ROUTED event:

1. ``begin_canary(params, fraction)`` registers dense-tower version
   N+1 (flat f32 vector + crc32c digest), loads it onto a canary
   subset of the fleet, and asks the router to pin ``fraction`` of the
   block-hash space to those members. Traffic splits deterministically;
   the router counts requests per version so the split is verified.
2. ``promote()`` — after clean SLO windows — loads N+1 onto every
   member and clears the band; N stays in the version store.
3. ``rollback()`` — one epoch, any time — re-loads version N onto
   EVERY member from the stored flat vector. Rollback is digest-pinned:
   the bytes that come back are the bytes that were serving before the
   canary, verified per member (``fleet_versions()``), not re-derived
   from a feed that has moved on.

Auto-rollback: ``guard(watchdog)`` subscribes an SLO watchdog (any
object with ``on_fire(cb)``; the port has no ``obs.slo`` yet) — a fired
guard rule while a canary is open rolls the canary back on the
watchdog's notify thread and journals why. The alert is any object with
a ``rule`` name.

Re-attach healing: a replica that fell off the feed (primary failover,
the epoch fence) and re-attached may have had its dense table
rewritten by the new primary's snapshot; :meth:`assert_assignments`
(the fleet watcher calls it every tick) re-pins every member to its
ASSIGNED version — digest-checked, so a member already serving the
right bytes costs one compare, and a drifted one is healed without a
restart.

The manager deals in *members* (serving/fleet.FleetMember protocol:
``endpoint``, ``model`` with ``set``/``version``/``digest``) through a
``members()`` provider so it composes with ServingFleet or a bare list
in tests.
"""

from __future__ import annotations

import dataclasses
# lock discipline (the JAX module's): `_mu` guards the version store and
# the canary state and is a leaf; member model loads and router calls run
# outside it
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import sync as _sync
from ..core.enforce import enforce
from ..io.fs import crc32c
from ..obs import registry as _obs_registry
from ..obs import trace as _obs_trace

__all__ = ["DenseModel", "RolloutConfig", "RolloutManager"]


class DenseModel:
    """One member's live dense tower: a flat f32 vector + the version /
    digest stamps the rollout plane pins. ``sink`` receives the
    unraveled params on every load (putting them on the member's device,
    where its infer reads them, is the intended shape); reads of
    ``version``/``digest`` are the member's rollout identity."""

    def __init__(self, unravel: Callable, flat: np.ndarray,
                 version: int = 1,
                 sink: Optional[Callable] = None) -> None:
        self._unravel = unravel
        self._sink = sink
        self._mu = _sync.Lock()  # a leaf
        self.version = 0
        self.digest = 0
        self.flat: Optional[np.ndarray] = None
        self.loads = 0
        self.set(version, flat)

    def set(self, version: int, flat: np.ndarray,
            expect_digest: Optional[int] = None) -> int:
        """Swap the live tower to (version, flat); returns the crc32c
        digest of the loaded bytes. ``expect_digest`` pins a rollback:
        the load REFUSES bytes that do not hash to the recorded
        version digest (a corrupted store must not silently serve)."""
        flat = np.ascontiguousarray(flat, np.float32)
        dg = crc32c(flat.tobytes())
        if expect_digest is not None:
            enforce(dg == expect_digest,
                    f"dense tower v{version} digest mismatch: got {dg:#x}, "
                    f"pinned {expect_digest:#x} — refusing to load")
        params = self._unravel(flat)
        if self._sink is not None:
            self._sink(params)
        with self._mu:
            self.flat = flat
            self.version = int(version)
            self.digest = dg
            self.loads += 1
        return dg

    def identity(self) -> Tuple[int, int]:
        with self._mu:
            return self.version, self.digest


@dataclasses.dataclass
class RolloutConfig:
    #: canary traffic band (fraction of the block-hash space)
    fraction: float = 0.1
    #: canary member count = max(1, round(fraction × fleet)) unless set
    canary_members: Optional[int] = None
    #: flat vectors kept for rollback (N, N-1, ...)
    keep_versions: int = 4
    #: SLO rules whose FIRE during an open canary triggers auto-rollback
    guard_rules: Tuple[str, ...] = ("fleet_serving_p99", "serving_p99")


class RolloutManager:
    """``members()`` → current List[FleetMember]; ``router`` is the
    :class:`~.router.ServingRouter` carrying the canary band."""

    def __init__(self, members: Callable[[], List], router,
                 config: Optional[RolloutConfig] = None) -> None:
        self._members = members
        self.router = router
        self.config = config or RolloutConfig()
        self._mu = _sync.Lock()
        #: version → (flat f32 vector, digest). Bounded: _register
        #: evicts the oldest UNPROTECTED versions past keep_versions —
        #: the live current and an open canary are never evicted (a
        #: rollback target must stay pinned no matter how many canary
        #: cycles abort), so the store holds ≤ keep_versions + 2.
        self._store: Dict[int, Tuple[np.ndarray, int]] = {}
        self._next_version = 1
        self.current: int = 0
        #: open canary: (version, frozenset(endpoints)) or None
        self._canary: Optional[Tuple[int, frozenset]] = None
        #: traffic fraction of the open canary (observability for the
        #: reconciler's observed-state diff; None when no canary)
        self._canary_fraction: Optional[float] = None
        self.events: deque = deque(maxlen=256)
        self._c_roll = _obs_registry.REGISTRY.counter(
            "serving_rollouts", max_series=64, kind="promote")
        self._c_back = _obs_registry.REGISTRY.counter(
            "serving_rollouts", max_series=64, kind="rollback")
        self._c_canary = _obs_registry.REGISTRY.counter(
            "serving_rollouts", max_series=64, kind="canary")
        self._c_heal = _obs_registry.REGISTRY.counter(
            "serving_rollouts", max_series=64, kind="heal")

    # -- version store -----------------------------------------------------

    def _register(self, flat: np.ndarray) -> Tuple[int, int]:
        flat = np.ascontiguousarray(flat, np.float32).copy()
        dg = crc32c(flat.tobytes())
        with self._mu:
            version = self._next_version
            self._next_version += 1
            self._store[version] = (flat, dg)
            protected = {version, self.current}
            if self._canary is not None:
                protected.add(self._canary[0])
            while len(self._store) > self.config.keep_versions:
                victims = sorted(v for v in self._store
                                 if v not in protected)
                if not victims:
                    break
                self._store.pop(victims[0])
        return version, dg

    def register_baseline(self, flat: np.ndarray) -> int:
        """Record the CURRENTLY-SERVING tower as version 1 (or N) —
        call once at fleet bring-up so rollback always has a pinned
        target."""
        version, dg = self._register(flat)
        with self._mu:
            self.current = version
        self._journal("baseline", version=version, digest=dg)
        return version

    def version_digest(self, version: int) -> Optional[int]:
        with self._mu:
            rec = self._store.get(version)
        return rec[1] if rec is not None else None

    # -- canary / promote / rollback ---------------------------------------

    def begin_canary(self, flat: np.ndarray,
                     fraction: Optional[float] = None) -> int:
        """Register N+1, load it on the canary subset, open the band.
        Returns the new version id."""
        with self._mu:
            enforce(self._canary is None,
                    "a canary is already open — promote or roll back first")
            enforce(self.current in self._store,
                    "no baseline registered — call register_baseline() "
                    "at bring-up so rollback always has a pinned target")
        fraction = (self.config.fraction if fraction is None
                    else float(fraction))
        version, dg = self._register(flat)
        members = sorted(self._members(), key=lambda m: m.endpoint)
        enforce(len(members) >= 2,
                "canary needs ≥2 members (one band, one stable)")
        k = (self.config.canary_members
             if self.config.canary_members is not None
             else max(1, round(fraction * len(members))))
        k = min(k, len(members) - 1)   # at least one stable member
        canary = members[:k]
        flatv, _ = self._store[version]
        with self._mu:
            # assignment recorded BEFORE the model loads: a concurrent
            # fleet tick's assert_assignments() otherwise heals the
            # freshly-loaded canary members back to stable mid-setup
            # (band opens routing canary-version traffic to members
            # actually serving stable bytes)
            self._canary = (version, frozenset(m.endpoint for m in canary))
            self._canary_fraction = fraction
        for m in canary:
            m.model.set(version, flatv, expect_digest=dg)
        self.router.set_canary([m.endpoint for m in canary], fraction,
                               canary_version=str(version),
                               stable_version=str(self.current))
        self._c_canary.inc()
        self._journal("canary_open", version=version, digest=dg,
                      fraction=fraction,
                      endpoints=[m.endpoint for m in canary])
        return version

    def promote(self) -> int:
        """Flip the WHOLE fleet to the canary version; the band
        closes. The previous current stays stored for rollback."""
        with self._mu:
            enforce(self._canary is not None, "no canary open to promote")
            version, _ = self._canary
            flat, dg = self._store[version]
            # assignment flips BEFORE the model loads: a concurrent
            # fleet tick's assert_assignments() then heals members the
            # SAME direction (to `version`, idempotent) instead of
            # racing this loop back to the old current (members would
            # read the old version right after promote()/rollback()
            # returned)
            self.current = version
            self._canary = None
            self._canary_fraction = None
        for m in sorted(self._members(), key=lambda m: m.endpoint):
            if m.model.identity() != (version, dg):
                m.model.set(version, flat, expect_digest=dg)
        self.router.clear_canary()
        self._c_roll.inc()
        self._journal("promote", version=version, digest=dg)
        return version

    def rollback(self, reason: str = "operator") -> int:
        """One-epoch rollback: every member reloads the stable version
        N from the stored bytes, digest-pinned. Works with or without
        an open canary (post-promotion rollbacks re-target N-1 ... the
        previous current)."""
        with self._mu:
            if self._canary is not None:
                target = self.current          # canary open: N is current
            else:
                prior = [v for v in self._store if v < self.current]
                enforce(bool(prior), "no prior version stored to roll "
                                     "back to")
                target = max(prior)
            flat, dg = self._store[target]
            # assignment flips first — same reasoning as promote()
            self._canary = None
            self._canary_fraction = None
            self.current = target
        for m in sorted(self._members(), key=lambda m: m.endpoint):
            m.model.set(target, flat, expect_digest=dg)
        self.router.clear_canary()
        self._c_back.inc()
        self._journal("rollback", version=target, digest=dg, reason=reason)
        return target

    # -- auto-rollback guard ----------------------------------------------

    def guard(self, watchdog) -> "RolloutManager":
        """Subscribe the SLO watchdog: a guard rule firing while a
        canary is open rolls it back (the "one-epoch rollback on a
        fired alert" contract). Runs on the watchdog's notify thread —
        outside its lock, per the on_fire contract."""
        watchdog.on_fire(self._on_alert)
        return self

    def set_proposer(self, proposer) -> "RolloutManager":
        """Demote the auto-rollback guard to a PROPOSER: with one wired
        in, a guard alert calls its ``propose_rollback(reason=...,
        origin=...)`` and a single serialized actuator performs the
        rollback, so a guard firing mid-reshard does not actuate
        concurrently with the cutover."""
        self._proposer = proposer
        return self

    def _on_alert(self, alert) -> None:
        if alert.rule not in self.config.guard_rules:
            return
        with self._mu:
            open_canary = self._canary is not None
        if open_canary:
            proposer = getattr(self, "_proposer", None)
            if proposer is not None:
                proposer.propose_rollback(
                    reason=f"slo_alert:{alert.rule}", origin="rollout")
                return
            self.rollback(reason=f"slo_alert:{alert.rule}")

    # -- re-attach healing -------------------------------------------------

    def assigned_version(self, endpoint: str) -> int:
        with self._mu:
            if self._canary is not None and endpoint in self._canary[1]:
                return self._canary[0]
            return self.current

    def assert_assignments(self) -> int:
        """Re-pin every member to its assigned version (fleet tick
        hook). A member whose (version, digest) already matches costs
        one tuple compare; a drifted one (re-attached through a
        primary promotion, fresh join) is healed from the store.
        Returns members healed."""
        healed = 0
        for m in list(self._members()):
            want = self.assigned_version(m.endpoint)
            with self._mu:
                rec = self._store.get(want)
            if rec is None:
                continue
            flat, dg = rec
            if m.model.identity() != (want, dg):
                m.model.set(want, flat, expect_digest=dg)
                healed += 1
        if healed:
            self._c_heal.inc(healed)
            self._journal("heal", members=healed)
        return healed

    # -- introspection -----------------------------------------------------

    def fleet_versions(self) -> Dict[str, Tuple[int, int]]:
        """endpoint → (version, digest) actually loaded — the
        digest-identical acceptance reads this."""
        return {m.endpoint: m.model.identity() for m in self._members()}

    def stable_version(self) -> int:
        """The fleet-wide stable version (the reconciler's observed
        ``stable_version``)."""
        with self._mu:
            return self.current

    def fraction(self) -> Optional[float]:
        """Traffic fraction of the open canary, None when closed."""
        with self._mu:
            return self._canary_fraction

    def canary_open(self) -> Optional[int]:
        with self._mu:
            return self._canary[0] if self._canary is not None else None

    def _journal(self, kind: str, **kw) -> None:
        self.events.append({"kind": kind, "t": _obs_trace.wall_s(), **kw})
