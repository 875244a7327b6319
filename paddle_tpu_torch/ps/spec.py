"""ClusterSpec: the versioned desired-state document.

The port's own copy of ``paddle_tpu.ps.spec``. One JSON document in the elastic store (``ps/<job>/spec``) names what
the cluster SHOULD look like — shard count, replication factor, the
serving model version plus an optional canary, per-table placement
assignments, the trainer count, and opaque per-tenant quota docs. The
reconciler (ps/reconcile.py) diffs it against observed state each tick
and sequences the existing primitives; everything else in the control
plane *proposes* spec deltas through :meth:`SpecStore.propose` instead
of actuating directly.

The document is deliberately small and value-only: it carries model
VERSION NUMBERS, never parameter payloads — the reconciler resolves a
version to its flat vector through its ``model_source`` at actuation
time, so the spec stays cheap to write, journal, and diff.

Versioning: every accepted proposal bumps ``version`` by one and
journals the field-level delta under ``ps/<job>/spec_log/<version>``.
Writes serialize under ``_spec_mu`` (the store interface has no CAS;
the single-writer discipline is the same one the routing table uses —
one SpecStore instance owns the key, proposers call into it).

:func:`plan_transitions` is the PURE diff: desired spec + observed
state → an ordered list of :class:`Transition` steps. It is shared by
the live actuator and the discrete-event simulator (ps/simulate.py),
so a policy validated in simulation exercises the exact transition
planner that runs against real hardware.
"""

# lock discipline (read by testing.sched.load_lock_order):
# LOCK LEAF: _spec_mu

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

from ..core.enforce import PreconditionNotMetError, enforce
from ..core import sync as _sync

__all__ = [
    "ClusterSpec", "SpecStore", "Transition", "plan_transitions",
    "spec_key", "spec_log_prefix",
]


def spec_key(job_id: str) -> str:
    return f"ps/{job_id}/spec"


def spec_log_prefix(job_id: str) -> str:
    return f"ps/{job_id}/spec_log/"


@dataclasses.dataclass
class ClusterSpec:
    """Desired state. ``version`` is the monotonically increasing spec
    generation (bumped by :meth:`SpecStore.propose`); ``origin`` names
    the last proposer (``"operator"``, ``"autoscaler"``, ``"rollout"``,
    ``"gameday"`` …) so journals attribute every transition."""

    version: int = 0
    shards: int = 1
    replication: int = 1
    #: desired fleet-wide stable serving model version (None = no
    #: serving plane under spec control)
    model_version: Optional[int] = None
    #: open canary: ``{"version": int, "fraction": float}`` or None
    canary: Optional[dict] = None
    #: table-id (str) → "ps" | "collective"
    placements: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: desired trainer world size (None = not under spec control)
    trainer_np: Optional[int] = None
    #: opaque per-tenant quota docs (ps/tenancy.py owns the semantics;
    #: the spec just versions them with everything else)
    tenants: Dict[str, dict] = dataclasses.field(default_factory=dict)
    origin: str = "operator"

    def validate(self) -> None:
        enforce(self.shards >= 1, f"spec.shards must be >= 1, "
                f"got {self.shards}", PreconditionNotMetError)
        enforce(self.replication >= 1, "spec.replication must be >= 1",
                PreconditionNotMetError)
        if self.canary is not None:
            frac = self.canary.get("fraction", 0.0)
            enforce(0.0 < frac < 1.0,
                    f"spec.canary.fraction must sit in (0, 1), "
                    f"got {frac}", PreconditionNotMetError)
            enforce("version" in self.canary,
                    "spec.canary needs a 'version'",
                    PreconditionNotMetError)
        for tid, target in self.placements.items():
            enforce(target in ("ps", "collective"),
                    f"spec.placements[{tid}] must be 'ps' or "
                    f"'collective', got {target!r}",
                    PreconditionNotMetError)
        if self.trainer_np is not None:
            enforce(self.trainer_np >= 1, "spec.trainer_np must be >= 1",
                    PreconditionNotMetError)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "ClusterSpec":
        d = json.loads(raw)
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})

    def copy(self) -> "ClusterSpec":
        return ClusterSpec(**{
            f.name: (dict(v) if isinstance(
                v := getattr(self, f.name), dict) else v)
            for f in dataclasses.fields(self)})


def spec_delta(old: Optional[ClusterSpec], new: ClusterSpec) -> dict:
    """Field-level diff for journals and postmortem bundles."""
    out: dict = {}
    for f in dataclasses.fields(ClusterSpec):
        if f.name in ("version", "origin"):
            continue
        a = getattr(old, f.name) if old is not None else None
        b = getattr(new, f.name)
        if a != b:
            out[f.name] = {"from": a, "to": b}
    return out


class SpecStore:
    """Owns the spec document of one job in the elastic store.

    Single-writer by construction: every mutation funnels through
    :meth:`propose` under ``_spec_mu``. A proposal whose mutation is a
    no-op (the desired state already says that) is NOT a new version —
    idempotent proposers (an autoscaler re-asserting its target every
    poll) do not churn the spec log.
    """

    def __init__(self, store, job_id: str) -> None:
        self.store = store
        self.job_id = job_id
        self._spec_mu = _sync.Lock()  # LOCK LEAF: _spec_mu
        self._subscribers: List[Callable[[ClusterSpec], None]] = []

    def read(self) -> Optional[ClusterSpec]:
        raw = self.store.get(spec_key(self.job_id))
        return None if raw is None else ClusterSpec.from_json(raw)

    def initialize(self, spec: ClusterSpec) -> ClusterSpec:
        """Write version 0 (the captured observed state). Refuses to
        clobber an existing document."""
        with self._spec_mu:
            enforce(self.read() is None,
                    f"spec for job {self.job_id} already exists — "
                    "propose deltas instead", PreconditionNotMetError)
            spec.validate()
            self.store.put(spec_key(self.job_id), spec.to_json())
        return spec

    def subscribe(self, fn: Callable[[ClusterSpec], None]) -> None:
        """``fn(new_spec)`` runs after every ACCEPTED proposal, outside
        ``_spec_mu`` (the reconciler uses this to wake its actuator)."""
        self._subscribers.append(fn)

    def propose(self, origin: str,
                mutate: Callable[[ClusterSpec], None]) -> ClusterSpec:
        """Read-modify-write one spec delta: ``mutate(spec)`` edits the
        desired state in place; an actual change bumps ``version``,
        journals the delta, and publishes. Returns the (possibly
        unchanged) current spec."""
        with self._spec_mu:
            cur = self.read()
            enforce(cur is not None,
                    f"no spec for job {self.job_id} — initialize() "
                    "first (the reconciler captures observed state "
                    "at start)", PreconditionNotMetError)
            new = cur.copy()
            # edits a local copy; proposers pass pure field mutations
            # that take no lock
            mutate(new)
            delta = spec_delta(cur, new)
            if not delta:
                return cur
            new.version = cur.version + 1
            new.origin = origin
            new.validate()
            self.store.put(spec_key(self.job_id), new.to_json())
            self.store.put(
                spec_log_prefix(self.job_id) + str(new.version),
                json.dumps({"version": new.version, "origin": origin,
                            "wall_s": time.time(),  # journal wall stamp
                            "delta": delta}, sort_keys=True))
        for fn in list(self._subscribers):
            fn(new)
        return new

    def log(self) -> List[dict]:
        keys = sorted(self.store.list_prefix(spec_log_prefix(self.job_id)),
                      key=lambda k: int(k.rsplit("/", 1)[1]))
        return [json.loads(self.store.get(k)) for k in keys
                if self.store.get(k) is not None]


# ---------------------------------------------------------------------------
# the pure diff: desired vs observed → ordered transitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Transition:
    """One actuation step. ``kind`` is one of ``canary_rollback`` /
    ``canary_promote`` / ``canary_open`` / ``reshard_grow`` /
    ``reshard_shrink`` / ``placement`` / ``trainer_np`` /
    ``unreachable`` (desired state no primitive can reach — surfaced,
    never silently dropped)."""

    kind: str
    detail: dict = dataclasses.field(default_factory=dict)


def _shard_steps(observed: int, desired: int) -> List[Transition]:
    if desired == observed:
        return []
    if desired > observed:
        if desired % observed == 0:
            # one grow op reaches any integer multiple (plan_grow
            # supports factor >= 2): a single cutover, not a chain
            return [Transition("reshard_grow",
                               {"factor": desired // observed,
                                "from": observed, "to": desired})]
    else:
        # shrink only halves per step: chain the halvings
        steps: List[Transition] = []
        n = observed
        while n > desired and n % 2 == 0:
            steps.append(Transition("reshard_shrink",
                                    {"divisor": 2, "from": n, "to": n // 2}))
            n //= 2
        if n == desired:
            return steps
    return [Transition("unreachable",
                       {"field": "shards", "from": observed,
                        "to": desired})]


def plan_transitions(desired: ClusterSpec, observed: dict) \
        -> List[Transition]:
    """Diff desired vs observed into the ordered actuation sequence.

    ``observed`` carries ``shards`` (int), ``stable_version``
    (int | None), ``canary`` ({"version", "fraction"} | None),
    ``placements`` ({tid: plane}), ``trainer_np`` (int | None).

    Order is fixed and deliberate: serving-plane moves first (cheap,
    bounded — a bad canary gets rolled back before an expensive
    reshard runs under it), then the reshard chain, then placement
    swaps (they ride reshard fences when one is pending), then the
    trainer lever. The actuator admits them one at a time, each
    digest-verified before the next (ps/reconcile.py).
    """
    steps: List[Transition] = []
    obs_canary = observed.get("canary")
    want_canary = desired.canary
    # -- canary lifecycle --------------------------------------------------
    if obs_canary is not None:
        if want_canary is None:
            if desired.model_version is not None and \
                    desired.model_version == obs_canary.get("version"):
                steps.append(Transition("canary_promote",
                                        {"version": obs_canary["version"]}))
            else:
                steps.append(Transition(
                    "canary_rollback",
                    {"version": obs_canary.get("version"),
                     "reason": "spec cleared canary"}))
        elif want_canary.get("version") != obs_canary.get("version") or \
                want_canary.get("fraction") != obs_canary.get("fraction"):
            # retarget = rollback then reopen (two verified steps)
            steps.append(Transition(
                "canary_rollback",
                {"version": obs_canary.get("version"),
                 "reason": "spec retargeted canary"}))
            steps.append(Transition("canary_open", dict(want_canary)))
    elif want_canary is not None:
        if observed.get("stable_version") != want_canary.get("version"):
            steps.append(Transition("canary_open", dict(want_canary)))
        # else: the canary version already IS the fleet-wide stable —
        # nothing to open (a promote raced the proposal; converged)
    # -- shard count -------------------------------------------------------
    steps.extend(_shard_steps(int(observed.get("shards", desired.shards)),
                              int(desired.shards)))
    # -- placement ---------------------------------------------------------
    obs_place = observed.get("placements", {})
    for tid in sorted(desired.placements):
        target = desired.placements[tid]
        if obs_place.get(tid, "ps") != target:
            steps.append(Transition("placement",
                                    {"table": tid, "target": target}))
    # -- trainer lever -----------------------------------------------------
    if desired.trainer_np is not None and \
            observed.get("trainer_np") != desired.trainer_np:
        steps.append(Transition("trainer_np", {"np": desired.trainer_np}))
    return steps
