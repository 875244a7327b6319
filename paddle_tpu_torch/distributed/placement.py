"""Density-measured auto-placement: PS plane vs. collective plane.

The port's own copy of ``paddle_tpu.distributed.placement``. Parallax
(arxiv 1808.02621) showed that "sparse → parameter server, dense →
allreduce" should be a MEASURED decision per variable, not an
architectural constant: an embedding whose gradient block is almost
always fully dense pays the PS wire (8-byte keys, a pull of the same
working set every batch) for sparsity it does not have. The per-table
density series of ``ps.rpc`` are the measured feed, and this module
closes the loop:

- :class:`DensitySeries` turns the last-write density gauge into a
  STABLE signal: an alpha-0.2 EWMA plus min/max over a bounded window of
  recent samples, with restart RE-BASE semantics (a fresh client's first
  sample seeds the EWMA and the window: no decay from a phantom zero, no
  stale pre-restart extremes).
- :class:`PlacementPolicy` is the decision: densify when the EWMA clears
  ``densify_threshold`` AND the window minimum never dipped into the
  sparse band (one dense batch is not a dense variable); sparsify back on
  the symmetric hysteresis band.
- :class:`PlacementManager` EXECUTES a swap for a
  :class:`~paddle_tpu_torch.ps.ps_trainer.CtrStreamTrainer` table, gated
  on the reshard epoch fence (``ReshardController.on_pre_cutover``, the
  one point where routing, tier residency and replication already
  survive a topology flip): moving to the collective plane exports every
  row (exactly once, by the routed capture), verifies the content
  digests, and installs the rows in a trainer-local table on the
  servers' own native engine (``ps.table.NativeMemorySparseTable``), whose
  updates run the identical accessor math, bit for bit; moving back imports the rows to the PS and
  verifies the digests again, so no row is lost or doubled, by
  construction AND by check.

Collective-plane semantics: the PS stays the DURABLE home (the hot tier's
write-back contract, table-wide). While resident, the trainer updates the
local table with no PS call; the stream loop covers the
one-trainer-per-variable topology. Checkpoint cuts call
:meth:`PlacementManager.flush` (the trainer wires it), so a job snapshot
never knows the plane exists.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np

from ..core import sync as _sync
from ..core.enforce import PreconditionNotMetError, enforce
from ..obs import flightrec as _flightrec
from ..obs import registry as _obs_registry
from ..ps.table import make_sparse_table, row_digest

__all__ = [
    "DensitySeries",
    "PlacementConfig",
    "PlacementPolicy",
    "PlacementManager",
]

_MASK = 0xFFFFFFFFFFFFFFFF


class DensitySeries:
    """Windowed density signal for one (table, direction).

    ``update(v)`` feeds: the plain last-write gauge (the
    ``ps_client_density`` family; its alpha-0.2 EWMA view rides along),
    plus ``ps_client_density_min``/``_max`` gauges over the last
    ``window`` samples. Reads (``ewma``/``wmin``/``wmax``/``n``)
    come from the local object — lock-free: one background push thread
    writes, the trainer thread reads, and every field update is a
    single GIL-atomic rebind.

    Restart re-base: a fresh series (client restart) starts EMPTY — the
    first post-restart sample seeds the EWMA (no decay from zero) and
    the window holds only post-restart samples, so the placement pass
    never acts on another incarnation's extremes.
    """

    def __init__(self, gauge=None, gmin=None, gmax=None,
                 window: int = 64, alpha: float = 0.2) -> None:
        enforce(window >= 1, "DensitySeries window must be >= 1")
        self._q: deque = deque(maxlen=int(window))
        self._alpha = float(alpha)
        self._ewma: Optional[float] = None
        self._g, self._gmin, self._gmax = gauge, gmin, gmax

    def update(self, v: float) -> None:
        v = float(v)
        self._ewma = v if self._ewma is None else \
            (1.0 - self._alpha) * self._ewma + self._alpha * v
        self._q.append(v)
        if self._g is not None:
            self._g.set(v)
        if self._gmin is not None:
            self._gmin.set(min(self._q))
        if self._gmax is not None:
            self._gmax.set(max(self._q))

    @property
    def n(self) -> int:
        return len(self._q)

    @property
    def ewma(self) -> float:
        return 0.0 if self._ewma is None else self._ewma

    @property
    def wmin(self) -> float:
        q = list(self._q)
        return min(q) if q else 0.0

    @property
    def wmax(self) -> float:
        q = list(self._q)
        return max(q) if q else 0.0


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Knobs for the measured-placement decision and its execution."""

    #: EWMA density at/above which an embedding counts as dense-ish
    densify_threshold: float = 0.6
    #: EWMA density at/below which a collective-resident variable moves
    #: back to the PS (hysteresis band between the two)
    sparsify_threshold: float = 0.25
    #: samples required before ANY decision (a fresh/restarted series
    #: must earn a window first)
    min_samples: int = 8
    #: verify the content digests around every swap (O(table) — on by
    #: default; flip off only for tables too large to digest per swap)
    verify_digests: bool = True
    #: re-evaluate the policy every poll; False = manual arm() only
    auto: bool = True
    #: swaps apply only after a reshard epoch fence has passed since
    #: arming (the safe point); False applies at the next batch
    #: boundary — tests and single-node jobs with no controller
    require_fence: bool = True

    def __post_init__(self):
        enforce(0.0 <= self.sparsify_threshold < self.densify_threshold
                <= 1.0,
                "need 0 <= sparsify_threshold < densify_threshold <= 1")
        enforce(self.min_samples >= 1, "min_samples must be >= 1")


class PlacementPolicy:
    """The pure decision: current placement + series state → target
    placement or None. Separated from the manager so it unit-tests
    without a cluster."""

    def __init__(self, config: PlacementConfig) -> None:
        self.config = config

    def decide(self, placement: str, series: Optional[DensitySeries]
               ) -> Optional[str]:
        cfg = self.config
        if series is None or series.n < cfg.min_samples:
            return None
        if placement == "ps":
            # Densifying caution: the EWMA must clear the dense bar AND
            # the whole window must have stayed out of the sparse band —
            # one dense batch (or a short dense burst) never densifies
            if series.ewma >= cfg.densify_threshold and \
                    series.wmin > cfg.sparsify_threshold:
                return "collective"
        else:
            if series.ewma <= cfg.sparsify_threshold and \
                    series.wmax < cfg.densify_threshold:
                return "ps"
        return None


class PlacementManager:
    """Executes measured placement swaps for one sparse table of a
    ``CtrStreamTrainer``.

    Wiring: construct with the trainer's ``RpcPsClient`` + table id,
    optionally a :class:`~paddle_tpu_torch.ps.reshard.ReshardController`
    (subscribes ``on_pre_cutover`` as the epoch fence — swaps armed by
    the policy apply at the first batch boundary AFTER a fence), and
    pass it to ``CtrStreamTrainer(placement=...)``. The trainer calls
    :meth:`poll` each batch, :meth:`flush` before checkpoint cuts, and
    :meth:`reset_to_ps` after a restore.

    Threading: ``arm``/``fence`` may run on controller threads;
    ``poll``/``flush`` (and the swap they execute) run on the TRAINING
    thread at batch boundaries only. ``_mu`` guards just the armed/
    fence handshake scalars.
    """
    # LOCK LEAF: _mu

    def __init__(self, client, table_id: int,
                 config: Optional[PlacementConfig] = None,
                 controller=None) -> None:
        self._client = client
        self._table_id = int(table_id)
        self.config = config or PlacementConfig()
        self.policy = PlacementPolicy(self.config)
        #: "ps" | "collective" — where the variable lives NOW
        self.placement = "ps"
        #: trainer-local residence while on the collective plane
        self.local_table = None
        self._mu = _sync.Lock()
        self._armed: Optional[str] = None
        self._armed_at_fence = 0
        self._fence_gen = 0
        #: local-plane density series (client counters stop moving while
        #: resident — the trainer feeds observe_push instead)
        self._local_series: Optional[DensitySeries] = None
        #: swap journal (tests/operators read it; mirrors flightrec)
        self.events: List[dict] = []
        # max_series: one series per embedding table a job places
        self._c_swaps = _obs_registry.REGISTRY.counter(
            "placement_swaps", max_series=256, table=str(table_id))
        self._g_state = _obs_registry.REGISTRY.gauge(
            "placement_state", max_series=256, table=str(table_id))
        self._g_state.set(0.0)
        if controller is not None:
            controller.on_pre_cutover(self.fence)

    # -- signal -----------------------------------------------------------

    def series(self) -> Optional[DensitySeries]:
        """The ACTIVE density series: the client's push-wire window on
        the PS plane, the trainer-fed local window while resident."""
        if self.placement == "collective":
            return self._local_series
        return self._client.density_series(self._table_id, "push")

    def observe_push(self, push_values) -> None:
        """Collective-plane density sample (the trainer calls this per
        batch while resident — local pushes never cross the client's
        wire counters). Same gradient-block convention as the client."""
        if self._local_series is None:
            return
        g = push_values[:, 3:] if push_values.ndim == 2 and \
            push_values.shape[1] > 3 else push_values
        if g.size:
            self._local_series.update(
                float(np.count_nonzero(g)) / g.size)

    # -- decision / fence handshake ---------------------------------------

    def _collective_capable(self) -> bool:
        """Only RAM tables can take trainer-local residence (an SSD
        cold tier cannot move). Checked at DECISION time — the auto
        policy silently never densifies an SSD table, and a manual
        arm fails fast instead of killing the training thread after
        a full-table export."""
        try:
            cfg = self._client.sparse_config(self._table_id)
        except Exception:  # noqa: BLE001 — table not created yet
            return False
        return getattr(cfg, "storage", "memory") == "memory"

    def arm(self, target: str) -> None:
        """Queue a swap to ``target`` ("ps" | "collective"); it executes
        at the first poll() after the next epoch fence (or immediately
        when require_fence is off)."""
        enforce(target in ("ps", "collective"),
                f"placement target must be 'ps' or 'collective', "
                f"got {target!r}")
        enforce(target != "collective" or self._collective_capable(),
                "placement: only RAM tables can move onto the "
                "collective plane (an SSD cold tier stays on the PS)")
        with self._mu:
            if target == self.placement:
                self._armed = None
                return
            if self._armed != target:
                self._armed = target
                self._armed_at_fence = self._fence_gen

    def fence(self, plan=None) -> None:
        """An epoch fence passed (reshard pre-cutover hook, or called
        directly by an operator/test at any safe point)."""
        with self._mu:
            self._fence_gen += 1

    def armed(self) -> Optional[str]:
        """The queued swap target, None when nothing is armed (the
        reconciler's in-flight check — it must not re-arm a pending
        swap every tick)."""
        with self._mu:
            return self._armed

    def set_proposer(self, proposer) -> "PlacementManager":
        """Demote the auto policy to a PROPOSER: with one wired in,
        :meth:`decide` hands the desired plane to its
        ``propose_placement(table, target, origin=...)`` instead of
        arming directly, so an actuator can arm and fence serially with
        every other transition."""
        self._proposer = proposer
        return self

    def decide(self) -> Optional[str]:
        """Run the policy against the active series; arms the result
        (or proposes it, when a proposer is wired in).
        Densify decisions on tables that cannot take local residence
        (SSD cold tiers) are dropped, not raised — the auto loop runs
        on the training thread."""
        tgt = self.policy.decide(self.placement, self.series())
        if tgt == "collective" and not self._collective_capable():
            return None
        if tgt is not None:
            proposer = getattr(self, "_proposer", None)
            if proposer is not None:
                proposer.propose_placement(str(self._table_id), tgt,
                                           origin="placement")
                return tgt
            self.arm(tgt)
        return tgt

    # -- trainer-thread surface -------------------------------------------

    def poll(self, trainer) -> bool:
        """Batch-boundary hook: re-evaluate (auto mode), and execute an
        armed swap once a fence has passed since it was armed. Returns
        True when a swap was executed this call."""
        if self.config.auto:
            self.decide()
        with self._mu:
            tgt = self._armed
            if tgt is None or tgt == self.placement:
                self._armed = None
                return False
            if self.config.require_fence and \
                    self._fence_gen <= self._armed_at_fence:
                return False
            self._armed = None
        self._apply(trainer, tgt)
        return True

    def flush(self) -> int:
        """Write the collective-plane rows back to the PS WITHOUT
        leaving the plane (the checkpoint-cut hook — the captured PS
        table is complete, the trainer keeps its local residence).
        Returns rows written."""
        if self.local_table is None:
            return 0
        keys, values = self.local_table.snapshot_items()
        if len(keys):
            self._client.import_full(self._table_id, keys, values)
        return len(keys)

    def reset_to_ps(self) -> None:
        """Drop the local residence WITHOUT writing back (post-restore:
        the PS was just rebuilt from the checkpoint — it is the truth
        and the local rows are stale)."""
        self.local_table = None
        self._local_series = None
        self.placement = "ps"
        self._g_state.set(0.0)

    # -- the swap ----------------------------------------------------------

    def _digest_server(self) -> int:
        # routed per-server digests ADD (wrapping u64) — exactly-once
        # per key class even mid-reshard (RpcPsClient.digest_routed)
        return sum(self._client.digest_routed(self._table_id)) & _MASK

    def _verify(self, keys, values, where: str) -> None:
        if not self.config.verify_digests:
            return
        want = self._digest_server()
        got = row_digest(keys, values)
        enforce(want == got,
                f"placement swap {where}: content digest mismatch "
                f"(servers {want:#x} != moved rows {got:#x}) — rows "
                "were lost or doubled; aborting the swap",
                PreconditionNotMetError)

    def _journal(self, **event) -> None:
        self.events.append(event)
        self._c_swaps.inc()
        _flightrec.notify("placement_swap", **event)

    def _apply(self, trainer, target: str) -> None:
        # the trainer's queued pushes AND quantized-wire error-feedback
        # residuals must land before rows move (exactly-once accounting)
        if trainer.communicator is not None:
            trainer.communicator.quiesce()
        if target == "collective":
            keys, values = self._client.snapshot_items(self._table_id)
            self._verify(keys, values, "to-collective capture")
            cfg = self._client.sparse_config(self._table_id)
            enforce(cfg.storage == "memory",
                    "placement: only RAM tables can move onto the "
                    "collective plane (an SSD cold tier stays on the PS)")
            # the servers' engine: rows it creates and every update it applies
            # are bit for bit a server's
            local = make_sparse_table(dataclasses.replace(cfg, backend="native"))
            if len(keys):
                local.import_full(keys, values)
            self.local_table = local
            self._local_series = DensitySeries()  # fresh window (re-base)
            self.placement = "collective"
            self._g_state.set(1.0)
            self._journal(to="collective", rows=int(len(keys)))
        else:
            local = self.local_table
            enforce(local is not None,
                    "placement swap to 'ps' with no local residence")
            keys, values = local.snapshot_items()
            if len(keys):
                self._client.import_full(self._table_id, keys, values)
            self._verify(keys, values, "to-ps writeback")
            self.local_table = None
            self._local_series = None
            self.placement = "ps"
            self._g_state.set(0.0)
            self._journal(to="ps", rows=int(len(keys)))
