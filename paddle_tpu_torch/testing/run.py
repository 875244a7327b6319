"""Budgeted deterministic-schedule exploration of the control-plane
protocol harnesses (:mod:`.models`): the port's own copy of the JAX
repo's explorer gate.

For each harness the gate runs a preemption-bounded EXHAUSTIVE sweep
(the whole ≤bound-preemption schedule space, or the run does not count
as exhausted) plus a seeded random-walk sweep on the full-task variant.
Every failure prints a replayable seed and a shrunk minimal schedule;
dynamic lock-order observations are cross-checked against the
``# LOCK ORDER:`` / ``# LOCK LEAF:`` declarations of the modules under
test — a mismatch fails the gate.

Usage:
  python -m paddle_tpu_torch.testing.run                       # full gate
  python -m paddle_tpu_torch.testing.run --harness three_way   # one harness
  python -m paddle_tpu_torch.testing.run --replay three_way --seed 123456
  python -m paddle_tpu_torch.testing.run --json out.json --budget-s 240
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from . import models
from .sched import Explorer, ScheduleFailure, load_lock_order

# (model factory, dfs bound, dfs task-trimming kwargs) per harness.  The
# exhaustive sweep wants a space small enough to actually EXHAUST inside
# the budget — the three-way harness drops the writer task for the pb-2
# sweep (the unpaused-read invariant alone catches the torn cut) and
# adds it back for the random walk; the checkpoint harness exhausts at
# bound 1 (bound 2 is ~75k schedules: random walk covers the tail).
HARNESSES: Dict[str, Dict[str, Any]] = {
    "three_way": {
        "dfs": lambda: models.three_way_model(with_writer=False),
        "full": lambda: models.three_way_model(),
        "bound": 2,
        "random_n": 5000,
    },
    "fleet": {
        "dfs": models.fleet_drain_tick_model,
        "full": models.fleet_drain_tick_model,
        "bound": 2,
        "random_n": 2000,
    },
    "ckpt": {
        "dfs": models.ckpt_writer_model,
        "full": models.ckpt_writer_model,
        "bound": 1,
        "random_n": 2000,
    },
    # the reconciler's single-actuator discipline: the pb sweep runs
    # the lean variant (one proposer) to exhaustion; the random walk
    # adds the trainer_np proposer back for spec-write interleavings
    "reconciler": {
        "dfs": lambda: models.reconciler_model(with_np_proposer=False),
        "full": models.reconciler_model,
        "bound": 2,
        "random_n": 2000,
    },
    # the cold-tier compactor drops the shrink sweep for the pb sweep
    # (the push/pull/save races alone cover the phase-B reconcile) and
    # adds it back for the random walk
    "ssd_compact": {
        "dfs": lambda: models.ssd_compact_model(with_shrink=False),
        "full": models.ssd_compact_model,
        "bound": 2,
        "random_n": 2000,
    },
}


def _decls() -> Tuple[Dict[str, Set[str]], Set[str]]:
    return load_lock_order(models.DECL_FILES)


def _closure(edges: Dict[str, Set[str]]) -> Dict[str, Set[str]]:
    out = {a: set(bs) for a, bs in edges.items()}
    changed = True
    while changed:
        changed = False
        for a in list(out):
            for b in list(out[a]):
                for c in out.get(b, ()):
                    if c not in out[a]:
                        out[a].add(c)
                        changed = True
    return out


def cross_check(observed: Set[Tuple[str, str]],
                decls: Tuple[Dict[str, Set[str]], Set[str]]
                ) -> List[str]:
    """Every dynamically observed held-A-acquire-B edge must agree with
    the static declarations: B acquired under a declared LEAF is a
    violation, and an observed edge whose REVERSE is in the declared
    order's transitive closure is an inversion.  (The scheduler already
    fails schedules on these live; this is the aggregated end-of-gate
    re-check across every schedule of every harness, so a declaration
    drifting from reality cannot slip through a non-failing run.)"""
    edges, leaves = decls
    closure = _closure(edges)
    bad = []
    for a, b in sorted(observed):
        if a in leaves:
            bad.append(f"observed {a} -> {b}, but {a} is declared LEAF")
        if b in closure and a in closure[b]:
            bad.append(f"observed {a} -> {b} inverts declared order "
                       f"{b} < {a}")
    return bad


def _fail_report(name: str, ex: Explorer, f: ScheduleFailure,
                 shrink: bool = True) -> ScheduleFailure:
    if shrink:
        try:
            f = ex.shrink(f)
        except Exception:  # noqa: BLE001 — report the unshrunk failure
            pass
    print(f"FAIL [{name}]\n{f.format()}", file=sys.stderr)
    if f.seed is not None:
        print(f"  replay: python -m paddle_tpu_torch.testing.run --replay "
              f"{name} --seed {f.seed}", file=sys.stderr)
    return f


def run_harness(name: str, spec: Dict[str, Any], seed: int,
                deadline: float, summary: Dict[str, Any]) -> bool:
    decls = _decls()
    entry: Dict[str, Any] = {}
    summary["harnesses"][name] = entry
    ok = True

    t0 = time.monotonic()
    ex = Explorer(spec["dfs"](), order_decls=decls)
    failure, exhausted = ex.explore_dfs(
        bound=spec["bound"], deadline=deadline)
    entry["dfs"] = {"bound": spec["bound"], "schedules": ex.schedules_run,
                    "exhausted": exhausted,
                    "wall_ms": int((time.monotonic() - t0) * 1000)}
    if failure is not None:
        f = _fail_report(name, ex, failure)
        entry["dfs"]["failure"] = {"kind": f.kind, "message": f.message,
                                   "choices": f.choices}
        ok = False
    elif not exhausted:
        print(f"FAIL [{name}] pb-{spec['bound']} sweep did NOT exhaust "
              f"inside budget ({ex.schedules_run} schedules) — the gate "
              "requires full coverage of the bounded space",
              file=sys.stderr)
        ok = False
    obs = set(ex.observed_edges)

    t0 = time.monotonic()
    ex2 = Explorer(spec["full"](), order_decls=decls)
    f2 = ex2.explore_random(spec["random_n"], base_seed=seed,
                            deadline=deadline)
    entry["random"] = {"n": spec["random_n"], "base_seed": seed,
                       "schedules": ex2.schedules_run,
                       "wall_ms": int((time.monotonic() - t0) * 1000)}
    if f2 is not None:
        f2 = _fail_report(name, ex2, f2, shrink=False)
        entry["random"]["failure"] = {"kind": f2.kind,
                                      "message": f2.message,
                                      "seed": f2.seed}
        ok = False
    obs |= ex2.observed_edges

    entry["observed_edges"] = sorted(list(e) for e in obs)
    violations = cross_check(obs, decls)
    if violations:
        entry["lock_order_violations"] = violations
        for v in violations:
            print(f"FAIL [{name}] lock-order cross-check: {v}",
                  file=sys.stderr)
        ok = False
    entry["ok"] = ok
    status = "ok" if ok else "FAIL"
    print(f"[{name}] {status}: pb-{spec['bound']} "
          f"{'exhausted' if exhausted else 'NOT exhausted'} "
          f"({entry['dfs']['schedules']} schedules, "
          f"{entry['dfs']['wall_ms']}ms) + "
          f"{entry['random']['schedules']} random walks "
          f"(base seed {seed}, {entry['random']['wall_ms']}ms)")
    return ok


def replay(name: str, seed: Optional[int],
           choices: Optional[List[str]]) -> int:
    spec = HARNESSES[name]
    ex = Explorer(spec["full"](), order_decls=_decls())
    if choices:
        sched = ex.replay_choices(choices)
    else:
        sched = ex.replay_seed(int(seed))
    if sched.failure is not None:
        if seed is not None and sched.failure.seed is None:
            sched.failure.seed = int(seed)
        print(sched.failure.format(max_trace=200))
        return 1
    print(f"[{name}] schedule ran clean "
          f"({len(sched.decision_log)} decisions)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--harness", choices=sorted(HARNESSES), default=None,
                    help="run one harness (default: all)")
    ap.add_argument("--seed", type=int, default=None,
                    help="base seed for random walks / seed to --replay")
    ap.add_argument("--budget-s", type=float, default=300.0,
                    help="wall budget for the whole gate")
    ap.add_argument("--json", default=None,
                    help="write the machine-readable summary here")
    ap.add_argument("--replay", choices=sorted(HARNESSES), default=None,
                    help="replay ONE schedule of this harness from "
                         "--seed (or --choices) and print its trace")
    ap.add_argument("--choices", default=None,
                    help="comma/space-separated choice list to --replay")
    args = ap.parse_args(argv)

    if args.replay:
        choices = None
        if args.choices:
            choices = args.choices.replace(",", " ").split()
        if args.seed is None and not choices:
            ap.error("--replay needs --seed or --choices")
        return replay(args.replay, args.seed, choices)

    base_seed = args.seed if args.seed is not None else (
        int(time.time()) & 0x7FFFFFFF)
    deadline = time.monotonic() + args.budget_s
    summary: Dict[str, Any] = {"base_seed": base_seed, "harnesses": {}}
    names = [args.harness] if args.harness else sorted(HARNESSES)
    print(f"sched: harnesses={names} base_seed={base_seed} "
          f"budget={args.budget_s:.0f}s")
    ok = True
    t0 = time.monotonic()
    for name in names:
        ok &= run_harness(name, HARNESSES[name], base_seed, deadline,
                          summary)
    summary["wall_ms"] = int((time.monotonic() - t0) * 1000)
    summary["total_schedules"] = sum(
        h["dfs"]["schedules"] + h["random"]["schedules"]
        for h in summary["harnesses"].values()
        if "dfs" in h and "random" in h)
    summary["ok"] = ok
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(summary, fh, indent=2, sort_keys=True)
        print(f"summary -> {args.json}")
    print(f"sched: {'OK' if ok else 'FAILED'} "
          f"({summary['total_schedules']} schedules, "
          f"{summary['wall_ms']}ms)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
