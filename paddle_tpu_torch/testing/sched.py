"""Deterministic concurrency explorer (loom/Coyote style).

The port's own copy of ``paddle_tpu.testing.sched``. The port's threaded
modules construct their synchronization primitives through
:mod:`paddle_tpu_torch.core.sync`.  Install a :class:`Scheduler` before
building the objects under test and those factories hand back
*controlled* primitives instead: every operation on them is a
scheduling point where the one running thread parks on a private
semaphore and an exploration strategy picks who runs next.  All
threads are REAL OS threads, but exactly one ever runs at a time, so
an interleaving is fully determined by the strategy's choice sequence
— replayable from a seed, minimizable by shrinking, and explorable
systematically.

What a run can detect:

* **deadlock** — runnable-set empty while live threads block on locks
  (the classic AB-BA cycle, reported with who-holds-what);
* **lost wakeup** — runnable-set empty and every stuck thread is
  parked in an untimed ``Condition.wait`` / ``Queue`` op past
  quiescence: the notify that should have come never will;
* **ordering violations** — the ``LOCK ORDER``/``LOCK LEAF``
  declaration comments in the sources (:func:`load_lock_order`) checked
  DYNAMICALLY against the acquisition sequences actually observed;
* **invariant failures** — the model calls :meth:`Scheduler.check`.

Exploration (:class:`Explorer`): a seeded random walk (every schedule
``i`` runs under ``seed = mix(base_seed, i)`` so any single failing
schedule replays from its printed seed alone) and a systematic
preemption-bounded DFS (:meth:`Explorer.explore_dfs`) that provably
exhausts the schedule space reachable with at most N preemptions.
Failures carry the full decision trace; :meth:`Explorer.shrink`
reduces it to a minimal choice prefix that still fails, which is what
gets pinned as a deterministic regression test.

Timed waits (``Event.wait(t)``, ``Condition.wait(t)``) keep
exploration finite by firing their timeout only at quiescence: a timed
waiter blocks like an untimed one, but when the runnable set would
otherwise be empty every timed waiter wakes with a timeout result.
That models "the timeout eventually fires" without exploding the
schedule space, and a run that makes no progress between such wakes
trips the livelock guard (``max_steps`` / ``timeout_wake_cap``).
"""

from __future__ import annotations

import os
import random
import re
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..core import sync as _sync

__all__ = [
    "Scheduler", "ScheduleFailure", "RandomWalk", "Guided", "Explorer",
    "load_lock_order", "parse_lock_decls",
]

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

#: owner sentinel for ops performed outside run() (single-threaded
#: harness setup/teardown on the main thread)
_EXTERNAL = "<external>"

# task states
_READY, _BLOCKED, _TIMED, _DONE = "ready", "blocked", "timed", "done"


class ScheduleFailure(AssertionError):
    """A bad interleaving, with everything needed to replay it."""

    def __init__(self, kind: str, message: str, *,
                 trace: Optional[List[str]] = None,
                 choices: Optional[List[str]] = None,
                 seed: Optional[int] = None) -> None:
        self.kind = kind          # deadlock | lost-wakeup | lock-order |
        self.message = message    # livelock | invariant | harness
        self.trace = list(trace or [])
        self.choices = list(choices or [])
        self.seed = seed
        super().__init__(self.format())

    def format(self, max_trace: int = 40) -> str:
        lines = [f"[{self.kind}] {self.message}"]
        if self.seed is not None:
            lines.append(f"  replay: seed={self.seed}")
        if self.choices:
            lines.append(f"  choices ({len(self.choices)}): "
                         f"{' '.join(self.choices)}")
        tail = self.trace[-max_trace:]
        if len(self.trace) > len(tail):
            lines.append(f"  ... ({len(self.trace) - len(tail)} earlier "
                         "steps elided)")
        lines.extend(f"  {t}" for t in tail)
        return "\n".join(lines)


class _Abort(BaseException):
    """Unwinds task threads when a run ends early (never escapes)."""


class _Task:
    def __init__(self, index: int, name: str, fn: Callable[[], None]) -> None:
        self.index = index
        self.name = name
        self.fn = fn
        self.sem = threading.Semaphore(0)
        self.state = _READY
        self.started = False
        self.blocked_on: Optional[str] = None
        self.blocked_kind: Optional[str] = None
        self.wait_obj: Any = None
        self.notified = False
        self.timeout_fired = False
        self.held: List["_CtlLock"] = []   # acquisition order, outermost 1st
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

def _mix(base_seed: int, i: int) -> int:
    """Per-schedule seed: schedule i of a sweep replays standalone."""
    return (base_seed * 1_000_003 + i * 7_919 + 0x9E3779B9) & 0xFFFFFFFF


class RandomWalk:
    """Uniform random pick among the runnable set, from one seed."""

    def __init__(self, seed: int) -> None:
        self.seed = seed
        self._rng = random.Random(seed)

    def choose(self, current: Optional[str], runnable: List[str]) -> str:
        return runnable[self._rng.randrange(len(runnable))]


class Guided:
    """Replay an explicit choice prefix, then the default policy
    (continue the current task when runnable, else the lowest-index
    runnable).  Tolerates divergence — a recorded choice no longer in
    the runnable set falls back to the default — so minimized
    schedules stay replayable across small code changes (the pinned-
    regression use case)."""

    def __init__(self, prefix: Sequence[str] = ()) -> None:
        self.prefix = list(prefix)
        self._i = 0

    def choose(self, current: Optional[str], runnable: List[str]) -> str:
        if self._i < len(self.prefix):
            want = self.prefix[self._i]
            self._i += 1
            if want in runnable:
                return want
        if current is not None and current in runnable:
            return current
        return runnable[0]


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

class Scheduler:
    """Serializes registered threads onto one runnable-set.

    Lifecycle::

        sched = Scheduler(RandomWalk(seed), order_decls=decls)
        sync.install_scheduler(sched)     # BEFORE building the model
        model = build()                   # constructs controlled prims
        sched.spawn(model.writer, name="writer")
        sched.spawn(model.saver,  name="saver")
        try:
            sched.run()                   # raises ScheduleFailure
        finally:
            sync.uninstall_scheduler()

    ``order_decls`` is ``(edges, leaves)`` in the py_locks grammar
    (see :func:`load_lock_order`); when set, every named-lock
    acquisition is checked against it and the observed edge set is
    kept on ``observed_edges`` for the gate's declaration cross-check.
    """

    def __init__(self, strategy, *,
                 order_decls: Optional[Tuple[Dict[str, Set[str]],
                                             Set[str]]] = None,
                 max_steps: int = 20_000,
                 timeout_wake_cap: int = 500,
                 wall_timeout_s: float = 60.0) -> None:
        self.strategy = strategy
        self.max_steps = max_steps
        self.timeout_wake_cap = timeout_wake_cap
        self.wall_timeout_s = wall_timeout_s
        self.tasks: List[_Task] = []
        self.trace: List[str] = []
        self.choices: List[str] = []          # chosen task per handoff
        self.decision_log: List[Tuple[Tuple[str, ...], str,
                                      Optional[str]]] = []
        self.steps = 0
        self.failure: Optional[ScheduleFailure] = None
        self.observed_edges: Set[Tuple[str, str]] = set()
        self._edges: Dict[str, Set[str]] = {}
        self._leaves: Set[str] = set()
        self._closure: Dict[str, Set[str]] = {}
        if order_decls is not None:
            self._edges, self._leaves = order_decls
            self._closure = _transitive_closure(self._edges)
        self._tls = threading.local()
        self._running = False
        self._aborting = False
        self._timeout_wakes = 0
        self._progress_since_wake = True
        self._done_evt = threading.Event()
        self._checks: List[Callable[[], None]] = []

    # -- construction hooks (called by core/sync factories) ---------------

    def make_lock(self, name):
        return _CtlLock(self, name, reentrant=False)

    def make_rlock(self, name):
        return _CtlLock(self, name, reentrant=True)

    def make_condition(self, lock, name):
        return _CtlCondition(self, lock, name)

    def make_event(self, name):
        return _CtlEvent(self, name)

    def make_semaphore(self, value, name):
        return _CtlSemaphore(self, value, name)

    def make_queue(self, maxsize, name):
        return _CtlQueue(self, maxsize, name)

    def make_thread(self, target, name, args, kwargs, daemon):
        return _CtlThread(self, target, name, args, kwargs)

    # -- model surface ----------------------------------------------------

    def spawn(self, fn: Callable[[], None], name: str) -> None:
        """Register a model thread (before :meth:`run`)."""
        if self._running:
            raise RuntimeError("spawn() before run(); in-run threads go "
                               "through sync.Thread().start()")
        self._add_task(fn, name).started = True

    def yield_point(self, label: str = "yield") -> None:
        """Explicit model scheduling point for steps that touch shared
        state through something other than a controlled primitive
        (e.g. a routing-store read-modify-write)."""
        self._switch(label)

    def check(self, ok: bool, message: str) -> None:
        """Model invariant — a False aborts the schedule as a failure."""
        if not ok and not self._aborting:
            self._fail("invariant", message)

    def on_finish(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` after a clean completion; raising AssertionError
        converts the schedule into an ``invariant`` failure."""
        self._checks.append(fn)

    def name_locks(self, obj: Any, *named: str) -> Any:
        """Adopt attribute names as lock names (py_locks' final-
        attribute-segment convention): every still-unnamed controlled
        lock/condition hanging off ``obj`` gets its attribute name."""
        for attr, val in vars(obj).items():
            if named and attr not in named:
                continue
            if isinstance(val, _CtlLock) and val.name is None:
                val.name = attr
            elif isinstance(val, _CtlCondition) and val._lock.name is None:
                val._lock.name = attr
        return obj

    def run(self) -> None:
        """Drive all spawned tasks to completion (or failure) from the
        calling (non-task) thread; raises :class:`ScheduleFailure`."""
        if not self.tasks:
            return
        self._running = True
        try:
            for t in self.tasks:
                if t.started:
                    self._start_os_thread(t)
            first = self._pick(None)
            if first is not None:
                first.sem.release()
                if not self._done_evt.wait(self.wall_timeout_s):
                    self._aborting = True
                    for t in self.tasks:
                        t.sem.release()
                    raise ScheduleFailure(
                        "harness", f"run exceeded wall timeout "
                        f"({self.wall_timeout_s}s) — a task escaped the "
                        "scheduler (raw primitive or real blocking call?)",
                        trace=self.trace, choices=self.choices)
            for t in self.tasks:
                if t.thread is not None:
                    t.thread.join(timeout=5.0)
        finally:
            self._running = False
        if self.failure is not None:
            raise self.failure
        for t in self.tasks:
            if t.error is not None:
                raise t.error
        for fn in self._checks:
            try:
                fn()
            except AssertionError as e:
                raise ScheduleFailure("invariant", str(e), trace=self.trace,
                                      choices=self.choices) from None

    # -- internals --------------------------------------------------------

    def _add_task(self, fn: Callable[[], None], name: str) -> _Task:
        base = name
        n = 1
        while any(t.name == name for t in self.tasks):
            n += 1
            name = f"{base}#{n}"
        t = _Task(len(self.tasks), name, fn)
        self.tasks.append(t)
        return t

    def _start_os_thread(self, t: _Task) -> None:
        def wrapper():
            self._tls.task = t
            t.sem.acquire()
            if self._aborting:
                t.state = _DONE
                return
            try:
                t.fn()
            except _Abort:
                pass
            except ScheduleFailure:
                pass      # recorded in self.failure already
            except BaseException as e:  # noqa: BLE001 — model bug, surfaced
                if not self._aborting:  # teardown noise after an abort
                    t.error = e         # (half-unwound locks) isn't a
                    self._fail_quiet(   # model error — failure is set
                        "harness", f"task {t.name} raised {e!r}")
            finally:
                t.state = _DONE
                t.wait_obj = None
                if not self._aborting:
                    for j in self.tasks:   # joiners wait on the task itself
                        if j.wait_obj is t:
                            self._wake(j)
                    self._handoff(t, parked=False)
        t.thread = threading.Thread(target=wrapper, daemon=True,
                                    name=f"sched:{t.name}")
        t.thread.start()

    def current_task(self) -> Optional[_Task]:
        return getattr(self._tls, "task", None)

    def _owner_token(self):
        t = self.current_task()
        if t is not None:
            return t
        if self._running and not self._aborting:
            # a thread the scheduler never saw is mutating controlled
            # state mid-run — it cannot be serialized, so the schedule
            # is meaningless
            raise RuntimeError("controlled-primitive op from a thread the "
                               "scheduler does not manage (mid-run)")
        return _EXTERNAL

    # scheduling points ---------------------------------------------------

    def _switch(self, op: str) -> None:
        """Preemption point: current task may yield to any runnable."""
        t = self.current_task()
        if t is None:
            return                      # external (setup/teardown): no-op
        if self._aborting:
            raise _Abort()
        self._step(t, op)
        nxt = self._pick(t)
        if nxt is None:                 # only current runnable
            return
        if nxt is not t:
            nxt.sem.release()
            t.sem.acquire()
            if self._aborting:
                raise _Abort()

    def _block(self, t: _Task, obj: Any, kind: str, desc: str,
               timed: bool = False) -> None:
        """Park current task until some op wakes it (or timeout fires
        at quiescence, when ``timed``)."""
        t.state = _TIMED if timed else _BLOCKED
        t.blocked_on = desc
        t.blocked_kind = kind
        t.wait_obj = obj
        t.timeout_fired = False
        self.trace.append(f"{self.steps:4d} {t.name}: BLOCK {desc}")
        self._handoff(t, parked=True)
        t.sem.acquire()
        if self._aborting:
            raise _Abort()
        t.blocked_on = None
        t.blocked_kind = None
        t.wait_obj = None

    def _wake(self, t: _Task) -> None:
        """Make a blocked task runnable again (does NOT transfer the
        baton — the waker keeps running until its next switch point)."""
        if t.state in (_BLOCKED, _TIMED):
            t.state = _READY
            self._progress_since_wake = True

    def _handoff(self, frm: _Task, parked: bool) -> None:
        """Current task blocked or finished: someone else must run."""
        runnable = [t for t in self.tasks
                    if t.state == _READY and t.started]
        if runnable:
            nxt = self._choose(frm, runnable, forced=True)
            nxt.sem.release()
            return
        timed = [t for t in self.tasks if t.state == _TIMED]
        if timed:
            self._timeout_wakes += 1
            if (self._timeout_wakes > self.timeout_wake_cap
                    or not self._progress_since_wake):
                self._fail_quiet(
                    "livelock",
                    "timed waiters re-polling without progress "
                    f"(quiescent wakes: {self._timeout_wakes}) — a poll "
                    "loop spins with nothing to satisfy its predicate")
                self._release_all()
                return
            self._progress_since_wake = False
            for t in timed:
                t.timeout_fired = True
                t.state = _READY
            self.trace.append(f"{self.steps:4d} <quiescent: timeout fires "
                              f"for {', '.join(t.name for t in timed)}>")
            nxt = self._choose(frm, timed, forced=True)
            nxt.sem.release()
            return
        live = [t for t in self.tasks if t.state != _DONE and t.started]
        if not live:
            self._done_evt.set()
            return
        # stuck: classify
        kinds = {t.blocked_kind for t in live}
        if kinds <= {"cond", "queue"}:
            kind, what = "lost-wakeup", (
                "every live thread is parked in an untimed Condition/"
                "Queue wait past quiescence — the wakeup it needs was "
                "lost or never sent")
        else:
            kind, what = "deadlock", "no runnable thread"
        detail = "; ".join(
            f"{t.name} blocked on {t.blocked_on}"
            + (f" holding [{', '.join(h.name or '?' for h in t.held)}]"
               if t.held else "")
            for t in live)
        self._fail_quiet(kind, f"{what}: {detail}")
        self._release_all()

    def _pick(self, current: Optional[_Task]) -> Optional[_Task]:
        runnable = [t for t in self.tasks
                    if t.state == _READY and t.started]
        if not runnable:
            return None
        return self._choose(current, runnable, forced=False)

    def _choose(self, current: Optional[_Task], runnable: List[_Task],
                forced: bool) -> _Task:
        runnable = sorted(runnable, key=lambda t: t.index)
        names = [t.name for t in runnable]
        cur = current.name if (current is not None
                               and current in runnable) else None
        picked = self.strategy.choose(cur, names)
        if picked not in names:
            picked = names[0]
        self.choices.append(picked)
        self.decision_log.append((tuple(names), picked, cur))
        return next(t for t in runnable if t.name == picked)

    def _step(self, t: _Task, op: str) -> None:
        self.steps += 1
        self.trace.append(f"{self.steps:4d} {t.name}: {op}")
        if self.steps > self.max_steps:
            self._fail("livelock",
                       f"schedule exceeded max_steps={self.max_steps}")

    def _fail_quiet(self, kind: str, message: str) -> None:
        if self.failure is None:
            seed = getattr(self.strategy, "seed", None)
            self.failure = ScheduleFailure(kind, message, trace=self.trace,
                                           choices=self.choices, seed=seed)
        self._aborting = True
        self._done_evt.set()

    def _release_all(self) -> None:
        for t in self.tasks:
            t.sem.release()

    def _fail(self, kind: str, message: str) -> None:
        self._fail_quiet(kind, message)
        self._release_all()
        raise _Abort()

    # lock-order bookkeeping ---------------------------------------------

    def _on_acquire(self, owner, lock: "_CtlLock") -> None:
        if owner is _EXTERNAL or not isinstance(owner, _Task):
            return
        for held in owner.held:
            a, b = held.name, lock.name
            if held is lock or a is None or b is None or a == b:
                continue
            self.observed_edges.add((a, b))
            if a in self._leaves:
                self._fail(
                    "lock-order",
                    f"{owner.name} acquired {b!r} while holding declared "
                    f"LEAF lock {a!r} (declared LOCK LEAF)")
            if a in self._closure.get(b, ()):
                self._fail(
                    "lock-order",
                    f"{owner.name} acquired {b!r} while holding {a!r} but "
                    f"declarations order {b} < {a} — inversion")
        owner.held.append(lock)

    def _on_release(self, owner, lock: "_CtlLock") -> None:
        if isinstance(owner, _Task) and lock in owner.held:
            owner.held.remove(lock)


def _transitive_closure(edges: Dict[str, Set[str]]) -> Dict[str, Set[str]]:
    closure: Dict[str, Set[str]] = {}

    def reach(n: str) -> Set[str]:
        if n in closure:
            return closure[n]
        closure[n] = set()          # cycle guard; decls are acyclic anyway
        out: Set[str] = set()
        for m in edges.get(n, ()):
            out.add(m)
            out |= reach(m)
        closure[n] = out
        return out

    for n in list(edges):
        reach(n)
    return closure


#: the declaration grammar, one form per comment leader: ``#`` in Python
#: sources, ``//`` in C++ (``LOCK ORDER: a < b [< c ...]`` declares an
#: order, ``LOCK LEAF: a [b ...]`` locks that take nothing inside them)
_DECL_RES = {
    "#": (re.compile(r"#\s*LOCK ORDER:\s*(.+)$"),
          re.compile(r"#\s*LOCK LEAF:\s*(.+)$")),
    "//": (re.compile(r"//\s*LOCK ORDER:\s*(.+)$"),
           re.compile(r"//\s*LOCK LEAF:\s*(.+)$")),
}


def parse_lock_decls(lines: Sequence[str], leader: str = "#"
                     ) -> Tuple[Dict[str, Set[str]], Set[str], List[str]]:
    """(declared edges ``{a: {b, ...}}`` meaning a < b, declared leaf
    locks, syntax errors as ``"line N: ..."``) of one source's lines, in
    the ``#`` or the ``//`` comment form."""
    order_re, leaf_re = _DECL_RES[leader]
    edges: Dict[str, Set[str]] = {}
    leaves: Set[str] = set()
    errors: List[str] = []
    for i, line in enumerate(lines, 1):
        lm = leaf_re.search(line)
        if lm:
            names = lm.group(1).split()
            if not names or not all(re.fullmatch(r"\w+", n) for n in names):
                errors.append(f"line {i}: malformed LOCK LEAF decl: "
                              f"{lm.group(1).strip()!r} (want `a [b ...]`)")
                continue
            leaves.update(names)
            continue
        m = order_re.search(line)
        if not m:
            continue
        names = [n.strip() for n in m.group(1).split("<")]
        if len(names) < 2 or not all(re.fullmatch(r"\w+", n) for n in names):
            errors.append(f"line {i}: malformed LOCK ORDER decl: "
                          f"{m.group(1).strip()!r} (want `a < b [< c ...]`)")
            continue
        for a, b in zip(names, names[1:]):
            edges.setdefault(a, set()).add(b)
            edges.setdefault(b, set())
    return edges, leaves, errors


def load_lock_order(paths: Sequence[str]) -> Tuple[Dict[str, Set[str]],
                                                   Set[str]]:
    """Merged ``LOCK ORDER``/``LOCK LEAF`` declarations from the given
    source files (relative paths from the checkout's root): the ``//``
    form in ``.cc``/``.h`` files, the ``#`` form elsewhere. A malformed
    declaration raises ``ValueError``."""
    edges: Dict[str, Set[str]] = {}
    leaves: Set[str] = set()
    for p in paths:
        if not os.path.isabs(p):
            p = os.path.join(_REPO_ROOT, p)
        with open(p, encoding="utf-8") as f:
            lines = f.read().splitlines()
        e, l, bad = parse_lock_decls(
            lines, "//" if p.endswith((".cc", ".h")) else "#")
        if bad:
            raise ValueError(f"malformed lock decl: {p}: {bad[0]}")
        for a, bs in e.items():
            edges.setdefault(a, set()).update(bs)
        leaves |= l
    return edges, leaves


# ---------------------------------------------------------------------------
# controlled primitives
# ---------------------------------------------------------------------------

class _CtlLock:
    def __init__(self, sched: Scheduler, name: Optional[str],
                 reentrant: bool) -> None:
        self._sched = sched
        self.name = name
        self._reentrant = reentrant
        self._owner: Any = None
        self._depth = 0

    def _label(self) -> str:
        return self.name or f"lock@{id(self):x}"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        s = self._sched
        me = s._owner_token()
        if me is _EXTERNAL:
            if self._owner not in (None, _EXTERNAL):
                raise RuntimeError("external acquire of a task-held lock")
            if self._owner is _EXTERNAL and not self._reentrant:
                raise RuntimeError("external re-acquire of a Lock")
            self._owner = _EXTERNAL
            self._depth += 1
            return True
        s._switch(f"acquire({self._label()})")
        if self._reentrant and self._owner is me:
            self._depth += 1
            return True
        while self._owner is not None:
            if not blocking:
                return False
            s._block(me, self, "lock",
                     f"lock {self._label()} held by "
                     f"{getattr(self._owner, 'name', self._owner)}",
                     timed=timeout is not None and timeout >= 0)
            if me.timeout_fired:
                return False
        self._owner = me
        self._depth = 1
        s._on_acquire(me, self)
        return True

    def release(self) -> None:
        s = self._sched
        me = s._owner_token()
        if self._owner is not me:
            raise RuntimeError(f"release of {self._label()} not owned by "
                               f"{getattr(me, 'name', me)}")
        self._depth -= 1
        if self._depth:
            return
        s._on_release(me, self)
        self._owner = None
        if me is _EXTERNAL:
            return
        for t in s.tasks:
            if t.wait_obj is self:
                s._wake(t)
        s._switch(f"release({self._label()})")

    def locked(self) -> bool:
        return self._owner is not None

    # threading.RLock's test-visible introspection surface
    def _is_owned(self) -> bool:
        me = self._sched.current_task() or _EXTERNAL
        return self._owner is me

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _CtlCondition:
    def __init__(self, sched: Scheduler, lock, name: Optional[str]) -> None:
        self._sched = sched
        self.name = name
        if lock is None:
            lock = _CtlLock(sched, name, reentrant=True)
        elif not isinstance(lock, _CtlLock):
            raise TypeError("Condition over a non-shim lock — construct "
                            "the lock through core.sync too")
        self._lock = lock
        self._waiters: List[_Task] = []

    def _label(self) -> str:
        return self.name or self._lock._label()

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        s = self._sched
        me = s._owner_token()
        if me is _EXTERNAL:
            raise RuntimeError("Condition.wait outside a scheduled run")
        if self._lock._owner is not me:
            raise RuntimeError("wait() on un-acquired Condition")
        s._step(me, f"cond_wait({self._label()})")
        depth, self._lock._depth = self._lock._depth, 1
        me.notified = False
        self._waiters.append(me)
        self._lock.release()      # wakes lock waiters, switch point
        if me.notified:
            got = True            # notified before we even parked
        else:
            s._block(me, self, "cond",
                     f"cond {self._label()} (untimed wait)"
                     if timeout is None else f"cond {self._label()} "
                     f"(timed wait {timeout})",
                     timed=timeout is not None)
            got = me.notified
        if me in self._waiters:
            self._waiters.remove(me)
        self._lock.acquire()
        self._lock._depth = depth
        return got or timeout is None

    def notify(self, n: int = 1) -> None:
        s = self._sched
        me = s._owner_token()
        if me is not _EXTERNAL and self._lock._owner is not me:
            raise RuntimeError("notify() on un-acquired Condition")
        for t in list(self._waiters)[:n]:
            t.notified = True
            self._waiters.remove(t)
            s._wake(t)
        if me is not _EXTERNAL:
            s._switch(f"notify({self._label()})")

    def notify_all(self) -> None:
        self.notify(n=len(self._waiters) or 1)


class _CtlEvent:
    def __init__(self, sched: Scheduler, name: Optional[str]) -> None:
        self._sched = sched
        self.name = name
        self._flag = False

    def _label(self) -> str:
        return self.name or f"event@{id(self):x}"

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        s = self._sched
        me = s._owner_token()
        self._flag = True
        for t in s.tasks:
            if t.wait_obj is self:
                s._wake(t)
        if me is not _EXTERNAL:
            s._switch(f"set({self._label()})")

    def clear(self) -> None:
        self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        s = self._sched
        me = s._owner_token()
        if me is _EXTERNAL:
            return self._flag
        s._switch(f"event_wait({self._label()})")
        while not self._flag:
            s._block(me, self, "event", f"event {self._label()}",
                     timed=timeout is not None)
            if timeout is not None and me.timeout_fired and not self._flag:
                return False
        return True


class _CtlSemaphore:
    def __init__(self, sched: Scheduler, value: int,
                 name: Optional[str]) -> None:
        self._sched = sched
        self.name = name
        self._value = value

    def _label(self) -> str:
        return self.name or f"sem@{id(self):x}"

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        s = self._sched
        me = s._owner_token()
        if me is _EXTERNAL:
            if self._value <= 0:
                raise RuntimeError("external semaphore acquire would block")
            self._value -= 1
            return True
        s._switch(f"sem_acquire({self._label()})")
        while self._value <= 0:
            if not blocking:
                return False
            s._block(me, self, "sem", f"semaphore {self._label()}",
                     timed=timeout is not None)
            if timeout is not None and me.timeout_fired and self._value <= 0:
                return False
        self._value -= 1
        return True

    def release(self, n: int = 1) -> None:
        s = self._sched
        me = s._owner_token()
        self._value += n
        for t in s.tasks:
            if t.wait_obj is self:
                s._wake(t)
        if me is not _EXTERNAL:
            s._switch(f"sem_release({self._label()})")

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _CtlQueue:
    """queue.Queue surface (put/get/_nowait/task_done/join/qsize)."""

    def __init__(self, sched: Scheduler, maxsize: int,
                 name: Optional[str]) -> None:
        self._sched = sched
        self.name = name
        self.maxsize = maxsize
        self._items: deque = deque()  # bounded by the model, not here
        self._unfinished = 0

    def _label(self) -> str:
        return self.name or f"queue@{id(self):x}"

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return 0 < self.maxsize <= len(self._items)

    def _wake_waiters(self) -> None:
        for t in self._sched.tasks:
            if t.wait_obj is self:
                self._sched._wake(t)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None):
        import queue as _q
        s = self._sched
        me = s._owner_token()
        if me is _EXTERNAL:
            if self.full():
                raise _q.Full
            self._items.append(item)
            self._unfinished += 1
            return
        s._switch(f"put({self._label()})")
        while self.full():
            if not block:
                raise _q.Full
            s._block(me, self, "queue", f"queue {self._label()} full",
                     timed=timeout is not None)
            if timeout is not None and me.timeout_fired and self.full():
                raise _q.Full
        self._items.append(item)
        self._unfinished += 1
        self._wake_waiters()

    def put_nowait(self, item):
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        import queue as _q
        s = self._sched
        me = s._owner_token()
        if me is _EXTERNAL:
            if not self._items:
                raise _q.Empty
            return self._items.popleft()
        s._switch(f"get({self._label()})")
        while not self._items:
            if not block:
                raise _q.Empty
            s._block(me, self, "queue", f"queue {self._label()} empty",
                     timed=timeout is not None)
            if timeout is not None and me.timeout_fired and not self._items:
                raise _q.Empty
        item = self._items.popleft()
        self._wake_waiters()
        return item

    def get_nowait(self):
        return self.get(block=False)

    def task_done(self) -> None:
        s = self._sched
        me = s._owner_token()
        if self._unfinished <= 0:
            raise ValueError("task_done() called too many times")
        self._unfinished -= 1
        if self._unfinished == 0:
            self._wake_waiters()
        if me is not _EXTERNAL:
            s._switch(f"task_done({self._label()})")

    def join(self) -> None:
        s = self._sched
        me = s._owner_token()
        if me is _EXTERNAL:
            if self._unfinished:
                raise RuntimeError("external Queue.join would block")
            return
        s._switch(f"queue_join({self._label()})")
        while self._unfinished:
            s._block(me, self, "queue", f"queue {self._label()} join")


class _CtlThread:
    """sync.Thread under a scheduler: start() registers a new task."""

    def __init__(self, sched: Scheduler, target, name, args, kwargs) -> None:
        self._sched = sched
        self._target = target
        self._args = args
        self._kwargs = kwargs
        self.name = name or "sync-thread"
        self.daemon = True
        self._task: Optional[_Task] = None

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("threads can only be started once")
        s = self._sched
        me = s._owner_token()
        t = s._add_task(lambda: self._target(*self._args, **self._kwargs),
                        self.name)
        self._task = t
        t.started = True
        if s._running:
            s._start_os_thread(t)
            if me is not _EXTERNAL:
                s._switch(f"thread_start({t.name})")
        # pre-run start: run() launches it with the rest

    def is_alive(self) -> bool:
        return self._task is not None and self._task.state != _DONE

    def join(self, timeout: Optional[float] = None) -> None:
        s = self._sched
        me = s._owner_token()
        if self._task is None:
            return
        if me is _EXTERNAL:
            if self._task.state != _DONE and s._running:
                raise RuntimeError("external join on a live scheduled task")
            return
        s._switch(f"join({self._task.name})")
        while self._task.state != _DONE:
            s._block(me, self._task, "join", f"join {self._task.name}",
                     timed=timeout is not None)
            if timeout is not None and me.timeout_fired \
                    and self._task.state != _DONE:
                return


# ---------------------------------------------------------------------------
# exploration
# ---------------------------------------------------------------------------

class Explorer:
    """Runs a model under many schedules.

    ``model`` is a callable ``model(sched)`` that installs nothing
    itself — the explorer installs/uninstalls the scheduler around it —
    but constructs the system under test (through core.sync factories)
    and registers its threads via ``sched.spawn`` / ``sched.on_finish``
    / ``sched.check``.
    """

    def __init__(self, model: Callable[[Scheduler], None], *,
                 order_decls: Optional[Tuple[Dict[str, Set[str]],
                                             Set[str]]] = None,
                 max_steps: int = 20_000) -> None:
        self.model = model
        self.order_decls = order_decls
        self.max_steps = max_steps
        self.schedules_run = 0
        self.observed_edges: Set[Tuple[str, str]] = set()

    def run_one(self, strategy) -> Scheduler:
        """One schedule; returns the (finished) scheduler, with
        ``failure`` set instead of raised."""
        sched = Scheduler(strategy, order_decls=self.order_decls,
                          max_steps=self.max_steps)
        _sync.install_scheduler(sched)
        try:
            self.model(sched)
            sched.run()
        except ScheduleFailure as f:
            if sched.failure is None:
                sched.failure = f
        finally:
            _sync.uninstall_scheduler()
        self.schedules_run += 1
        self.observed_edges |= sched.observed_edges
        return sched

    # random walk ---------------------------------------------------------

    def explore_random(self, n: int, base_seed: int = 0, *,
                       deadline: Optional[float] = None
                       ) -> Optional[ScheduleFailure]:
        """n seeded random-walk schedules; first failure wins.  The
        failure's ``seed`` alone replays it (:meth:`replay_seed`)."""
        import time
        for i in range(n):
            if deadline is not None and time.monotonic() > deadline:
                break
            seed = _mix(base_seed, i)
            sched = self.run_one(RandomWalk(seed))
            if sched.failure is not None:
                sched.failure.seed = seed
                return sched.failure
        return None

    def replay_seed(self, seed: int) -> Scheduler:
        return self.run_one(RandomWalk(seed))

    def replay_choices(self, choices: Sequence[str]) -> Scheduler:
        return self.run_one(Guided(choices))

    # preemption-bounded systematic exploration ---------------------------

    def explore_dfs(self, bound: int = 2, *,
                    max_schedules: int = 200_000,
                    deadline: Optional[float] = None
                    ) -> Tuple[Optional[ScheduleFailure], bool]:
        """DFS over choice-prefixes, preemption-bounded: beyond the
        prefix the default policy runs (no extra preemptions), and a
        branch is enqueued only while its preemption count stays within
        ``bound``.  Returns ``(first_failure_or_None, exhausted)``;
        ``exhausted=True`` means the ENTIRE preemption-≤bound schedule
        space of the model was covered."""
        import time
        pending: List[List[str]] = [[]]
        seen: Set[Tuple[str, ...]] = {()}
        while pending:
            if self.schedules_run >= max_schedules or (
                    deadline is not None and time.monotonic() > deadline):
                return None, False
            prefix = pending.pop()
            sched = self.run_one(Guided(prefix))
            if sched.failure is not None:
                return sched.failure, False
            log = sched.decision_log
            chosen = [c for _, c, _ in log]
            # preemption count of each position's prefix
            preempts = 0
            counts = []
            for names, c, cur in log:
                counts.append(preempts)
                if cur is not None and c != cur:
                    preempts += 1
            for j in range(len(prefix), len(log)):
                names, c, cur = log[j]
                for alt in names:
                    if alt == c:
                        continue
                    cost = counts[j] + (1 if cur is not None
                                        and alt != cur else 0)
                    if cost > bound:
                        continue
                    new = tuple(chosen[:j] + [alt])
                    if new not in seen:
                        seen.add(new)
                        pending.append(list(new))
        return None, True

    # shrinking -----------------------------------------------------------

    def shrink(self, failure: ScheduleFailure, *,
               max_attempts: int = 400) -> ScheduleFailure:
        """Minimize a failing schedule: shortest choice-prefix (with
        the default policy beyond it) that still fails the same way,
        then splice out individual choices to a fixpoint."""
        choices = list(failure.choices)
        kind = failure.kind
        attempts = 0

        def fails(prefix: List[str]) -> Optional[ScheduleFailure]:
            nonlocal attempts
            attempts += 1
            sched = self.run_one(Guided(prefix))
            f = sched.failure
            return f if (f is not None and f.kind == kind) else None

        # shortest failing prefix — bisect on length (failure is not
        # strictly monotone in the prefix, so verify and fall back to a
        # linear backstop from the found point)
        lo, hi = 0, len(choices)
        best = failure
        while lo < hi and attempts < max_attempts:
            mid = (lo + hi) // 2
            f = fails(choices[:mid])
            if f is not None:
                best, hi = f, mid
            else:
                lo = mid + 1
        prefix = choices[:hi]
        # splice out single choices until nothing more drops
        changed = True
        while changed and attempts < max_attempts:
            changed = False
            i = 0
            while i < len(prefix) and attempts < max_attempts:
                cand = prefix[:i] + prefix[i + 1:]
                f = fails(cand)
                if f is not None:
                    prefix, best, changed = cand, f, True
                else:
                    i += 1
        best.choices = prefix
        best.seed = failure.seed
        return best
