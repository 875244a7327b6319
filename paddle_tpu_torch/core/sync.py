"""Instrumentable synchronization layer.

The port's own copy of ``paddle_tpu.core.sync``. The threaded modules of
the port (the job-checkpoint writer, the flight recorder) build their
primitives through these factories instead of calling
``threading.Lock()`` / ``queue.Queue()`` directly. In production the
factories are pass-throughs: one module-global ``is None`` check at
CONSTRUCTION time, then the caller holds a raw ``threading`` / ``queue``
object — no wrapper and no indirection on the acquire/release path.

A deterministic concurrency explorer installs a scheduler first, and the
same factories then return *controlled* primitives on which every
operation is a scheduling point. The contract is construction-time
binding: install the scheduler BEFORE constructing the objects under
test (primitives built earlier stay raw and invisible to it). The port
has no explorer of its own yet (``testing/sched.py``, ROADMAP Queue A);
the hooks are here so that the modules built on them need no change
when it comes.

The optional ``name=`` keyword names a lock for a lock-order checker;
the production path ignores it.
"""

from __future__ import annotations

import queue as _queue
import threading as _threading
from typing import Any, Optional

__all__ = [
    "Lock", "RLock", "Condition", "Event", "Semaphore", "Queue", "Thread",
    "install_scheduler", "uninstall_scheduler", "current_scheduler",
]

#: the installed controlled scheduler, or None (production): one load and
#: is-None test per CONSTRUCTION, nothing per operation
_scheduler: Optional[Any] = None


def install_scheduler(sched: Any) -> None:
    """Route later constructions to ``sched`` (test harness only).

    ``sched`` provides ``make_lock/make_rlock/make_condition/make_event/
    make_semaphore/make_queue/make_thread`` — duck-typed, so this module
    never imports an explorer."""
    global _scheduler
    _scheduler = sched


def uninstall_scheduler() -> None:
    global _scheduler
    _scheduler = None


def current_scheduler() -> Optional[Any]:
    return _scheduler


# -- factories ---------------------------------------------------------------
#
# Signatures mirror the stdlib ones plus the optional ``name=``, which the
# production path ignores (raw objects carry no metadata).

def Lock(name: Optional[str] = None):
    if _scheduler is None:
        return _threading.Lock()
    return _scheduler.make_lock(name)


def RLock(name: Optional[str] = None):
    if _scheduler is None:
        return _threading.RLock()
    return _scheduler.make_rlock(name)


def Condition(lock=None, name: Optional[str] = None):
    if _scheduler is None:
        return _threading.Condition(lock)
    return _scheduler.make_condition(lock, name)


def Event(name: Optional[str] = None):
    if _scheduler is None:
        return _threading.Event()
    return _scheduler.make_event(name)


def Semaphore(value: int = 1, name: Optional[str] = None):
    if _scheduler is None:
        return _threading.Semaphore(value)
    return _scheduler.make_semaphore(value, name)


def Queue(maxsize: int = 0, name: Optional[str] = None):
    if _scheduler is None:
        return _queue.Queue(maxsize=maxsize)
    return _scheduler.make_queue(maxsize, name)


def Thread(target=None, name: Optional[str] = None, args=(), kwargs=None,
           daemon: Optional[bool] = None):
    if _scheduler is None:
        return _threading.Thread(target=target, name=name, args=args,
                                 kwargs=kwargs or {}, daemon=daemon)
    return _scheduler.make_thread(target, name, args, kwargs or {}, daemon)
