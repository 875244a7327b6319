"""Deterministic fault injection (the chaos harness).

The port's own copy of ``paddle_tpu.ps.faultpoints``: a registry that
makes the worst moments *schedulable*, so tests exercise failure paths
deterministically instead of hoping production does. Instrumented sites
call :func:`faultpoint` with a site name. A site is inert — one dict
probe — until a test or operator arms it with :func:`arm_faultpoint` or
the ``FLAGS_ps_faultpoints`` flag/env.

Sites in the port: the RPC connection's ``rpc.call`` (inside the retry
loop, ``ps/rpc.py``), the replication shipper's ``repl.ship``
(``rpc.send_replicate``), the HA heartbeat's ``ha.heartbeat``
(``ps/ha.py``), and the job checkpoint's ``ckpt.artifact``,
``ckpt.manifest`` and ``ckpt.publish`` (``io/job_checkpoint.py``). The
C++ server has its own mirror, counted per command and armed through
``NativePsServer.arm_fault`` (``kill-shard``, ``drop-frame``,
``close-socket``, ``delay-ms``; each fires before the request changes any
state).

Actions:

- ``delay-ms``   — sleep ``ms`` at the site (latency injection).
- ``drop-frame`` — raise a transport error as if the frame vanished.
- ``close-socket`` — invoke the site's ``close`` context callable (the
  connection drops mid-protocol), then raise the transport error.
- ``kill-shard`` — invoke the site's ``kill`` context callable (the
  hosting server stops, like a SIGKILL'd shard host).
- ``kill-job`` — same dispatch as ``kill-shard`` (invoke ``kill``) under
  the name the checkpoint sites use: their ``kill`` callable SIGKILLs
  the whole process (preemption mid-save).
- ``corrupt-epoch`` — return the spec so the site substitutes
  ``spec.param`` for the real epoch (stale-primary fencing tests).
- ``truncate-artifact`` — chop ``param`` bytes (default: half) off the
  end of the file named by the site's ``path`` context (torn write: the
  crash landed between the data write and its fsync).
- ``flip-bytes`` — XOR ``0xFF`` into the byte at offset ``param``
  (default: the middle) of the site's ``path`` file (silent media/bus
  corruption under an intact length).

Scheduling: a spec fires once ``after`` matching hits have been seen
(default 1 = first hit), then every ``every`` further hits (0 = only
the threshold hit), at most ``count`` times total (0 = unlimited).
``cmd`` restricts matching to one wire command id (None = any).

Flag format (``FLAGS_ps_faultpoints``):
``site=action[:k=v]*[;site=action...]`` — e.g.
``rpc.call=delay-ms:ms=20`` or ``ckpt.manifest=kill-job:after=3``.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..core.enforce import PsTransportError
from ..core.flags import flag
from ..obs import flightrec as _flightrec
from ..obs import registry as _obs_registry

__all__ = ["FaultSpec", "faultpoint", "arm_faultpoint", "disarm_faultpoints",
           "armed_faultpoints", "FaultInjected"]

# FLAGS_ps_faultpoints itself is defined in core/flags.py, as in the JAX
# package (the transport's, the HA harness's and the checkpoint's sites
# read it)

_ACTIONS = frozenset({"delay-ms", "drop-frame", "close-socket", "kill-shard",
                      "kill-job", "corrupt-epoch", "truncate-artifact",
                      "flip-bytes"})


class FaultInjected(PsTransportError):
    """Transport-shaped error raised by drop-frame/close-socket faults —
    a subclass of the real transport error so every retry/failover path
    treats it exactly like the failure it simulates."""


@dataclass
class FaultSpec:
    name: str
    action: str
    cmd: Optional[int] = None   # restrict to one wire command (None = any)
    after: int = 1              # fire once this many matching hits seen
    every: int = 0              # then every k further hits (0 = just once)
    count: int = 0              # max fires (0 = unlimited)
    ms: int = 0                 # delay-ms duration
    param: int = 0              # corrupt-epoch substitute value
    seen: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)

    def _should_fire(self) -> bool:
        if self.count and self.fired >= self.count:
            return False
        if self.seen < self.after:
            return False
        if self.seen == self.after:
            return True
        return self.every > 0 and (self.seen - self.after) % self.every == 0


_mu = threading.Lock()
_armed: Dict[str, FaultSpec] = {}
_flag_loaded = False
# per-site fired counters, bound at ARM time (the cold path — the
# faultpoint() probe itself may sit on an RPC hot path)
_fired_counters: Dict[str, object] = {}


def _load_flag_specs() -> None:
    global _flag_loaded
    _flag_loaded = True
    raw = str(flag("ps_faultpoints")).strip()
    if not raw:
        return
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, rhs = part.partition("=")
        bits = rhs.split(":")
        kw: Dict[str, int] = {}
        for b in bits[1:]:
            k, _, v = b.partition("=")
            kw[k.strip()] = int(v)
        arm_faultpoint(site.strip(), bits[0].strip(), **kw)


def arm_faultpoint(name: str, action: str, cmd: Optional[int] = None,
                   after: int = 1, every: int = 0, count: int = 0,
                   ms: int = 0, param: int = 0) -> FaultSpec:
    """Arm ``action`` at site ``name``; returns the live spec (tests can
    read ``.fired``). One spec per site — re-arming replaces it."""
    if action not in _ACTIONS:
        raise ValueError(f"unknown faultpoint action {action!r} "
                         f"(have {sorted(_ACTIONS)})")
    spec = FaultSpec(name=name, action=action, cmd=cmd, after=after,
                     every=every, count=count, ms=ms, param=param)
    with _mu:
        _armed[name] = spec
        if name not in _fired_counters:
            _fired_counters[name] = _obs_registry.REGISTRY.counter(
                "ps_faultpoints_fired", max_series=1024, site=name)
    return spec


def disarm_faultpoints(name: Optional[str] = None) -> None:
    """Disarm one site, or every site when ``name`` is None (test
    teardown — chaos must never leak into the next test)."""
    with _mu:
        if name is None:
            _armed.clear()
        else:
            _armed.pop(name, None)


def armed_faultpoints() -> Dict[str, FaultSpec]:
    with _mu:
        return dict(_armed)


def faultpoint(name: str, cmd: Optional[int] = None,
               **ctx: Any) -> Optional[FaultSpec]:
    """Instrumentation site: no-op (one dict probe) unless ``name`` is
    armed and the schedule fires. Generic actions run here; sites pass
    ``close=``/``kill=`` callables for the socket/server-scoped ones.
    Returns the spec when the action is advisory (corrupt-epoch) so the
    site applies it; None otherwise."""
    if not _armed:
        if _flag_loaded:
            return None
        # load OUTSIDE _mu: _load_flag_specs arms via arm_faultpoint,
        # which takes _mu itself (a racing double-load just re-arms the
        # same specs — idempotent)
        _load_flag_specs()
        if not _armed:
            return None
    with _mu:
        spec = _armed.get(name)
        if spec is None or (spec.cmd is not None and cmd is not None
                            and spec.cmd != cmd):
            return None
        spec.seen += 1
        if not spec._should_fire():
            return None
        spec.fired += 1
        action = spec.action
        counter = _fired_counters.get(name)
    # outside _mu: the counter is lock-cheap but the flight-recorder
    # notify may dump a postmortem bundle (a fired chaos faultpoint is
    # exactly a moment worth keeping)
    if counter is not None:
        counter.inc()
    _flightrec.notify("faultpoint", site=name, action=action)
    if action == "delay-ms":
        time.sleep(spec.ms / 1000.0)
        return None
    if action == "drop-frame":
        raise FaultInjected(f"faultpoint {name}: frame dropped")
    if action == "close-socket":
        close = ctx.get("close")
        if callable(close):
            close()
        raise FaultInjected(f"faultpoint {name}: socket closed mid-call")
    if action in ("kill-shard", "kill-job"):
        kill = ctx.get("kill")
        if callable(kill):
            kill()
        return spec
    if action == "truncate-artifact":
        path = ctx.get("path")
        if path and os.path.exists(path):
            size = os.path.getsize(path)
            cut = spec.param if spec.param > 0 else max(1, size // 2)
            with open(path, "r+b") as f:
                f.truncate(max(0, size - cut))
        return None
    if action == "flip-bytes":
        path = ctx.get("path")
        if path and os.path.exists(path) and os.path.getsize(path) > 0:
            size = os.path.getsize(path)
            off = min(spec.param if spec.param > 0 else size // 2, size - 1)
            with open(path, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
        return None
    return spec  # corrupt-epoch: the site applies spec.param
