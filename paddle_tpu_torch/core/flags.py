"""Process-wide typed flags (the reference's exported gflags).

The port's own copy of the mechanism of ``paddle_tpu.core.flags``: a flag
is defined by the module that owns it, with a default whose type the
flag keeps; an environment variable ``FLAGS_<name>`` overrides the
default when the flag is defined; :func:`set_flags` and
:func:`get_flags` read and write them at run time. Only the flags of the
port's own modules exist (the PS transport's in ``ps.rpc``, the
communicator's in ``ps.communicator``, the metrics registry's in
``obs.registry``, the job checkpoint's in ``io.job_checkpoint``), under
the JAX package's names and defaults. The core flags are defined here,
as in the JAX package: ``check_nan_inf`` (the numeric guard of
``core.nan_inf``, read by ``executor.Trainer`` and ``CtrPassTrainer``),
``benchmark``, ``tpu_allocator_strategy`` and ``eager_delete_tensor_gb``
(kept for API parity: PyTorch's caching allocator owns device memory),
and ``ps_faultpoints``, since more than one layer's fault sites read it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, Union

__all__ = ["define_flag", "flag", "get_flags", "set_flags"]

_TRUE = frozenset({"1", "true", "yes", "on"})
_FALSE = frozenset({"0", "false", "no", "off"})

_lock = threading.Lock()
_values: Dict[str, Any] = {}
_types: Dict[str, type] = {}


def _coerce(raw: Any, ty: type, name: str) -> Any:
    if ty is bool:
        if isinstance(raw, bool):
            return raw
        s = str(raw).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"flag {name}: cannot parse bool from {raw!r}")
    return ty(raw)


def define_flag(name: str, default: Any, help: str = "") -> None:
    """Define ``name`` with ``default`` (a second definition keeps the
    first); ``FLAGS_<name>`` in the environment overrides the default."""
    with _lock:
        if name in _values:
            return
        env = os.environ.get("FLAGS_" + name)
        _values[name] = default if env is None else _coerce(env, type(default), name)
        _types[name] = type(default)


def flag(name: str) -> Any:
    """One flag's value; raises KeyError for an unknown name."""
    with _lock:
        if name not in _values:
            raise KeyError(f"unknown flag: {name!r}")
        return _values[name]


def get_flags(names: Union[str, Iterable[str]]) -> Dict[str, Any]:
    """name → value for a name or a list of names."""
    if isinstance(names, str):
        names = [names]
    return {n: flag(n) for n in names}


def set_flags(kv: Dict[str, Any]) -> None:
    """Set flags, each coerced to its defined type."""
    for name, value in kv.items():
        with _lock:
            if name not in _values:
                raise KeyError(f"unknown flag: {name!r}")
            _values[name] = _coerce(value, _types[name], name)


# Core flags (a subsystem's own flags are defined by its module).
define_flag("check_nan_inf", False, "Scan each step's loss for NaN/Inf (core.nan_inf).")
# The next three have no reader in the port: they are defined under the
# reference's names and defaults so that set_flags/get_flags calls carry over.
define_flag("benchmark", False,
            "No effect in this package (kept for API parity): no step syncs on it; time "
            "with core.profiler.timed or CUDA events.")
define_flag("tpu_allocator_strategy", "auto_growth",
            "No effect in this package (kept for API parity): PyTorch's caching allocator "
            "owns device memory.")
define_flag("eager_delete_tensor_gb", 0.0,
            "No effect in this package (kept for API parity): PyTorch frees tensors by "
            "reference count.")
# Cross-cutting chaos switch: read by the job checkpoint's and the
# transport's fault sites, so it lives here rather than at either point of
# use. Format and actions: ps/faultpoints.py.
define_flag("ps_faultpoints", "",
            "arm PS fault-injection sites: 'site=action[:k=v]*[;...]' — "
            "actions delay-ms/drop-frame/close-socket/kill-shard/"
            "corrupt-epoch (ps/faultpoints.py; chaos testing only)")
