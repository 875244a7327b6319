"""Build-at-first-use for the port's native code.

Both the host library (``csrc/*.cc`` through ``g++``) and the CUDA
kernels (``ops/csrc/*.cu`` through ``nvcc``) compile into
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``) the first time a
caller needs them, and load with ``ctypes``.

The output name carries a digest of the sources and the command line, so
an edited source never loads a stale library. Builds run under an
exclusive ``fcntl`` lock and publish with an atomic rename: several test
workers (``pytest -n``) may ask for the same library at once, and each
either builds it or waits and loads the finished file — none ever loads
a half-written one. A failed build raises; there is no fallback.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Callable, List, Sequence

__all__ = ["BUILD_DIR", "BuildError", "build_shared_library", "find_nvcc"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")


class BuildError(RuntimeError):
    """The compiler is missing or rejected a source."""


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default prefix.
    Raises :class:`BuildError` when neither exists."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (needed to build the CUDA kernels; "
                     "install the CUDA toolkit or put nvcc on PATH)")


def build_shared_library(name: str, sources: Sequence[str],
                         command: Callable[[str], List[str]]) -> str:
    """Compile ``sources`` into ``_build/lib<name>-<digest>.so`` unless an
    identical build exists; returns the library path.

    ``command(out_path)`` returns the compiler argv writing ``out_path``.
    The digest covers the source bytes and the argv (with a placeholder
    output path), so a new flag or source rebuilds."""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(command("<out>")).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it while we waited
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        argv = command(tmp)
        try:
            proc = subprocess.run(argv, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise BuildError(f"compiler not found: {argv[0]}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise BuildError(f"building {name} failed ({' '.join(argv)}):\n"
                             f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out
