"""Host memory allocation (the allocator facade's host side).

Port of ``paddle_tpu.core.allocator``: the Python face of
``csrc/allocator.cc`` (the port's own copy, built at first use into a
library of its own, so that the host library every live path loads does
not build it), the role the reference's ``memory::Alloc(place, size)``
facade plays for host memory (``allocator_facade.h``, strategy
``auto_growth_best_fit_allocator.cc``). Device memory is PyTorch's
caching allocator's; this arena serves host buffers that are reused
batch after batch.

``HostArena.ndarray(shape, dtype)`` returns a numpy array backed by an
arena block; the block goes back to the arena when the array and every
view of it are garbage collected. ``default_arena()`` is the process-wide
singleton (``AllocatorFacade::Instance``).

Divergence: the JAX package's :func:`arena_ndarray` falls back to
``np.empty`` when its native library is missing. The port has no Python
fallback for its host library: a library that does not build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops._build import build_shared_library
from .enforce import enforce

__all__ = ["HostArena", "arena_ndarray", "default_arena"]

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                       "allocator.cc")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _gxx_command(out: str):
    # the host library's flags (ps/native.py)
    return ["g++", "-O3", "-ffp-contract=off", "-std=c++17", "-fPIC", "-shared", "-o", out,
            _SOURCE, "-lpthread"]


def load_arena_lib() -> ctypes.CDLL:
    """Build (first use) and load the arena's library; raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_shared_library("paddle_tpu_torch_arena", (_SOURCE,),
                                                   _gxx_command))
            lib.arena_create.restype = ctypes.c_void_p
            lib.arena_create.argtypes = [ctypes.c_int64]
            lib.arena_destroy.restype = None
            lib.arena_destroy.argtypes = [ctypes.c_void_p]
            lib.arena_alloc.restype = ctypes.c_void_p
            lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.arena_free.restype = ctypes.c_int
            lib.arena_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.arena_stats.restype = None
            lib.arena_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
            _LIB = lib
        return _LIB


class _Block:
    """Owns one arena block; numpy arrays keep it alive through ``base``.
    It holds the ``HostArena`` object, not the raw handle, so the arena
    outlives every block it handed out."""

    __slots__ = ("_owner_arena", "ptr", "size")

    def __init__(self, arena: "HostArena", ptr, size):
        self._owner_arena = arena
        self.ptr = ptr
        self.size = size

    def __del__(self):
        try:
            a = self._owner_arena
            if self.ptr and a is not None and a._h:
                a._lib.arena_free(a._h, self.ptr)
        except Exception:  # noqa: BLE001 — a finalizer must not raise
            pass

    def as_array(self, shape, dtype) -> np.ndarray:
        buf = (ctypes.c_char * self.size).from_address(self.ptr)
        # the array's base chain keeps `buf` alive and `buf._owner` this
        # block: the block is freed when the last view is collected
        buf._owner = self
        arr = np.frombuffer(buf, dtype=dtype, count=int(np.prod(shape)) if shape else 1)
        return arr.reshape(shape)


class HostArena:
    """Auto-growth best-fit host arena (thread-safe), in chunks of
    ``chunk_size`` bytes."""

    def __init__(self, chunk_size: int = 64 << 20) -> None:
        self._lib = load_arena_lib()
        self._h = self._lib.arena_create(int(chunk_size))
        enforce(self._h, "arena_create failed")

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.arena_destroy(self._h)
            self._h = None

    def alloc(self, size: int) -> _Block:
        ptr = self._lib.arena_alloc(self._h, int(size))
        enforce(ptr, f"arena alloc of {size} bytes failed")
        return _Block(self, ptr, int(size))

    def free(self, block: _Block) -> None:
        rc = int(self._lib.arena_free(self._h, block.ptr))
        enforce(rc == 0, "double free / foreign pointer")
        block.ptr = None

    def ndarray(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """An arena-backed numpy array; its block is recycled when the
        array and its views are unreferenced."""
        dt = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dt.itemsize if shape else dt.itemsize
        return self.alloc(max(nbytes, 1)).as_array(shape, dt)

    def stats(self) -> dict:
        """Bytes reserved, in use and at the peak of use, and the chunk
        count."""
        out = (ctypes.c_int64 * 4)()
        self._lib.arena_stats(self._h, out)
        return {"reserved": int(out[0]), "in_use": int(out[1]), "peak": int(out[2]),
                "chunks": int(out[3])}


_DEFAULT: Optional[HostArena] = None
_DEFAULT_LOCK = threading.Lock()


def default_arena() -> HostArena:
    """The process-wide arena (``AllocatorFacade::Instance``)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = HostArena()
        return _DEFAULT


def arena_ndarray(shape, dtype) -> np.ndarray:
    """``memory::Alloc`` for host arrays, from :func:`default_arena`;
    raises when the host library does not build (no ``np.empty``
    fallback)."""
    return default_arena().ndarray(tuple(shape), dtype)
