"""Device places (``paddle.CPUPlace``, ``paddle.CUDAPlace``, ``set_device``).

Port of ``paddle_tpu.core.places``. A :class:`Place` is a hashable
``(device_type, device_id)`` handle that resolves to a ``torch.device``
(:meth:`Place.torch_device`); the JAX package's resolves to a
``jax.Device``. The types are ``"cpu"`` and ``"gpu"`` (paddle's name for
a CUDA card; JAX's are ``"cpu"`` and ``"tpu"``): ``CUDAPlace(i)`` is
``cuda:i`` and raises ``InvalidArgumentError`` without a GPU, and
``TPUPlace`` raises, as the JAX package's ``CUDAPlace`` shim does, since
this build has no TPU.

As in the JAX package, :func:`set_device` only records a per-thread
choice: no entry point reads it. Entry points take ``device=`` and
default to the card (``core.device.resolve_device``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from .enforce import InvalidArgumentError, enforce

__all__ = ["CPUPlace", "CUDAPlace", "Place", "TPUPlace", "device_count", "get_device",
           "is_compiled_with_tpu", "set_device"]

_TORCH_TYPE = {"cpu": "cpu", "gpu": "cuda"}


@dataclasses.dataclass(frozen=True)
class Place:
    """A hashable device handle: (device_type, device_id)."""

    device_type: str
    device_id: int = 0

    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this place; raises
        ``InvalidArgumentError`` for an unknown type, a GPU place without a
        GPU, or an id past the devices there are."""
        kind = _TORCH_TYPE.get(self.device_type)
        enforce(kind is not None,
                f"unknown device type {self.device_type!r} (have: 'cpu', 'gpu')",
                InvalidArgumentError)
        if kind == "cpu":
            return torch.device("cpu")
        enforce(torch.cuda.is_available(), "no 'gpu' devices visible to torch "
                "(torch.cuda.is_available() is false)", InvalidArgumentError)
        enforce(0 <= self.device_id < torch.cuda.device_count(),
                f"device_id {self.device_id} out of range for gpu "
                f"({torch.cuda.device_count()} devices)", InvalidArgumentError)
        return torch.device("cuda", self.device_id)

    def __repr__(self) -> str:  # Place(gpu:0)
        return f"Place({self.device_type}:{self.device_id})"


def CPUPlace() -> Place:
    return Place("cpu", 0)


def CUDAPlace(device_id: int = 0) -> Place:
    """``cuda:device_id``; raises ``InvalidArgumentError`` without a GPU."""
    place = Place("gpu", int(device_id))
    place.torch_device()  # validate
    return place


def TPUPlace(device_id: int = 0) -> Place:  # API-parity shim: no TPU in this build
    raise InvalidArgumentError("paddle_tpu_torch is built without TPU; use CUDAPlace()/CPUPlace()")


class _DeviceState(threading.local):
    def __init__(self) -> None:
        self.place: Optional[Place] = None


_STATE = _DeviceState()


def set_device(device: str) -> Place:
    """``paddle.set_device``-style selector: "cpu", "gpu", "gpu:1"
    (validated, recorded for this thread). Only :func:`get_device` reads
    the choice: no entry point does, so ``set_device("cpu")`` leaves
    every entry point on its own ``device=`` (default the card)."""
    kind, _, idx = device.partition(":")
    place = Place(kind, int(idx) if idx else 0)
    place.torch_device()  # validate
    _STATE.place = place
    return place


def get_device() -> Place:
    """This thread's :func:`set_device` choice, else ``gpu:0`` when torch
    sees a card and ``cpu`` otherwise."""
    if _STATE.place is not None:
        return _STATE.place
    return Place("gpu", 0) if torch.cuda.is_available() else Place("cpu", 0)


def device_count(device_type: str = "gpu") -> int:
    """Devices of ``device_type`` torch sees: 1 for "cpu", the CUDA
    count for "gpu", 0 for any other type."""
    if device_type == "cpu":
        return 1
    if device_type == "gpu":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 0


def is_compiled_with_tpu() -> bool:
    return False
