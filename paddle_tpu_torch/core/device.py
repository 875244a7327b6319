"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device=None`` means ``"cuda"``, and a CUDA request on a machine
without a usable GPU raises instead of carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .enforce import UnavailableError

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; raises :class:`UnavailableError` when CUDA is
    asked for (explicitly or by default) and ``torch.cuda.is_available()``
    is false. Pass ``device="cpu"`` to run the plain versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise UnavailableError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
