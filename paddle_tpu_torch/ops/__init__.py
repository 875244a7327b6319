"""Kernels of the port and their plain PyTorch versions.

(``DeviceGraph``, the device graph table, loads on first use: it builds
on ``ps.device_hash``.)"""

__all__ = ["DeviceGraph"]


def __getattr__(name):
    if name == "DeviceGraph":
        from .device_graph import DeviceGraph

        return DeviceGraph
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
