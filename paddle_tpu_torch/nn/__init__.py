"""Neural-network pieces of the port (layers are ``torch.nn``'s own)."""

from . import functional

__all__ = ["functional"]
