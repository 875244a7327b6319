"""Neural-network pieces of the port (other layers are ``torch.nn``'s own)."""

from . import functional
from .layers import Dropout, LayerNorm

__all__ = ["Dropout", "LayerNorm", "functional"]
