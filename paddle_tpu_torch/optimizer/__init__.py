"""Dense optimizers of the port."""

from .adam import Adam

__all__ = ["Adam"]
