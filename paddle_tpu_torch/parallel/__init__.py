"""Attention over local blocks (the serial part of the JAX package's
``parallel`` package)."""
