"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A second package beside ``paddle_tpu`` (the JAX reference, unchanged).
It imports torch, numpy and the standard library only — never jax and
never ``paddle_tpu``. Importing it is light: no kernel is built and no
device is touched until an entry point runs.

Entry points take ``device`` and default to ``"cuda"``; without a GPU
they raise unless the caller passes ``device="cpu"``. On a CUDA tensor a
kernel wrapper launches its hand-written kernel (built from
``ops/csrc`` at first use) or raises; on a CPU tensor it runs the plain
PyTorch version beside it.
"""

__version__ = "0.1.0"
