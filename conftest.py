"""Build the JAX package's native library once, before the test workers start.

``paddle_tpu/ps/native.py`` builds ``paddle_tpu/csrc/libpaddle_tpu_native.so``
at its first use with ``make -s``, with no lock and a 120 s timeout, and a
process whose build fails keeps no library for the rest of its life. Under
``pytest -n`` every worker starts that build while it collects (modules call
``native_available()`` at import), so the workers race on one output file and
a loser drops whole test files. This hook runs ``make -s`` in ``paddle_tpu/csrc``
under an exclusive ``fcntl.flock`` on its ``Makefile`` (the lock that
``tests/test_torch_jax_native.py`` takes) in ``pytest_configure``, which the
xdist controller runs before it starts any worker; each worker's own call then
finds the library up to date and its first use runs no ``make``.

It imports neither package and changes no test: it skips, marks and filters
nothing. If ``make`` fails, it prints why and the session goes on as it would
have without it.
"""

import fcntl
import os
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "paddle_tpu", "csrc")


def build_native(csrc: str = CSRC, timeout: float = 900.0) -> bool:
    """``make -s`` in ``csrc`` under an exclusive lock on its Makefile;
    True when it succeeded. A failure is printed, not raised."""
    makefile = os.path.join(csrc, "Makefile")
    if not os.path.exists(makefile):
        return False
    try:
        with open(makefile) as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            proc = subprocess.run(["make", "-s"], cwd=csrc, capture_output=True, text=True,
                                  timeout=timeout)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"conftest: building {csrc} failed: {e!r}")
        return False
    if proc.returncode != 0:
        print(f"conftest: make in {csrc} failed (rc {proc.returncode}):\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        return False
    return True


def pytest_configure(config):
    build_native()
