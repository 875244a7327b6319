"""The JAX package's native library, as the port's parity tests need it.

``paddle_tpu.ps.native.load_native`` builds ``libpaddle_tpu_native.so`` at
first use with ``make -s`` under a 120 s timeout and no file lock, and a
failure leaves the library ``None`` for the rest of the process. Under
``pytest -n`` several workers start that build at once, and a worker that
loses the race silently falls back: ``dedup_u64`` returns ``np.unique``
(sorted, not the native order that fixes a pass's cache rows),
``DeviceKeyMap`` raises and the SSD table cannot open. The parity tests
would then compare the port against a different JAX result, or fail for
a reason that has nothing to do with the port.

:func:`require_jax_native` repairs that state from the test side (the
JAX package stays as it is): under an exclusive lock it runs ``make -s``
with no short timeout, loads the library again if this process holds
``None``, and asserts that it is there. Every port test module that
needs the JAX package's native order or native tables calls it from an
autouse fixture (:func:`jax_native`).
"""

import fcntl
import os
import subprocess

import pytest

from paddle_tpu.ps import native as jax_native_mod


def require_jax_native():
    """Build (if needed) and load the JAX package's native library in this
    process; raises if it cannot. The lock is taken on the Makefile, so
    every process that asks here builds one at a time and no file is
    created for it."""
    csrc = os.path.dirname(os.path.abspath(jax_native_mod._LIB_PATH))
    with open(os.path.join(csrc, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(["make", "-s"], cwd=csrc, capture_output=True, text=True)
        assert proc.returncode == 0, f"make in {csrc} failed:\n{proc.stdout}\n{proc.stderr}"
        if jax_native_mod._LIB is None:
            jax_native_mod._TRIED = False
            jax_native_mod.load_native()
    assert jax_native_mod._LIB is not None, \
        "the JAX package's native library did not load: parity tests would compare " \
        "the port against its np.unique fallback"
    return jax_native_mod._LIB


@pytest.fixture(scope="module")
def jax_native():
    """Module fixture: the JAX package's native library, loaded."""
    return require_jax_native()


def test_require_jax_native_reloads_after_a_lost_build(monkeypatch):
    """A worker that lost the first-use build holds ``_LIB = None`` with
    ``_TRIED`` set; the helper loads the library again, and the JAX dedup
    then gives the native order, not the sorted fallback."""
    import numpy as np

    monkeypatch.setattr(jax_native_mod, "_LIB", None)
    monkeypatch.setattr(jax_native_mod, "_TRIED", True)
    keys = np.random.default_rng(0).integers(1, 1 << 40, 4096).astype(np.uint64)
    assert np.array_equal(jax_native_mod.dedup_u64(keys), np.unique(keys))  # the fallback
    lib = require_jax_native()
    assert lib is jax_native_mod._LIB is not None
    uniq = jax_native_mod.dedup_u64(keys)
    assert np.array_equal(np.sort(uniq), np.unique(keys))
    assert not np.array_equal(uniq, np.unique(keys))  # the native order is not sorted
