"""paddle_tpu_torch's on-device key map against the JAX package.

The port emulates the uint32 mixer in int64 (masked to 32 bits, products
split so nothing overflows); its bucket ids must be bit-equal to the JAX
package's numpy mirror ``_mix32_np`` and its probe rows bit-equal to
``device_hash_lookup``, including keys whose hi half is zero (low-bit
keys), keys with all 32 bits set in a half, and missing keys. The host
cuckoo build is the port's own copy of cuckoo.cc and must lay the table
out identically.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ps.device_hash import DeviceKeyMap as JaxDeviceKeyMap
from paddle_tpu.ps.device_hash import _mix32_np
from paddle_tpu_torch.convert import map_state_from_jax
from paddle_tpu_torch.ps.device_hash import (DeviceKeyMap, _mix32, device_hash_lookup,
                                             split_keys)
from test_torch_jax_native import jax_native  # noqa: F401  (the fixture)

# the JAX DeviceKeyMap needs the native cuckoo_build
pytestmark = pytest.mark.usefixtures("jax_native")


def _hash_cases(rng):
    return {
        "random": rng.integers(0, 1 << 64, size=4096, dtype=np.uint64),
        "low_bit": rng.integers(1, 1 << 30, size=4096, dtype=np.uint64),
        "all_ones": np.asarray([0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF00000000,
                                0, 1, 1 << 63], np.uint64),
    }


@pytest.mark.parametrize("case", ["random", "low_bit", "all_ones"])
@pytest.mark.parametrize("seed", [0x1234ABCD, 0x9E3779B9 ^ 0x7FEB352D, 0xFFFFFFFF])
def test_mix32_bit_equal_to_numpy_mirror(case, seed):
    keys = _hash_cases(np.random.default_rng(3))[case]
    hi, lo = split_keys(keys)
    want = _mix32_np(hi, lo, seed)
    got = _mix32(torch.from_numpy(hi.astype(np.int64)),
                 torch.from_numpy(lo.astype(np.int64)), seed)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the 0-dim tensor seed the map state carries hashes identically
    got_t = _mix32(torch.from_numpy(hi.astype(np.int64)),
                   torch.from_numpy(lo.astype(np.int64)),
                   torch.tensor(seed, dtype=torch.int64))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


@pytest.mark.parametrize("low_bit", [False, True])
def test_probe_rows_bit_equal_to_jax(low_bit):
    rng = np.random.default_rng(5 + low_bit)
    hi_max = 1 << 30 if low_bit else 1 << 62
    keys = np.unique(rng.integers(1, hi_max, size=3000, dtype=np.uint64))
    rows = rng.permutation(len(keys)).astype(np.int32)

    host = DeviceKeyMap.build_host(keys, rows)
    jax_host = JaxDeviceKeyMap.build_host(keys, rows)
    for k in ("hi", "lo", "row"):  # the two cuckoo.cc copies agree
        np.testing.assert_array_equal(host[k], jax_host[k], err_msg=k)
    assert int(host["seed"]) == int(jax_host["seed"])

    jmap = JaxDeviceKeyMap(host_built=jax_host)
    tmap = DeviceKeyMap(host, torch.device("cpu"))
    missing = rng.integers(1 << 62, 1 << 63, size=500, dtype=np.uint64)
    batch = np.concatenate([keys[rng.integers(0, len(keys), size=2000)], missing])
    bh, bl = split_keys(batch)
    want = np.asarray(jmap.lookup(jnp.asarray(bh), jnp.asarray(bl)))
    got = tmap.lookup(torch.from_numpy(bh.astype(np.int64)),
                      torch.from_numpy(bl.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (got[-500:] == -1).all()
    np.testing.assert_array_equal(got[:2000].numpy(),
                                  rows[np.searchsorted(keys, batch[:2000])])


def test_map_state_from_jax_probes_identically():
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(1, 1 << 40, size=1000, dtype=np.uint64))
    rows = np.arange(len(keys), dtype=np.int32)
    jmap = JaxDeviceKeyMap(keys, rows)
    state = map_state_from_jax(jmap.state, "cpu")
    bh, bl = split_keys(keys)
    got = device_hash_lookup(state, torch.from_numpy(bh.astype(np.int64)),
                             torch.from_numpy(bl.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), rows)
