"""The hot tier across a live grow on the card (``cuda``; jax-free, so it
runs on the card's machine): ``chip_smoke.py`` phase 17's leg B at a small
size.

512 lines of 400 ids a slot at batch 128 (4 batches an epoch) through a
2^14-row tier over a 2 x 2 sync ``HACluster``: the oracle, then the run
that grows 2 -> 4 after the cold epoch, trains the warm epoch across the
flip and shrinks back. On the card: one B2 and one B4 a warm step in both
runs, no client op in the warm epoch, B2 and B4 bitwise against their
plain versions on the first batch after the flip, and the run across the
flip bitwise equal to its oracle (rows pulled for the data's keys, table
size and digest sum, dense params, Adam state, per-step losses). Against
the same run on the CPU: the table size, the losses within rtol 1e-5 and
the rows within rtol 1e-4 / atol 1e-5, phase 5's card-vs-CPU bounds.
cuBLAS and the CPU BLAS sum the dense tower's products in another order,
so the pushed gradients differ in their last bits (the sparse rule itself
is bitwise on both). The dense params are not compared here: Adam
normalizes each step's update, so an element whose gradient sits near 0
can move by up to the learning rate on one side only, and after 8 steps
of the DNN 400³ single elements read 3.39e-6 and 1.06e-5 apart on two
H100 runs; phase 5 holds the dense tower card against CPU on its small
model.
"""

import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def chip_smoke(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: B2 and B4 have no CPU mode")
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    for name, v in (("HA_LINES", 512), ("HA_IDS", 400), ("HA_BATCH", 128),
                    ("HA_CAP", 1 << 14)):
        monkeypatch.setattr(cs, name, v)
    return cs


def test_tier_across_a_grow_on_the_card(chip_smoke):
    cs = chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = cs.ha_dataset()
    run = cs.reshard_leg_b(torch.device("cuda"), "cuda", ds)  # the oracle check inside
    n = cs.HA_LINES // cs.HA_BATCH
    assert run["launches"]["hot_probe_gather"] == run["launches"]["hot_scatter_apply"] == n
    cap = run["captured"]
    assert cs.rpc_b2_check(cap["b2"], "first batch after the flip")["max_abs_err"] == 0
    assert cs.rpc_b4_check(cap["b4"], "first batch after the flip")["max_abs_err"] == 0
    cpu = cs.reshard_leg_b_run(torch.device("cpu"), ds, flip=True)
    assert run["size"] == cpu["size"]
    np.testing.assert_allclose(run["losses"], cpu["losses"], rtol=1e-5)
    np.testing.assert_allclose(run["pulled"], cpu["pulled"], rtol=1e-4, atol=1e-5)
