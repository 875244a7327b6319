"""Failover under the hot tier on the card (``cuda``; jax-free, so it runs
on the card's machine): ``chip_smoke.py`` phase 16's tier arm at a small
size.

2,048 lines of 400 ids a slot at batch 128 (16 batches) through a
2^14-row tier over a 2 x 2 sync ``HACluster``: the oracle run, then the
chaos run whose shard-1 primary dies on its 7th export (a miss fill) and
fails over to its backup. The chaos run's rows pulled for the data's
keys, dense params, Adam state and per-step losses are bitwise equal to
the oracle's on the card; B2 and B4 launch once a step in both runs; each
checkpoint's manifest digest equals every live replica's at its cut; and
B2 and B4, called on the inputs of the first batch after the promotion,
equal their plain versions bitwise.
"""

import os
import sys

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
    for name, v in (("HA_LINES", 2048), ("HA_IDS", 400), ("HA_BATCH", 128),
                    ("HA_CAP", 1 << 14)):
        monkeypatch.setattr(cs, name, v)
    return cs


def test_tier_arm_fails_over_bitwise_on_the_card(chip_smoke):
    cs = chip_smoke
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    oracle, chaos = cs.ha_arm(dev, "cuda", cs.ha_dataset(), hot=True)
    n = cs.HA_LINES // cs.HA_BATCH
    for run in (oracle, chaos):
        assert run["launches"]["hot_probe_gather"] == run["launches"]["hot_scatter_apply"] == n
    assert chaos["promotions"] >= 1 and len(chaos["cuts"]) == n // cs.HA_EVERY
    cap = chaos["captured"]
    assert cs.rpc_b2_check(cap["b2"], "first batch after the promotion")["max_abs_err"] == 0
    assert cs.rpc_b4_check(cap["b4"], "first batch after the promotion")["max_abs_err"] == 0
