"""The sharded PS steps over a mesh of processes on the card, through
``chip_smoke.py`` phase 27's leg A at a small size.

``test_mp_leg_a_on_the_card`` (``cuda``: skips without a card) shrinks the
hot path (a 2^14-row tier, batch 256 over 4 processes, 2,048 lines of 200
ids a slot) and the CTR leg (a 2^14-row cache, 2^12 keys), runs phase 4's
sharded hot path for the tier it starts from, then leg A as the script
does: 4 gloo processes sharing the card, each holding its row block,
every CUDA tensor staged through the host, against the thread mesh in
this process (overflow 0, the first step's rows bitwise, losses and dense
params within ``MP_LOSS_TOL``, one B3 + one B4 and one B1 a step a
process, each process's first B3/B4/B1 bitwise against the plain
versions). The file imports neither jax nor ``paddle_tpu``.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(BATCH=256, HOT_CAP=1 << 14, HOT_LINES=2048, HOT_IDS=200, CAPACITY=1 << 14,
             PASS_KEYS=1 << 12)


@pytest.mark.cuda
def test_mp_leg_a_on_the_card(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    for name, v in SMALL.items():
        monkeypatch.setattr(cs, name, v)
    monkeypatch.setattr(cs, "SHARD_N", SMALL["BATCH"] * cs.SLOTS // cs.SHARDS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, _, snap = cs.phase_hot_path(dev, "card", cs.hot_dataset(), None, cs.SHARDS)
    out = cs.mp_leg_a(dev, "card", str(tmp_path), snap)
    steps = {"hot": cs.MP_HOT_STEPS, "ctr": cs.MP_CTR_STEPS}
    assert out["hot"]["launches"] == {"hot_probe": cs.MP_RANKS * steps["hot"],
                                      "hot_scatter_apply": cs.MP_RANKS * steps["hot"]}
    assert out["ctr"]["launches"] == {"ctr_sparse_rows": cs.MP_RANKS * steps["ctr"]}
    # gloo on a CUDA tensor: every collective staged through the host
    assert all(b > 0 for b in out["hot"]["staged_bytes_per_step"])
    assert out["b3"]["max_abs_err"] == 0 and out["b4"]["max_abs_err"] == 0
