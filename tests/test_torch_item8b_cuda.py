"""Item 8's second half through ``chip_smoke.py`` phase 25 at a small size:
the planner's leg (trace, completion, the plan on the hybrid trainer,
``Engine`` against a ``Trainer``), the fleet executor over the pass path
across two processes, and the elastic launcher with its trainers.

The ``cuda``-marked tests run the legs on a card (launch counts checked
there) and skip without one; ``test_chip_smoke_phase_25_on_the_cpu`` runs
the whole phase on the CPU (plain versions, no launch counted). The file
imports neither jax nor ``paddle_tpu`` (``pytest --noconftest -m cuda``
runs it on a machine without them). Sizes: ERNIE at hidden 64, 4 heads,
ffn 128, 4 layers, seq 64, batch 8; the pass path's DeepFM (26 slots, dim
8, a 400³ tower) at batch 256 over 200 ids a slot. The checks are the
phase's own: the plan's first loss within ``PIPE_FIRST_LOSS_TOL`` of the
serial model, Engine's losses bitwise a Trainer's, the executor's 16 steps
and the elastic items' losses bitwise their serial runs.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(ERNIE_CFG=dict(vocab_size=1024, hidden_size=64, num_heads=4, ffn_size=128,
                            num_layers=4, max_seq_len=64),
             ERNIE_SEQ=64, BATCH=256, HET_IDS=200, FE_CAP=1 << 14, EL_CAP=1 << 13,
             PIPE_HOP=(2, 64, 4, 16))   # a micro-batch's attention at this ERNIE


@pytest.fixture
def chip_smoke(monkeypatch):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    for name, v in SMALL.items():
        monkeypatch.setattr(cs, name, v)
    return cs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_chip_smoke_phase_25_on_the_cpu(chip_smoke):
    rec = chip_smoke.phase_item8b(torch.device("cpu"), "cpu")
    plan = rec["plan"]
    assert plan["plan"]["dp"] * plan["plan"]["mp"] * plan["plan"]["pp"] == 4
    assert len(plan["engine_losses"]) == chip_smoke.ENGINE_STEPS
    assert rec["fleet"]["b1"] == 0 and len(rec["fleet"]["walls_s"]) == chip_smoke.FE_ITEMS
    assert all(n <= chip_smoke.FE_CREDITS for v in rec["fleet"]["peaks"].values()
               for n in v.values())
    assert rec["elastic"]["restarts"] == 1


@pytest.mark.cuda
def test_plan_leg_a_small_on_the_card(chip_smoke, card):
    rec = chip_smoke.plan_leg_a(card, "card")
    assert abs(rec["first_loss"] - rec["serial_loss"]) <= (
        chip_smoke.PIPE_FIRST_LOSS_TOL * abs(rec["serial_loss"]))


@pytest.mark.cuda
def test_fleet_leg_b_small_on_the_card(chip_smoke, card, tmp_path):
    source = chip_smoke.fe_source_start(str(tmp_path))
    try:
        rec = chip_smoke.fe_leg_b(card, "card", source)
    finally:
        if source[0].poll() is None:
            source[0].kill()
            source[0].communicate()
    assert rec["b1"] == chip_smoke.FE_ITEMS


@pytest.mark.cuda
def test_elastic_leg_c_small_on_the_card(chip_smoke, card):
    assert chip_smoke.elastic_leg_c(card, "card")["restarts"] == 1
