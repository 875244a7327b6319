"""Phase 22 of ``chip_smoke.py`` small, on the card (``cuda``; skipped
without one).

- Leg A's export round trip: DCN and xDeepFM each train one pass through
  ``CtrPassTrainer`` on the card (2,048 lines, batch 256, 8 steps: one B1
  and one merge a step, B1 bitwise on the first push), export fused and
  dense, and a child process (``chip_smoke.py --serve-export``) loads each
  artifact on the card and serves batch 1 and 256 within 1e-6 of the
  trainer's forward (5 % of the keys outside the pass pull zeros),
  launching no kernel.
- Leg B's card vs CPU: every zoo family's eval forward and one training
  step from the same weights within the phase's bounds, and the hapi
  save/load round trip bitwise on the card.

Run on a card: ``python -m pytest -q -p no:cacheprovider --noconftest -m cuda
tests/test_torch_zoo_cuda.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def chip_smoke(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    for name, v in (("ZOO_LINES", 2048), ("BATCH", 256), ("CAPACITY", 1 << 16)):
        monkeypatch.setattr(cs, name, v)
    cs.build_all()
    return cs


def test_leg_a_small_exports_serve_in_a_child_on_the_card(chip_smoke, tmp_path):
    cs = chip_smoke
    dev = torch.device("cuda")
    ds = cs.ctr_dataset(cs.ctr_lines(np.random.default_rng(60), cs.ZOO_LINES, cs.ZOO_IDS,
                                     cs.SLOTS, cs.DENSE), cs.SLOTS, cs.DENSE)
    for family, opt in cs.CTR_FAMILIES:
        rec = cs.ctr_export_leg(dev, cs.card_line(), family, opt, ds, str(tmp_path))
        assert rec["launches"] == rec["steps"] == 8
        assert rec["b1"]["max_abs_err"] == 0.0
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--serve-export",
                        str(tmp_path)], capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    got = [json.loads(line[len(cs._SERVE_RESULT):]) for line in p.stdout.splitlines()
           if line.startswith(cs._SERVE_RESULT)][0]
    assert sorted(got) == ["DCN_dense", "DCN_fused", "XDeepFM_dense", "XDeepFM_fused"]
    for name, r in got.items():
        assert r["max_abs_err"] <= cs.EXPORT_TOL and r["launches"] == 0, (name, r)


def test_leg_b_card_vs_cpu_and_hapi_round_trip(chip_smoke, tmp_path):
    chip_smoke.zoo_parity(torch.device("cuda"))
    chip_smoke.zoo_hapi_roundtrip(torch.device("cuda"), str(tmp_path))
