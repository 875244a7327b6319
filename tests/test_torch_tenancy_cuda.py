"""Phase 18 of ``chip_smoke.py`` small on the card (``cuda``; skipped
without one): the ``ctr`` tenant trains over the tier beside the abuser
(bitwise against its own oracle, B2 and B4 bitwise against their plain
versions on its first warm batch), then read-only replicas serve it;
the same composition on the CPU agrees with the card: the table's size
exactly, per-step losses at rtol 1e-5, the rows pulled for the data's keys
at rtol 1e-4 / atol 1e-5 (``tests/test_torch_reshard_cuda.py``'s), and the
checked predictions at atol 1e-4 (probabilities from two runs whose dense
params drift apart by ~1e-5 over the steps of the DNN 400^3).

Run on a card: ``python -m pytest -q -p no:cacheprovider --noconftest -m cuda
tests/test_torch_tenancy_cuda.py``.
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
                    ("HA_CAP", 1 << 14), ("SERVE_REQUESTS", 256), ("SERVE_CHECKED", 128),
                    ("SERVE_PROBES", 5)):
        monkeypatch.setattr(cs, name, v)
    return cs


def test_tenant_beside_abuser_and_serving_on_the_card(chip_smoke):
    cs = chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = {}, {}
    counts, b2, b4 = cs.phase_tenancy(torch.device("cuda"), "cuda", keep=card)
    n = cs.HA_LINES // cs.HA_BATCH
    assert counts["hot_probe_gather"] == counts["hot_scatter_apply"] == n
    assert b2["max_abs_err"] == 0 and b4["max_abs_err"] == 0
    cs.phase_tenancy(torch.device("cpu"), "cpu", keep=cpu)
    assert card["train"]["size"] == cpu["train"]["size"]
    np.testing.assert_allclose(card["train"]["losses"], cpu["train"]["losses"], rtol=1e-5)
    np.testing.assert_allclose(card["train"]["pulled"], cpu["train"]["pulled"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card["serve"]["checked_preds"], cpu["serve"]["checked_preds"],
                               rtol=0, atol=1e-4)
