"""The recsys models and phase 20 of ``chip_smoke.py`` on the card
(``cuda``; skipped without one).

- The GRU (``nn.rnn``) and the GRU4Rec and DSSM rankers on the card
  against the same modules on the CPU, on the same numpy inputs: within
  1e-5 absolute.
- B1 through a GRU4Rec train step's push: one ``ctr_sparse_rows`` launch
  and one merge a step, and the kernel on the step's first push bitwise
  against its plain version.
- Phase 20 small (2,000 keys, 3 steps at batch 32, seed 0, short arms),
  on the card: leg A's checks (card vs CPU within ``RS_TOL``, one B1 a
  step, B1 bitwise on each family's first push) and leg B's.

Run on a card: ``python -m pytest -q -p no:cacheprovider --noconftest -m cuda
tests/test_torch_recsys_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def chip_smoke(monkeypatch, card):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    for name, v in (("RS_KEYS", 2000), ("RS_STEPS", 3), ("RS_BATCH", 32), ("RS_SEEDS", (0,)),
                    ("RS_TREE_ITEMS", 512), ("RS_RAMP_S", 3.0), ("RS_TAIL_S", 2.0),
                    ("RS_CANARY", 60), ("RS_WARM", 20)):
        monkeypatch.setattr(cs, name, v)
    return cs


def test_gru_and_rankers_on_the_card_match_the_cpu(card):
    from paddle_tpu_torch.models.dssm import DSSM, make_dssm_ranker
    from paddle_tpu_torch.models.gru4rec import GRU4Rec, make_gru4rec_ranker
    from paddle_tpu_torch.nn import GRU

    rng = np.random.default_rng(0)
    gru = GRU(9, 16, num_layers=2, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(32, 6, 9)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(0, 7, 32))
    want = gru(x, lengths)
    got = gru.to(card)(x.to(card), lengths.to(card))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().cpu().numpy(), w.detach().numpy(), atol=TOL,
                                   rtol=0)
    hist = rng.normal(size=(32, 6, 9)).astype(np.float32)
    cand = rng.normal(size=(32, 8, 9)).astype(np.float32)
    lens = rng.integers(2, 7, 32).astype(np.int32)
    g4r = GRU4Rec(8, 16, 16, generator=torch.Generator().manual_seed(1))
    dssm = DSSM(6, 1, 8, generator=torch.Generator().manual_seed(2))
    for model, make in ((g4r, make_gru4rec_ranker), (dssm, make_dssm_ranker)):
        params = {k: v.detach() for k, v in model.named_parameters()}
        on_cpu = make(model, params, device="cpu")(hist, lens, cand)
        on_card = make(model, {k: v.to(card) for k, v in params.items()},
                       device=card)(hist, lens, cand)
        np.testing.assert_allclose(on_card, on_cpu, atol=TOL, rtol=0)


def test_b1_through_a_gru4rec_push_is_bitwise(chip_smoke, card):
    cs = chip_smoke
    from paddle_tpu_torch.ops import sparse_optimizer as so

    inp = cs.rs_family_inputs("gru4rec", 0)
    table, cfg, (cache,) = cs.rs_caches(inp, (card,))
    try:
        got, restore = cs.capture_first_push()
        cs.reset_launches()
        cs.rs_run_family("gru4rec", inp, cs.rs_model("gru4rec", 0), cfg, cache, card,
                         after_first_step=restore)
        torch.cuda.synchronize()
        n = cs.read_launches()
        assert n["ctr_sparse_rows"] == cs.RS_STEPS and n["merge_sparse_grads"] == cs.RS_STEPS
        state, (uniq, ds, dc, g), kw = got["state"], got["args"], got["kw"]
        mine = tuple(c.clone() for c in state)
        so.ctr_sparse_rows_at(mine, uniq, ds, dc, g, **kw)
        want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                           **kw)
        assert cs.bitwise_cols(mine, want)
    finally:
        table.close()


def test_phase20_small_on_the_card(chip_smoke, card):
    launches, b1 = chip_smoke.phase_recsys(card, "cuda")
    assert launches == 3 * chip_smoke.RS_STEPS
    assert b1["max_abs_err"] == 0.0 and b1["bound_ms"] > 0
