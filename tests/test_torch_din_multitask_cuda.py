"""DIN, ESMM and MMoE on the card, and phase 23 of ``chip_smoke.py``
(the ``cuda`` tests skip without a card; no JAX here).

- Each family's step on the card (B1 and the merge on the push) against
  the same steps on the CPU (their plain versions), from the same weights,
  rows and labels, 3 steps of SGD(0.1) on the dense params: losses rtol
  1e-5; each param by the update it
  received, ||Δcard − Δcpu|| / ||Δcpu|| ≤ 1e-4, and each cache column
  within 1e-4 of its largest magnitude (cuBLAS sums in another order than
  the CPU's BLAS); one B1 and one merge a step. DIN's ``att2.bias`` adds
  one constant to every score of a row, which the softmax ignores: its
  true gradient is 0, so both devices move it by rounding noise alone,
  and it is held to an update below 1e-6 on each instead (readings on an
  H100: the other updates within 1.3e-5, the cache within 5e-7).
- The same under Adam(1e-3), which moves an element whose gradient is
  within rounding of 0 by ±lr whatever the sign of its rounding: one step
  held element by element where the gradient is above rounding, three
  steps by their losses and moments (``test_family_adam_steps_card_vs_cpu``).
- Phase 23 small on the card (``cuda``) and on the CPU (not marked: the
  phase's own checks but the launch counts and B1's, which are the
  card's).

Run on a card: ``python -m pytest -q -p no:cacheprovider --noconftest -m cuda
tests/test_torch_din_multitask_cuda.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(BATCH=256, DIN_ITEMS=2001, DIN_CATS=41, DIN_HIST=10, DIN_CAP=1 << 12,
             MT_IDS=200, MT_CAP=1 << 14, ZOO_IDS=300)
ADAM_LR = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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


def _run(family, dev, cs, opt_name="sgd", steps=3):
    """``steps`` steps (of 3 batches) of ``family`` on ``dev`` over a fresh
    pass with SGD(0.1) or Adam(1e-3): (losses, each param's update, cache
    columns, B1 launches, merge launches, the optimizer's slots), all on
    the host."""
    from paddle_tpu_torch.ops import hot_kernels as hk
    from paddle_tpu_torch.ops import sparse_optimizer as so
    from paddle_tpu_torch.optimizer import SGD, Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    model, make_step, dim, cap, make_batches = cs.i9_family(family)
    batches = make_batches(np.random.default_rng(7), 3, 64)
    table = MemorySparseTable(TableConfig(shard_num=4,
                                          accessor_config=AccessorConfig(embedx_dim=dim)))
    cfg = CacheConfig(capacity=cap, embedx_dim=dim, embedx_threshold=0.0)
    cache = HbmEmbeddingCache(table, cfg, device=dev)
    try:
        cache.begin_pass(np.unique(np.concatenate([k[~p] for k, p, _, _ in batches])))
        model = model.to(dev)
        params = {k: v.detach() for k, v in model.named_parameters()}
        opt = SGD(0.1) if opt_name == "sgd" else Adam(ADAM_LR)
        opt_state = opt.init(params)
        step = make_step(model, opt, cfg, device=dev)
        b1, merges = so.ctr_sparse_rows.launches, hk.merge_sparse_grads.launches
        start = {k: v.cpu() for k, v in params.items()}
        losses = []
        for keys, pad, dense, labels in batches[:steps]:
            rows = np.full(keys.shape, cap, np.int64)
            rows[~pad] = cache.lookup(keys[~pad])
            params, opt_state, cache.state, loss = step(
                params, opt_state, cache.state,
                *(torch.from_numpy(a).to(dev) for a in (rows, dense, labels)))
            losses.append(float(loss))
        return (losses, {k: v.cpu() - start[k] for k, v in params.items()},
                {k: v.cpu() for k, v in cache.state.items()},
                so.ctr_sparse_rows.launches - b1, hk.merge_sparse_grads.launches - merges,
                {s: {k: v.cpu() for k, v in opt_state[s].items()}
                 for s in opt_state if s != "step"})
    finally:
        table.close()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["din", "esmm", "mmoe"])
def test_family_steps_card_vs_cpu(card, chip_smoke, family):
    got = _run(family, card, chip_smoke)
    want = _run(family, torch.device("cpu"), chip_smoke)
    assert got[3] == got[4] == 3 and want[3] == want[4] == 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    noise = [k for k in want[1] if k == "att2.bias"]
    for k in noise:
        assert got[1][k].abs().max() <= 1e-6 and want[1][k].abs().max() <= 1e-6, k
    update = {k: float((got[1][k] - v).norm() / v.norm().clamp_min(1e-30))
              for k, v in want[1].items() if k not in noise}
    cache = {k: float((got[2][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
             for k, v in want[2].items() if v.numel()}
    print(f"{family}: update {max(update.values()):.3e} ({max(update, key=update.get)}), "
          f"cache {max(cache.values()):.3e} ({max(cache, key=cache.get)})")
    assert max(update.values()) <= 1e-4 and max(cache.values()) <= 1e-4, (update, cache)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["din", "esmm", "mmoe"])
def test_family_adam_steps_card_vs_cpu(card, chip_smoke, family):
    """Adam(1e-3) on the dense params, card against CPU. One step from the
    same weights: the moments (m = 0.1 g, v = 0.001 g²) of every param by
    norm within 1e-4, as the SGD test holds the gradients; the cache within
    1e-4 of its largest; the update (−lr·g/(|g| + eps)) within 1e-3·lr on
    every element whose CPU |g| is at least 1e-3 of its param's largest
    (below that a gradient within rounding of 0 may flip its sign, and Adam
    moves such an element by ±lr on either device). Three steps: losses
    rtol 1e-5, every moment by norm within 1e-2 (the first step's flips
    change the next forwards: MMoE's moments read 3.6e-3 at most on an
    H100). DIN's ``att2.bias`` (true gradient 0) is held to |m| ≤ 1e-6."""
    cpu = torch.device("cpu")
    got, want = (_run(family, d, chip_smoke, "adam", steps=1) for d in (card, cpu))
    assert got[3] == got[4] == 1 and want[3] == want[4] == 0
    noise = {"att2.bias"} & set(want[1])
    moments, flips = {}, {}
    for k, mc in want[5]["m"].items():
        if k in noise:
            assert got[5]["m"][k].abs().max() <= 1e-6 and mc.abs().max() <= 1e-6, k
            continue
        moments[k] = max(_rel(got[5][s][k], want[5][s][k]) for s in ("m", "v"))
        above = mc.abs() >= 1e-3 * mc.abs().max()
        flips[k] = float((got[1][k] - want[1][k])[above].abs().max()) / ADAM_LR
    cache = {k: float((got[2][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
             for k, v in want[2].items() if v.numel()}
    got3, want3 = (_run(family, d, chip_smoke, "adam") for d in (card, cpu))
    moments3 = {k: max(_rel(got3[5][s][k], want3[5][s][k]) for s in ("m", "v"))
                for k in want3[5]["m"] if k not in noise}
    for k in noise:
        assert got3[5]["m"][k].abs().max() <= 1e-6 and want3[5]["m"][k].abs().max() <= 1e-6, k
    worst = lambda d: f"{max(d.values()):.3e} ({max(d, key=d.get)})"
    # the params whose 3-step update differs by norm beyond 1e-3: not held
    spread = {k: f"{_rel(got3[1][k], v):.3e}" for k, v in want3[1].items()
              if k not in noise and _rel(got3[1][k], v) > 1e-3}
    print(f"{family} adam: step 1 moments {worst(moments)}, update/lr {worst(flips)}, cache "
          f"{worst(cache)}; 3 steps moments {worst(moments3)}, losses "
          f"{max(abs(a - b) / abs(b) for a, b in zip(got3[0], want3[0])):.3e}, updates by "
          f"norm beyond 1e-3 {spread}")
    assert max(moments.values()) <= 1e-4, moments
    assert max(flips.values()) <= 1e-3, flips
    assert max(cache.values()) <= 1e-4, cache
    np.testing.assert_allclose(got3[0], want3[0], rtol=1e-5)
    assert max(moments3.values()) <= 1e-2, moments3


@pytest.mark.cuda
def test_chip_smoke_phase_23_small_on_the_card(card, chip_smoke):
    """Phase 23 at a small size on the card: its own checks, with one B1
    and one merge a step and B1 bitwise on each family's first push."""
    rec = chip_smoke.phase_item9(card, "test")
    for family, r in rec["families"].items():
        assert r["launches"] == r["steps"] == chip_smoke.I9_STEPS, family
        assert r["b1"]["max_abs_err"] == 0.0, family


def test_chip_smoke_phase_23_on_the_cpu(chip_smoke):
    """Phase 23 end to end on the CPU at a small size (batch 256, 2,001
    items and 41 categories, histories of 10, 200 ids a slot): losses finite
    and falling, the exports served within ``EXPORT_TOL`` with no launch,
    the guard's discard and scope count, the dump, the collectives."""
    rec = chip_smoke.phase_item9(torch.device("cpu"), "cpu")
    assert sorted(rec["families"]) == ["din", "esmm", "mmoe"]
    for family, r in rec["families"].items():
        assert r["steps"] == chip_smoke.I9_STEPS and r["launches"] == 0 and r["b1"] == {}
        assert ("serve" in r) == (family != "mmoe")
        if "serve" in r:
            assert r["serve"]["max_abs_err"] <= chip_smoke.EXPORT_TOL
            assert r["serve"]["launches"] == 0
