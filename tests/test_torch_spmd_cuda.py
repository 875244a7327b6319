"""Dense data parallel and ZeRO through ``chip_smoke.py`` phase 26 at a small
size.

``test_spmd_leg_b_on_the_card`` (``cuda``: skips without a card) runs phase
26's leg B as the script does: fused int8 and fused ZeRO-2 over
``{"dp": 4}`` and the hybrid trainer's sh mesh, card (the kernels) against
the CPU (their plain versions) within ``SPMD_TOL``, the sh mesh against the
dp mesh without sh within ``SPMD_SH_TOL``; then the sh mesh's steps at the
size below. ``test_chip_smoke_phase_26_on_the_cpu`` runs the whole phase on
the CPU: ERNIE at hidden 64, 4 heads, ffn 128, 4 layers, seq 64, batch 8
with ``attn_impl="flash"`` (the plain versions of B5–B7, wrapped to count
their calls in place of the card's launch counters, so the phase's launch
formulas are checked), the card's memory counters stubbed out. The file
imports neither jax nor ``paddle_tpu`` (``pytest --noconftest -m cuda``
runs it on a machine without them).
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(ERNIE_CFG=dict(vocab_size=1024, hidden_size=64, num_heads=4, ffn_size=128,
                            num_layers=4, max_seq_len=64),
             ERNIE_SEQ=64, PIPE_HOP=(2, 64, 4, 16), SPMD_RANK=(2, 64, 4, 16))


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


@pytest.mark.cuda
def test_spmd_leg_b_on_the_card(chip_smoke):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    worst = chip_smoke.spmd_leg_b(dev, "card")
    for what in ("int8 fused", "zero2 fused", "sh"):
        assert worst[what]["loss"] <= chip_smoke.SPMD_TOL["loss"]
        assert worst[what]["update"] <= chip_smoke.SPMD_TOL["update"]
    assert worst["sh"]["vs_dp_loss"] <= chip_smoke.SPMD_SH_TOL
    rec = chip_smoke.spmd_sh_full_width(dev, "card")
    assert len(rec["losses"]) == chip_smoke.SPMD_SH_STEPS


def test_chip_smoke_phase_26_on_the_cpu(chip_smoke, monkeypatch):
    from paddle_tpu_torch.ops import flash_attention as fa

    def counting(fn):
        def wrapped(*a, **k):
            wrapped.launches += 1
            return fn(*a, **k)

        wrapped.launches = 0
        return wrapped

    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        monkeypatch.setattr(fa, name, counting(getattr(fa, name)))
    monkeypatch.setattr(chip_smoke, "ERNIE_CFG", {**SMALL["ERNIE_CFG"], "attn_impl": "flash"})
    for name in ("reset_peak_memory_stats", "empty_cache", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # the rank threads are the parallelism
    try:
        rec = chip_smoke.phase_spmd(torch.device("cpu"), "cpu")
    finally:
        torch.set_num_threads(threads)
    L, K = SMALL["ERNIE_CFG"]["num_layers"], chip_smoke.SPMD_MESH["dp"]
    steps = chip_smoke.SPMD_WARM + chip_smoke.SPMD_STEPS
    fused = sum(1 for _, _, comm, _ in chip_smoke.spmd_rungs() if comm is not None)
    assert rec["counts"] == {k: fused * steps * L * K for k in rec["counts"]}
    assert set(rec["leg_a"]["rungs"]) == {r[0] for r in chip_smoke.spmd_rungs()}
    assert rec["leg_b"]["sh"]["vs_dp_loss"] <= chip_smoke.SPMD_SH_TOL
