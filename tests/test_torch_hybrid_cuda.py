"""The hybrid path's kernels on a card: B5–B7 at a ring hop's offsets, and
a small hybrid trainer on the card against the CPU.

Every test here is ``cuda``-marked and skips without a CUDA device; the
file imports neither jax nor ``paddle_tpu`` (``pytest --noconftest -m
cuda`` runs it on a machine without them). The plain versions run on the
same card (cuBLAS f32, TF32 off).

Tolerances: the hop kernels as in ``test_torch_flash_attention_cuda.py``
("default": 2e-2 on out and the gradients, 1e-4 on lse), the fully
masked hop exactly (out, dQ, dK, dV 0, lse NEG). The small trainer, 3
Adam steps card (kernels) vs CPU (plain versions) from the same weights:
losses rtol 1e-4, each tensor's update within 5e-2 of the CPU's in norm
with the key bias left out (its true gradient is 0, so Adam moves it on
rounding noise), as ``chip_smoke.py`` phase 8 holds the serial model.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.mesh import make_mesh
from paddle_tpu_torch.models.ernie import ErnieConfig
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel.hybrid import HybridParallelTrainer, flatten_tree

HOP = (2, 256, 4, 64)      # [B, L a rank, H a rank, D]
MESH = {"dp": 1, "pp": 2, "cp": 2, "mp": 2}
SMALL = dict(vocab_size=512, hidden_size=64, num_heads=4, ffn_size=128, num_layers=2,
             max_seq_len=64)


@pytest.fixture(autouse=True)
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(256, 0), (256, 256), (0, 256)], ids=str)
def test_ring_hop_kernels_match_plain(offsets):
    qo, ko = offsets
    B, L, H, D = HOP
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.normal(size=HOP).astype(np.float32)).cuda()
                   for _ in range(4))
    dlse = torch.from_numpy(rng.normal(size=(B, L, H)).astype(np.float32)).cuda()
    kw = dict(causal=True, q_offset=qo, k_offset=ko)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = ((do * out).sum(-1) - dlse).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    w_out, w_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    for got, want, tol in ((out, w_out, 2e-2), (lse, w_lse, 1e-4), (dq, w_dq, 2e-2),
                           (dk, w_dk, 2e-2), (dv, w_dv, 2e-2)):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= tol
    if qo + L - 1 < ko:
        assert all(bool((t == 0).all()) for t in (out, dq, dk, dv))
        assert bool((lse == fa.NEG).all())


def _run(device, causal, impl):
    cfg = ErnieConfig(**SMALL, causal=causal, attn_impl=impl)
    tr = HybridParallelTrainer(cfg, make_mesh(MESH, device=device), Adam(1e-3), seed=4,
                               device=device)
    start = {k: v.cpu().clone() for k, v in flatten_tree(tr.params).items()}
    rng = np.random.default_rng(9)
    losses = []
    for _ in range(3):
        ids, labels = (torch.from_numpy(rng.integers(0, SMALL["vocab_size"], (4, 64)))
                       for _ in range(2))
        losses.append(float(tr.train_step(ids.to(device), labels.to(device))))
    return np.asarray(losses), start, {k: v.cpu() for k, v in flatten_tree(tr.params).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_small_hybrid_card_matches_cpu_and_counts(causal):
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        getattr(fa, f"flash_attention_{name}").launches = 0
    gl, w0, gp = _run("cuda", causal, "auto")
    # 3 steps x 8 ranks x (3 ticks for B5, the 2 valid ones for B6/B7) x
    # 1 block a stage x 2 hops
    assert fa.flash_attention_fwd.launches == 3 * 8 * 3 * 1 * 2
    assert fa.flash_attention_bwd_dq.launches == 3 * 8 * 2 * 1 * 2
    assert fa.flash_attention_bwd_dkv.launches == 3 * 8 * 2 * 1 * 2
    cl, c0, cp = _run("cpu", causal, "flash")
    assert all(torch.equal(w0[k], c0[k]) for k in w0)
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    H, D = SMALL["num_heads"], SMALL["hidden_size"] // SMALL["num_heads"]
    for k, s in w0.items():
        dg, dc = gp[k] - s, cp[k] - s
        if k.endswith("attn.qkv_b"):
            dg, dc = (d.reshape(-1, H, 3, D)[:, :, [0, 2]] for d in (dg, dc))
        if float(dc.norm()) > 0:
            assert float((dg - dc).norm() / dc.norm()) <= 5e-2, k
