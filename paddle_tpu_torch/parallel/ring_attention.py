"""Attention over local blocks, and context parallelism over a ``cp`` axis.

Port of ``paddle_tpu.parallel.ring_attention``:

- :func:`local_attention`: plain softmax attention on local blocks — the
  einsum path for ERNIE off the card, and the oracle of the
  flash-attention kernels (``ops.flash_attention``);
- :func:`ring_attention`: Q stays put, K/V blocks rotate around the
  ring (``shift`` over the axis) while an online softmax merges the
  blocks, einsum per block;
- :func:`ring_flash_attention`: the same ring with the flash kernels per
  hop (B5 forward, B6/B7 backward through ``flash_attention_with_lse``),
  each hop at its global query and key offsets, partial results merged
  by their log-sum-exp — so the backward feeds an lse cotangent (dlse)
  into B6 and B7;
- :func:`ulysses_attention`: an all-to-all from sequence to heads, exact
  local attention per head group, and back.

The last three run inside ``ops.collectives.run_ranks`` over a mesh
with the named axis; q, k, v are this rank's sequence shard
[B, L_local, H, D], and shard r holds global positions
[r·L_local, (r+1)·L_local).
"""

from __future__ import annotations

import torch

from ..core.enforce import enforce_eq
from ..ops import collectives as coll

__all__ = ["local_attention", "ring_attention", "ring_flash_attention", "ulysses_attention"]

NEG = -1e30


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Softmax attention in the [B, L, H, D] layout, in the inputs' type.
    ``causal`` masks key positions ``k_offset + j`` above query positions
    ``q_offset + i``; a row with no key left is NaN, as in the JAX
    package."""
    D = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=q.dtype))  # rounded as jnp does
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale.to(q.device)
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :] + k_offset
        scores = torch.where(ki <= qi, scores,
                             torch.tensor(float("-inf"), dtype=scores.dtype, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis: str = "cp", causal: bool = False,
                         precision: str = "default") -> torch.Tensor:
    """Ring attention whose per-hop block attention is the flash kernels:
    after i hops this rank holds the K/V block of rank (rank − i) mod P,
    computes (out_i, lse_i) for it with ``flash_attention_with_lse`` at
    q_offset rank·L and k_offset src·L, and merges it into the carry by
    log-add-exp. The carry's lse starts at NEG (−1e30), so a hop whose
    keys all lie in every query's future (causal; its out 0 and lse NEG)
    weighs nothing. P − 1 shifts, each after a merge, then the last
    merge."""
    from ..ops.flash_attention import flash_attention_with_lse

    P = coll.axis_size(axis)
    rank = coll.axis_index(axis)
    B, L, H, D = q.shape
    q = q.contiguous()

    def merge(out, lse, k_cur, v_cur, i):
        src = (rank - i) % P
        o_i, lse_i = flash_attention_with_lse(q, k_cur, v_cur, causal=causal,
                                              q_offset=rank * L, k_offset=src * L,
                                              precision=precision)
        lse_new = torch.logaddexp(lse, lse_i)
        w_prev = torch.exp(lse - lse_new)
        w_cur = torch.exp(lse_i - lse_new)
        out_new = out * w_prev[..., None].to(out.dtype) + o_i * w_cur[..., None].to(out.dtype)
        return out_new, lse_new

    out = torch.zeros_like(q)
    lse = torch.full((B, L, H), NEG, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for i in range(P - 1):
        out, lse = merge(out, lse, k_cur, v_cur, i)
        k_cur, v_cur = coll.shift(k_cur, axis, 1), coll.shift(v_cur, axis, 1)
    out, _ = merge(out, lse, k_cur, v_cur, P - 1)
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = "cp", causal: bool = False) -> torch.Tensor:
    """Blockwise ring attention with an einsum per block: rotates K/V
    around the ring, merging blocks with a numerically stable online
    softmax in f32. A masked score is −1e30; a row whose running maximum
    is still below −5e29 (every key so far masked) contributes zero, so a
    fully masked block (causal, a later rank's keys) adds nothing."""
    P = coll.axis_size(axis)
    rank = coll.axis_index(axis)
    B, L, H, D = q.shape
    dev = q.device
    scale = (1.0 / torch.sqrt(torch.tensor(D, dtype=q.dtype))).to(dev)
    q_off = rank * L
    neg_big = torch.tensor(NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def merge_block(out, m, denom, k_cur, v_cur, i):
        src = (rank - i) % P   # whose K/V block this rank holds now
        scores = (torch.einsum("bqhd,bkhd->bhqk", q, k_cur) * scale).float()
        if causal:
            qi = torch.arange(L, device=dev)[:, None] + q_off
            ki = torch.arange(L, device=dev)[None, :] + src * L
            scores = torch.where(ki <= qi, scores, neg_big)
        m_new = torch.maximum(m, scores.amax(dim=-1))                  # [B, H, Lq]
        # guard fully masked rows: exp(neg_big - neg_big) would be 1
        alive = m_new > neg_big * 0.5
        p = torch.where(alive[..., None], torch.exp(scores - m_new[..., None]), zero)
        corr = torch.where(alive, torch.exp(m - m_new), zero)
        denom_new = denom * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v_cur)
        out_new = out * corr.transpose(1, 2)[..., None] + pv
        return out_new, m_new, denom_new

    out = torch.zeros_like(q)
    m = torch.full((B, H, L), NEG, dtype=torch.float32, device=dev)
    denom = torch.zeros((B, H, L), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    # P-1 rotate-and-merge steps, then the last block's merge: the last
    # rotation's result would be discarded
    for i in range(P - 1):
        out, m, denom = merge_block(out, m, denom, k_cur, v_cur, i)
        k_cur, v_cur = coll.shift(k_cur, axis, 1), coll.shift(v_cur, axis, 1)
    out, m, denom = merge_block(out, m, denom, k_cur, v_cur, P - 1)
    denom = torch.clamp_min(denom, 1e-30)
    return out / denom.transpose(1, 2)[..., None].to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: str = "cp", causal: bool = False) -> torch.Tensor:
    """Ulysses: all-to-all from the sequence shard to a head shard
    ([B, L, H, D] → [B, L·P, H/P, D]), exact :func:`local_attention` over
    the whole sequence (causal needs no offsets), and back. Needs
    H % P == 0."""
    Pn = coll.axis_size(axis)
    H = q.shape[2]
    enforce_eq(H % Pn, 0, "heads must divide cp size for ulysses")

    def seq_to_heads(x):
        return coll.all_to_all(x, axis, split_axis_=2, concat_axis=1)

    out = local_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v), causal=causal)
    return coll.all_to_all(out, axis, split_axis_=1, concat_axis=2)
