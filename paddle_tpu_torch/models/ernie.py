"""ERNIE-style transformer encoder, trained on one card.

Port of the serial path of ``paddle_tpu.models.ernie`` (BASELINE.md
config 5, ERNIE-1.0 pretraining): token + position embeddings, pre-LN
blocks of self-attention and a GELU MLP, a final LayerNorm and the
vocabulary projection, softmax cross entropy.

Parameters keep the JAX package's names (``embed.word_emb``,
``blocks.{i}.attn.qkv_w``, ``head.w``, …) and its ``[in, out]`` layout,
used as ``x @ w`` — not ``nn.Linear`` — so weights carry over name for
name with no transpose (``convert.ernie_params_from_jax``). The fused
QKV projection is head-major: ``y.reshape(B, L, H, 3, D)``, then
q, k, v = ``[..., 0/1/2, :]``.

Attention (``ErnieConfig.attn_impl``): ``"auto"`` runs the flash kernels
(``ops.flash_attention``) on a CUDA tensor and ``local_attention`` on a
CPU tensor — the JAX package's rule with the card in the TPU's place;
``"flash"`` runs ``flash_attention`` anywhere (its plain versions on the
CPU); ``"einsum"`` runs ``local_attention`` anywhere.

Not in this slice (each raises ``InvalidArgumentError``): MoE blocks
(``num_experts > 0``), tensor/sequence/expert parallelism (vocab-sharded
logits in :func:`parallel_cross_entropy`, :func:`partition_spec`). The
JAX config's MoE gate and mesh-axis fields wait for those slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.enforce import InvalidArgumentError, enforce
from ..nn import Dropout, LayerNorm
from ..nn import functional as F
from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import local_attention

__all__ = ["Ernie", "ErnieBlock", "ErnieConfig", "ErnieEmbedding", "ErnieHead", "ErnieStage",
           "parallel_cross_entropy", "partition_spec"]

_ATTN_IMPLS = ("auto", "flash", "einsum")


@dataclasses.dataclass
class ErnieConfig:
    vocab_size: int = 8192
    hidden_size: int = 256
    num_heads: int = 8
    ffn_size: int = 1024
    num_layers: int = 4
    max_seq_len: int = 512
    causal: bool = False          # False = encoder (ERNIE); True = GPT-style
    dropout: float = 0.0
    num_experts: int = 0          # MoE blocks are not in this slice
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _normal(shape, std: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


def _zeros(n: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n))


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           vocab_size: int) -> torch.Tensor:
    """Per-token cross entropy over full logits (the serial path of the
    JAX function). Vocab-sharded logits need the mp path, which is not in
    this slice."""
    enforce(logits.shape[-1] == vocab_size,
            f"parallel_cross_entropy: logits carry {logits.shape[-1]} of {vocab_size} classes; "
            f"vocab-sharded logits need tensor parallelism, which this port does not have yet",
            InvalidArgumentError)
    return F.cross_entropy(logits, labels, reduction="none")


def partition_spec(*args, **kwargs):
    """Mesh sharding specs belong to the parallel layouts (tp/cp/ep/pp),
    which are not in this slice of the port."""
    raise InvalidArgumentError("partition_spec: ERNIE's mesh layouts (tp/cp/ep/pp) are not "
                               "ported yet; the port trains the serial model on one card")


class ErnieEmbedding(nn.Module):
    """Token + position embeddings, LayerNorm, dropout."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_emb = _normal((cfg.vocab_size, h), 1.0 / np.sqrt(h), generator)
        self.pos_emb = _normal((cfg.max_seq_len, h), 0.02, generator)
        self.ln = LayerNorm(h)
        self.drop = Dropout(cfg.dropout)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.word_emb[ids]
        x = x + self.pos_emb[: ids.shape[-1]]
        return self.drop(self.ln(x))


class _SelfAttention(nn.Module):
    """Fused head-major QKV projection, attention, output projection."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        h, D = cfg.hidden_size, cfg.head_dim
        s = 1.0 / np.sqrt(h)
        self.qkv_w = _normal((h, cfg.num_heads * 3 * D), s, generator)
        self.qkv_b = _zeros(cfg.num_heads * 3 * D)
        self.proj_w = _normal((h, h), s, generator)
        self.proj_b = _zeros(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        D = cfg.head_dim
        lead, L = x.shape[:-2], x.shape[-2]
        y = x.reshape(-1, L, cfg.hidden_size) @ self.qkv_w + self.qkv_b
        H = y.shape[-1] // (3 * D)
        y = y.reshape(y.shape[0], L, H, 3, D)
        q, k, v = y[..., 0, :], y[..., 1, :], y[..., 2, :]
        impl = cfg.attn_impl
        if impl == "auto":
            impl = "flash" if x.device.type == "cuda" else "einsum"
        if impl == "flash":
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=cfg.causal)
        else:
            out = local_attention(q, k, v, causal=cfg.causal)
        out = out.reshape(out.shape[0], L, H * D) @ self.proj_w + self.proj_b
        return out.reshape(*lead, L, cfg.hidden_size)


class _DenseFFN(nn.Module):
    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_size
        self.w_in = _normal((h, f), 1.0 / np.sqrt(h), generator)
        self.b_in = _zeros(f)
        self.w_out = _normal((f, h), 1.0 / np.sqrt(f), generator)
        self.b_out = _zeros(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x @ self.w_in + self.b_in) @ self.w_out + self.b_out


class ErnieBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        enforce(cfg.num_experts == 0,
                "ERNIE with MoE blocks (num_experts > 0, _MoEFFN over an ep axis) is not "
                "ported yet", InvalidArgumentError)
        self.ln1 = LayerNorm(cfg.hidden_size)
        self.attn = _SelfAttention(cfg, generator)
        self.ln2 = LayerNorm(cfg.hidden_size)
        self.ffn = _DenseFFN(cfg, generator)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop(self.attn(self.ln1(x)))
        return x + self.drop(self.ffn(self.ln2(x)))


class ErnieStage(nn.Module):
    """``blocks_per_stage`` consecutive blocks (a pipeline stage)."""

    def __init__(self, cfg: ErnieConfig, blocks_per_stage: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.blocks = nn.ModuleList([ErnieBlock(cfg, generator)
                                     for _ in range(blocks_per_stage)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for b in self.blocks:
            x = b(x)
        return x


class ErnieHead(nn.Module):
    """Final LayerNorm + vocabulary projection."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.ln = LayerNorm(h)
        self.w = _normal((h, cfg.vocab_size), 1.0 / np.sqrt(h), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x) @ self.w


class Ernie(nn.Module):
    """Embed → blocks → head; ``generator`` draws the initial weights."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        enforce(cfg.attn_impl in _ATTN_IMPLS,
                f"attn_impl must be one of {_ATTN_IMPLS}, got {cfg.attn_impl!r}",
                InvalidArgumentError)
        self.cfg = cfg
        self.embed = ErnieEmbedding(cfg, generator)
        self.blocks = nn.ModuleList([ErnieBlock(cfg, generator) for _ in range(cfg.num_layers)])
        self.head = ErnieHead(cfg, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(ids)
        for b in self.blocks:
            x = b(x)
        return self.head(x)

    def loss(self, ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        ce = parallel_cross_entropy(self(ids), labels, self.cfg.vocab_size)
        return ce.mean()
