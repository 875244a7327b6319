"""ERNIE-style transformer encoder, serial and over the hybrid mesh.

Port of ``paddle_tpu.models.ernie`` (BASELINE.md config 5, ERNIE-1.0
pretraining): token + position embeddings, pre-LN blocks of
self-attention and a GELU MLP (or a mixture of experts), a final
LayerNorm and the vocabulary projection, softmax cross entropy.

Parameters keep the JAX package's names (``embed.word_emb``,
``blocks.{i}.attn.qkv_w``, ``head.w``, …) and its ``[in, out]`` layout,
used as ``x @ w`` — not ``nn.Linear`` — so weights carry over name for
name with no transpose (``convert.ernie_params_from_jax``). The fused
QKV projection is head-major: ``y.reshape(B, L, H, 3, D)``, then
q, k, v = ``[..., 0/1/2, :]``.

The same layers run serially and as one rank's part of a
``dp``/``pp``/``cp``/``mp``/``ep`` layout inside
``ops.collectives.run_ranks``, as the JAX layers run serially and inside
``shard_map``: a layer derives its per-rank extents from the shapes of
the parameters it is handed (global, or this rank's shard as
:func:`partition_spec` cuts it), and an axis is active when the mesh
has it (``ops.collectives.axis_active``):

- **mp** (tensor parallel): vocab-sharded word embedding
  (:func:`_take_rows`) and head, head-sharded attention (QKV column-,
  output row-parallel) and a column→row MLP, each row-parallel product
  psummed over mp; :func:`parallel_cross_entropy` over vocab-sharded
  logits;
- **cp** (context parallel): position ids offset by the rank's sequence
  shard, attention by the ring over cp (``ring_flash_attention`` under
  the flash impl, ``ring_attention`` under einsum);
- **ep** (expert parallel): ``_MoEFFN`` banks sharded over ep, tokens
  exchanged by all-to-all.

Attention (``ErnieConfig.attn_impl``): ``"auto"`` runs the flash kernels
(``ops.flash_attention``) on a CUDA tensor and the einsum path on a CPU
tensor — the JAX package's rule with the card in the TPU's place;
``"flash"`` runs the flash path anywhere (its plain versions on the
CPU); ``"einsum"`` runs ``local_attention``/``ring_attention`` anywhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.enforce import InvalidArgumentError, enforce
from ..nn import Dropout, LayerNorm
from ..nn import functional as F
from ..ops import collectives as coll
from ..ops.flash_attention import flash_attention
from ..parallel.moe import top1_gate, top2_gate
from ..parallel.mp_layers import vocab_parallel_cross_entropy, vocab_parallel_lookup
from ..parallel.ring_attention import local_attention, ring_attention, ring_flash_attention

__all__ = ["Ernie", "ErnieBlock", "ErnieConfig", "ErnieEmbedding", "ErnieHead", "ErnieStage",
           "parallel_cross_entropy", "partition_spec"]

_ATTN_IMPLS = ("auto", "flash", "einsum")
_axis_active = coll.axis_active


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
    # MoE: 0 = dense FFN in every block
    num_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_gate: str = "gshard"      # gshard = top-2, switch = top-1
    # mesh axis names (None disables that parallelism even inside run_ranks)
    mp_axis: Optional[str] = "mp"
    cp_axis: Optional[str] = "cp"
    ep_axis: Optional[str] = "ep"
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _normal(shape, std: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


def _zeros(n: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n))


def _take_rows(table: torch.Tensor, ids: torch.Tensor, total_rows: int,
               axis: Optional[str]) -> torch.Tensor:
    """Row lookup on a (possibly) row-sharded table (``c_embedding``):
    each rank owns rows [rank·per, (rank+1)·per); an id outside them
    contributes zeros, and the partials are summed over ``axis``."""
    if not _axis_active(axis) or table.shape[0] == total_rows:
        return table[ids]
    return vocab_parallel_lookup(table, ids, axis)


def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                           axis: Optional[str] = "mp", pinned_vjp: bool = False) -> torch.Tensor:
    """Per-token cross entropy over full logits (serial) or, with ``axis``
    active and a vocab shard in the last dimension, over vocab-sharded
    logits (``parallel.mp_layers.vocab_parallel_cross_entropy``: a
    stop-gradient pmax, psums of the exponentials and of the picked
    logit). ``pinned_vjp`` is accepted for the JAX signature and has no
    effect: the JAX package pins the psums' VJP to get its shard_map
    transposes right, and here the ranks' one autograd graph gives a
    plain psum the right gradient."""
    per = logits.shape[-1]
    if not _axis_active(axis) or per == vocab_size:
        return F.cross_entropy(logits, labels, reduction="none")
    return vocab_parallel_cross_entropy(logits, labels, axis)


# name → the axis of each dimension (JAX's ``_SPEC_RULES``); "mp" stands
# for ``cfg.mp_axis``
_SPEC_RULES = {
    "word_emb": ("mp", None),
    "pos_emb": (None, None),
    "qkv_w": (None, "mp"),
    "qkv_b": ("mp",),
    "proj_w": ("mp", None),
    "gate_w": (None, None),
    "w_in": (None, "mp"),        # dense FFN; the 3-D MoE bank is told by its rank
    "b_in": ("mp",),
    "w_out": ("mp", None),
    "w": (None, "mp"),           # ErnieHead's vocabulary projection
}


def partition_spec(name: str, arr, cfg: ErnieConfig,
                   leading_pp: bool = False) -> Tuple[Optional[str], ...]:
    """The layout of parameter or buffer ``name`` (value ``arr``, anything
    with ``ndim``/``dim()``) over the mesh: one entry a dimension, the
    axis it is sharded over or None — JAX's ``PartitionSpec`` entries as
    a tuple. ``leading_pp``: the value is stage-stacked (the hybrid
    trainer stacks stages on a new leading dimension, sharded over
    ``pp``) and the rules apply to the trailing dimensions."""
    ndim = getattr(arr, "ndim", 0) - (1 if leading_pp else 0)
    base = name.rsplit(".", 1)[-1]
    dims: tuple = (None,) * ndim
    if base in ("w_in", "w_out") and ndim == 3:
        dims = (cfg.ep_axis, None, None)              # MoE expert bank
    elif base in _SPEC_RULES:
        spec = _SPEC_RULES[base]
        if len(spec) == ndim:
            dims = tuple(cfg.mp_axis if a == "mp" else a for a in spec)
    if leading_pp:
        dims = ("pp",) + dims
    return dims


class ErnieEmbedding(nn.Module):
    """Token (vocab-parallel over mp) + position embeddings, LayerNorm,
    dropout. Position ids are offset by the cp rank's sequence-shard
    start."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_emb = _normal((cfg.vocab_size, h), 1.0 / np.sqrt(h), generator)
        self.pos_emb = _normal((cfg.max_seq_len, h), 0.02, generator)
        self.ln = LayerNorm(h)
        self.drop = Dropout(cfg.dropout)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _take_rows(self.word_emb, ids, cfg.vocab_size, cfg.mp_axis)
        L = ids.shape[-1]
        start = coll.axis_index(cfg.cp_axis) * L if _axis_active(cfg.cp_axis) else 0
        x = x + self.pos_emb[start:start + L]
        return self.drop(self.ln(x))


class _SelfAttention(nn.Module):
    """Head-sharded attention: the QKV weight is column-parallel in the
    head-major layout ``(h, H·3·D)``, so a contiguous mp split hands each
    rank whole heads; the output projection is row-parallel, psummed over
    mp. Under an active cp axis, the ring over cp."""

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
        H = y.shape[-1] // (3 * D)                    # this rank's heads
        y = y.reshape(y.shape[0], L, H, 3, D)
        q, k, v = y[..., 0, :], y[..., 1, :], y[..., 2, :]
        impl = cfg.attn_impl
        if impl == "auto":
            impl = "flash" if x.device.type == "cuda" else "einsum"
        if _axis_active(cfg.cp_axis):
            ring = ring_flash_attention if impl == "flash" else ring_attention
            out = ring(q, k, v, axis=cfg.cp_axis, causal=cfg.causal)
        elif impl == "flash":
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=cfg.causal)
        else:
            out = local_attention(q, k, v, causal=cfg.causal)
        proj = out.reshape(out.shape[0], L, H * D) @ self.proj_w
        if _axis_active(cfg.mp_axis) and self.proj_w.shape[0] != cfg.hidden_size:
            proj = coll.psum(proj, cfg.mp_axis)
        proj = proj + self.proj_b
        return proj.reshape(*lead, L, cfg.hidden_size)


class _DenseFFN(nn.Module):
    """Column→row parallel MLP, psummed over mp on the way back."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        h, f = cfg.hidden_size, cfg.ffn_size
        self.w_in = _normal((h, f), 1.0 / np.sqrt(h), generator)
        self.b_in = _zeros(f)
        self.w_out = _normal((f, h), 1.0 / np.sqrt(f), generator)
        self.b_out = _zeros(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        y = F.gelu(x @ self.w_in + self.b_in) @ self.w_out
        if _axis_active(cfg.mp_axis) and self.w_out.shape[0] != cfg.ffn_size:
            y = coll.psum(y, cfg.mp_axis)
        return y + self.b_out


class _MoEFFN(nn.Module):
    """Expert-parallel FFN with global-shape expert banks ``(E, h, f)``
    sharded over ep (the gates of ``parallel.moe``): tokens go densely
    into capacity buffers, all-to-all over ep, through the local expert
    bank as one batched product, and back. The gate's load-balancing loss
    of the last forward is the ``aux_loss`` buffer."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        h, f, E = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
        self.gate_w = _normal((h, E), 0.01, generator)
        self.w_in = _normal((E, h, f), 1.0 / np.sqrt(h), generator)
        self.w_out = _normal((E, f, h), 1.0 / np.sqrt(f), generator)
        self.register_buffer("aux_loss", torch.zeros(()))
        self.gate_fn = top2_gate if cfg.moe_gate == "gshard" else top1_gate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        E = cfg.num_experts
        lead = x.shape[:-1]
        xt = x.reshape(-1, cfg.hidden_size)                     # [T, h]
        top_k = 2 if self.gate_fn is top2_gate else 1
        C = max(4, int(math.ceil(xt.shape[0] * top_k * cfg.moe_capacity_factor / E)))
        dispatch, combine, aux = self.gate_fn(xt @ self.gate_w, C)
        self.aux_loss = aux
        buf = torch.einsum("tec,td->ecd", dispatch, xt)         # [E, C, h]
        active = _axis_active(cfg.ep_axis) and self.w_in.shape[0] != E
        if active:
            buf = coll.all_to_all(buf, cfg.ep_axis, split_axis_=0, concat_axis=1)
        hmid = F.gelu(torch.einsum("ecd,edf->ecf", buf, self.w_in))
        out = torch.einsum("ecf,efd->ecd", hmid, self.w_out)
        if active:
            out = coll.all_to_all(out, cfg.ep_axis, split_axis_=1, concat_axis=0)
        y = torch.einsum("tec,ecd->td", combine, out)
        return y.reshape(*lead, cfg.hidden_size)


class ErnieBlock(nn.Module):
    """Pre-LN transformer block; the FFN is MoE when ``num_experts > 0``,
    so every block (and every pipeline stage) has one structure."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size)
        self.attn = _SelfAttention(cfg, generator)
        self.ln2 = LayerNorm(cfg.hidden_size)
        self.ffn = _MoEFFN(cfg, generator) if cfg.num_experts > 0 else _DenseFFN(cfg, generator)
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
    """Final LayerNorm + vocabulary projection, column-parallel over mp so
    the logits come out vocab-sharded for :func:`parallel_cross_entropy`."""

    def __init__(self, cfg: ErnieConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.ln = LayerNorm(h)
        self.w = _normal((h, cfg.vocab_size), 1.0 / np.sqrt(h), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x) @ self.w


class Ernie(nn.Module):
    """The whole model (the serial form): embed → blocks → head;
    ``generator`` draws the initial weights."""

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
        ce = parallel_cross_entropy(self(ids), labels, self.cfg.vocab_size, self.cfg.mp_axis)
        return ce.mean()
