"""Flash attention: three CUDA kernels and their plain PyTorch versions.

Port of ``paddle_tpu.ops.flash_attention``. Layout [B, L, H, D] in and
out; ``lse`` is [B, L, H] f32. Three kernels carry it, each behind a
wrapper that dispatches on the tensors' device:

- :func:`flash_attention_fwd` (B5) — out and the per-row log-sum-exp;
- :func:`flash_attention_bwd_dq` (B6) — dQ from P recomputed from lse;
- :func:`flash_attention_bwd_dkv` (B7) — dK and dV.

On a CUDA tensor a wrapper launches its kernel (``ops/csrc/flash_attention.cu``,
nvcc ``sm_90a``, built at first use) and counts one in ``<fn>.launches``;
on a CPU tensor it runs the plain version. There is no fallback between
the two. :func:`flash_attention` and :func:`flash_attention_with_lse`
put the three behind one ``torch.autograd.Function``; the lse cotangent
folds into ``delta`` (``dS = P * (dP - delta + dlse)``), as in the JAX
package.

Numerics (``precision``): ``"default"`` rounds Q, K, V, dO, P and dS to
bf16 before each product and does everything else in f32 (the MXU's
bf16-in, f32-accumulate contract, kept on the tensor cores);
``"highest"`` keeps every operand f32. The scale 1/sqrt(D) multiplies
the f32 product. A masked score is ``NEG``; a row with no key left has
lse ``NEG`` and output 0. The plain versions compute the whole score
matrix with the same roundings (the JAX kernels at L ≤ 512 run one key
block, so the plain forward is the JAX forward's order of operations);
the forward kernel runs an online softmax over 64-key tiles, so P rounds
to bf16 against a running maximum and the two differ by bf16 rounding of
P. The backward kernels recompute P from lse (as ``exp2`` of an FMA on
log2(e)-prescaled operands) and differ from the plain versions only in
the order of their f32 sums.

The backward kernels are built for Hopper: each block owns 128 rows
(query rows for B6, key rows for B7, one warpgroup per 64) and streams
the other side through a two-stage ring of 32-row tiles filled by
``cp.async``; each landed tile is converted to bf16 once, into the
core-matrix layout that the warpgroup products (``wgmma``) read, while
the previous tile's products run (the source note in
``flash_attention.cu`` has the budget). Each output row is written by one
block, with no atomics, so two runs give the same bits.

Keys are masked by their true length. The JAX package pads K and V to
its block (``_run_padded``) and masks by the padded length, so its
non-causal attention at a length that is not a multiple of 8 admits the
zero-padded keys; the port does not copy that.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from typing import Optional, Tuple

import torch

from ..core.enforce import InvalidArgumentError, enforce
from ._build import build_cuda_library

__all__ = ["NEG", "flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_with_lse", "load_flash_kernels"]

NEG = -1e30
_F32, _BF16 = torch.float32, torch.bfloat16
_PRECISIONS = ("default", "highest")

# -- plain versions ------------------------------------------------------


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product sees it, in f32: rounded to bf16 for "default"."""
    x = x.to(_F32)
    return x.to(_BF16).to(_F32) if precision == "default" else x


def _causal_mask(Lq: int, Lk: int, q_offset: int, k_offset: int,
                 device: torch.device) -> torch.Tensor:
    rows = torch.arange(Lq, device=device)[:, None] + q_offset
    cols = torch.arange(Lk, device=device)[None, :] + k_offset
    return cols <= rows                                   # [Lq, Lk]


def _scores(q, k, precision):
    """S = (Q K^T) * scale, [B, H, Lq, Lk] f32, the scale after the product."""
    s = torch.einsum("bqhd,bkhd->bhqk", _operand(q, precision), _operand(k, precision))
    return s * (1.0 / math.sqrt(q.shape[-1]))


def flash_attention_fwd_plain(q, k, v, causal=False, q_offset=0, k_offset=0,
                              precision="default") -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole score matrix at once: (out [B, Lq, H, D] in q's type,
    lse [B, Lq, H] f32)."""
    B, Lq, H, D = q.shape
    if k.shape[1] == 0:
        return (torch.zeros_like(q),
                torch.full((B, Lq, H), NEG, dtype=_F32, device=q.device))
    s = _scores(q, k, precision)
    mask = _causal_mask(Lq, k.shape[1], q_offset, k_offset, q.device) if causal else None
    zero = torch.zeros((), dtype=_F32, device=q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full((), NEG, dtype=_F32, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, zero)
    l = p.sum(dim=-1, keepdim=True)                       # [B, H, Lq, 1]
    acc = torch.einsum("bhqk,bkhd->bqhd", _operand(p, precision), _operand(v, precision))
    lc = l.clamp_min(1e-30)
    out = acc / lc.permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m + torch.log(lc), torch.full((), NEG, dtype=_F32, device=q.device))
    return out.to(q.dtype), lse[..., 0].permute(0, 2, 1).contiguous()


def _bwd_terms(q, k, v, dout, lse, delta, causal, q_offset, k_offset, precision):
    """P recomputed from lse, and dS = P * (dP - delta), [B, H, Lq, Lk]."""
    s = _scores(q, k, precision)
    lse4 = lse.permute(0, 2, 1)[..., None]
    ok = lse4 > NEG / 2
    if causal:
        ok = ok & _causal_mask(q.shape[1], k.shape[1], q_offset, k_offset, q.device)
    p = torch.where(ok, torch.exp(s - lse4), torch.zeros((), dtype=_F32, device=q.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", _operand(dout, precision), _operand(v, precision))
    return p, p * (dp - delta.permute(0, 2, 1)[..., None])


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal=False, q_offset=0,
                                 k_offset=0, precision="default") -> torch.Tensor:
    """dQ = (dS K) * scale, in q's type."""
    _, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, q_offset, k_offset, precision)
    dq = torch.einsum("bhqk,bkhd->bqhd", _operand(ds, precision), _operand(k, precision))
    return (dq * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, causal=False, q_offset=0,
                                  k_offset=0, precision="default"):
    """(dK = (dS^T Q) * scale, dV = P^T dO), in k's and v's types."""
    p, ds = _bwd_terms(q, k, v, dout, lse, delta, causal, q_offset, k_offset, precision)
    dv = torch.einsum("bhqk,bqhd->bkhd", _operand(p, precision), _operand(dout, precision))
    dk = torch.einsum("bhqk,bqhd->bkhd", _operand(ds, precision), _operand(q, precision))
    return (dk * (1.0 / math.sqrt(q.shape[-1]))).to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels -----------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def load_flash_kernels() -> ctypes.CDLL:
    """Build (first use) and load ``flash_attention.cu``; raises on failure.
    It builds with the port's common nvcc flags (``--fmad=false``): the
    tensor-core path does not care, the f32 path calls ``fmaf`` itself."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_cuda_library(
                "flash_attention", os.path.join(_CSRC, "flash_attention.cu")))
            p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            tail = [i32] * 10 + [f32, p]      # B H Lq Lk D causal q_off k_off highest bf16
            lib.flash_fwd_launch.restype = i32
            lib.flash_fwd_launch.argtypes = [p] * 5 + tail
            lib.flash_bwd_dq_launch.restype = i32
            lib.flash_bwd_dq_launch.argtypes = [p] * 7 + tail
            lib.flash_bwd_dkv_launch.restype = i32
            lib.flash_bwd_dkv_launch.argtypes = [p] * 8 + tail
            _LIB = lib
        return _LIB


def _check_args(q, k, v, precision) -> None:
    enforce(precision in _PRECISIONS,
            f"precision must be one of {_PRECISIONS}, got {precision!r}", InvalidArgumentError)
    enforce(q.dim() == 4 and k.dim() == 4 and tuple(k.shape) == tuple(v.shape)
            and k.shape[0] == q.shape[0] and tuple(k.shape[2:]) == tuple(q.shape[2:]),
            f"flash attention: q [B, Lq, H, D] and k, v [B, Lk, H, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}", InvalidArgumentError)


def _cuda_args(name: str, tensors, q, precision, causal, q_offset, k_offset) -> list:
    """Validate CUDA inputs; the launch's trailing arguments."""
    dev = q.device
    enforce(dev.type == "cuda", f"{name}: no kernel for device {dev}", InvalidArgumentError)
    dt = q.dtype
    enforce(dt in (_F32, _BF16), f"{name}: f32 or bf16 inputs, got {dt}", InvalidArgumentError)
    for t in tensors:
        enforce(t.device == dev, f"{name}: all tensors must be on one device",
                InvalidArgumentError)
        enforce(t.is_contiguous(), f"{name}: inputs must be contiguous", InvalidArgumentError)
        # the kernels load four elements of a row at a time
        enforce(t.dim() < 4 or t.data_ptr() % 16 == 0,
                f"{name}: [B, L, H, D] inputs must start on a 16-byte boundary",
                InvalidArgumentError)
    B, Lq, H, D = q.shape
    Lk = tensors[1].shape[1]
    enforce(D % 8 == 0 and 8 <= D <= 128,
            f"{name}: head dim {D} must be a multiple of 8 in [8, 128]", InvalidArgumentError)
    enforce(B * H <= 65535, f"{name}: B*H = {B * H} above 65535", InvalidArgumentError)
    return [B, H, Lq, Lk, D, int(bool(causal)), int(q_offset), int(k_offset),
            int(precision == "highest"), int(dt == _BF16),
            ctypes.c_float(1.0 / math.sqrt(D)), torch.cuda.current_stream(dev).cuda_stream]


def _check_bwd(q, dout, lse, delta) -> None:
    B, Lq, H, _ = q.shape
    enforce(tuple(dout.shape) == tuple(q.shape) and tuple(lse.shape) == (B, Lq, H)
            and tuple(delta.shape) == (B, Lq, H),
            f"flash attention backward: dout like q {tuple(q.shape)}, lse and delta "
            f"[B, Lq, H], got {tuple(dout.shape)}, {tuple(lse.shape)}, {tuple(delta.shape)}",
            InvalidArgumentError)


def _check_side(name, tensors, dtype) -> None:
    for t in tensors:
        enforce(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}",
                InvalidArgumentError)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_attention_fwd(q, k, v, causal=False, q_offset=0, k_offset=0,
                        precision="default") -> Tuple[torch.Tensor, torch.Tensor]:
    """B5: (out [B, Lq, H, D] in q's type, lse [B, Lq, H] f32)."""
    _check_args(q, k, v, precision)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, q_offset, k_offset, precision)
    tail = _cuda_args("flash_attention_fwd", (q, k, v), q, precision, causal, q_offset,
                      k_offset)
    _check_side("flash_attention_fwd", (k, v), q.dtype)
    B, Lq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Lq, H), dtype=_F32, device=q.device)
    if out.numel():
        _raise_on(load_flash_kernels().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), *tail),
            "flash_attention_fwd")
        flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False, q_offset=0, k_offset=0,
                           precision="default") -> torch.Tensor:
    """B6: dQ [B, Lq, H, D] in q's type; ``dout`` like q, ``lse`` and
    ``delta`` [B, Lq, H] f32."""
    _check_args(q, k, v, precision)
    _check_bwd(q, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, causal, q_offset,
                                            k_offset, precision)
    tail = _cuda_args("flash_attention_bwd_dq", (q, k, v, dout, lse, delta), q, precision,
                      causal, q_offset, k_offset)
    _check_side("flash_attention_bwd_dq", (k, v, dout), q.dtype)
    _check_side("flash_attention_bwd_dq", (lse, delta), _F32)
    dq = torch.empty_like(q)
    if dq.numel():
        _raise_on(load_flash_kernels().flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *tail), "flash_attention_bwd_dq")
        flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False, q_offset=0, k_offset=0,
                            precision="default") -> Tuple[torch.Tensor, torch.Tensor]:
    """B7: (dK, dV) [B, Lk, H, D] in k's and v's type."""
    _check_args(q, k, v, precision)
    _check_bwd(q, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, q_offset,
                                             k_offset, precision)
    tail = _cuda_args("flash_attention_bwd_dkv", (q, k, v, dout, lse, delta), q, precision,
                      causal, q_offset, k_offset)
    _check_side("flash_attention_bwd_dkv", (k, v, dout), q.dtype)
    _check_side("flash_attention_bwd_dkv", (lse, delta), _F32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _raise_on(load_flash_kernels().flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail), "flash_attention_bwd_dkv")
        flash_attention_bwd_dkv.launches += 1
    return dk, dv


#: kernel launches since import (or since a caller reset them to 0)
flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


# -- the differentiable entry points ---------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward saves q, k, v, out and lse; backward runs B6 then B7 with
    delta = rowsum(dO * O) - dlse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset, precision):
        out, lse = flash_attention_fwd(q, k, v, causal, q_offset, k_offset, precision)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, q_offset, k_offset, precision)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = torch.zeros_like(out) if dout is None else dout.to(q.dtype).contiguous()
        delta = (dout.to(_F32) * out.to(_F32)).sum(dim=-1)
        if dlse is not None:
            # d(lse)/dS = P: an lse cotangent enters dS = P * (dP - delta + dlse)
            delta = delta - dlse.to(_F32)
        delta = delta.contiguous()
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, *ctx.cfg)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = False, q_offset: int = 0, k_offset: int = 0,
                             precision: str = "default") -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Lq, H, D], lse [B, Lq, H] f32), differentiable in q, k
    and v through both (a ring over sequence shards merges partial
    attentions by their lse, so its gradient needs dlse)."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset), int(k_offset), precision)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    q_offset: int = 0, k_offset: int = 0,
                    precision: str = "default") -> torch.Tensor:
    """Differentiable flash attention, [B, L, H, D] in and out."""
    return flash_attention_with_lse(q, k, v, causal, q_offset, k_offset, precision)[0]
