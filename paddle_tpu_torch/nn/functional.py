"""Functional ops of the port's models, with the JAX package's formulas.

``linear`` and ``conv2d`` are the two ops that consult ``amp``: under
``amp.auto_cast`` an f32 input computes in the amp dtype with f32
accumulation (see each). ``conv2d`` pins cuDNN's TF32 off for its own
calls, forward and backward, so f32 means f32 whatever the caller set.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import torch

from .. import amp
from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "batch_norm",
           "binary_cross_entropy_with_logits", "conv2d", "cross_entropy", "dropout",
           "embedding", "flatten", "gelu", "layer_norm", "linear", "log_softmax",
           "max_pool2d", "mse_loss", "one_hot", "relu", "sigmoid", "softmax", "tanh"]

IntPair = Union[int, Sequence[int]]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu``: the tanh approximation by default."""
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - p`` and scale by
    ``1 / (1 - p)``. The identity at ``p <= 0`` or when not training;
    otherwise the keep mask draws from ``generator``, which the caller
    owns (the Trainer seeds one), so a run is reproducible."""
    if not training or p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    enforce(generator is not None,
            "dropout with p > 0 in training needs an explicit torch.Generator",
            InvalidArgumentError)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis: biased variance, ``(x - mean) * rsqrt(var + eps)``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, soft_label: bool = False,
                  reduction: str = "mean", ignore_index: int = -100) -> torch.Tensor:
    """Softmax cross entropy over the last axis. Hard labels equal to
    ``ignore_index`` count zero, and ``"mean"`` divides by the number of
    the others (at least 1)."""
    lp = torch.log_softmax(logits, dim=-1)
    if soft_label:
        loss = -(labels * lp).sum(dim=-1)
    else:
        labels = labels.reshape(logits.shape[:-1])
        mask = labels != ignore_index
        idx = torch.where(mask, labels, torch.zeros_like(labels)).to(torch.int64)
        picked = torch.gather(lp, -1, idx[..., None])[..., 0]
        loss = torch.where(mask, -picked, torch.zeros((), dtype=lp.dtype, device=lp.device))
        if reduction == "mean":
            return loss.sum() / torch.clamp(mask.sum(), min=1)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def binary_cross_entropy_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                                     reduction: str = "mean") -> torch.Tensor:
    """``max(x, 0) - x*y + log1p(exp(-|x|))``, the formula of
    ``paddle_tpu.nn.functional.binary_cross_entropy_with_logits``."""
    labels = labels.to(logits.dtype)
    loss = (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def mse_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    loss = (pred - target.to(pred.dtype)) ** 2
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def flatten(x: torch.Tensor, start_axis: int = 1) -> torch.Tensor:
    return x.reshape(tuple(x.shape[:start_axis]) + (-1,))


def embedding(ids: torch.Tensor, table: torch.Tensor,
              padding_idx: Optional[int] = None) -> torch.Tensor:
    """Rows of ``table`` at ``ids``; rows of ``padding_idx`` read 0."""
    out = table[ids]
    if padding_idx is not None:
        out = torch.where((ids != padding_idx)[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def one_hot(ids: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: an id outside [0, num_classes) gives a zero row."""
    classes = torch.arange(num_classes, device=ids.device)
    return (ids[..., None] == classes).to(dtype)


# -- the amp-aware contractions ------------------------------------------------

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of two low-precision 2-D operands, summed in f32 and
    rounded once: cuBLAS with an f32 result on the card, the f32 product
    of the same values on the CPU."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


class _AmpLinear(torch.autograd.Function):
    """``x @ w.T`` under amp. Forward: the f32-summed product of the
    operands rounded to ``dt``, returned in f32 and not rounded again (the
    JAX package's ``preferred_element_type=float32``). Backward: the
    cotangent is rounded to ``dt`` (tensor cores take no f32 operand),
    each input gradient is the f32-summed product rounded to ``dt``, as
    the JAX package rounds it, then cast to its input's dtype."""

    @staticmethod
    def forward(ctx, x, w, dt):
        xl = x.reshape(-1, x.shape[-1]).to(dt)
        wl = w.to(dt)
        ctx.save_for_backward(xl, wl)
        ctx.meta = (x.shape, x.dtype, w.dtype, dt)
        return _mm_f32(xl, wl.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xl, wl = ctx.saved_tensors
        x_shape, x_dtype, w_dtype, dt = ctx.meta
        gl = g.reshape(-1, g.shape[-1]).to(dt)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(gl, wl).to(dt).to(x_dtype).reshape(x_shape)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(gl.t(), xl).to(dt).to(w_dtype)
        return dx, dw, None


def _promoted(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` with torch's ``[out, in]`` weight layout
    (the JAX package keeps ``[in, out]``; ``convert`` transposes).

    Under ``amp.auto_cast`` an f32 ``x`` takes :class:`_AmpLinear`: the
    product in the amp dtype with an f32 result; the bias add stays f32.
    Otherwise mixed dtypes (an O2 bf16 weight under an f32 input) promote
    as the JAX package's ``jnp.matmul`` does."""
    if amp.amp_enabled() and x.dtype == torch.float32:
        y = _AmpLinear.apply(x, weight, amp.amp_dtype())
        return y if bias is None else y + bias
    if bias is None:
        x, weight = _promoted(x, weight)
    else:
        x, weight, bias = _promoted(x, weight, bias)
    return torch.nn.functional.linear(x, weight, bias)


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return (int(v[0]), int(v[1]))


@contextlib.contextmanager
def _cudnn_f32(on_card: bool):
    """cuDNN convolutions in IEEE f32 (no TF32) for the enclosed calls,
    then the caller's setting back. Set through the per-operator
    ``cudnn.conv.fp32_precision``: reading the legacy ``allow_tf32`` raises
    once a caller has set conv and RNN apart with the newer API."""
    if not on_card:
        yield
        return
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


class _Conv2d(torch.autograd.Function):
    """NCHW × OIHW convolution, forward and backward under
    :func:`_cudnn_f32`. ``dt`` None: in the inputs' dtype. ``dt`` set
    (amp): the operands rounded to ``dt``; the forward sums in f32 and
    returns f32 (on the card cuDNN's ``dt`` convolution, whose output is
    rounded to ``dt`` once more: no ``dt`` convolution of cuDNN gives an
    f32 result; on the CPU too inside ``amp.card_conv_rounding``); the
    backward follows :class:`_AmpLinear`'s rule."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups, dt):
        conv = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
        if dt is not None:
            x_dtype, w_dtype = x.dtype, w.dtype
            x, w = x.to(dt), w.to(dt)
        with _cudnn_f32(x.is_cuda):
            if dt is None:
                y = torch.nn.functional.conv2d(x, w, None, **conv)
            elif x.is_cuda:
                y = torch.nn.functional.conv2d(x, w, None, **conv).to(torch.float32)
            else:
                y = torch.nn.functional.conv2d(x.to(torch.float32), w.to(torch.float32),
                                               None, **conv)
                if amp.conv_output_rounded():  # the card's rounding (amp.card_conv_rounding)
                    y = y.to(dt).to(torch.float32)
        ctx.save_for_backward(x, w)
        ctx.conv, ctx.dt = conv, dt
        ctx.dtypes = (x_dtype, w_dtype) if dt is not None else (x.dtype, w.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        c, dt = ctx.conv, ctx.dt
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        if dt is not None:
            g = g.to(dt)
            if not g.is_cuda:  # the f32 sums of the rounded operands
                g, x, w = g.to(torch.float32), x.to(torch.float32), w.to(torch.float32)
        with _cudnn_f32(g.is_cuda):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(c["stride"]), list(c["padding"]), list(c["dilation"]),
                False, [0, 0], c["groups"], mask)
        if dt is not None:
            dx = dx.to(dt) if dx is not None else None
            dw = dw.to(dt) if dw is not None else None
        x_dtype, w_dtype = ctx.dtypes
        return (dx.to(x_dtype) if dx is not None else None,
                dw.to(w_dtype) if dw is not None else None, None, None, None, None, None)


def _same_pads(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    """XLA's "SAME": output ceil(size / s), the extra pad cell at the end."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: IntPair = 1, padding: Union[IntPair, str] = 0,
           dilation: IntPair = 1, groups: int = 1) -> torch.Tensor:
    """NCHW convolution with OIHW weights; ``padding`` an int, a pair, or
    "SAME"/"VALID" as XLA reads them. Under ``amp.auto_cast`` an f32
    ``x`` computes in the amp dtype (see :class:`_Conv2d`); the bias add
    stays f32."""
    strides, dil = _pair(stride), _pair(dilation)
    if isinstance(padding, str):
        enforce(padding.upper() in ("SAME", "VALID"),
                f"conv2d padding {padding!r}: an int, a pair, 'SAME' or 'VALID'",
                InvalidArgumentError)
        pads = (0, 0)
        if padding.upper() == "SAME":
            kh, kw = weight.shape[2:]
            (t, b), (l, r) = (_same_pads(x.shape[2], kh, strides[0], dil[0]),
                              _same_pads(x.shape[3], kw, strides[1], dil[1]))
            x = torch.nn.functional.pad(x, (l, r, t, b))
    else:
        pads = _pair(padding)
    if amp.amp_enabled() and x.dtype == torch.float32:
        dt = amp.amp_dtype()
    else:
        dt = None
        x, weight = _promoted(x, weight)
    y = _Conv2d.apply(x, weight, strides, pads, dil, groups, dt)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y


# -- pooling and normalization -------------------------------------------------

def max_pool2d(x: torch.Tensor, kernel_size: IntPair, stride: Optional[IntPair] = None,
               padding: IntPair = 0) -> torch.Tensor:
    """Max over windows; padded cells count as -inf."""
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    return torch.nn.functional.max_pool2d(x, k, s, _pair(padding))


def avg_pool2d(x: torch.Tensor, kernel_size: IntPair, stride: Optional[IntPair] = None,
               padding: IntPair = 0) -> torch.Tensor:
    """Mean over each window's cells inside the input: with padding the
    divisor is the count of valid cells, as the JAX package divides
    (torch's default ``count_include_pad=True`` does not)."""
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    return torch.nn.functional.avg_pool2d(x, k, s, _pair(padding), count_include_pad=False)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: IntPair) -> torch.Tensor:
    """Mean over equal blocks; raises where the input size does not divide
    by the output size, as the JAX package does."""
    oh, ow = _pair(output_size)
    n, c, h, w = x.shape
    if h % oh or w % ow:
        raise InvalidArgumentError(
            f"adaptive_avg_pool2d needs divisible sizes; got {(h, w)}→{(oh, ow)}")
    return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, training: bool,
               momentum: float = 0.9, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (y, new_running_mean, new_running_var). The channel axis is 1 (2-,
    3- or 4-D input). Training normalizes by the batch's mean and *biased*
    variance and moves the running stats as
    ``momentum * running + (1 - momentum) * batch`` (momentum 0.9 keeps
    90 %: the other way round from torch's 0.1); eval uses the running
    stats. ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``."""
    if x.ndim not in (2, 3, 4):
        raise InvalidArgumentError(f"batch_norm: unsupported ndim {x.ndim}")
    axes = (0,) + tuple(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if training:
        mean = x.mean(dim=axes)
        var = torch.var(x, dim=axes, correction=0)
        with torch.no_grad():
            new_rm = momentum * running_mean + (1 - momentum) * mean
            new_rv = momentum * running_var + (1 - momentum) * var
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    y = (x - mean.reshape(shape)) * (inv * weight).reshape(shape) + bias.reshape(shape)
    return y.to(x.dtype), new_rm, new_rv
