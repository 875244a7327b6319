"""Recurrent layers (``paddle.nn.GRU`` / ``paddle.nn.LSTM``): the port of
``paddle_tpu.nn.rnn``.

Batch-major ``[B, T, D]`` in and out, stacked layers, and an optional
per-example ``lengths``: positions at or past a row's length keep the
row's last real state and output zeros (the padded-batch contract of the
framework; a length of 0 is allowed and leaves the state at zero).

Each layer computes its input projection for all timesteps in one product
and then runs the recurrence as a plain loop over T (the JAX package's
``lax.scan``); ``cudnn``'s RNNs are not used: their packed sequences
reject length 0 and round differently.

Weights keep the JAX package's layout ``[in, gates*H]`` (``x @ w``), so
they carry across name for name (``w_ih_{l}``, ``w_hh_{l}``, ``b_ih_{l}``,
``b_hh_{l}``); the gate chunks are GRU [reset, update, candidate] and LSTM
[input, forget, cell, output], paddle's order. Paddle's own rnn weights
(``[gates*H, in]``) go through :func:`import_paddle_rnn_weight`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["GRU", "LSTM", "import_paddle_rnn_weight"]


def import_paddle_rnn_weight(w):
    """A reference rnn ``weight_ih``/``weight_hh`` matrix ([gates*hidden,
    in]) → this module's [in, gates*H] layout (numpy). Gate chunk order is
    unchanged; biases need no conversion."""
    w = np.asarray(w)
    enforce(w.ndim == 2, f"expected a 2-D rnn weight, got shape {w.shape}",
            InvalidArgumentError)
    return np.ascontiguousarray(w.T)


class _RNNBase(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int, gates: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.input_size = int(input_size)
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        bound = 1.0 / np.sqrt(hidden_size)
        G = gates * hidden_size
        for l in range(num_layers):
            d_in = input_size if l == 0 else hidden_size
            for name, shape in ((f"w_ih_{l}", (d_in, G)), (f"w_hh_{l}", (hidden_size, G))):
                w = torch.empty(shape)
                w.uniform_(-bound, bound, generator=generator)
                self.register_parameter(name, nn.Parameter(w))
            self.register_parameter(f"b_ih_{l}", nn.Parameter(torch.zeros(G)))
            self.register_parameter(f"b_hh_{l}", nn.Parameter(torch.zeros(G)))

    def _layer(self, l: int):
        return (getattr(self, f"w_ih_{l}"), getattr(self, f"w_hh_{l}"),
                getattr(self, f"b_ih_{l}"), getattr(self, f"b_hh_{l}"))

    @staticmethod
    def _mask(lengths: Optional[torch.Tensor], T: int, dev) -> Optional[torch.Tensor]:
        if lengths is None:
            return None
        lengths = torch.as_tensor(lengths, device=dev)
        return torch.arange(T, device=dev)[None, :] < lengths.to(torch.int64)[:, None]


class GRU(_RNNBase):
    """forward(x [B, T, D], lengths [B]?) → (out [B, T, H], h_n
    [num_layers, B, H]). Each step: ``r = σ(xg_r + hg_r)``, ``z = σ(xg_z +
    hg_z)``, ``c = tanh(xg_c + r * hg_c)``, ``h' = (1 - z) c + z h`` with
    ``hg = h @ w_hh + b_hh``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(input_size, hidden_size, num_layers, 3, generator)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T = x.shape[0], x.shape[1]
        H = self.hidden_size
        mask = self._mask(lengths, T, x.device)
        finals = []
        for l in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self._layer(l)
            xg = x @ w_ih + b_ih                         # [B, T, 3H], one product
            h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
            outs = []
            for t in range(T):
                xg_t = xg[:, t]
                hg = h @ w_hh + b_hh
                r = torch.sigmoid(xg_t[:, :H] + hg[:, :H])
                z = torch.sigmoid(xg_t[:, H:2 * H] + hg[:, H:2 * H])
                c = torch.tanh(xg_t[:, 2 * H:] + r * hg[:, 2 * H:])
                h_new = (1.0 - z) * c + z * h
                if mask is not None:
                    keep = mask[:, t, None]
                    h_new = torch.where(keep, h_new, h)
                    outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
                else:
                    outs.append(h_new)
                h = h_new
            x = torch.stack(outs, dim=1)
            finals.append(h)
        return x, torch.stack(finals)


class LSTM(_RNNBase):
    """forward(x [B, T, D], lengths [B]?) → (out [B, T, H], (h_n, c_n) each
    [num_layers, B, H])."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(input_size, hidden_size, num_layers, 4, generator)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        B, T = x.shape[0], x.shape[1]
        H = self.hidden_size
        mask = self._mask(lengths, T, x.device)
        h_finals, c_finals = [], []
        for l in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self._layer(l)
            xg = x @ w_ih + b_ih                         # [B, T, 4H]
            h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
            c = torch.zeros_like(h)
            outs = []
            for t in range(T):
                g = xg[:, t] + h @ w_hh + b_hh
                i = torch.sigmoid(g[:, :H])
                f = torch.sigmoid(g[:, H:2 * H])
                cc = torch.tanh(g[:, 2 * H:3 * H])
                o = torch.sigmoid(g[:, 3 * H:])
                c_new = f * c + i * cc
                h_new = o * torch.tanh(c_new)
                if mask is not None:
                    keep = mask[:, t, None]
                    h_new = torch.where(keep, h_new, h)
                    c_new = torch.where(keep, c_new, c)
                    outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
                else:
                    outs.append(h_new)
                h, c = h_new, c_new
            x = torch.stack(outs, dim=1)
            h_finals.append(h)
            c_finals.append(c)
        return x, (torch.stack(h_finals), torch.stack(c_finals))
