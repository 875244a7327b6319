"""Multi-task CTR models over the sparse PS path: ESMM and MMoE.

Port of ``paddle_tpu.models.multitask`` (PaddleRec's
``models/multitask/{esmm,mmoe}``): shared slot embeddings pulled from the
PS cache like every CTR model here, and one tower a task.

- **ESMM** (Entire Space Multi-task Model): p(click) and p(conversion |
  click) towers over the shared embeddings; the conversion task trains
  through p(ctcvr) = p(ctr)·p(cvr) over the entire space (labels are
  (click, conversion-and-click)), which sidesteps the sample-selection
  bias of training CVR on clicked impressions only.
- **MMoE** (Multi-gate Mixture-of-Experts): shared expert layers, one
  softmax gate a task mixing the experts' outputs, then a tower a task.

Both keep the family's ``forward(emb [B, S, 1+dim], dense_x [B, D])``
and return one logit a task; each class has ``loss_vec`` (per-example
loss [B] from the logits and labels [B, T]), ``loss`` and ``predict``
(the probabilities serving returns, ``models.ctr.export_ctr_inference``).
:func:`make_multitask_train_step` runs the family's step body with the
model's objective; the push's click is ``labels[:, 0]``. Parameter names
are the JAX package's (``ctr_tower``/``cvr_tower``; ``experts.i``,
``gates.i``, ``towers.i``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layers import Linear
from ..ps.embedding_cache import CacheConfig
from .ctr import CtrConfig, Device, _check_device, _ctr_step_body, _DNN, _weighted_mean

__all__ = ["ESMM", "MMoE", "make_multitask_train_step"]


def _deep_in(cfg: CtrConfig, emb: torch.Tensor, dense_x: torch.Tensor) -> torch.Tensor:
    v = emb[..., 1:]
    return torch.cat([v.reshape(v.shape[0], cfg.num_sparse_slots * cfg.embedx_dim), dense_x],
                     dim=-1)


class ESMM(nn.Module):
    def __init__(self, cfg: CtrConfig, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.num_sparse_slots * cfg.embedx_dim + cfg.num_dense
        self.ctr_tower = _DNN(d, cfg.dnn_hidden, generator=generator)
        self.cvr_tower = _DNN(d, cfg.dnn_hidden, generator=generator)

    def forward(self, emb: torch.Tensor, dense_x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _deep_in(self.cfg, emb, dense_x)
        first = emb[..., 0].sum(dim=-1)
        return self.ctr_tower(x) + first, self.cvr_tower(x)

    @staticmethod
    def loss_vec(logits, labels: torch.Tensor) -> torch.Tensor:
        """Per-example loss [B]; labels [B, 2] = (click, conversion). The
        CVR tower trains through p(ctcvr) = p(ctr)·p(cvr)."""
        ctr_logit, cvr_logit = logits
        click = labels[:, 0].to(torch.float32)
        conv = labels[:, 1].to(torch.float32)  # implies click = 1
        l_ctr = F.binary_cross_entropy_with_logits(ctr_logit, click, reduction="none")
        p_ctcvr = torch.sigmoid(ctr_logit) * torch.sigmoid(cvr_logit)
        eps = 1e-7
        l_ctcvr = -(conv * torch.log(p_ctcvr + eps) + (1 - conv) * torch.log(1 - p_ctcvr + eps))
        return l_ctr + l_ctcvr

    @staticmethod
    def loss(logits, labels: torch.Tensor) -> torch.Tensor:
        return ESMM.loss_vec(logits, labels).mean()

    @staticmethod
    def predict(logits) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pCTR, pCTCVR = pCTR·pCVR)."""
        ctr_logit, cvr_logit = logits
        p_ctr = torch.sigmoid(ctr_logit)
        return p_ctr, p_ctr * torch.sigmoid(cvr_logit)


class MMoE(nn.Module):
    def __init__(self, cfg: CtrConfig, num_experts: int = 4, num_tasks: int = 2,
                 expert_dim: int = 32, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.num_sparse_slots * cfg.embedx_dim + cfg.num_dense
        self.num_tasks = num_tasks
        self.experts = nn.ModuleList([Linear(d, expert_dim, generator=generator)
                                      for _ in range(num_experts)])
        self.gates = nn.ModuleList([Linear(d, num_experts, generator=generator)
                                    for _ in range(num_tasks)])
        self.towers = nn.ModuleList([_DNN(expert_dim, cfg.dnn_hidden, generator=generator)
                                     for _ in range(num_tasks)])

    def forward(self, emb: torch.Tensor, dense_x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = _deep_in(self.cfg, emb, dense_x)
        ex = torch.stack([F.relu(e(x)) for e in self.experts], dim=1)   # [B, E, De]
        first = emb[..., 0].sum(dim=-1)
        outs = []
        for gate, tower in zip(self.gates, self.towers):
            w = torch.softmax(gate(x), dim=-1)                       # [B, E]
            outs.append(tower(torch.einsum("be,bed->bd", w, ex)) + first)
        return tuple(outs)

    @staticmethod
    def loss_vec(logits, labels: torch.Tensor) -> torch.Tensor:
        """Per-example loss [B]; labels [B, T]: a BCE a task, summed."""
        total = 0.0
        for t, logit in enumerate(logits):
            total = total + F.binary_cross_entropy_with_logits(
                logit, labels[:, t].to(torch.float32), reduction="none")
        return total

    @staticmethod
    def loss(logits, labels: torch.Tensor) -> torch.Tensor:
        return MMoE.loss_vec(logits, labels).mean()

    @staticmethod
    def predict(logits) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.sigmoid(l) for l in logits)


def make_multitask_train_step(model: nn.Module, optimizer, cache_cfg: CacheConfig,
                              loss_vec: Optional[Callable] = None,
                              device: Device = None) -> Callable:
    """The multitask GPUPS step over the device cache: the CTR family's
    body with the model's own per-example objective (``loss_vec``, by
    default the model class's), weighted by the optional [B] padding mask.

    step(params, opt_state, cache_state, rows [B, S], dense_x, labels [B, T],
         weights=None) → (params, opt_state, cache_state, loss)

    ``device`` defaults to ``"cuda"`` (raises without a GPU)."""
    dev = resolve_device(device)
    loss_vec = loss_vec or type(model).loss_vec

    def loss_builder(model_, dense_x, labels, weights):
        def loss_fn(params, emb):
            out = functional_call(model_, params, (emb, dense_x))
            return _weighted_mean(loss_vec(out, labels), weights)

        return loss_fn

    def step(params, opt_state, cache_state, rows, dense_x, labels, weights=None):
        _check_device(rows, dev, "rows")
        B, S = rows.shape
        return _ctr_step_body(model, optimizer, cache_cfg, params, opt_state, cache_state,
                              rows.reshape(-1), B, S, dense_x, labels, weights,
                              loss_builder=loss_builder)

    return step
