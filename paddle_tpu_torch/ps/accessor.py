"""The CTR feature-value accessor (host side, numpy).

The port's own copy of ``CtrCommonAccessor``/``FeatureBlock`` from
``paddle_tpu.ps.accessor``: the per-feature value layout and its
lifecycle — creation, pull (select) and push (update) — as columnar
numpy blocks.

Stored fields: slot, unseen_days, delta_score, show, click, embed_w[1],
embed_state[sgd], embedx_w[dim], embedx_state[sgd], has_embedx.
Push value: slot, show, click, embed_g[1], embedx_g[dim].
Pull value: show, click, embed_w[1], embedx_w[dim].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .sgd_rule import SGDRuleConfig, SparseSGDRule, make_sgd_rule

__all__ = ["AccessorConfig", "CtrCommonAccessor", "FeatureBlock"]


@dataclasses.dataclass
class AccessorConfig:
    """The fields of CtrAccessorParameter (ps.proto) that pull, push and
    the pass cache read; the shrink/save thresholds come with table
    save/shrink in a later slice."""

    embedx_dim: int = 8
    nonclk_coeff: float = 0.1
    click_coeff: float = 1.0
    embedx_threshold: float = 10.0  # create embedx lazily past this score
    embed_sgd_rule: str = "adagrad"
    embedx_sgd_rule: str = "adagrad"
    sgd: SGDRuleConfig = dataclasses.field(default_factory=SGDRuleConfig)


class FeatureBlock:
    """Columnar storage for a shard of features."""

    def __init__(self, n: int, accessor: "CtrCommonAccessor") -> None:
        dim = accessor.config.embedx_dim
        self.slot = np.zeros(n, np.int32)
        self.unseen_days = np.zeros(n, np.float32)
        self.delta_score = np.zeros(n, np.float32)
        self.show = np.zeros(n, np.float32)
        self.click = np.zeros(n, np.float32)
        self.embed_w = np.zeros((n, 1), np.float32)
        self.embed_state = np.zeros((n, accessor.embed_rule.state_dim), np.float32)
        self.embedx_w = np.zeros((n, dim), np.float32)
        self.embedx_state = np.zeros((n, accessor.embedx_rule.state_dim), np.float32)
        self.has_embedx = np.zeros(n, bool)


class CtrCommonAccessor:
    """The CTR accessor: show/click statistics drive value lifecycle
    (ctr_accessor.cc behaviour)."""

    def __init__(self, config: Optional[AccessorConfig] = None) -> None:
        self.config = config or AccessorConfig()
        self.embed_rule: SparseSGDRule = make_sgd_rule(
            self.config.embed_sgd_rule, 1, self.config.sgd)
        self.embedx_rule: SparseSGDRule = make_sgd_rule(
            self.config.embedx_sgd_rule, self.config.embedx_dim, self.config.sgd)

    @property
    def pull_dim(self) -> int:
        """show, click, embed_w, embedx_w[dim]"""
        return 3 + self.config.embedx_dim

    def create(self, block: FeatureBlock, idx: np.ndarray, slots: np.ndarray,
               rng: np.random.Generator) -> None:
        """Initialize freshly inserted features (Create)."""
        n = len(idx)
        if n == 0:
            return
        block.slot[idx] = slots
        block.unseen_days[idx] = 0.0
        block.delta_score[idx] = 0.0
        block.show[idx] = 0.0
        block.click[idx] = 0.0
        w, st = self.embed_rule.init_value(n, rng)
        block.embed_w[idx] = w
        block.embed_state[idx] = st
        block.embedx_w[idx] = 0.0
        block.embedx_state[idx] = 0.0
        # embedx is lazy: created on push once the show/click score
        # crosses embedx_threshold
        block.has_embedx[idx] = False

    def show_click_score(self, show: np.ndarray, click: np.ndarray) -> np.ndarray:
        cfg = self.config
        return (show - click) * cfg.nonclk_coeff + click * cfg.click_coeff

    def select(self, block: FeatureBlock, idx: np.ndarray) -> np.ndarray:
        """Pull: [n, pull_dim] = show, click, embed_w, embedx_w."""
        out = np.empty((len(idx), self.pull_dim), np.float32)
        out[:, 0] = block.show[idx]
        out[:, 1] = block.click[idx]
        out[:, 2] = block.embed_w[idx, 0]
        out[:, 3:] = block.embedx_w[idx] * block.has_embedx[idx, None]
        return out

    def update(self, block: FeatureBlock, idx: np.ndarray, push: np.ndarray,
               rng: np.random.Generator) -> None:
        """Push: apply CTR statistics + SGD rules (ctr_accessor.cc:219)."""
        cfg = self.config
        push_show = push[:, 1]
        push_click = push[:, 2]
        block.show[idx] += push_show
        block.click[idx] += push_click
        block.delta_score[idx] += (
            (push_show - push_click) * cfg.nonclk_coeff + push_click * cfg.click_coeff)
        block.unseen_days[idx] = 0.0

        w = block.embed_w[idx]
        st = block.embed_state[idx]
        self.embed_rule.update(w, st, push[:, 3:4], push_show)
        block.embed_w[idx] = w
        block.embed_state[idx] = st

        score = self.show_click_score(block.show[idx], block.click[idx])
        need = (~block.has_embedx[idx]) & (score >= cfg.embedx_threshold)
        if need.any():
            create_rows = idx[need]
            wx, stx = self.embedx_rule.init_value(len(create_rows), rng)
            block.embedx_w[create_rows] = wx
            block.embedx_state[create_rows] = stx
            block.has_embedx[create_rows] = True

        have = block.has_embedx[idx]
        if have.any():
            rows = idx[have]
            wx = block.embedx_w[rows]
            stx = block.embedx_state[rows]
            self.embedx_rule.update(wx, stx, push[have, 4:], push_show[have])
            block.embedx_w[rows] = wx
            block.embedx_state[rows] = stx
