"""The CTR feature-value accessor (host side, numpy).

The port's own copy of ``CtrCommonAccessor``/``FeatureBlock`` from
``paddle_tpu.ps.accessor``: the per-feature value layout and its
lifecycle — creation, pull (select), push (update), the daily shrink and
the save filter — as columnar numpy blocks, and the checkpoint text
format of one row (byte for byte the JAX package's, so table files
cross-load between the packages).

Stored fields: slot, unseen_days, delta_score, show, click, embed_w[1],
embed_state[sgd], embedx_w[dim], embedx_state[sgd], has_embedx.
Push value: slot, show, click, embed_g[1], embedx_g[dim].
Pull value: show, click, embed_w[1], embedx_w[dim].
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .sgd_rule import SGDRuleConfig, SparseSGDRule, make_sgd_rule

__all__ = ["AccessorConfig", "CtrCommonAccessor", "FeatureBlock", "accessor_class",
           "make_accessor"]


@dataclasses.dataclass
class AccessorConfig:
    """Mirrors CtrAccessorParameter (ps.proto): the coefficients pull and
    push read, and the lifecycle thresholds of admission, shrink and save."""

    embedx_dim: int = 8
    nonclk_coeff: float = 0.1
    click_coeff: float = 1.0
    base_threshold: float = 1.5
    delta_threshold: float = 0.25
    delta_keep_days: float = 16.0
    show_click_decay_rate: float = 0.98
    delete_threshold: float = 0.8
    delete_after_unseen_days: float = 30.0
    embedx_threshold: float = 10.0  # create embedx lazily past this score
    # the SSD tier's row admission: a key earns a durable row only after this
    # many push observations (0 or 1 admits every key). The accessor-level
    # default; TableConfig.ssd_admission_threshold wins when set.
    admission_threshold: int = 0
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

    def shrink(self, block: FeatureBlock, active: np.ndarray) -> np.ndarray:
        """Daily shrink (ctr_accessor.cc:55): decay show/click, age the
        rows by a day; returns the keep-mask over ``active`` rows."""
        cfg = self.config
        block.show[active] *= cfg.show_click_decay_rate
        block.click[active] *= cfg.show_click_decay_rate
        block.unseen_days[active] += 1
        score = self.show_click_score(block.show[active], block.click[active])
        return ~((score < cfg.delete_threshold)
                 | (block.unseen_days[active] > cfg.delete_after_unseen_days))

    def save_filter(self, block: FeatureBlock, idx: np.ndarray, mode: int) -> np.ndarray:
        """Save mode filter (ctr_accessor.cc Save): 0 = all, 1 = delta,
        2 = base (the delta threshold is 0), 3 = batch model (all)."""
        cfg = self.config
        if mode in (0, 3):
            return np.ones(len(idx), bool)
        delta_threshold = 0.0 if mode == 2 else cfg.delta_threshold
        score = self.show_click_score(block.show[idx], block.click[idx])
        return ((score >= cfg.base_threshold)
                & (block.delta_score[idx] >= delta_threshold)
                & (block.unseen_days[idx] <= cfg.delta_keep_days))

    def update_stat_after_save(self, block: FeatureBlock, idx: np.ndarray, mode: int) -> None:
        """Mode 3 ages the saved rows by a day; modes 1 and 2 start a new
        delta epoch (delta_score = 0)."""
        if mode == 3:
            block.unseen_days[idx] += 1
        elif mode in (1, 2):
            block.delta_score[idx] = 0.0

    # -- the shard-file text format ------------------------------------------

    def format_row(self, key: int, v: np.ndarray) -> str:
        """One checkpoint text line from a full-layout row ([slot, unseen,
        delta_score, show, click, embed_w, embed_state[es], has_embedx,
        embedx_w[dim], embedx_state...]); the embedx block is left out
        when the row has none."""
        es = self.embed_rule.state_dim
        fields = [str(int(key)), str(int(v[0])), f"{v[1]:.6g}", f"{v[2]:.6g}",
                  f"{v[3]:.6g}", f"{v[4]:.6g}", f"{v[5]:.8g}"]
        fields += [f"{x:.8g}" for x in v[6:6 + es]]
        if v[6 + es] != 0.0:
            fields += [f"{x:.8g}" for x in v[7 + es:]]
        return " ".join(fields)

    def parse_row(self, parts: List[str], full_dim: int) -> Tuple[np.uint64, np.ndarray]:
        """Inverse of :meth:`format_row`: text fields → (key, full row)."""
        es = self.embed_rule.state_dim
        key = np.uint64(parts[0])
        data = [float(x) for x in parts[1:]]
        row = np.zeros(full_dim, np.float32)
        row[:6] = data[:6]
        row[6:6 + es] = data[6:6 + es]
        rest = data[6 + es:]
        if len(rest) >= self.config.embedx_dim:
            row[6 + es] = 1.0
            row[7 + es:7 + es + len(rest)] = rest
        return key, row


_ACCESSOR_CLASSES = {"ctr": CtrCommonAccessor}


def accessor_class(name: str):
    """The accessor class registered under ``name`` (the port has the CTR
    accessor only)."""
    try:
        return _ACCESSOR_CLASSES[name]
    except KeyError:
        raise KeyError(f"unknown accessor {name!r}; the port has 'ctr'") from None


def make_accessor(name: str, config: Optional[AccessorConfig] = None):
    return accessor_class(name)(config)
