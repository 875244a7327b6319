"""Per-feature sparse SGD rules on the host (numpy).

The port's own copy of ``paddle_tpu.ps.sgd_rule``: the batched numpy
rules the host table applies on push (sparse_sgd_rule.cc semantics). The
device mirror of the same math is ``ops/sparse_optimizer.py``.

Rules (names match the reference registry):
- naive        w -= lr·g, clipped to weight bounds
- adagrad      shared g2sum per feature:
      scaled_g = g/scale
      w -= lr · scaled_g · sqrt(initial_g2sum / (initial_g2sum + g2sum))
      g2sum += mean(scaled_g²)
- std_adagrad  per-dimension g2sum, same form
- adam         per-dim m/v + shared β1ᵗ/β2ᵗ powers (2·dim + 2 floats)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["SGDRuleConfig", "SparseSGDRule", "make_sgd_rule"]


@dataclasses.dataclass
class SGDRuleConfig:
    """Mirrors SparseCommonSGDRuleParameter (ps.proto)."""

    learning_rate: float = 0.05
    initial_g2sum: float = 3.0
    initial_range: float = 1e-4
    weight_bounds: Tuple[float, float] = (-10.0, 10.0)
    # adam
    beta1: float = 0.9
    beta2: float = 0.999
    ada_epsilon: float = 1e-8


class SparseSGDRule:
    """Base: knows its optimizer-state width and implements batched
    init/update in place."""

    def __init__(self, embedding_dim: int, config: Optional[SGDRuleConfig] = None) -> None:
        self.dim = int(embedding_dim)
        self.config = config or SGDRuleConfig()

    @property
    def state_dim(self) -> int:
        raise NotImplementedError

    def init_value(self, n: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """(weights [n, dim], state [n, state_dim]) for new features."""
        raise NotImplementedError

    def update(self, w: np.ndarray, state: np.ndarray, grad: np.ndarray,
               scale: np.ndarray) -> None:
        raise NotImplementedError

    def _clip(self, w: np.ndarray) -> None:
        lo, hi = self.config.weight_bounds
        np.clip(w, lo, hi, out=w)

    def _init_weights(self, n: int, rng: np.random.Generator) -> np.ndarray:
        r = self.config.initial_range
        return rng.uniform(-r, r, size=(n, self.dim)).astype(np.float32)


class SparseNaiveSGDRule(SparseSGDRule):
    @property
    def state_dim(self) -> int:
        return 0

    def init_value(self, n, rng):
        return self._init_weights(n, rng), np.zeros((n, 0), np.float32)

    def update(self, w, state, grad, scale):
        w -= self.config.learning_rate * grad
        self._clip(w)


class SparseAdaGradSGDRule(SparseSGDRule):
    """One shared g2sum per feature (state = [g2sum])."""

    @property
    def state_dim(self) -> int:
        return 1

    def init_value(self, n, rng):
        return self._init_weights(n, rng), np.zeros((n, 1), np.float32)

    def update(self, w, state, grad, scale):
        cfg = self.config
        scaled_g = grad / np.maximum(scale, 1e-10)[:, None]
        g2sum = state[:, 0]
        ratio = np.sqrt(cfg.initial_g2sum / (cfg.initial_g2sum + g2sum))
        w -= cfg.learning_rate * scaled_g * ratio[:, None]
        self._clip(w)
        # sequential-over-dims association, one divide (the device rule
        # in ops/sparse_optimizer.py pins the same order)
        sq = scaled_g * scaled_g
        add = sq[:, 0].copy()
        for i in range(1, sq.shape[1]):
            add += sq[:, i]
        g2sum += add / np.float32(sq.shape[1])


class StdAdaGradSGDRule(SparseSGDRule):
    """Per-dimension g2sum (state = [g2sum × dim])."""

    @property
    def state_dim(self) -> int:
        return self.dim

    def init_value(self, n, rng):
        return self._init_weights(n, rng), np.zeros((n, self.dim), np.float32)

    def update(self, w, state, grad, scale):
        cfg = self.config
        scaled_g = grad / np.maximum(scale, 1e-10)[:, None]
        ratio = np.sqrt(cfg.initial_g2sum / (cfg.initial_g2sum + state))
        w -= cfg.learning_rate * scaled_g * ratio
        self._clip(w)
        state += scaled_g * scaled_g


class SparseAdamSGDRule(SparseSGDRule):
    """state = [m × dim, v × dim, beta1_pow, beta2_pow] (2·dim + 2).
    Like the reference, Adam ignores the push_show scale."""

    @property
    def state_dim(self) -> int:
        return 2 * self.dim + 2

    def init_value(self, n, rng):
        state = np.zeros((n, self.state_dim), np.float32)
        state[:, -2] = self.config.beta1  # beta1_pow starts at beta1
        state[:, -1] = self.config.beta2
        return self._init_weights(n, rng), state

    def update(self, w, state, grad, scale):
        cfg = self.config
        d = self.dim
        g = grad
        m = state[:, :d]
        v = state[:, d : 2 * d]
        b1p = state[:, 2 * d]
        b2p = state[:, 2 * d + 1]
        # (1 - beta) rounds through f32 like the native `1.0f - beta1`
        b1, b2 = np.float32(cfg.beta1), np.float32(cfg.beta2)
        one = np.float32(1.0)
        m *= b1
        m += (one - b1) * g
        v *= b2
        v += (one - b2) * g * g
        m_hat = m / (one - b1p)[:, None]
        v_hat = v / (one - b2p)[:, None]
        w -= cfg.learning_rate * m_hat / (np.sqrt(v_hat) + cfg.ada_epsilon)
        self._clip(w)
        state[:, 2 * d] *= b1
        state[:, 2 * d + 1] *= b2


_RULES = {
    "naive": SparseNaiveSGDRule,
    "adagrad": SparseAdaGradSGDRule,
    "std_adagrad": StdAdaGradSGDRule,
    "adam": SparseAdamSGDRule,
}


def make_sgd_rule(name: str, embedding_dim: int,
                  config: Optional[SGDRuleConfig] = None) -> SparseSGDRule:
    """Factory keyed by the reference's rule names."""
    try:
        return _RULES[name](embedding_dim, config)
    except KeyError:
        raise KeyError(f"unknown sparse sgd rule {name!r}; have {sorted(_RULES)}")
