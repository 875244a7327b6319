"""Bucketed AUC (the reference's ``BasicAucCalculator``,
``framework/fleet/metrics.h:46``).

Port of ``paddle_tpu.metrics.auc``: predictions fall into ``2^N`` bins
of positive and negative counts, and the AUC comes from the cumulative
bucket sums, so workers accumulate buckets locally and one sum merges
them. ``auc_update_buckets`` accumulates on the device; ``AUC`` on the
host in float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["AUC", "auc_update_buckets", "auc_from_buckets"]


def auc_update_buckets(buckets: torch.Tensor, preds: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """On-device bucket accumulation: ``buckets`` [2, num_buckets] (row 0
    negatives, row 1 positives) plus this batch's counts, as a new
    tensor."""
    num_buckets = buckets.shape[1]
    idx = torch.clamp((preds * num_buckets).to(torch.int64), 0, num_buckets - 1)
    pos = labels.to(buckets.dtype)
    neg = 1.0 - pos
    if mask is not None:
        m = mask.to(buckets.dtype)
        pos, neg = pos * m, neg * m
    return torch.stack([buckets[0].index_add(0, idx, neg), buckets[1].index_add(0, idx, pos)])


def auc_from_buckets(buckets: np.ndarray) -> float:
    """Trapezoidal AUC over cumulative bucket counts (metrics.cc math:
    area += (neg_cum_delta) * (pos_cum + pos_cum_prev) / 2)."""
    neg, pos = np.asarray(buckets[0], np.float64), np.asarray(buckets[1], np.float64)
    tot_pos = pos.sum()
    tot_neg = neg.sum()
    if tot_pos == 0 or tot_neg == 0:
        return 0.5
    area = 0.0
    pos_cum = 0.0
    # walk from highest-score bucket down (reference iterates descending)
    for i in range(len(pos) - 1, -1, -1):
        area += neg[i] * (pos_cum + pos_cum + pos[i]) / 2.0
        pos_cum += pos[i]
    return float(area / (tot_pos * tot_neg))


class AUC:
    """Streaming AUC metric with the reference's bucket resolution
    (2^12 buckets ≈ table size 4096, metrics.h `_table_size`)."""

    def __init__(self, num_buckets: int = 4096) -> None:
        self.num_buckets = num_buckets
        self.reset()

    def reset(self) -> None:
        self._buckets = np.zeros((2, self.num_buckets), np.float64)

    def update(self, preds, labels, mask=None) -> None:
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        if preds.ndim and preds.shape != labels.shape and preds.size == 2 * labels.size:
            preds = preds.reshape(labels.size, 2)[:, 1]  # two-class prob input
        idx = np.clip((preds * self.num_buckets).astype(np.int64), 0, self.num_buckets - 1)
        pos = labels.astype(np.float64)
        neg = 1.0 - pos
        if mask is not None:
            m = np.asarray(mask, np.float64).reshape(-1)
            pos, neg = pos * m, neg * m
        np.add.at(self._buckets[0], idx, neg)
        np.add.at(self._buckets[1], idx, pos)

    def merge(self, other_buckets: np.ndarray) -> None:
        """Merge buckets from other workers (the global-reduce step)."""
        self._buckets += np.asarray(other_buckets, np.float64)

    @property
    def buckets(self) -> np.ndarray:
        return self._buckets

    def accumulate(self) -> float:
        return auc_from_buckets(self._buckets)
