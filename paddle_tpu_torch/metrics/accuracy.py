"""Top-k accuracy (``paddle.metric.Accuracy``).

Port of ``paddle_tpu.metrics.accuracy``: ``accuracy`` on the device,
``Accuracy`` accumulated on the host in numpy."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Accuracy", "accuracy"]


def accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Share of rows whose label is among the ``k`` largest logits."""
    labels = labels.reshape(-1)
    if k == 1:
        return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
    topk = torch.topk(logits, k, dim=-1).indices
    return (topk == labels[:, None]).any(dim=-1).to(torch.float32).mean()


class Accuracy:
    def __init__(self, topk: int = 1) -> None:
        self.topk = topk
        self.reset()

    def reset(self) -> None:
        self._correct = 0.0
        self._total = 0

    def update(self, logits, labels) -> None:
        logits = np.asarray(logits)
        labels = np.asarray(labels).reshape(-1)
        if self.topk == 1:
            pred = logits.argmax(-1)
            self._correct += float((pred == labels).sum())
        else:
            topk = np.argsort(-logits, axis=-1)[:, : self.topk]
            self._correct += float((topk == labels[:, None]).any(-1).sum())
        self._total += labels.size

    def accumulate(self) -> float:
        return self._correct / max(self._total, 1)
