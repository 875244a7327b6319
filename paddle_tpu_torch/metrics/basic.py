"""MAE, RMSE and the user-weighted AUC (``WuAUC``).

Port of ``paddle_tpu.metrics.basic`` (numpy, as there): each metric
accumulates on the host and exposes its raw ``state`` for a merge
across workers (reference ``framework/fleet/metrics.{h,cc}`` and the
python fleet metrics).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.enforce import enforce

__all__ = ["MAE", "RMSE", "WuAUC"]


def _masked(preds, labels, mask):
    preds = np.asarray(preds, np.float64).reshape(-1)
    labels = np.asarray(labels, np.float64).reshape(-1)
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        preds, labels = preds[m], labels[m]
    return preds, labels


class MAE:
    """metrics.h mae bucket: sum |err| and count, merged by sum."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._abs_err = 0.0
        self._count = 0.0

    def update(self, preds, labels, mask=None) -> None:
        p, l = _masked(preds, labels, mask)
        self._abs_err += float(np.abs(p - l).sum())
        self._count += float(p.size)

    @property
    def state(self) -> np.ndarray:
        return np.asarray([self._abs_err, self._count])

    def merge(self, state: np.ndarray) -> None:
        self._abs_err += float(state[0])
        self._count += float(state[1])

    def accumulate(self) -> float:
        return self._abs_err / max(self._count, 1e-12)


class RMSE:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._sq_err = 0.0
        self._count = 0.0

    def update(self, preds, labels, mask=None) -> None:
        p, l = _masked(preds, labels, mask)
        self._sq_err += float(np.square(p - l).sum())
        self._count += float(p.size)

    @property
    def state(self) -> np.ndarray:
        return np.asarray([self._sq_err, self._count])

    def merge(self, state: np.ndarray) -> None:
        self._sq_err += float(state[0])
        self._count += float(state[1])

    def accumulate(self) -> float:
        return float(np.sqrt(self._sq_err / max(self._count, 1e-12)))


class WuAUC:
    """User-weighted AUC (metrics.h WuaucCalculator): AUC computed per
    user (group id), averaged weighted by the user's instance count —
    the CTR-serving ranking metric. Merging across workers requires the
    raw (uid, pred, label) records, which the reference also gathers
    (records are grouped by uid after a global shuffle); ``state``
    exposes them for a host all_gather."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._uid: list = []
        self._pred: list = []
        self._label: list = []

    def update(self, uids, preds, labels, mask=None) -> None:
        u = np.asarray(uids).reshape(-1)
        p, l = _masked(preds, labels, mask)
        if mask is not None:
            u = u[np.asarray(mask).reshape(-1).astype(bool)]
        enforce(len(u) == len(p), "uids/preds length mismatch")
        self._uid.append(u.astype(np.int64))
        self._pred.append(p)
        self._label.append(l)

    @property
    def state(self) -> Dict[str, np.ndarray]:
        return {
            "uid": np.concatenate(self._uid) if self._uid else np.zeros(0, np.int64),
            "pred": np.concatenate(self._pred) if self._pred else np.zeros(0),
            "label": np.concatenate(self._label) if self._label else np.zeros(0),
        }

    def merge(self, state: Dict[str, np.ndarray]) -> None:
        if len(state["uid"]):
            self._uid.append(np.asarray(state["uid"], np.int64))
            self._pred.append(np.asarray(state["pred"], np.float64))
            self._label.append(np.asarray(state["label"], np.float64))

    @staticmethod
    def _auc(pred: np.ndarray, label: np.ndarray) -> Optional[float]:
        pos = label > 0.5
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if n_pos == 0 or n_neg == 0:
            return None
        # vectorized average ranks (ties share their run's mean rank),
        # scipy.stats.rankdata-style: sort once, reduceat over tie runs
        order = np.argsort(pred, kind="mergesort")
        sorted_pred = pred[order]
        run_starts = np.flatnonzero(
            np.concatenate(([True], sorted_pred[1:] != sorted_pred[:-1])))
        run_ends = np.concatenate((run_starts[1:], [len(pred)]))
        mean_rank_per_run = (run_starts + run_ends + 1) / 2.0  # 1-based
        run_of_sorted = np.repeat(np.arange(len(run_starts)),
                                  run_ends - run_starts)
        ranks = np.empty(len(pred))
        ranks[order] = mean_rank_per_run[run_of_sorted]
        return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)

    def accumulate(self, state: Optional[Dict[str, np.ndarray]] = None) -> float:
        s = state if state is not None else self.state
        if not len(s["uid"]):
            return 0.0
        # group records per user in one argsort pass (O(n log n), not a
        # full-array mask scan per unique uid)
        order = np.argsort(s["uid"], kind="mergesort")
        uid_sorted = s["uid"][order]
        starts = np.flatnonzero(
            np.concatenate(([True], uid_sorted[1:] != uid_sorted[:-1])))
        ends = np.concatenate((starts[1:], [len(uid_sorted)]))
        total_w, total = 0.0, 0.0
        for a, b in zip(starts, ends):
            sel = order[a:b]
            auc = self._auc(s["pred"][sel], s["label"][sel])
            if auc is None:
                continue
            w = float(b - a)
            total += auc * w
            total_w += w
        return total / max(total_w, 1e-12)
