"""Metrics of the port: accuracy, the bucketed AUC, MAE, RMSE and the
user-weighted AUC (port of ``paddle_tpu.metrics``)."""

from .accuracy import Accuracy, accuracy
from .auc import AUC, auc_from_buckets, auc_update_buckets
from .basic import MAE, RMSE, WuAUC

__all__ = ["AUC", "Accuracy", "MAE", "RMSE", "WuAUC", "accuracy", "auc_from_buckets",
           "auc_update_buckets"]
