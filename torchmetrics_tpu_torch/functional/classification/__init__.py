"""Functional classification metrics (the slice ported so far)."""
from .accuracy import accuracy, binary_accuracy, multiclass_accuracy, multilabel_accuracy
from .auroc import auroc, multiclass_auroc
from .f_beta import (
    binary_f1_score,
    binary_fbeta_score,
    f1_score,
    fbeta_score,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multilabel_f1_score,
    multilabel_fbeta_score,
)
from .precision_recall_curve import multiclass_precision_recall_curve, precision_recall_curve
from .roc import multiclass_roc, roc
from .stat_scores import binary_stat_scores, multiclass_stat_scores, multilabel_stat_scores, stat_scores

__all__ = [
    "accuracy",
    "auroc",
    "binary_accuracy",
    "binary_f1_score",
    "binary_fbeta_score",
    "binary_stat_scores",
    "f1_score",
    "fbeta_score",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision_recall_curve",
    "multiclass_roc",
    "multiclass_stat_scores",
    "multilabel_accuracy",
    "multilabel_f1_score",
    "multilabel_fbeta_score",
    "multilabel_stat_scores",
    "precision_recall_curve",
    "roc",
    "stat_scores",
]
