"""Functional classification metrics (the slice ported so far)."""
from .accuracy import accuracy, binary_accuracy, multiclass_accuracy, multilabel_accuracy
from .auroc import auroc, binary_auroc, multiclass_auroc, multilabel_auroc
from .average_precision import (
    average_precision,
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from .exact_match import exact_match, multiclass_exact_match, multilabel_exact_match
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
from .hamming import binary_hamming_distance, hamming_distance, multiclass_hamming_distance, multilabel_hamming_distance
from .precision_recall import (
    binary_precision,
    binary_recall,
    multiclass_precision,
    multiclass_recall,
    multilabel_precision,
    multilabel_recall,
    precision,
    recall,
)
from .precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
    precision_recall_curve,
)
from .roc import binary_roc, multiclass_roc, multilabel_roc, roc
from .specificity import binary_specificity, multiclass_specificity, multilabel_specificity, specificity
from .stat_scores import binary_stat_scores, multiclass_stat_scores, multilabel_stat_scores, stat_scores

__all__ = [
    "accuracy",
    "auroc",
    "average_precision",
    "binary_accuracy",
    "binary_auroc",
    "binary_average_precision",
    "binary_f1_score",
    "binary_fbeta_score",
    "binary_hamming_distance",
    "binary_precision",
    "binary_precision_recall_curve",
    "binary_recall",
    "binary_roc",
    "binary_specificity",
    "binary_stat_scores",
    "exact_match",
    "f1_score",
    "fbeta_score",
    "hamming_distance",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_average_precision",
    "multiclass_exact_match",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_hamming_distance",
    "multiclass_precision",
    "multiclass_precision_recall_curve",
    "multiclass_recall",
    "multiclass_roc",
    "multiclass_specificity",
    "multiclass_stat_scores",
    "multilabel_accuracy",
    "multilabel_auroc",
    "multilabel_average_precision",
    "multilabel_exact_match",
    "multilabel_f1_score",
    "multilabel_fbeta_score",
    "multilabel_hamming_distance",
    "multilabel_precision",
    "multilabel_precision_recall_curve",
    "multilabel_recall",
    "multilabel_roc",
    "multilabel_specificity",
    "multilabel_stat_scores",
    "precision",
    "precision_recall_curve",
    "recall",
    "roc",
    "specificity",
    "stat_scores",
]
