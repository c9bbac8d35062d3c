"""Functional regression metrics: plain functions on tensors.

Counterpart of ``torchmetrics_tpu/functional/regression/``, with its
``__all__``.
"""
from .concordance import concordance_corrcoef
from .cosine_similarity import cosine_similarity
from .csi import critical_success_index
from .explained_variance import explained_variance
from .kendall import kendall_rank_corrcoef
from .kl_divergence import kl_divergence
from .log_mse import log_cosh_error, mean_squared_log_error
from .mae import mean_absolute_error
from .mape import (
    mean_absolute_percentage_error,
    symmetric_mean_absolute_percentage_error,
    weighted_mean_absolute_percentage_error,
)
from .minkowski import minkowski_distance
from .mse import mean_squared_error
from .pearson import pearson_corrcoef
from .r2 import r2_score
from .rse import relative_squared_error
from .spearman import spearman_corrcoef
from .tweedie_deviance import tweedie_deviance_score

__all__ = [
    "concordance_corrcoef",
    "cosine_similarity",
    "critical_success_index",
    "explained_variance",
    "kendall_rank_corrcoef",
    "kl_divergence",
    "log_cosh_error",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "minkowski_distance",
    "pearson_corrcoef",
    "r2_score",
    "relative_squared_error",
    "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
