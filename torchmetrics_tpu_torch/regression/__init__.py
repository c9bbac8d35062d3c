"""Regression metrics. Counterpart of ``torchmetrics_tpu/regression/``, with its ``__all__``."""
from .log_mse import LogCoshError, MeanSquaredLogError
from .mae import MeanAbsoluteError
from .mape import (
    MeanAbsolutePercentageError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)
from .mse import MeanSquaredError
from .other import (
    CosineSimilarity,
    CriticalSuccessIndex,
    KLDivergence,
    MinkowskiDistance,
    RelativeSquaredError,
    TweedieDevianceScore,
)
from .pearson import ConcordanceCorrCoef, PearsonCorrCoef
from .r2 import ExplainedVariance, R2Score
from .spearman import KendallRankCorrCoef, SpearmanCorrCoef

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "CriticalSuccessIndex",
    "ExplainedVariance",
    "KendallRankCorrCoef",
    "KLDivergence",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
