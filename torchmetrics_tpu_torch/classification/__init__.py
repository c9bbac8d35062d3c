"""Metric classes for classification (the slice ported so far)."""
from .accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from .auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from .average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from .exact_match import ExactMatch, MulticlassExactMatch, MultilabelExactMatch
from .f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from .hamming import BinaryHammingDistance, HammingDistance, MulticlassHammingDistance, MultilabelHammingDistance
from .precision_recall import (
    BinaryPrecision,
    BinaryRecall,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelPrecision,
    MultilabelRecall,
    Precision,
    Recall,
)
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from .roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from .specificity import BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity, Specificity
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores, StatScores

__all__ = [
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinaryAUROC",
    "BinaryAccuracy",
    "BinaryAveragePrecision",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryHammingDistance",
    "BinaryPrecision",
    "BinaryPrecisionRecallCurve",
    "BinaryROC",
    "BinaryRecall",
    "BinarySpecificity",
    "BinaryStatScores",
    "ExactMatch",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassAveragePrecision",
    "MulticlassExactMatch",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassHammingDistance",
    "MulticlassPrecision",
    "MulticlassPrecisionRecallCurve",
    "MulticlassROC",
    "MulticlassRecall",
    "MulticlassSpecificity",
    "MulticlassStatScores",
    "MultilabelAUROC",
    "MultilabelAccuracy",
    "MultilabelAveragePrecision",
    "MultilabelExactMatch",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelHammingDistance",
    "MultilabelPrecision",
    "MultilabelPrecisionRecallCurve",
    "MultilabelROC",
    "MultilabelRecall",
    "MultilabelSpecificity",
    "MultilabelStatScores",
    "Precision",
    "PrecisionRecallCurve",
    "ROC",
    "Recall",
    "Specificity",
    "StatScores",
]
