"""Metric classes for classification (the slice ported so far)."""
from .accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from .auroc import AUROC, MulticlassAUROC
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
from .precision_recall_curve import MulticlassPrecisionRecallCurve, PrecisionRecallCurve
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores, StatScores

__all__ = [
    "AUROC",
    "Accuracy",
    "BinaryAccuracy",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryStatScores",
    "F1Score",
    "FBetaScore",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
    "MultilabelAccuracy",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelStatScores",
    "PrecisionRecallCurve",
    "StatScores",
]
