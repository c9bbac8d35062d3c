"""Metric classes for classification (the slice ported so far)."""
from .accuracy import Accuracy, BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy
from .auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from .average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from .calibration_error import BinaryCalibrationError, CalibrationError, MulticlassCalibrationError
from .cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from .confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from .dice import Dice
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
from .jaccard import BinaryJaccardIndex, JaccardIndex, MulticlassJaccardIndex, MultilabelJaccardIndex
from .matthews_corrcoef import (
    BinaryMatthewsCorrCoef,
    MatthewsCorrCoef,
    MulticlassMatthewsCorrCoef,
    MultilabelMatthewsCorrCoef,
)
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
    "BinaryCalibrationError",
    "BinaryCohenKappa",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryHammingDistance",
    "BinaryJaccardIndex",
    "BinaryMatthewsCorrCoef",
    "BinaryPrecision",
    "BinaryPrecisionRecallCurve",
    "BinaryROC",
    "BinaryRecall",
    "BinarySpecificity",
    "BinaryStatScores",
    "CalibrationError",
    "CohenKappa",
    "ConfusionMatrix",
    "Dice",
    "ExactMatch",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "JaccardIndex",
    "MatthewsCorrCoef",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassAveragePrecision",
    "MulticlassCalibrationError",
    "MulticlassCohenKappa",
    "MulticlassConfusionMatrix",
    "MulticlassExactMatch",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassHammingDistance",
    "MulticlassJaccardIndex",
    "MulticlassMatthewsCorrCoef",
    "MulticlassPrecision",
    "MulticlassPrecisionRecallCurve",
    "MulticlassROC",
    "MulticlassRecall",
    "MulticlassSpecificity",
    "MulticlassStatScores",
    "MultilabelAUROC",
    "MultilabelAccuracy",
    "MultilabelAveragePrecision",
    "MultilabelConfusionMatrix",
    "MultilabelExactMatch",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelHammingDistance",
    "MultilabelJaccardIndex",
    "MultilabelMatthewsCorrCoef",
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
