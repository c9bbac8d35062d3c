"""AveragePrecision metric classes (binned mode).

Counterpart of ``torchmetrics_tpu/classification/average_precision.py``.
Each class subclasses its task's curve class and keeps its update.
"""
from typing import Any, Optional

import torch

from ..functional.classification.auroc import _support
from ..functional.classification.average_precision import (
    _binary_average_precision_compute,
    _reduce_average_precision,
)
from ..functional.classification.precision_recall_curve import (
    Thresholds,
    _multiclass_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_compute,
)
from ..metric import Metric
from .base import _ClassificationTaskWrapper
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_facade,
)


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Binned binary AP; 0 (not NaN) when no positive was seen."""

    higher_is_better = True

    def compute(self):
        return _binary_average_precision_compute(self.confmat, self.thresholds)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Binned one-vs-rest AP, reduced by ``average``; a class with no
    positives has AP 0 and stays in the average."""

    higher_is_better = True

    def __init__(self, num_classes: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self):
        precision, recall, _ = _multiclass_precision_recall_curve_compute(
            self.confmat, self.num_classes, self.thresholds
        )
        return _reduce_average_precision(precision, recall, self.average, weights=_support(self.confmat))


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Binned AP per label (mAP with ``average="macro"``); ``micro`` is the AP
    of the state summed over labels."""

    higher_is_better = True

    def __init__(self, num_labels: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self):
        if self.average == "micro":
            # per-label binary confusions add up to the flattened one; ignored
            # entries carry weight 0 in both
            return _binary_average_precision_compute(torch.sum(self.confmat, dim=1, dtype=torch.int32),
                                                     self.thresholds)
        precision, recall, _ = _multilabel_precision_recall_curve_compute(
            self.confmat, self.num_labels, self.thresholds
        )
        return _reduce_average_precision(precision, recall, self.average, weights=_support(self.confmat))


class AveragePrecision(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import AveragePrecision
        >>> metric = AveragePrecision(task="multiclass", num_classes=3, thresholds=5, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    def __new__(cls, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, average: Optional[str] = "macro",
                ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _curve_facade(task, num_classes, num_labels, (BinaryAveragePrecision, MulticlassAveragePrecision,
                             MultilabelAveragePrecision), kwargs, args=(average,))
