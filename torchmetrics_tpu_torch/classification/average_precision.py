"""AveragePrecision metric classes.

Counterpart of ``torchmetrics_tpu/classification/average_precision.py``.
Each class subclasses its task's curve class and keeps its update. The
exact mode (``thresholds=None``, the default) computes through the filled
curves of ``_exact_jit.py`` (JAX ``average_precision.py:45-47, :70-73,
:110-123``), on the device without a host sync.
"""
from typing import Any, Optional

import torch

from ..functional.classification import _exact_jit as _EJ
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
    """Binary AP: exact by default (NaN when no positive was seen), or
    binned (0, not NaN, then)."""

    higher_is_better = True
    plot = Metric.plot  # a value, not a curve
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def compute(self):
        if self.thresholds is None:
            return _EJ.binary_ap_exact(*self._exact_state())
        return _binary_average_precision_compute(self.confmat, self.thresholds)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """One-vs-rest AP, reduced by ``average``: exact by default (a class
    with no positives is NaN and left out of the average), or binned (AP 0,
    kept in the average)."""

    higher_is_better = True
    plot = Metric.plot  # a value, not a curve
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(self, num_classes: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self):
        if self.thresholds is None:
            return _EJ.multiclass_ap_exact(*self._exact_state(), self.average)
        precision, recall, _ = _multiclass_precision_recall_curve_compute(
            self.confmat, self.num_classes, self.thresholds
        )
        return _reduce_average_precision(precision, recall, self.average, weights=_support(self.confmat))


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """AP per label (mAP with ``average="macro"``), exact by default or
    binned; ``micro`` is the AP of the flattened entries (exact; ignored ones
    weighted 0) or of the binned state summed over labels."""

    higher_is_better = True
    plot = Metric.plot  # a value, not a curve
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(self, num_labels: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self):
        if self.thresholds is None:
            preds, target = self._exact_state()
            if self.average == "micro":
                preds, target = preds.reshape(-1), target.reshape(-1)
                weights = None if self.ignore_index is None else target != self.ignore_index
                return _EJ.binary_ap_exact(preds, target, weights)
            return _EJ.multilabel_ap_exact(preds, target, self.average, self.ignore_index)
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
