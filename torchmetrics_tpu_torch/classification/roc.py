"""ROC metric classes: curve-state subclasses with a ROC compute.

Counterpart of ``torchmetrics_tpu/classification/roc.py``.
"""
from typing import Any, Optional

from ..functional.classification.precision_recall_curve import Thresholds
from ..functional.classification.roc import _binary_roc_compute, _multiclass_roc_compute, _multilabel_roc_compute
from ..metric import Metric
from .base import _ClassificationTaskWrapper
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_facade,
)


class BinaryROC(BinaryPrecisionRecallCurve):
    """ROC of a binary task: fpr, tpr and descending thresholds, exact (from
    the +inf origin) by default or binned, (T,)."""

    def compute(self):
        if self.thresholds is None:
            return _binary_roc_compute(self._exact_state(), None)
        return _binary_roc_compute(self.confmat, self.thresholds)

    def plot(self, curve=None, score=None, ax=None):
        """TPR against FPR, of ``curve`` or of ``compute()``; needs matplotlib."""
        from ..utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("FPR", "TPR"), name=type(self).__name__)


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """One-vs-rest ROC: per-class lists of exact curves, or (C, T) binned."""

    def compute(self):
        if self.thresholds is None:
            return _multiclass_roc_compute(self._exact_state(), self.num_classes, None)
        return _multiclass_roc_compute(self.confmat, self.num_classes, self.thresholds)

    plot = BinaryROC.plot


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """ROC per label: per-label lists of exact curves, or (L, T) binned."""

    def compute(self):
        if self.thresholds is None:
            return _multilabel_roc_compute(self._exact_state(), self.num_labels, None, self.ignore_index)
        return _multilabel_roc_compute(self.confmat, self.num_labels, self.thresholds)

    plot = BinaryROC.plot


class ROC(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ROC
        >>> metric = ROC(task="binary", thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> [[round(float(x), 4) for x in v] for v in metric.compute()]
        [[0.0, 0.0, 0.0, 0.6667, 1.0], [0.0, 0.6667, 1.0, 1.0, 1.0], [1.0, 0.75, 0.5, 0.25, 0.0]]
    """

    def __new__(cls, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _curve_facade(task, num_classes, num_labels, (BinaryROC, MulticlassROC, MultilabelROC), kwargs)
