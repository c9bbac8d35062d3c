"""AUROC metric classes (binned mode).

Counterpart of ``torchmetrics_tpu/classification/auroc.py``. Each class
subclasses its task's curve class and keeps its update, so a collection
updates an AUROC and an AveragePrecision of one task and grid once.
"""
from typing import Any, Optional

from ..functional.classification.auroc import _binary_auroc_compute, _check_max_fpr, _reduce_auroc, _support
from ..functional.classification.precision_recall_curve import Thresholds
from ..functional.classification.roc import _multiclass_roc_compute, _multilabel_roc_compute
from ..metric import Metric
from .base import _ClassificationTaskWrapper
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_facade,
)


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Binned binary AUROC; with ``max_fpr``, the McClish-standardised
    partial AUC up to that false-positive rate."""

    higher_is_better = True

    def __init__(self, max_fpr: Optional[float] = None, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(thresholds, ignore_index, validate_args, **kwargs)
        _check_max_fpr(max_fpr, validate_args)
        self.max_fpr = max_fpr

    def compute(self):
        return _binary_auroc_compute(self.confmat, self.thresholds, self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """One-vs-rest AUROC over the binned curve state.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAUROC
        >>> metric = MulticlassAUROC(num_classes=3, thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
        ...                             [0.3, 0.3, 0.4], [0.1, 0.2, 0.7]]),
        ...               torch.tensor([0, 1, 2, 2]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    higher_is_better = True

    def __init__(self, num_classes: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self):
        fpr, tpr, _ = _multiclass_roc_compute(self.confmat, self.num_classes, self.thresholds)
        return _reduce_auroc(fpr, tpr, self.average, weights=_support(self.confmat))


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """AUROC per label over the binned curve state, reduced by ``average``
    (``micro`` is the functional form's only: it flattens raw inputs)."""

    higher_is_better = True

    def __init__(self, num_labels: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self):
        fpr, tpr, _ = _multilabel_roc_compute(self.confmat, self.num_labels, self.thresholds)
        return _reduce_auroc(fpr, tpr, self.average, weights=_support(self.confmat))


class AUROC(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import AUROC
        >>> metric = AUROC(task="binary", thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    def __new__(cls, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, average: Optional[str] = "macro",
                max_fpr: Optional[float] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _curve_facade(task, num_classes, num_labels, (BinaryAUROC, MulticlassAUROC, MultilabelAUROC),
                             kwargs, binary_args=(max_fpr,), args=(average,))
