"""AUROC metric classes (multiclass binned mode).

Counterpart of ``torchmetrics_tpu/classification/auroc.py``.
"""
from typing import Any, Optional

import torch

from ..functional.classification.auroc import _reduce_auroc
from ..functional.classification.precision_recall_curve import Thresholds, _task_not_ported
from ..functional.classification.roc import _multiclass_roc_compute
from ..metric import Metric
from ..utils.enums import ClassificationTask
from .base import _ClassificationTaskWrapper
from .precision_recall_curve import MulticlassPrecisionRecallCurve

Tensor = torch.Tensor


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

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_classes: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self) -> Tensor:
        fpr, tpr, _ = _multiclass_roc_compute(self.confmat, self.num_classes, self.thresholds)
        support = (self.confmat[0, :, 1, 1] + self.confmat[0, :, 1, 0]).to(torch.float32)
        return _reduce_auroc(fpr, tpr, self.average, weights=support)


class AUROC(_ClassificationTaskWrapper):
    """Task facade (multiclass only in this slice)."""

    def __new__(cls, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, average: Optional[str] = "macro",
                max_fpr: Optional[float] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTask.from_str(task)
        if task != ClassificationTask.MULTICLASS:
            raise _task_not_ported(task.value)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return MulticlassAUROC(num_classes, average, thresholds=thresholds, ignore_index=ignore_index,
                               validate_args=validate_args, **kwargs)
