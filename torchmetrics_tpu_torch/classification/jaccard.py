"""JaccardIndex metric classes.

Counterpart of ``torchmetrics_tpu/classification/jaccard.py``: subclasses of
the confusion-matrix classes that keep their update (and so their compute
group) and reduce the matrix to IoU.
"""
from typing import Any, Optional

import torch

from ..functional.classification.jaccard import _jaccard_index_reduce
from ..metric import Metric
from ..utils.enums import ClassificationTask
from .base import _ClassificationTaskWrapper
from .confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix, MultilabelConfusionMatrix

Tensor = torch.Tensor


class BinaryJaccardIndex(BinaryConfusionMatrix):
    is_differentiable = False
    higher_is_better = True
    plot = Metric.plot  # a value, not a confusion matrix
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        return _jaccard_index_reduce(self.confmat, "binary", zero_division=self.zero_division)


class MulticlassJaccardIndex(MulticlassConfusionMatrix):
    """Mean IoU (macro by default), as semantic segmentation reports it.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassJaccardIndex
        >>> metric = MulticlassJaccardIndex(num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    plot = Metric.plot  # a value, not a confusion matrix
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"
    full_state_update = False

    def __init__(self, num_classes: int, average: Optional[str] = "macro", ignore_index: Optional[int] = None,
                 validate_args: bool = True, zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        self.average = average
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        return _jaccard_index_reduce(self.confmat, self.average, self.ignore_index, self.zero_division)


class MultilabelJaccardIndex(MultilabelConfusionMatrix):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"
    full_state_update = False

    def __init__(self, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 ignore_index: Optional[int] = None, validate_args: bool = True,
                 zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        self.average = average
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        return _jaccard_index_reduce(self.confmat, self.average, zero_division=self.zero_division)


class JaccardIndex(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import JaccardIndex
        >>> metric = JaccardIndex(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.6667
    """

    def __new__(cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, average: Optional[str] = "macro",
                ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryJaccardIndex(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassJaccardIndex(num_classes, average, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelJaccardIndex(num_labels, threshold, average, **kwargs)
