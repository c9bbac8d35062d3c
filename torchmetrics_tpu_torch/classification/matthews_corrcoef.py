"""MatthewsCorrCoef metric classes.

Counterpart of ``torchmetrics_tpu/classification/matthews_corrcoef.py``:
subclasses of the confusion-matrix classes that keep their update.
"""
from typing import Any, Optional

import torch

from ..functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from ..metric import Metric
from ..utils.enums import ClassificationTask
from .base import _ClassificationTaskWrapper
from .confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix, MultilabelConfusionMatrix

Tensor = torch.Tensor


class BinaryMatthewsCorrCoef(BinaryConfusionMatrix):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> Tensor:
        return _matthews_corrcoef_reduce(self.confmat)


class MulticlassMatthewsCorrCoef(MulticlassConfusionMatrix):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> Tensor:
        return _matthews_corrcoef_reduce(self.confmat)


class MultilabelMatthewsCorrCoef(MultilabelConfusionMatrix):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def compute(self) -> Tensor:
        return _matthews_corrcoef_reduce(self.confmat)


class MatthewsCorrCoef(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MatthewsCorrCoef
        >>> metric = MatthewsCorrCoef(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.7
    """

    def __new__(cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryMatthewsCorrCoef(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassMatthewsCorrCoef(num_classes, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelMatthewsCorrCoef(num_labels, threshold, **kwargs)
