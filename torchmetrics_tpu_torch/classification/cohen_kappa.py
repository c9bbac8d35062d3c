"""CohenKappa metric classes (binary and multiclass).

Counterpart of ``torchmetrics_tpu/classification/cohen_kappa.py``:
subclasses of the confusion-matrix classes that keep their update.
"""
from typing import Any, Optional

import torch

from ..functional.classification.cohen_kappa import _cohen_kappa_reduce
from ..metric import Metric
from ..utils.enums import ClassificationTaskNoMultilabel
from .base import _ClassificationTaskWrapper
from .confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix

Tensor = torch.Tensor


class BinaryCohenKappa(BinaryConfusionMatrix):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 weights: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=False, **kwargs)
        self.weights = weights
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None,
                 weights: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=False, **kwargs)
        self.weights = weights
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)


class CohenKappa(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CohenKappa
        >>> metric = CohenKappa(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.6364
    """

    def __new__(cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                weights: Optional[str] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"weights": weights, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCohenKappa(threshold, **kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return MulticlassCohenKappa(num_classes, **kwargs)
