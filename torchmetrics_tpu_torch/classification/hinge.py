"""HingeLoss metric classes.

Counterpart of ``torchmetrics_tpu/classification/hinge.py`` (:1-112): the
summed losses and the count of kept samples, ``"sum"``-reduced; the ignore
mask is a 0/1 weight, so an update never depends on the data's shape.
"""
from typing import Any, Optional

import torch

from ..functional.classification.hinge import (
    _binary_hinge_loss_update,
    _check_multiclass_mode,
    _multiclass_hinge_loss_update,
)
from ..metric import Metric
from ..utils.enums import ClassificationTaskNoMultilabel
from .base import _ClassificationTaskWrapper

Tensor = torch.Tensor


class BinaryHingeLoss(Metric):
    """Mean hinge loss of binary decision scores."""

    is_differentiable = True
    higher_is_better = False
    plot_lower_bound = 0.0
    full_state_update = False

    def __init__(self, squared: bool = False, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        w = None if self.ignore_index is None else target.reshape(-1) != self.ignore_index
        measures, total = _binary_hinge_loss_update(preds, target, self.squared, w)
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        return self.measures / self.total


class MulticlassHingeLoss(Metric):
    """Mean multiclass hinge loss: a scalar (``crammer-singer``) or one per
    class (``one-vs-all``)."""

    is_differentiable = True
    higher_is_better = False
    plot_lower_bound = 0.0
    full_state_update = False

    def __init__(self, num_classes: int, squared: bool = False, multiclass_mode: str = "crammer-singer",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _check_multiclass_mode(multiclass_mode)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        default = torch.tensor(0.0) if multiclass_mode == "crammer-singer" else torch.zeros(num_classes)
        self.add_state("measures", default, dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        w = None if self.ignore_index is None else target.reshape(-1) != self.ignore_index
        measures, total = _multiclass_hinge_loss_update(
            preds, target, self.num_classes, self.squared, self.multiclass_mode, w
        )
        if self.multiclass_mode == "crammer-singer":
            measures = torch.sum(measures)
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        return self.measures / self.total


class HingeLoss(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import HingeLoss
        >>> metric = HingeLoss(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.5875
    """

    def __new__(cls, task: str, num_classes: Optional[int] = None, squared: bool = False,
                multiclass_mode: str = "crammer-singer", ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryHingeLoss(squared, **kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return MulticlassHingeLoss(num_classes, squared, multiclass_mode, **kwargs)
