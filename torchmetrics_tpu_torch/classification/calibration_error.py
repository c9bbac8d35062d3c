"""CalibrationError metric classes (binary and multiclass).

Counterpart of ``torchmetrics_tpu/classification/calibration_error.py``: the
confidences and accuracies of every update are ``cat`` list states (ignored
samples removed by boolean indexing, as there), and the binning — one
launch of the CUDA bincount on the card — runs at ``compute``.
"""
from typing import Any, Optional

import torch

from ..functional.classification.calibration_error import (
    _binary_calibration_error_update,
    _ce_compute,
    _multiclass_calibration_error_update,
)
from ..metric import Metric
from ..utils.data import dim_zero_cat
from ..utils.enums import ClassificationTaskNoMultilabel
from .base import _ClassificationTaskWrapper

Tensor = torch.Tensor


class BinaryCalibrationError(Metric):
    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, n_bins: int = 15, norm: str = "l1", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            if not isinstance(n_bins, int) or n_bins < 1:
                raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
            if norm not in ("l1", "l2", "max"):
                raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        confidences, accuracies = _binary_calibration_error_update(preds, target, self.ignore_index)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)

    def compute(self) -> Tensor:
        return _ce_compute(dim_zero_cat(self.confidences), dim_zero_cat(self.accuracies), self.n_bins, self.norm)


class MulticlassCalibrationError(Metric):
    """Expected calibration error of the top-1 confidence (l1 norm by default).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassCalibrationError
        >>> metric = MulticlassCalibrationError(num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.125
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_classes: int, n_bins: int = 15, norm: str = "l1",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        confidences, accuracies = _multiclass_calibration_error_update(
            preds, target, self.num_classes, self.ignore_index
        )
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)

    def compute(self) -> Tensor:
        return _ce_compute(dim_zero_cat(self.confidences), dim_zero_cat(self.accuracies), self.n_bins, self.norm)


class CalibrationError(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CalibrationError
        >>> metric = CalibrationError(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.125
    """

    def __new__(cls, task: str, n_bins: int = 15, norm: str = "l1", num_classes: Optional[int] = None,
                ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return MulticlassCalibrationError(num_classes, **kwargs)
