"""ConfusionMatrix metric classes.

Counterpart of ``torchmetrics_tpu/classification/confusion_matrix.py``: one
int32 ``confmat`` state summed over updates, each update one launch of the
CUDA bincount on the card. Each task class is its own ``_signature_base``,
so JaccardIndex, CohenKappa and MatthewsCorrCoef (subclasses that keep its
update) share one update in a collection; ``normalize`` only changes
``compute`` and stays out of the signature.
"""
from typing import Any, Optional

import torch

from ..functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_update,
    _confusion_matrix_reduce,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_update,
)
from ..metric import Metric
from ..utils.enums import ClassificationTask
from .base import _ClassificationTaskWrapper

Tensor = torch.Tensor


class BinaryConfusionMatrix(Metric):
    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 normalize: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mask = _binary_confusion_matrix_format(preds, target, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _binary_confusion_matrix_update(preds, target, mask)

    def _engine_signature(self):
        return ("binary_confusion_matrix", self.threshold, self.ignore_index)

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)

    def plot(self, val=None, ax=None, add_text=True, labels=None):
        """Heatmap of ``val`` or of ``compute()``; needs matplotlib."""
        from ..utils.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels)


class MulticlassConfusionMatrix(Metric):
    """Confusion matrix for multiclass tasks: rows are targets, columns predictions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> metric = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 1, 1, 2]))
        >>> metric.compute().tolist()
        [[1, 0, 0], [0, 1, 1], [0, 0, 1]]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None,
                 normalize: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mask = _multiclass_confusion_matrix_format(preds, target, self.num_classes, self.ignore_index)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(preds, target, mask, self.num_classes)

    def _engine_signature(self):
        return ("multiclass_confusion_matrix", self.num_classes, self.ignore_index)

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)

    def plot(self, val=None, ax=None, add_text=True, labels=None):
        """Heatmap of ``val`` or of ``compute()``; needs matplotlib."""
        from ..utils.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels)


class MultilabelConfusionMatrix(Metric):
    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 normalize: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_labels, 2, 2), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mask = _multilabel_confusion_matrix_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self.confmat = self.confmat + _multilabel_confusion_matrix_update(preds, target, mask, self.num_labels)

    def _engine_signature(self):
        return ("multilabel_confusion_matrix", self.num_labels, self.threshold, self.ignore_index)

    def compute(self) -> Tensor:
        return _confusion_matrix_reduce(self.confmat, self.normalize)


BinaryConfusionMatrix._signature_base = BinaryConfusionMatrix
MulticlassConfusionMatrix._signature_base = MulticlassConfusionMatrix
MultilabelConfusionMatrix._signature_base = MultilabelConfusionMatrix


class ConfusionMatrix(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ConfusionMatrix
        >>> metric = ConfusionMatrix(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> metric.compute().tolist()
        [[1, 1, 0], [0, 1, 0], [0, 0, 1]]
    """

    def __new__(cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, normalize: Optional[str] = None,
                ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryConfusionMatrix(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassConfusionMatrix(num_classes, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelConfusionMatrix(num_labels, threshold, **kwargs)
