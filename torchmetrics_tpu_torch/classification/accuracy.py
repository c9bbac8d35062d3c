"""Accuracy metric classes.

Counterpart of ``torchmetrics_tpu/classification/accuracy.py``.
"""
from typing import Any, Optional

import torch

from ..functional.classification._reduce import _accuracy_reduce
from ..metric import Metric
from ..utils.enums import ClassificationTask
from .base import _ClassificationTaskWrapper
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores

Tensor = torch.Tensor


class BinaryAccuracy(BinaryStatScores):
    """Binary accuracy over thresholded probabilities / logits.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = BinaryAccuracy(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.7, 0.6, 0.1]), torch.tensor([0, 1, 0, 0]))
        >>> float(metric.compute())
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassAccuracy(MulticlassStatScores):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"
    full_state_update = False

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, top_k=self.top_k
        )


class MultilabelAccuracy(MultilabelStatScores):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"
    full_state_update = False

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Accuracy(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import Accuracy
        >>> metric = Accuracy(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    def __new__(
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: int = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        task = ClassificationTask.from_str(task)
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        if task == ClassificationTask.BINARY:
            return BinaryAccuracy(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            if not isinstance(top_k, int):
                raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)}` was passed.")
            return MulticlassAccuracy(num_classes, top_k, average, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelAccuracy(num_labels, threshold, average, **kwargs)
