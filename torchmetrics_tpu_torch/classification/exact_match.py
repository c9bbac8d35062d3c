"""ExactMatch metric classes: int32 correct/total counts of their own.

Counterpart of ``torchmetrics_tpu/classification/exact_match.py``. Global
counts are scalar ``"sum"`` states; ``multidim_average="samplewise"`` keeps
per-sample rows as ``cat`` lists.
"""
from typing import Any, Optional

import torch

from ..functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_update,
)
from ..functional.classification.stat_scores import _multiclass_stat_scores_format, _multilabel_stat_scores_format
from ..metric import Metric
from ..utils.data import dim_zero_cat
from ..utils.enums import ClassificationTaskNoBinary
from .base import _ClassificationTaskWrapper

Tensor = torch.Tensor


class _AbstractExactMatch(Metric):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def _create_state(self, multidim_average: str) -> None:
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        else:
            self.add_state("correct", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_state(self, correct: Tensor, total: Tensor) -> None:
        if self.multidim_average == "samplewise":
            self.correct.append(correct)
            self.total.append(total)
        else:
            self.correct = self.correct + correct
            self.total = self.total + total

    def compute(self):
        return _exact_match_reduce(dim_zero_cat(self.correct), dim_zero_cat(self.total))


class MulticlassExactMatch(_AbstractExactMatch):
    """Share of (N, ...) samples whose every position has the right class."""

    def __init__(self, num_classes: int, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _multiclass_stat_scores_format(preds, target, top_k=1)
        self._update_state(*_multiclass_exact_match_update(preds, target, self.multidim_average, self.ignore_index))


class MultilabelExactMatch(_AbstractExactMatch):
    """Share of samples whose every label is right (subset accuracy)."""

    def __init__(self, num_labels: int, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mask = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self._update_state(*_multilabel_exact_match_update(preds, target, mask, self.num_labels,
                                                           self.multidim_average))


class ExactMatch(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ExactMatch
        >>> metric = ExactMatch(task="multiclass", num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0, 1, 2], [2, 1, 0]]), torch.tensor([[0, 1, 2], [2, 1, 1]]))
        >>> round(float(metric.compute()), 4)
        0.5
    """

    def __new__(cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, multidim_average: str = "global",
                ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        if task == ClassificationTaskNoBinary.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
            return MulticlassExactMatch(num_classes, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
        return MultilabelExactMatch(num_labels, threshold, **kwargs)
