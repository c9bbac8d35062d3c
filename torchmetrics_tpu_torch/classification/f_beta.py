"""F-beta / F1 metric classes.

Counterpart of ``torchmetrics_tpu/classification/f_beta.py``.
"""
from typing import Any, Optional

import torch

from ..functional.classification._reduce import _fbeta_reduce
from ..functional.classification.f_beta import _check_beta
from ..metric import Metric
from .base import _ClassificationTaskWrapper, _stat_dispatch, _stat_facade_new
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores

Tensor = torch.Tensor


class BinaryFBetaScore(BinaryStatScores):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def __init__(self, beta: float, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold, multidim_average, ignore_index, validate_args=False, **kwargs)
        _check_beta(beta, validate_args)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average="binary", multidim_average=self.multidim_average)


class MulticlassFBetaScore(MulticlassStatScores):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"
    full_state_update = False

    def __init__(self, beta: float, num_classes: int, top_k: int = 1, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, top_k, average, multidim_average, ignore_index,
                         validate_args=False, **kwargs)
        _check_beta(beta, validate_args)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average=self.average,
                             multidim_average=self.multidim_average)


class MultilabelFBetaScore(MultilabelStatScores):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"
    full_state_update = False

    def __init__(self, beta: float, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels, threshold, average, multidim_average, ignore_index,
                         validate_args=False, **kwargs)
        _check_beta(beta, validate_args)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average=self.average,
                             multidim_average=self.multidim_average, multilabel=True)


class BinaryF1Score(BinaryFBetaScore):
    def __init__(self, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, threshold, multidim_average, ignore_index, validate_args, **kwargs)


class MulticlassF1Score(MulticlassFBetaScore):
    def __init__(self, num_classes: int, top_k: int = 1, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, num_classes, top_k, average, multidim_average, ignore_index, validate_args, **kwargs)


class MultilabelF1Score(MultilabelFBetaScore):
    def __init__(self, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args, **kwargs)


class FBetaScore(_ClassificationTaskWrapper):
    """Task facade."""

    def __new__(cls, task: str, beta: float = 1.0, threshold: float = 0.5, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, average: Optional[str] = "micro",
                multidim_average: str = "global", top_k: int = 1, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        return _stat_dispatch(task, (beta,), threshold, num_classes, num_labels, average, top_k, kwargs,
                              (BinaryFBetaScore, MulticlassFBetaScore, MultilabelFBetaScore))


class F1Score(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import F1Score
        >>> metric = F1Score(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    __new__ = _stat_facade_new((BinaryF1Score, MulticlassF1Score, MultilabelF1Score))
