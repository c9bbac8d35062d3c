"""Precision and Recall metric classes over the stat-scores engine.

Counterpart of ``torchmetrics_tpu/classification/precision_recall.py``. They
keep their stat-scores base's update, so a collection updates them once with
the other consumers of the same engine (F1, Specificity, ...).
"""
from ..functional.classification._reduce import _precision_recall_reduce
from .base import _ClassificationTaskWrapper, _stat_facade_new
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores


class _BinaryPR(BinaryStatScores):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False
    _stat = "precision"

    def compute(self):
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(self._stat, tp, fp, tn, fn, average="binary",
                                        multidim_average=self.multidim_average)


class _MulticlassPR(MulticlassStatScores):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"
    full_state_update = False
    _stat = "precision"

    def compute(self):
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(self._stat, tp, fp, tn, fn, average=self.average,
                                        multidim_average=self.multidim_average, top_k=self.top_k)


class _MultilabelPR(MultilabelStatScores):
    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"
    full_state_update = False
    _stat = "precision"

    def compute(self):
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(self._stat, tp, fp, tn, fn, average=self.average,
                                        multidim_average=self.multidim_average, multilabel=True)


class BinaryPrecision(_BinaryPR):
    """tp / (tp + fp)."""


class MulticlassPrecision(_MulticlassPR):
    """tp / (tp + fp) per class, reduced by ``average``."""


class MultilabelPrecision(_MultilabelPR):
    """tp / (tp + fp) per label, reduced by ``average``."""


class BinaryRecall(_BinaryPR):
    """tp / (tp + fn)."""

    _stat = "recall"


class MulticlassRecall(_MulticlassPR):
    """tp / (tp + fn) per class, reduced by ``average``."""

    _stat = "recall"


class MultilabelRecall(_MultilabelPR):
    """tp / (tp + fn) per label, reduced by ``average``."""

    _stat = "recall"


class Precision(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import Precision
        >>> metric = Precision(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    __new__ = _stat_facade_new((BinaryPrecision, MulticlassPrecision, MultilabelPrecision))


class Recall(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import Recall
        >>> metric = Recall(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    __new__ = _stat_facade_new((BinaryRecall, MulticlassRecall, MultilabelRecall))
