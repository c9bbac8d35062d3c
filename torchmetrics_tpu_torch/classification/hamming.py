"""Hamming distance metric classes over the stat-scores engine.

Counterpart of ``torchmetrics_tpu/classification/hamming.py``.
"""
from ..functional.classification._reduce import _hamming_distance_reduce
from .base import _ClassificationTaskWrapper, _stat_facade_new
from .stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores


class BinaryHammingDistance(BinaryStatScores):
    """The share of wrong labels."""

    is_differentiable = False
    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def compute(self):
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassHammingDistance(MulticlassStatScores):
    """One minus the per-class accuracy, reduced by ``average``."""

    is_differentiable = False
    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"
    full_state_update = False

    def compute(self):
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(tp, fp, tn, fn, average=self.average,
                                        multidim_average=self.multidim_average)


class MultilabelHammingDistance(MultilabelStatScores):
    """The share of wrong labels, per label reduced by ``average``."""

    is_differentiable = False
    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"
    full_state_update = False

    def compute(self):
        tp, fp, tn, fn = self._final_state()
        return _hamming_distance_reduce(tp, fp, tn, fn, average=self.average,
                                        multidim_average=self.multidim_average, multilabel=True)


class HammingDistance(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import HammingDistance
        >>> metric = HammingDistance(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.25
    """

    __new__ = _stat_facade_new((BinaryHammingDistance, MulticlassHammingDistance, MultilabelHammingDistance))
