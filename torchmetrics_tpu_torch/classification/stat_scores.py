"""Stat-scores base classes + StatScores metrics.

Counterpart of ``torchmetrics_tpu/classification/stat_scores.py``: int32
tp/fp/tn/fn states summed over updates (``multidim_average="global"``) or
``cat`` lists of per-sample rows (``"samplewise"``).
"""
from typing import Any, Optional

import torch

from ..functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from ..metric import Metric
from ..utils.data import dim_zero_cat
from .base import _ClassificationTaskWrapper, _stat_facade_new

Tensor = torch.Tensor


class _AbstractStatScores(Metric):
    """Owns tp/fp/tn/fn state registration + accumulation.

    Each task base sets ``_signature_base`` and provides
    ``_engine_signature()``; ``average`` is left out of the signatures since
    it only affects ``compute``, so Accuracy/F1 over one engine share updates.
    """

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        if multidim_average == "samplewise":
            for name in ("tp", "fp", "tn", "fn"):
                self.add_state(name, [], dist_reduce_fx="cat")
        else:
            default = torch.zeros(size, dtype=torch.int32) if size > 1 else torch.tensor(0, dtype=torch.int32)
            for name in ("tp", "fp", "tn", "fn"):
                self.add_state(name, default, dist_reduce_fx="sum")

    def _update_state(self, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> None:
        if self.multidim_average == "samplewise":
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def _final_state(self):
        return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)


class BinaryStatScores(_AbstractStatScores):
    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1, multidim_average=multidim_average)

    def _eager_validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mask = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        tp, fp, tn, fn = _binary_stat_scores_update(preds, target, mask, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def _engine_signature(self):
        return ("binary_stat_scores", self.threshold, self.multidim_average, self.ignore_index)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _binary_stat_scores_compute(tp, fp, tn, fn, self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_classes, multidim_average=multidim_average)

    def _eager_validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _multiclass_stat_scores_format(preds, target, self.top_k)
        tp, fp, tn, fn = _multiclass_stat_scores_update(
            preds, target, self.num_classes, self.top_k, self.multidim_average, self.ignore_index
        )
        self._update_state(tp, fp, tn, fn)

    def _engine_signature(self):
        return ("multiclass_stat_scores", self.num_classes, self.top_k, self.multidim_average, self.ignore_index)

    def _supports_sample_counts(self) -> bool:
        """Whether :meth:`_resampled_update` gives this metric's update for
        resampled batches: the engine's own update, global, top-1."""
        return self.update_signature is not None and self.top_k == 1 and self.multidim_average == "global"

    def _resampled_update(self, sample_counts: Tensor, preds: Tensor, target: Tensor) -> dict:
        """The (B, C) tp/fp/tn/fn increments of B resamples of this batch,
        ``sample_counts`` (B, N) giving how often each sample is drawn: one
        bincount launch for all B (the BootStrapper's replicas)."""
        preds, target = _multiclass_stat_scores_format(preds, target, self.top_k)
        tp, fp, tn, fn = _multiclass_stat_scores_update(
            preds, target, self.num_classes, 1, "global", self.ignore_index, sample_counts=sample_counts
        )
        return {"tp": tp, "fp": fp, "tn": tn, "fn": fn}

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multiclass_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelStatScores(_AbstractStatScores):
    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def _eager_validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mask = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, mask, self.multidim_average)
        self._update_state(tp, fp, tn, fn)

    def _engine_signature(self):
        return ("multilabel_stat_scores", self.num_labels, self.threshold, self.multidim_average,
                self.ignore_index)

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _multilabel_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


BinaryStatScores._signature_base = BinaryStatScores
MulticlassStatScores._signature_base = MulticlassStatScores
MultilabelStatScores._signature_base = MultilabelStatScores


class StatScores(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import StatScores
        >>> metric = StatScores(task="multiclass", num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> metric.compute().tolist()
        [3, 1, 7, 1, 4]
    """

    __new__ = _stat_facade_new((BinaryStatScores, MulticlassStatScores, MultilabelStatScores))
