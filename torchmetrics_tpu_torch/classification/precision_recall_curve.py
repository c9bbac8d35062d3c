"""PrecisionRecallCurve metric classes — the stateful Engine B, binned mode.

Counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``.
The binned state is a (T, 2, 2), (T, C, 2, 2) or (T, L, 2, 2) int32
confusion per threshold with a ``"sum"`` reduction. ``thresholds=None``
(exact mode, raw cat states) raises ``NotImplementedError`` until a later
slice.
"""
from typing import Any, Optional, Tuple

import torch

from ..functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_update,
    _check_task_count,
    _exact_mode_not_ported,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_update,
)
from ..metric import Metric
from ..utils.enums import ClassificationTask
from .base import _ClassificationTaskWrapper

Tensor = torch.Tensor


class _BinnedCurve(Metric):
    """Registers the threshold grid and the binned confusion state.

    ``thresholds`` is a buffer, so ``.to()`` moves it with the states; it is
    not part of ``state_dict``. The task classes set ``_signature_key`` and
    ``_engine_signature``: ROC, AUROC and AP subclasses keep their curve
    class's update, so a collection updates them once.
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def _init_binned(self, thresholds: Thresholds, ignore_index: Optional[int], validate_args: bool,
                     columns: Tuple[int, ...]) -> None:
        if thresholds is None:
            raise _exact_mode_not_ported()
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        thr = _adjust_threshold_arg(thresholds, self.device)
        self.register_buffer("thresholds", thr, persistent=False)
        self._thresholds_key = tuple(thr.tolist())
        self.add_state("confmat", torch.zeros(thr.shape[0], *columns, 2, 2, dtype=torch.int32), dist_reduce_fx="sum")


class BinaryPrecisionRecallCurve(_BinnedCurve):
    """Binned precision-recall curve of a binary task; state (T, 2, 2).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve
        >>> metric = BinaryPrecisionRecallCurve(thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> [[round(float(x), 4) for x in v] for v in metric.compute()]
        [[0.5, 0.6, 1.0, 1.0, 0.0, 1.0], [1.0, 1.0, 1.0, 0.6667, 0.0, 0.0], [0.0, 0.25, 0.5, 0.75, 1.0]]
    """

    _signature_key = "binary_prc"

    def __init__(self, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._init_binned(thresholds, ignore_index, validate_args, ())

    def _engine_signature(self):
        return (self._signature_key, self._thresholds_key, self.ignore_index)

    def update(self, preds: Tensor, target: Tensor) -> None:
        p, t, _, mask = _binary_precision_recall_curve_format(preds, target, None, self.ignore_index)
        self.confmat = self.confmat + _binary_precision_recall_curve_update(p, t, self.thresholds, mask)

    def compute(self):
        return _binary_precision_recall_curve_compute(self.confmat, self.thresholds)


class MulticlassPrecisionRecallCurve(_BinnedCurve):
    """Binned one-vs-rest precision-recall curves; state (T, C, 2, 2)."""

    _signature_key = "multiclass_prc"

    def __init__(self, num_classes: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._init_binned(thresholds, ignore_index, validate_args, (num_classes,))

    def _engine_signature(self):
        return (self._signature_key, self.num_classes, self._thresholds_key, self.ignore_index)

    def update(self, preds: Tensor, target: Tensor) -> None:
        p, t, _, mask = _multiclass_precision_recall_curve_format(preds, target, self.num_classes, None,
                                                                  self.ignore_index)
        self.confmat = self.confmat + _multiclass_precision_recall_curve_update(
            p, t, self.num_classes, self.thresholds, mask
        )

    def compute(self):
        return _multiclass_precision_recall_curve_compute(self.confmat, self.num_classes, self.thresholds)


class MultilabelPrecisionRecallCurve(_BinnedCurve):
    """Binned precision-recall curves per label; state (T, L, 2, 2)."""

    _signature_key = "multilabel_prc"

    def __init__(self, num_labels: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self._init_binned(thresholds, ignore_index, validate_args, (num_labels,))

    def _engine_signature(self):
        return (self._signature_key, self.num_labels, self._thresholds_key, self.ignore_index)

    def update(self, preds: Tensor, target: Tensor) -> None:
        # as in the JAX class: format without ignore_index (targets not
        # clipped), then mask the ignored entries by weight 0
        p, t, _, _ = _multilabel_precision_recall_curve_format(preds, target, self.num_labels, None, None)
        mask = None if self.ignore_index is None else target.reshape(-1, self.num_labels) != self.ignore_index
        self.confmat = self.confmat + _multilabel_precision_recall_curve_update(
            p, t, self.num_labels, self.thresholds, mask
        )

    def compute(self):
        return _multilabel_precision_recall_curve_compute(self.confmat, self.num_labels, self.thresholds)


BinaryPrecisionRecallCurve._signature_base = BinaryPrecisionRecallCurve
MulticlassPrecisionRecallCurve._signature_base = MulticlassPrecisionRecallCurve
MultilabelPrecisionRecallCurve._signature_base = MultilabelPrecisionRecallCurve


def _curve_facade(task: str, num_classes: Optional[int], num_labels: Optional[int], classes, kwargs: dict,
                  binary_args: tuple = (), args: tuple = ()) -> Metric:
    """The binary, multiclass or multilabel class of ``classes`` for ``task``:
    ``binary_args`` lead the binary class's arguments, ``args`` follow the
    class or label count, ``kwargs`` go to every task."""
    binary_cls, multiclass_cls, multilabel_cls = classes
    task = _check_task_count(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_cls(*binary_args, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_cls(num_classes, *args, **kwargs)
    return multilabel_cls(num_labels, *args, **kwargs)


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task facade."""

    def __new__(cls, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _curve_facade(task, num_classes, num_labels, (BinaryPrecisionRecallCurve,
                             MulticlassPrecisionRecallCurve, MultilabelPrecisionRecallCurve), kwargs)
