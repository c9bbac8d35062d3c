"""PrecisionRecallCurve metric classes — the stateful Engine B, binned mode.

Counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``.
The multiclass binned state is a (T, C, 2, 2) int32 confusion per threshold
with a ``"sum"`` reduction. ``thresholds=None`` (exact mode, raw cat states)
and the binary/multilabel classes raise ``NotImplementedError`` until later
slices.
"""
from typing import Any, Optional

import torch

from ..functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
    _exact_mode_not_ported,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _task_not_ported,
)
from ..metric import Metric
from ..utils.enums import ClassificationTask
from .base import _ClassificationTaskWrapper

Tensor = torch.Tensor


class MulticlassPrecisionRecallCurve(Metric):
    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    _signature_key = "multiclass_prc"

    def __init__(self, num_classes: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if thresholds is None:
            raise _exact_mode_not_ported()
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        thr = _adjust_threshold_arg(thresholds, self.device)
        # a buffer, so .to() moves it with the states; not part of state_dict
        self.register_buffer("thresholds", thr, persistent=False)
        self._thresholds_key = tuple(thr.tolist())
        self.add_state("confmat", torch.zeros(thr.shape[0], num_classes, 2, 2, dtype=torch.int32),
                       dist_reduce_fx="sum")

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


MulticlassPrecisionRecallCurve._signature_base = MulticlassPrecisionRecallCurve


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task facade (multiclass only in this slice)."""

    def __new__(cls, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        task = ClassificationTask.from_str(task)
        if task != ClassificationTask.MULTICLASS:
            raise _task_not_ported(task.value)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return MulticlassPrecisionRecallCurve(num_classes, thresholds=thresholds, ignore_index=ignore_index,
                                              validate_args=validate_args, **kwargs)
