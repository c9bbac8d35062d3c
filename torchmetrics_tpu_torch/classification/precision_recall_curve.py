"""PrecisionRecallCurve metric classes — the stateful Engine B.

Counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``.
Two state modes:

- ``thresholds`` an int, list or tensor (binned): a (T, 2, 2), (T, C, 2, 2)
  or (T, L, 2, 2) int32 confusion per threshold with a ``"sum"`` reduction;
- ``thresholds=None`` (exact, the default): the formatted ``preds`` and
  ``target`` of every update as ``cat`` states, with a ``valid`` mask state
  for the binary and multiclass tasks under ``ignore_index`` (JAX
  ``:53-96, :116-160, :172-210``). Under the default padded layout each is
  a ``CatBuffer``, and ``_exact_state`` reads its valid rows without a copy.
  Dropping ignored rows there is boolean indexing, one host sync; without
  ``ignore_index`` the scalar computes (AUROC, AP, the at-fixed scans) make
  none. The curve computes return data-length curves and sync by nature.
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
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_update,
)
from ..metric import Metric
from ..parallel.sharded_compute import cat_compact
from ..utils.enums import ClassificationTask
from .base import _ClassificationTaskWrapper

Tensor = torch.Tensor


class _CurveState(Metric):
    """Registers the threshold grid and the binned state, or the exact
    mode's cat states.

    ``thresholds`` is a buffer (None in exact mode), so ``.to()`` moves it
    with the states; it is not part of ``state_dict``. The task classes set
    ``_signature_key`` and ``_engine_signature``: ROC, AUROC, AP and the
    at-fixed subclasses keep their curve class's update, so a collection
    updates them once.
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def _init_curve(self, thresholds: Thresholds, ignore_index: Optional[int], validate_args: bool,
                    columns: Tuple[int, ...], valid_state: bool = True) -> None:
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        thr = _adjust_threshold_arg(thresholds, self.device)
        self.register_buffer("thresholds", thr, persistent=False)
        if thr is None:
            self._thresholds_key = None
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
            if ignore_index is not None and valid_state:
                self.add_state("valid", [], dist_reduce_fx="cat")
            return
        self._thresholds_key = tuple(thr.tolist())
        self.add_state("confmat", torch.zeros(thr.shape[0], *columns, 2, 2, dtype=torch.int32), dist_reduce_fx="sum")

    def _append_exact(self, preds: Tensor, target: Tensor, mask: Optional[Tensor]) -> None:
        self.preds.append(preds)
        self.target.append(target)
        if mask is not None and "valid" in self._defaults:
            self.valid.append(mask)

    def _exact_state(self) -> Tuple[Tensor, Tensor]:
        """The concatenated ``preds`` and ``target``, ignored rows dropped."""
        preds, target = cat_compact(self.preds), cat_compact(self.target)
        if "valid" in self._defaults:
            keep = cat_compact(self.valid).to(torch.bool)
            preds, target = preds[keep], target[keep]
        return preds, target


class BinaryPrecisionRecallCurve(_CurveState):
    """Precision-recall curve of a binary task: exact over every distinct
    score by default, or binned on a (T, 2, 2) state.

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
        self._init_curve(thresholds, ignore_index, validate_args, ())

    def _engine_signature(self):
        return (self._signature_key, self._thresholds_key, self.ignore_index)

    def update(self, preds: Tensor, target: Tensor) -> None:
        p, t, _, mask = _binary_precision_recall_curve_format(preds, target, None, self.ignore_index)
        if self.thresholds is None:
            self._append_exact(p, t, mask)
        else:
            self.confmat = self.confmat + _binary_precision_recall_curve_update(p, t, self.thresholds, mask)

    def compute(self):
        if self.thresholds is None:
            return _binary_precision_recall_curve_compute(self._exact_state(), None)
        return _binary_precision_recall_curve_compute(self.confmat, self.thresholds)

    def plot(self, curve=None, score=None, ax=None):
        """Recall against precision (the curve's first two outputs swapped),
        of ``curve`` or of ``compute()``; needs matplotlib."""
        from ..utils.plot import plot_curve

        curve = curve if curve is not None else self.compute()
        return plot_curve((curve[1], curve[0], curve[2]), score=score, ax=ax,
                          label_names=("Recall", "Precision"), name=type(self).__name__)


class MulticlassPrecisionRecallCurve(_CurveState):
    """One-vs-rest precision-recall curves: per-class exact curves by
    default, or binned on a (T, C, 2, 2) state."""

    _signature_key = "multiclass_prc"

    def __init__(self, num_classes: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._init_curve(thresholds, ignore_index, validate_args, (num_classes,))

    def _engine_signature(self):
        return (self._signature_key, self.num_classes, self._thresholds_key, self.ignore_index)

    def update(self, preds: Tensor, target: Tensor) -> None:
        p, t, _, mask = _multiclass_precision_recall_curve_format(preds, target, self.num_classes, None,
                                                                  self.ignore_index)
        if self.thresholds is None:
            self._append_exact(p, t, mask)
        else:
            self.confmat = self.confmat + _multiclass_precision_recall_curve_update(
                p, t, self.num_classes, self.thresholds, mask
            )

    def compute(self):
        if self.thresholds is None:
            return _multiclass_precision_recall_curve_compute(self._exact_state(), self.num_classes, None)
        return _multiclass_precision_recall_curve_compute(self.confmat, self.num_classes, self.thresholds)

    plot = BinaryPrecisionRecallCurve.plot


class MultilabelPrecisionRecallCurve(_CurveState):
    """Precision-recall curves per label: per-label exact curves by default
    (the ``target`` state keeps the ignore marker, so no ``valid`` state),
    or binned on a (T, L, 2, 2) state."""

    _signature_key = "multilabel_prc"

    def __init__(self, num_labels: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self._init_curve(thresholds, ignore_index, validate_args, (num_labels,), valid_state=False)

    def _engine_signature(self):
        return (self._signature_key, self.num_labels, self._thresholds_key, self.ignore_index)

    def update(self, preds: Tensor, target: Tensor) -> None:
        # as in the JAX class: format without ignore_index (targets not
        # clipped), then mask the ignored entries by weight 0
        p, t, _, _ = _multilabel_precision_recall_curve_format(preds, target, self.num_labels, None, None)
        if self.thresholds is None:
            self._append_exact(p, t, None)
            return
        mask = None if self.ignore_index is None else target.reshape(-1, self.num_labels) != self.ignore_index
        self.confmat = self.confmat + _multilabel_precision_recall_curve_update(
            p, t, self.num_labels, self.thresholds, mask
        )

    def compute(self):
        if self.thresholds is None:
            return _multilabel_precision_recall_curve_compute(self._exact_state(), self.num_labels, None,
                                                              self.ignore_index)
        return _multilabel_precision_recall_curve_compute(self.confmat, self.num_labels, self.thresholds)

    plot = BinaryPrecisionRecallCurve.plot


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
