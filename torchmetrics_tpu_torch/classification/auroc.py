"""AUROC metric classes.

Counterpart of ``torchmetrics_tpu/classification/auroc.py``. Each class
subclasses its task's curve class and keeps its update, so a collection
updates an AUROC and an AveragePrecision of one task and grid once. The
exact mode (``thresholds=None``, the default) computes through the filled
curves of ``_exact_jit.py`` (JAX ``auroc.py:73-77``): the whole compute
stays on the device, without a host sync (one, to drop ignored rows, under
``ignore_index`` for the binary and multiclass tasks).
"""
from typing import Any, Optional

from ..buffers import ShardedCatBuffer
from ..functional.classification import _exact_jit as _EJ
from ..functional.classification.auroc import _binary_auroc_compute, _check_max_fpr, _reduce_auroc, _support
from ..functional.classification.precision_recall_curve import Thresholds
from ..functional.classification.roc import _multiclass_roc_compute, _multilabel_roc_compute
from ..metric import Metric
from ..parallel.sharded_compute import histogram_auroc
from .base import _ClassificationTaskWrapper
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_facade,
)


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Binary AUROC, exact by default or binned; with ``max_fpr``, the
    McClish-standardised partial AUC up to that false-positive rate.

    ``hist_bins`` (JAX ``auroc.py:46-72``) selects the bucketed histogram
    over sharded cat state (``cat_layout="sharded"``, which it requires):
    each shard's scores are counted by the bincount kernel into
    ``hist_bins`` buckets and the AUROC is read off the summed histogram
    (:func:`~torchmetrics_tpu_torch.parallel.sharded_compute.histogram_auroc`),
    within half the tied positive-negative pairs of the exact value.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAUROC
        >>> metric = BinaryAUROC(device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = True
    plot = Metric.plot  # a value, not a curve
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, max_fpr: Optional[float] = None, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True,
                 hist_bins: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(thresholds, ignore_index, validate_args, **kwargs)
        _check_max_fpr(max_fpr, validate_args)
        if validate_args and hist_bins is not None:
            if not (isinstance(hist_bins, int) and hist_bins >= 2):
                raise ValueError(f"Argument `hist_bins` should be an int >= 2, but got: {hist_bins}")
            if self._cat_layout != "sharded":
                raise ValueError("Argument `hist_bins` selects the bucketed-histogram AUROC backend, which only "
                                 "applies to cat_layout='sharded' state")
            if max_fpr is not None:
                raise ValueError("`hist_bins` and `max_fpr` are mutually exclusive")
        self.max_fpr = max_fpr
        self.hist_bins = hist_bins

    def compute(self):
        if self.thresholds is None:
            if self.hist_bins is not None and isinstance(self.preds, ShardedCatBuffer):
                valid = self.valid if "valid" in self._defaults else None
                return histogram_auroc(self.preds, self.target, bins=self.hist_bins, valid=valid)
            return _EJ.binary_auroc_exact(*self._exact_state(), max_fpr=self.max_fpr)
        return _binary_auroc_compute(self.confmat, self.thresholds, self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """One-vs-rest AUROC, exact by default (one sort of the (C, N) scores)
    or over the binned curve state.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAUROC
        >>> metric = MulticlassAUROC(num_classes=3, thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
        ...                             [0.3, 0.3, 0.4], [0.1, 0.2, 0.7]]),
        ...               torch.tensor([0, 1, 2, 2]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
        >>> exact = MulticlassAUROC(num_classes=3, device="cpu")
        >>> exact.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1],
        ...                            [0.3, 0.3, 0.4], [0.1, 0.2, 0.7]]),
        ...              torch.tensor([0, 1, 2, 2]))
        >>> print(f"{float(exact.compute()):.4f}")
        1.0000
    """

    higher_is_better = True
    plot = Metric.plot  # a value, not a curve
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Class"

    def __init__(self, num_classes: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self):
        if self.thresholds is None:
            return _EJ.multiclass_auroc_exact(*self._exact_state(), self.average)
        fpr, tpr, _ = _multiclass_roc_compute(self.confmat, self.num_classes, self.thresholds)
        return _reduce_auroc(fpr, tpr, self.average, weights=_support(self.confmat))


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """AUROC per label, exact by default or over the binned curve state,
    reduced by ``average``. ``micro`` is exact mode's only (the flattened
    entries, ignored ones weighted 0); the binned class rejects it as the
    JAX class does."""

    higher_is_better = True
    plot = Metric.plot  # a value, not a curve
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = "Label"

    def __init__(self, num_labels: int, average: Optional[str] = "macro", thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels, thresholds, ignore_index, validate_args, **kwargs)
        self.average = average

    def compute(self):
        if self.thresholds is None:
            preds, target = self._exact_state()
            if self.average == "micro":
                preds, target = preds.reshape(-1), target.reshape(-1)
                weights = None if self.ignore_index is None else target != self.ignore_index
                return _EJ.binary_auroc_exact(preds, target, weights)
            return _EJ.multilabel_auroc_exact(preds, target, self.average, self.ignore_index)
        fpr, tpr, _ = _multilabel_roc_compute(self.confmat, self.num_labels, self.thresholds)
        return _reduce_auroc(fpr, tpr, self.average, weights=_support(self.confmat))


class AUROC(_ClassificationTaskWrapper):
    """Task facade.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import AUROC
        >>> metric = AUROC(task="binary", thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    def __new__(cls, task: str, thresholds: Thresholds = None, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, average: Optional[str] = "macro",
                max_fpr: Optional[float] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True, **kwargs: Any) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _curve_facade(task, num_classes, num_labels, (BinaryAUROC, MulticlassAUROC, MultilabelAUROC),
                             kwargs, binary_args=(max_fpr,), args=(average,))
