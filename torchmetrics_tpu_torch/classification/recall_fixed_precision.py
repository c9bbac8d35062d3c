"""Best-X-at-fixed-Y metric classes — curve-state subclasses.

Counterpart of ``torchmetrics_tpu/classification/recall_fixed_precision.py``
(:1-378): recall at fixed precision, precision at fixed recall, sensitivity
at fixed specificity and specificity at fixed sensitivity, for the three
tasks, and their facades. Each class keeps its task curve class's update
(a collection updates it with an AUROC or AP of that task once). In exact
mode (``thresholds=None``, the default) compute scans the filled curve of
``_exact_jit.py`` on the device; binned, it scans the binned curve, whose
update is the CUDA bincount on the card.
"""
from typing import Any, Optional, Tuple

import torch

from ..functional.classification import _exact_jit as _EJ
from ..functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_compute,
)
from ..functional.classification.roc import _binary_roc_compute, _multiclass_roc_compute, _multilabel_roc_compute
from ..functional.classification.specificity_sensitivity import (
    _best_subject_to,
    _precision_recall,
    _recall_precision,
    _scan_per_class,
    _sensitivity_specificity,
    _specificity_sensitivity,
)
from ..metric import Metric
from .base import _ClassificationTaskWrapper
from .precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_facade,
)

Tensor = torch.Tensor


def _check_min(name: str, value: float, validate_args: bool) -> None:
    if validate_args and not (isinstance(value, float) and 0 <= value <= 1):
        raise ValueError(f"Expected argument `{name}` to be a float in the [0,1] range, but got {value}")


class _AtFixed:
    """The scan every at-fixed class shares: ``_use_roc`` picks the ROC
    (else the PR curve), ``_pick`` maps the curve's two value arrays to
    (objective, constraint), and ``_objective_first`` says the same for the
    filled exact scan (``_exact_jit``: the objective is recall or
    sensitivity when True).

    The constraint's value is the first argument after the class or label
    count, by position, as ``min_value`` (the JAX package's multiclass
    name) or by the family's own name (``min_precision``, ``min_recall``,
    ``min_specificity``, ``min_sensitivity``).

    ``higher_is_better`` is set class by class, as in the JAX package:
    ``True`` on the binary family only; the multiclass and multilabel
    classes keep their curve base's ``None``."""

    plot = Metric.plot  # a value, not a curve

    _use_roc = False
    _pick = staticmethod(_recall_precision)
    _objective_first = True
    _min_name = "min_precision"

    def _pop_min(self, min_value: Optional[float], kwargs: dict, validate_args: bool) -> float:
        """The constraint's value, given by position or by the family's
        name (taken out of ``kwargs``), checked."""
        named = kwargs.pop(self._min_name, None)
        if named is not None:
            if min_value is not None:
                raise TypeError(f"{type(self).__name__} got both `min_value` and `{self._min_name}`")
            min_value = named
        _check_min(self._min_name, min_value, validate_args)
        return min_value

    def _keep_min(self, min_value: float) -> None:
        self.min_value = min_value
        setattr(self, self._min_name, min_value)

    def _curve_kind(self) -> str:
        return "roc" if self._use_roc else "prc"


class _BinaryAtFixed(_AtFixed, BinaryPrecisionRecallCurve):
    higher_is_better = True

    def __init__(self, min_value: Optional[float] = None, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        min_value = self._pop_min(min_value, kwargs, validate_args)
        super().__init__(thresholds, ignore_index, validate_args, **kwargs)
        self._keep_min(min_value)

    def compute(self) -> Tuple[Tensor, Tensor]:
        if self.thresholds is None:
            return _EJ.binary_at_fixed_exact(*self._exact_state(), self.min_value, self._curve_kind(),
                                             self._objective_first)
        compute = _binary_roc_compute if self._use_roc else _binary_precision_recall_curve_compute
        a, b, t = compute(self.confmat, self.thresholds)
        return _best_subject_to(*self._pick(a, b), t, self.min_value)


class _MulticlassAtFixed(_AtFixed, MulticlassPrecisionRecallCurve):
    def __init__(self, num_classes: int, min_value: Optional[float] = None, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        min_value = self._pop_min(min_value, kwargs, validate_args)
        super().__init__(num_classes, thresholds, ignore_index, validate_args, **kwargs)
        self._keep_min(min_value)

    def compute(self) -> Tuple[Tensor, Tensor]:
        if self.thresholds is None:
            return _EJ.ovr_at_fixed_exact(*self._exact_state(), self.min_value, self._curve_kind(),
                                          self._objective_first)
        compute = _multiclass_roc_compute if self._use_roc else _multiclass_precision_recall_curve_compute
        curves = compute(self.confmat, self.num_classes, self.thresholds)
        return _scan_per_class(curves, self.thresholds, self._pick, self.min_value)


class _MultilabelAtFixed(_AtFixed, MultilabelPrecisionRecallCurve):
    def __init__(self, num_labels: int, min_value: Optional[float] = None, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        min_value = self._pop_min(min_value, kwargs, validate_args)
        super().__init__(num_labels, thresholds, ignore_index, validate_args, **kwargs)
        self._keep_min(min_value)

    def compute(self) -> Tuple[Tensor, Tensor]:
        if self.thresholds is None:
            return _EJ.multilabel_at_fixed_exact(*self._exact_state(), self.min_value, self._curve_kind(),
                                                 self._objective_first, self.ignore_index)
        compute = _multilabel_roc_compute if self._use_roc else _multilabel_precision_recall_curve_compute
        curves = compute(self.confmat, self.num_labels, self.thresholds)
        return _scan_per_class(curves, self.thresholds, self._pick, self.min_value)


class _RecallAtFixedPrecision(_AtFixed):
    _min_name = "min_precision"


class _PrecisionAtFixedRecall(_AtFixed):
    _pick = staticmethod(_precision_recall)
    _objective_first = False
    _min_name = "min_recall"


class _SensitivityAtSpecificity(_AtFixed):
    _use_roc = True
    _pick = staticmethod(_sensitivity_specificity)
    _min_name = "min_specificity"


class _SpecificityAtSensitivity(_AtFixed):
    _use_roc = True
    _pick = staticmethod(_specificity_sensitivity)
    _objective_first = False
    _min_name = "min_sensitivity"


class BinaryRecallAtFixedPrecision(_RecallAtFixedPrecision, _BinaryAtFixed):
    """Highest recall with precision >= ``min_precision``, and its threshold.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryRecallAtFixedPrecision
        >>> metric = BinaryRecallAtFixedPrecision(min_precision=0.5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 0.1)
    """


class BinaryPrecisionAtFixedRecall(_PrecisionAtFixedRecall, _BinaryAtFixed):
    """Highest precision with recall >= ``min_recall``, and its threshold."""


class BinarySensitivityAtSpecificity(_SensitivityAtSpecificity, _BinaryAtFixed):
    """Highest sensitivity with specificity >= ``min_specificity``, and its threshold."""


class BinarySpecificityAtSensitivity(_SpecificityAtSensitivity, _BinaryAtFixed):
    """Highest specificity with sensitivity >= ``min_sensitivity``, and its threshold."""


class MulticlassRecallAtFixedPrecision(_RecallAtFixedPrecision, _MulticlassAtFixed):
    """Per class (one-vs-rest): (C,) recalls and thresholds."""


class MulticlassPrecisionAtFixedRecall(_PrecisionAtFixedRecall, _MulticlassAtFixed):
    """Per class (one-vs-rest): (C,) precisions and thresholds."""


class MulticlassSensitivityAtSpecificity(_SensitivityAtSpecificity, _MulticlassAtFixed):
    """Per class (one-vs-rest): (C,) sensitivities and thresholds."""


class MulticlassSpecificityAtSensitivity(_SpecificityAtSensitivity, _MulticlassAtFixed):
    """Per class (one-vs-rest): (C,) specificities and thresholds."""


class MultilabelRecallAtFixedPrecision(_RecallAtFixedPrecision, _MultilabelAtFixed):
    """Per label: (L,) recalls and thresholds."""


class MultilabelPrecisionAtFixedRecall(_PrecisionAtFixedRecall, _MultilabelAtFixed):
    """Per label: (L,) precisions and thresholds."""


class MultilabelSensitivityAtSpecificity(_SensitivityAtSpecificity, _MultilabelAtFixed):
    """Per label: (L,) sensitivities and thresholds."""


class MultilabelSpecificityAtSensitivity(_SpecificityAtSensitivity, _MultilabelAtFixed):
    """Per label: (L,) specificities and thresholds."""


def _at_fixed_new(classes):
    """``__new__`` of an at-fixed task facade over its (binary, multiclass,
    multilabel) classes; the constraint's value follows ``task``, by
    position or by the family's name."""
    min_name = classes[0]._min_name

    def __new__(cls, task: str, min_value: Optional[float] = None, thresholds: Thresholds = None,
                num_classes: Optional[int] = None, num_labels: Optional[int] = None,
                ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> Metric:
        if min_name in kwargs:
            min_value = kwargs.pop(min_name)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _curve_facade(task, num_classes, num_labels, classes, kwargs, binary_args=(min_value,),
                             args=(min_value,))

    return __new__


class RecallAtFixedPrecision(_ClassificationTaskWrapper):
    """Task facade; ``min_precision`` follows ``task``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RecallAtFixedPrecision
        >>> metric = RecallAtFixedPrecision("binary", 0.5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 0.1)
    """

    __new__ = _at_fixed_new((BinaryRecallAtFixedPrecision, MulticlassRecallAtFixedPrecision,
                             MultilabelRecallAtFixedPrecision))


class PrecisionAtFixedRecall(_ClassificationTaskWrapper):
    """Task facade; ``min_recall`` follows ``task``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import PrecisionAtFixedRecall
        >>> metric = PrecisionAtFixedRecall("binary", 0.5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 0.6)
    """

    __new__ = _at_fixed_new((BinaryPrecisionAtFixedRecall, MulticlassPrecisionAtFixedRecall,
                             MultilabelPrecisionAtFixedRecall))


class SensitivityAtSpecificity(_ClassificationTaskWrapper):
    """Task facade; ``min_specificity`` follows ``task``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SensitivityAtSpecificity
        >>> metric = SensitivityAtSpecificity("binary", 0.5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 0.6)
    """

    __new__ = _at_fixed_new((BinarySensitivityAtSpecificity, MulticlassSensitivityAtSpecificity,
                             MultilabelSensitivityAtSpecificity))


class SpecificityAtSensitivity(_ClassificationTaskWrapper):
    """Task facade; ``min_sensitivity`` follows ``task``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SpecificityAtSensitivity
        >>> metric = SpecificityAtSensitivity("binary", 0.5, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.8, 0.6, 0.3, 0.9, 0.4]), torch.tensor([0, 1, 1, 0, 1, 0]))
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 0.8)
    """

    __new__ = _at_fixed_new((BinarySpecificityAtSensitivity, MulticlassSpecificityAtSensitivity,
                             MultilabelSpecificityAtSensitivity))
