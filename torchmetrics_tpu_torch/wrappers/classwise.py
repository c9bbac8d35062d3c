"""ClasswiseWrapper: a per-class result split into a labelled dict.

Counterpart of ``torchmetrics_tpu/wrappers/classwise.py`` (reference
``wrappers/classwise.py:31``). The wrapped metric (``average=None``)
computes one value per class along a leading axis; labelling it is
:func:`~torchmetrics_tpu_torch.utils.data.label_results`.
"""
from typing import Any, Dict, List, Optional

import torch

from ..metric import Metric
from ..utils.data import label_results
from .abstract import WrapperMetric

Tensor = torch.Tensor


class ClasswiseWrapper(WrapperMetric):
    """One entry per class of the wrapped metric's result.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ClasswiseWrapper
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"), device="cpu")
        >>> metric.update(torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1]]), torch.tensor([0, 2]))
        >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
        {'multiclassaccuracy_0': 1.0, 'multiclassaccuracy_1': 0.0, 'multiclassaccuracy_2': 0.0}
    """

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        self._check_wrapped(metric)
        self.metric = metric
        self.labels = labels
        self._prefix = prefix
        self._postfix = postfix

    def _state_children(self) -> Dict[str, Any]:
        return {"metric": self.metric}

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        name = self._prefix or f"{type(self.metric).__name__.lower()}_"
        return label_results(x, labels=self.labels, prefix=name, postfix=self._postfix or "")

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self._convert(self.metric(*args, **kwargs))

    def reset(self) -> None:
        self.metric.reset()
        super().reset()
