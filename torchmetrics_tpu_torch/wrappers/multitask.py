"""MultitaskWrapper: one metric or collection per task, with dict inputs.

Counterpart of ``torchmetrics_tpu/wrappers/multitask.py`` (reference
``wrappers/multitask.py:30``). The tasks sit in an ``nn.ModuleDict``, so
``.to()`` and ``state_dict`` reach every task's metric or collection.
"""
import copy
from typing import Any, Dict, Optional, Union

import torch

from ..collections import MetricCollection
from ..metric import Metric
from .abstract import WrapperMetric


class MultitaskWrapper(WrapperMetric):
    """A dict of task -> metric, updated from dicts of per-task inputs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric, MultitaskWrapper
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = MultitaskWrapper({"loss": MeanMetric(device="cpu"), "cls": BinaryAccuracy(device="cpu")},
        ...                           device="cpu")
        >>> preds = {"loss": torch.tensor([1.0, 2.0]), "cls": torch.tensor([0.9, 0.2])}
        >>> target = {"loss": torch.tensor([1.0, 1.0]), "cls": torch.tensor([1, 0])}
        >>> metric.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
        {'cls': 1.0, 'loss': 1.5}
    """

    is_differentiable = False

    def __init__(
        self,
        task_metrics: Dict[str, Union[Metric, MetricCollection]],
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not isinstance(metric, (Metric, MetricCollection)):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )
        self._check_wrapped(*task_metrics.values())
        self.task_metrics = torch.nn.ModuleDict(task_metrics)
        self._prefix = prefix or ""
        self._postfix = postfix or ""

    def _state_children(self) -> Dict[str, Any]:
        return dict(self.task_metrics.items())

    def _check_keys(self, data: Dict[str, Any], name: str) -> None:
        if set(data) != set(self.task_metrics.keys()):
            raise ValueError(
                f"Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped "
                f"`task_metrics`. Found {name} keys = {sorted(data)} vs metric keys = {sorted(self.task_metrics)}"
            )

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        self._check_keys(task_preds, "task_preds")
        self._check_keys(task_targets, "task_targets")
        for task_name, metric in self.task_metrics.items():
            metric.update(task_preds[task_name], task_targets[task_name])

    def compute(self) -> Dict[str, Any]:
        return {f"{self._prefix}{name}{self._postfix}": m.compute() for name, m in self.task_metrics.items()}

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        self._check_keys(task_preds, "task_preds")
        self._check_keys(task_targets, "task_targets")
        self._update_count += 1
        self._computed = None
        return {
            f"{self._prefix}{name}{self._postfix}": m(task_preds[name], task_targets[name])
            for name, m in self.task_metrics.items()
        }

    def reset(self) -> None:
        for m in self.task_metrics.values():
            m.reset()
        super().reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MultitaskWrapper":
        mt = copy.deepcopy(self)
        if prefix is not None:
            mt._prefix = prefix
        if postfix is not None:
            mt._postfix = postfix
        return mt
