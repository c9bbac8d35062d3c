"""MetricTracker: one copy of a metric or collection per ``increment()`` (epoch).

Counterpart of ``torchmetrics_tpu/wrappers/tracker.py`` (reference
``wrappers/tracker.py:31``, ``best_metric`` :186). ``increment`` deep-copies
the base and resets the copy; a copied collection keeps its compute groups,
and its members share states with each other inside the copy, never with
the base or another epoch's copy. ``best_metric`` reads the stacked results
back to the host once.
"""
from copy import deepcopy
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from ..collections import MetricCollection
from ..metric import Metric
from ..utils.prints import rank_zero_warn
from .abstract import WrapperMetric

Tensor = torch.Tensor


class MetricTracker(WrapperMetric):
    """Tracks a metric (or collection) over increments (epochs).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric, MetricTracker
        >>> tracker = MetricTracker(MeanMetric(device="cpu"), device="cpu")
        >>> for epoch in range(2):
        ...     tracker.increment()
        ...     tracker.update(torch.tensor(float(epoch + 1)))
        >>> best, step = tracker.best_metric(return_step=True)
        >>> print(f"{best:.1f}", step)
        2.0 1
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool], None] = True,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a torchmetrics_tpu_torch `Metric` or `MetricCollection` "
                f"but got {metric}"
            )
        self._check_wrapped(metric)
        self._base_metric = metric
        if maximize is None:  # from higher_is_better
            if isinstance(metric, Metric):
                if metric.higher_is_better is None:
                    raise AttributeError("When `maximize` is not set, the metric must define `higher_is_better`")
                maximize = bool(metric.higher_is_better)
            else:
                maximize = [bool(m.higher_is_better) for m in metric.values(copy_state=False)]
        if not isinstance(maximize, (bool, list)) or (
                isinstance(maximize, list) and not all(isinstance(m, bool) for m in maximize)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        self.maximize = maximize
        self._increment_called = False
        self._metrics = torch.nn.ModuleList()

    def _state_children(self) -> Dict[str, Any]:
        return {"metrics": list(self._metrics)}

    @property
    def n_steps(self) -> int:
        return len(self._metrics)

    def increment(self) -> None:
        """Start tracking a new version (epoch)."""
        self._increment_called = True
        self._metrics.append(deepcopy(self._base_metric))
        self._metrics[-1].reset()

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._metrics[-1](*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Any:
        """The results of every tracked version, stacked along a leading axis."""
        self._check_for_increment("compute_all")
        res = [m.compute() for m in self._metrics]
        if isinstance(self._base_metric, MetricCollection):
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in res[0]}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def best_metric(self, return_step: bool = False) -> Any:
        """The best value (and its step) across the tracked versions, as
        Python numbers; ``None`` where a result is not one value per step."""
        res = self.compute_all()

        def _best(vals: Tensor, maximize: bool) -> Tuple[float, int]:
            arr = vals.detach().cpu().numpy()
            idx = int(np.argmax(arr)) if maximize else int(np.argmin(arr))
            return float(arr[idx]), idx

        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            values: Dict[str, Any] = {}
            steps: Dict[str, Any] = {}
            for (k, v), mx in zip(res.items(), maximize):
                try:
                    values[k], steps[k] = _best(v, mx)
                except (ValueError, TypeError):
                    values[k], steps[k] = None, None
            return (values, steps) if return_step else values
        try:
            value, step = _best(res, bool(self.maximize))
        except (ValueError, TypeError):
            rank_zero_warn("Encountered nested structure; returning None as best metric.")
            value, step = None, None
        return (value, step) if return_step else value

    def reset(self) -> None:
        """Reset the current version."""
        if len(self._metrics):
            self._metrics[-1].reset()

    def reset_all(self) -> None:
        for m in self._metrics:
            m.reset()

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")
