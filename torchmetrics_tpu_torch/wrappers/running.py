"""Running: a base metric over the states of its last ``window`` updates.

Counterpart of ``torchmetrics_tpu/wrappers/running.py`` (reference
``wrappers/running.py:27``): each update computes the batch's state from the
defaults with the base's pure ``update_state`` and pushes it onto a window;
``compute`` merges the window's states by their reduction tags
(``merge_states``) and runs the base's ``compute_state``. The base metric
itself accumulates nothing.
"""
from collections import deque
from typing import Any

from ..metric import Metric
from .abstract import WrapperMetric


class Running(WrapperMetric):
    """A base metric over its last ``window`` updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import Running, SumMetric
        >>> metric = Running(SumMetric(device="cpu"), window=2, device="cpu")
        >>> _ = metric(torch.tensor([1.0]))
        >>> _ = metric(torch.tensor([2.0]))
        >>> _ = metric(torch.tensor([3.0]))
        >>> float(metric.compute())
        5.0
    """

    def __init__(self, base_metric: Metric, window: int = 5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected argument `metric` to be an instance of `torchmetrics_tpu_torch.Metric` but got {base_metric}"
            )
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        if base_metric.full_state_update:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        self._check_wrapped(base_metric)
        self.base_metric = base_metric
        self.window = window
        self._window_states: deque = deque(maxlen=window)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """This batch's state from the defaults, pushed onto the window."""
        m = self.base_metric
        self._window_states.append(m.update_state(m.init_state(), *args, **kwargs))

    def _merged_window_state(self) -> dict:
        states = list(self._window_states)
        if not states:
            return self.base_metric.init_state()
        return states[0] if len(states) == 1 else self.base_metric.merge_states(states)

    def compute(self) -> Any:
        return self.base_metric.compute_state(self._merged_window_state())

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        return self.base_metric.compute_state(self._window_states[-1])

    def reset(self) -> None:
        super().reset()
        self._window_states.clear()
        self.base_metric.reset()

    def _apply(self, fn, recurse=True):
        """Device moves reach the window's states too."""
        super()._apply(fn, recurse)
        self._window_states = deque(
            ({k: tuple(fn(e) for e in v) if isinstance(v, tuple) else fn(v) for k, v in s.items()}
             for s in self._window_states),
            maxlen=self.window,
        )
        return self
