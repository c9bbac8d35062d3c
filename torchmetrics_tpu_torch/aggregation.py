"""Aggregation metrics: free-standing accumulators.

Counterpart of ``torchmetrics_tpu/aggregation.py:28-226`` (reference
``src/torchmetrics/aggregation.py``): ``BaseAggregator`` with its
``nan_strategy`` (``"error"``, ``"warn"``, ``"ignore"``, ``"disable"`` or a
float to impute), ``MaxMetric``, ``MinMetric``, ``SumMetric``, ``CatMetric``
and the weighted ``MeanMetric``. Values are float32, as in the JAX package.

NaN *checking* (error, warn) reads the input on the host before the update,
as there; NaN *ignoring* masks the reductions, so only ``CatMetric``, which
drops the values, changes its increment's length with the data. Under
``"ignore"``, ``"disable"`` or a float the update reads nothing back.

The running and online variants (JAX ``aggregation.py:228-408``):
``RunningMean`` and ``RunningSum`` keep a fixed ``(window, 2)`` ring of
per-update ``[sum, count]`` rows and an int32 cursor on the device, so
their state syncs elementwise; ``WindowedSum``, ``WindowedMean``,
``WindowedMax``, ``WindowedMin``, ``DecayedSum`` and ``DecayedMean`` build a
:class:`~torchmetrics_tpu_torch.online.WindowedMetric` or
:class:`~torchmetrics_tpu_torch.online.DecayedMetric` over the basic
aggregator, whose constructor takes the keyword arguments.
"""
from typing import Any, Union

import torch

from .metric import Metric
from .utils.compute import _safe_divide
from .utils.data import dim_zero_cat
from .utils.prints import rank_zero_warn

Tensor = torch.Tensor

__all__ = ["BaseAggregator", "CatMetric", "DecayedMean", "DecayedSum", "MaxMetric", "MeanMetric", "MinMetric",
           "RunningMean", "RunningSum", "SumMetric", "WindowedMax", "WindowedMean", "WindowedMin", "WindowedSum"]


def _is_float_strategy(nan_strategy: Any) -> bool:
    return isinstance(nan_strategy, (int, float)) and not isinstance(nan_strategy, bool)


class BaseAggregator(Metric):
    """Shared nan-strategy plumbing for aggregators."""

    is_differentiable = None
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        fn: str,
        default_value: Union[Tensor, list],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed = ("error", "warn", "ignore", "disable")
        if not _is_float_strategy(nan_strategy) and nan_strategy not in allowed:
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed} but got {nan_strategy}"
            )
        self.nan_strategy = nan_strategy
        self.state_name = state_name
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn)

    def _value(self, value: Any) -> Tensor:
        """The input as a float32 tensor on this metric's device."""
        return torch.as_tensor(value, dtype=torch.float32, device=self.device)

    def _eager_validate(self, *args: Any, **kwargs: Any) -> None:
        if self.nan_strategy not in ("error", "warn"):  # nothing to raise or warn: read nothing
            return
        for v in (*args, *kwargs.values()):
            if isinstance(v, Tensor) and v.is_floating_point() and bool(torch.isnan(v).any()):
                if self.nan_strategy == "error":
                    raise RuntimeError("Encountered `nan` values in tensor")
                if self.nan_strategy == "warn":
                    rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)

    def _impute(self, x: Tensor) -> Tensor:
        """Replace NaN under a float strategy; masks handle ignore and warn."""
        if _is_float_strategy(self.nan_strategy):
            return torch.nan_to_num(x, nan=float(self.nan_strategy))
        return x

    def _nan_mask(self, x: Tensor) -> Tensor:
        if self.nan_strategy in ("ignore", "warn"):
            return ~torch.isnan(x)
        return torch.ones_like(x, dtype=torch.bool)

    def compute(self) -> Tensor:
        return getattr(self, self.state_name)


class MaxMetric(BaseAggregator):
    """Running maximum. Parity: reference ``aggregation.py:114``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> metric.update(torch.tensor([4.0]))
        >>> float(metric.compute())
        4.0
    """

    higher_is_better = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-float("inf")), nan_strategy, **kwargs)

    def update(self, value: Any) -> None:
        value = self._impute(self._value(value))
        batch_max = torch.amax(torch.where(self._nan_mask(value), value, -float("inf")))
        self.value = torch.maximum(self.value, batch_max)


class MinMetric(BaseAggregator):
    """Running minimum. Parity: reference ``aggregation.py:219``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> metric.update(torch.tensor([4.0]))
        >>> float(metric.compute())
        1.0
    """

    higher_is_better = False

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, **kwargs)

    def update(self, value: Any) -> None:
        value = self._impute(self._value(value))
        batch_min = torch.amin(torch.where(self._nan_mask(value), value, float("inf")))
        self.value = torch.minimum(self.value, batch_min)


class SumMetric(BaseAggregator):
    """Running sum. Parity: reference ``aggregation.py:324``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> metric.update(torch.tensor([4.0]))
        >>> float(metric.compute())
        10.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)

    def update(self, value: Any) -> None:
        value = self._impute(self._value(value))
        self.value = self.value + torch.sum(torch.where(self._nan_mask(value), value, 0.0))


class CatMetric(BaseAggregator):
    """Concatenate all seen values. Parity: reference ``aggregation.py:429``.

    Under ``nan_strategy`` ignore or warn the update drops the NaN values,
    so its increment's length depends on the data.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> metric.update(torch.tensor([4.0]))
        >>> metric.compute().tolist()
        [1.0, 2.0, 3.0, 4.0]
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)
        if self.nan_strategy in ("ignore", "warn"):
            # the update drops NaN values by boolean indexing: the increment's
            # length depends on the data (JAX ``aggregation.py:169-171``)
            self._use_jit = False

    def update(self, value: Any) -> None:
        value = torch.atleast_1d(self._impute(self._value(value)))
        if self.nan_strategy in ("ignore", "warn"):
            value = value[~torch.isnan(value)]
        if value.numel():
            self.value.append(value)

    def compute(self) -> Tensor:
        return dim_zero_cat(self.value) if len(self.value) else torch.zeros((0,), dtype=torch.float32,
                                                                              device=self.device)


class MeanMetric(BaseAggregator):
    """Weighted running mean. Parity: reference ``aggregation.py:493``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> _ = metric(torch.tensor([1.0, 2.0, 3.0]))
        >>> _ = metric(torch.tensor([4.0, 5.0]))
        >>> float(metric.compute())
        3.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Any, weight: Union[Tensor, float] = 1.0) -> None:
        value = self._value(value)
        if isinstance(weight, (int, float)):  # a fill, not a copy of a host scalar to the card
            weight = torch.full_like(value, float(weight))
        weight = torch.broadcast_to(self._value(weight), value.shape)
        nans = torch.isnan(value) | torch.isnan(weight)
        if _is_float_strategy(self.nan_strategy):
            # impute both the value and its weight (the JAX package's
            # reading of reference ``aggregation.py:101-102``)
            fill = float(self.nan_strategy)
            value = torch.where(nans, fill, value)
            weight = torch.where(nans, fill, weight)
            keep = torch.ones_like(nans)
        elif self.nan_strategy in ("ignore", "warn"):
            keep = ~nans
        else:  # "disable" or "error": propagate (error has raised already)
            keep = torch.ones_like(nans)
        self.value = self.value + torch.sum(torch.where(keep, value * weight, 0.0))
        self.weight = self.weight + torch.sum(torch.where(keep, weight, 0.0))

    def compute(self) -> Tensor:
        return _safe_divide(self.value, self.weight)


class RunningMean(BaseAggregator):
    """Mean over the elements of the last ``window`` updates.

    Counterpart of JAX ``aggregation.py:228`` (reference ``aggregation.py:616``):
    a fixed ``(window, 2)`` ring of per-update ``[element sum, element
    count]`` rows and an int32 ``cursor``; the update writes row ``cursor %
    window`` with ``index_copy`` and reads nothing back. NaN elements are
    excluded under ``"warn"`` (the default) and ``"ignore"``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RunningMean
        >>> metric = RunningMean(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> metric.update(torch.tensor([4.0]))
        >>> float(metric.compute())
        2.5
    """

    full_state_update = True  # the update reads the cursor and ring it advances

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.zeros((max(int(window), 1), 2), dtype=torch.float32), nan_strategy, **kwargs)
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Arg `window` should be a positive integer but got {window}")
        self.window = window
        self.add_state("cursor", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")

    def update(self, value: Any) -> None:
        value = torch.atleast_1d(self._impute(self._value(value)))
        mask = self._nan_mask(value)
        row = torch.stack([torch.sum(torch.where(mask, value, 0.0)), torch.sum(mask).to(torch.float32)])
        at = (self.cursor % self.window).reshape(1).long()
        self.value = self.value.index_copy(0, at, row.unsqueeze(0))
        self.cursor = self.cursor + 1

    def compute(self) -> Tensor:
        total, count = torch.sum(self.value, dim=0)
        return torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0)


class RunningSum(RunningMean):
    """Sum over the last ``window`` updates. Counterpart of JAX ``aggregation.py:278``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RunningSum
        >>> metric = RunningSum(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> metric.update(torch.tensor([4.0]))
        >>> float(metric.compute())
        10.0
    """

    def compute(self) -> Tensor:
        return torch.sum(self.value[:, 0])


class WindowedSum(Metric):
    """Sum over about the last ``horizon`` updates, in ``slots`` slots.

    ``WindowedSum(horizon, slots, **kwargs)`` is
    ``SumMetric(**kwargs).windowed(horizon, slots)``, a
    :class:`~torchmetrics_tpu_torch.online.WindowedMetric`: unlike
    :class:`RunningSum` (one ring row per update), its state is ``slots``
    sub-epoch states, so ``horizon`` may be large.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import WindowedSum
        >>> metric = WindowedSum(horizon=4, slots=4, device="cpu")
        >>> for v in [1.0, 2.0, 3.0, 4.0, 5.0]:
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())
        14.0
    """

    _base_cls: Any = SumMetric

    def __new__(cls, horizon: int = 64, slots: int = 8, **kwargs: Any) -> Any:
        from .online import WindowedMetric

        return WindowedMetric(cls._base_cls(**kwargs), horizon=horizon, slots=slots)


class WindowedMean(WindowedSum):
    """Weighted mean over about the last ``horizon`` updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import WindowedMean
        >>> metric = WindowedMean(horizon=2, slots=2, device="cpu")
        >>> for v in [0.0, 4.0, 6.0]:
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())
        5.0
    """

    _base_cls = MeanMetric


class WindowedMax(WindowedSum):
    """Maximum over about the last ``horizon`` updates: it recovers once a
    spike ages out of the window.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import WindowedMax
        >>> metric = WindowedMax(horizon=2, slots=2, device="cpu")
        >>> for v in [9.0, 1.0, 2.0, 1.0]:
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())
        2.0
    """

    _base_cls = MaxMetric


class WindowedMin(WindowedSum):
    """Minimum over about the last ``horizon`` updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import WindowedMin
        >>> metric = WindowedMin(horizon=2, slots=2, device="cpu")
        >>> for v in [-9.0, 1.0, 2.0, 3.0]:
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())
        2.0
    """

    _base_cls = MinMetric


class DecayedSum(Metric):
    """Exponentially decayed sum: an update ``halflife`` updates old counts
    half. ``DecayedSum(halflife, **kwargs)`` is
    ``SumMetric(**kwargs).decayed(halflife)``, a
    :class:`~torchmetrics_tpu_torch.online.DecayedMetric`.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import DecayedSum
        >>> metric = DecayedSum(halflife=1.0, device="cpu")
        >>> for v in [8.0, 0.0, 0.0, 0.0]:
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())
        1.0
    """

    _base_cls: Any = SumMetric

    def __new__(cls, halflife: float = 64.0, **kwargs: Any) -> Any:
        from .online import DecayedMetric

        return DecayedMetric(cls._base_cls(**kwargs), halflife=halflife)


class DecayedMean(DecayedSum):
    """Exponentially weighted mean: the weighted sum and the weight decay
    together, so their ratio follows the recent data.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import DecayedMean
        >>> metric = DecayedMean(halflife=2.0, device="cpu")
        >>> for v in [0.0, 0.0, 1.0, 1.0]:
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute()) > 0.5
        True
    """

    _base_cls = MeanMetric
