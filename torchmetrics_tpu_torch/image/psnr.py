"""PSNR and PSNR-B classes. Counterpart of ``torchmetrics_tpu/image/psnr.py``."""
from typing import Any, Optional, Tuple, Union

import torch

from ..functional.image.psnr import _psnr_compute, _psnr_update
from ..functional.image.psnrb import _psnrb_compute, _psnrb_update
from ..metric import Metric
from ..utils.data import dim_zero_cat
from ..utils.prints import rank_zero_warn

Tensor = torch.Tensor


class PeakSignalNoiseRatio(Metric):
    """PSNR: float32 sums of squared errors and of observations, or per-``dim``
    cat states of them; with ``data_range=None`` the target's running
    minimum and maximum (MIN and MAX states) give the range.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatio
        >>> metric = PeakSignalNoiseRatio(data_range=1.0, device="cpu")
        >>> pred = torch.linspace(0, 1, 48).reshape(1, 3, 4, 4)
        >>> metric.update(pred, (pred + 0.1).clamp(0, 1))
        >>> print(f"{float(metric.compute()):.4f}")
        20.3427
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        if dim is None:
            self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        self._clamp_range = None
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is set.")
            range_value = None
            self.add_state("min_target", torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", torch.tensor(float("-inf")), dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            range_value = torch.tensor(float(data_range[1] - data_range[0]), device=self.device)
            self._clamp_range = data_range
        else:
            range_value = torch.tensor(float(data_range), device=self.device)
        # a buffer, so that .to() moves it; read only by compute
        self.register_buffer("data_range", range_value, persistent=False)
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, (list, tuple)) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = preds.to(torch.float32), target.to(torch.float32)
        if self._clamp_range is not None:
            preds = torch.clamp(preds, *self._clamp_range)
            target = torch.clamp(target, *self._clamp_range)
        sum_squared_error, num_obs = _psnr_update(preds, target, self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(torch.min(target), self.min_target)
                self.max_target = torch.maximum(torch.max(target), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + num_obs
        else:
            self.sum_squared_error.append(torch.atleast_1d(sum_squared_error))
            self.total.append(torch.atleast_1d(num_obs))

    def compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else (self.max_target - self.min_target)
        if self.dim is None:
            return _psnr_compute(self.sum_squared_error, self.total, data_range, self.base, self.reduction)
        return _psnr_compute(dim_zero_cat(self.sum_squared_error), dim_zero_cat(self.total), data_range, self.base,
                             self.reduction)


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR-B over grayscale (N, 1, H, W) batches: float32 sums of squared
    errors, of observations and of blockiness, and the running maximum of
    the target's range.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatioWithBlockedEffect
        >>> metric = PeakSignalNoiseRatioWithBlockedEffect(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 1, 16, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        32.1864
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("bef", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("data_range", torch.tensor(0.0), dist_reduce_fx="max")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = preds.to(torch.float32), target.to(torch.float32)
        sse, bef, n = _psnrb_update(preds, target, self.block_size)
        self.sum_squared_error = self.sum_squared_error + sse
        self.total = self.total + n
        self.bef = self.bef + bef
        self.data_range = torch.maximum(self.data_range, torch.max(target) - torch.min(target))

    def compute(self) -> Tensor:
        return _psnrb_compute(self.sum_squared_error, self.bef, self.total, self.data_range)
