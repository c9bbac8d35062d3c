"""SSIM and MS-SSIM classes. Counterpart of ``torchmetrics_tpu/image/ssim.py``."""
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from ..functional.image.ssim import _multiscale_ssim_update, _ssim_check_inputs, _ssim_update
from ..metric import Metric
from ..utils.data import dim_zero_cat

Tensor = torch.Tensor


def _similarity_states(metric: Metric, reduction: Optional[str]) -> None:
    """float32 sums of the per-sample values and of the samples, or under
    reduction ``"none"``/None a cat state of the per-sample values."""
    if reduction in ("elementwise_mean", "sum"):
        metric.add_state("similarity", torch.tensor(0.0), dist_reduce_fx="sum")
        metric.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
    else:
        metric.add_state("similarity", [], dist_reduce_fx="cat")


def _accumulate(metric: Metric, similarity: Tensor) -> None:
    if metric.reduction in ("elementwise_mean", "sum"):
        metric.similarity = metric.similarity + torch.sum(similarity)
        metric.total = metric.total + similarity.shape[0]
    else:
        metric.similarity.append(similarity)


def _reduced(metric: Metric) -> Tensor:
    if metric.reduction == "elementwise_mean":
        return metric.similarity / metric.total
    if metric.reduction == "sum":
        return metric.similarity
    return dim_zero_cat(metric.similarity)


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM over (N, C, H, W) batches; ``return_full_image`` also keeps
    every SSIM map as a cat state.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure
        >>> metric = StructuralSimilarityIndexMeasure(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        0.9945
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("elementwise_mean", "sum", "none", None)
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        _similarity_states(self, reduction)
        if return_full_image:
            self.add_state("image_return", [], dist_reduce_fx="cat")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        out = _ssim_update(preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range,
                           self.k1, self.k2, self.return_full_image, self.return_contrast_sensitivity)
        if isinstance(out, tuple):
            similarity, img = out
            if self.return_full_image:
                self.image_return.append(img)
        else:
            similarity = out
        _accumulate(self, similarity)

    def compute(self) -> Any:
        sim = _reduced(self)
        if self.return_full_image:
            return sim, dim_zero_cat(self.image_return)
        return sim


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """MS-SSIM over (N, C, H, W) batches.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure
        >>> metric = MultiScaleStructuralSimilarityIndexMeasure(kernel_size=3, device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 48).repeat(2, 3, 48, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        0.9953
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _similarity_states(self, reduction)
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a tuple of floats")
        if normalize not in ("relu", "simple", None):
            raise ValueError("Argument `normalize` to be expected either `None`, `relu` or `simple`")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        _accumulate(self, _multiscale_ssim_update(preds, target, self.gaussian_kernel, self.sigma, self.kernel_size,
                                                  self.data_range, self.k1, self.k2, self.betas, self.normalize))

    def compute(self) -> Tensor:
        return _reduced(self)
