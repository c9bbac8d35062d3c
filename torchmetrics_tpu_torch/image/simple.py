"""TV, UQI, SAM, ERGAS, RASE, RMSE-SW, SCC, VIF, D_lambda, D_s and QNR
classes. Counterpart of ``torchmetrics_tpu/image/simple.py``: each a thin
shell over its functional with float32 running sums or cat states; the
three pan-sharpening classes keep whole images as cat states (their
computes compare bands across the whole set)."""
from typing import Any, Dict, Optional, Sequence

import torch

from ..functional.image.d_lambda import quality_with_no_reference, spatial_distortion_index, spectral_distortion_index
from ..functional.image.rmse_sw import _ergas_update, _rase_compute, _rase_update, _rmse_sw_update
from ..functional.image.sam import _sam_compute, _sam_update
from ..functional.image.scc import spatial_correlation_coefficient
from ..functional.image.tv import _total_variation_compute, _total_variation_update
from ..functional.image.uqi import _uqi_reduce, _uqi_update
from ..functional.image.vif import visual_information_fidelity
from ..metric import Metric
from ..utils.checks import _narrow
from ..utils.data import dim_zero_cat

Tensor = torch.Tensor


def _reduce(vals: Tensor, reduction: Optional[str]) -> Tensor:
    if reduction == "elementwise_mean":
        return torch.mean(vals)
    if reduction == "sum":
        return torch.sum(vals)
    return vals


class TotalVariation(Metric):
    """Total variation: a float32 sum of per-sample scores (a cat state of
    them under reduction ``"none"``/None) and of samples.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import TotalVariation
        >>> metric = TotalVariation(device="cpu")
        >>> metric.update(torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1))
        >>> round(float(metric.compute()), 2)
        76.8
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        if self.reduction is None or self.reduction == "none":
            self.add_state("score_list", [], dist_reduce_fx="cat")
        else:
            self.add_state("score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_elements", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img: Tensor) -> None:
        score, num_elements = _total_variation_update(img)
        if self.reduction is None or self.reduction == "none":
            self.score_list.append(score)
        else:
            self.score = self.score + torch.sum(score)
        self.num_elements = self.num_elements + num_elements

    def compute(self) -> Tensor:
        if self.reduction is None or self.reduction == "none":
            return dim_zero_cat(self.score_list)
        return _total_variation_compute(self.score, self.num_elements, self.reduction)


class UniversalImageQualityIndex(Metric):
    """UQI: a cat state of per-sample values.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import UniversalImageQualityIndex
        >>> metric = UniversalImageQualityIndex(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        0.9943
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, kernel_size: Sequence[int] = (11, 11), sigma: Sequence[float] = (1.5, 1.5),
                 reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        self.add_state("vals", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.vals.append(_uqi_update(preds, target, self.kernel_size, self.sigma))

    def compute(self) -> Tensor:
        return _uqi_reduce(dim_zero_cat(self.vals), self.reduction)


class SpectralAngleMapper(Metric):
    """SAM: a cat state of per-pixel angles, one row per sample (the JAX
    package's unused ``preds_sum``/``total`` sums are kept for its state
    layout).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralAngleMapper
        >>> metric = SpectralAngleMapper(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        0.0
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction
        self.add_state("preds_sum", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("vals", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        score = _sam_update(preds, target)
        self.vals.append(score.reshape(score.shape[0], -1))

    def compute(self) -> Tensor:
        return _sam_compute(dim_zero_cat(self.vals), self.reduction)


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """ERGAS: a cat state of per-sample values.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import ErrorRelativeGlobalDimensionlessSynthesis
        >>> metric = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        19.6684
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ratio: float = 4.0, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction
        self.add_state("vals", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.vals.append(_ergas_update(preds, target, self.ratio))

    def compute(self) -> Tensor:
        return _reduce(dim_zero_cat(self.vals), self.reduction)


class RelativeAverageSpectralError(Metric):
    """RASE: float32 sums of the RMSE map and of the window-mean target map
    over all images (scalar zeros that the first update broadcasts into
    (C, H, W) maps) and of images; compute applies RASE's nonlinear map to
    the pooled maps.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RelativeAverageSpectralError
        >>> metric = RelativeAverageSpectralError(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        250.6194
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size
        self.add_state("rmse_map", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_sum", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_images", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        rmse_map_sum, target_sum, total = _rase_update(preds, target, self.window_size)
        self.rmse_map = self.rmse_map + rmse_map_sum
        self.target_sum = self.target_sum + target_sum
        self.total_images = self.total_images + total

    def compute(self) -> Tensor:
        return _rase_compute(self.rmse_map, self.target_sum, self.total_images, self.window_size)


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """RMSE-SW: float32 sums of the batch-summed cropped map means and of
    images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RootMeanSquaredErrorUsingSlidingWindow
        >>> metric = RootMeanSquaredErrorUsingSlidingWindow(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        0.017
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_images", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        rmse_val_sum, _, total = _rmse_sw_update(preds, target, self.window_size)
        self.rmse_val_sum = self.rmse_val_sum + rmse_val_sum
        self.total_images = self.total_images + total

    def compute(self) -> Tensor:
        return self.rmse_val_sum / self.total_images


class SpatialCorrelationCoefficient(Metric):
    """SCC: a cat state of per-sample values. ``hp_filter`` (the 3 x 3
    Laplacian when None) is kept on the metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpatialCorrelationCoefficient
        >>> metric = SpatialCorrelationCoefficient(device="cpu")
        >>> wave = torch.sin(torch.linspace(0.0, 9.0, 24))
        >>> preds = (wave[:, None] * wave[None, :]).repeat(2, 3, 1, 1) * 0.4 + 0.5
        >>> metric.update(preds, preds * 0.9 + 0.03)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, hp_filter: Optional[Tensor] = None, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        hp = None if hp_filter is None else torch.as_tensor(hp_filter, dtype=torch.float32).to(self.device)
        self.register_buffer("hp_filter", hp, persistent=False)  # moved by .to()
        self.window_size = window_size
        self.add_state("vals", [], dist_reduce_fx="cat")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.vals.append(spatial_correlation_coefficient(preds, target, self.hp_filter, self.window_size,
                                                         reduction="none"))

    def compute(self) -> Tensor:
        return torch.mean(dim_zero_cat(self.vals))


class VisualInformationFidelity(Metric):
    """VIF: float32 sums of batch VIF times the batch size and of samples.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import VisualInformationFidelity
        >>> metric = VisualInformationFidelity(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 48).repeat(2, 3, 48, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        1.2344
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.sigma_n_sq = float(sigma_n_sq)
        self.add_state("vif_score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.vif_score = self.vif_score + visual_information_fidelity(preds, target, self.sigma_n_sq) * preds.shape[0]
        self.total = self.total + preds.shape[0]

    def compute(self) -> Tensor:
        return self.vif_score / self.total


class _PanSharpening(Metric):
    """Cat states of the inputs themselves, narrowed as the JAX package holds
    them; compute runs the functional over the whole set."""

    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, *names: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        for name in names:
            self.add_state(name, [], dist_reduce_fx="cat")

    @staticmethod
    def _ms_pan(target: Any) -> Dict[str, Tensor]:
        if not isinstance(target, dict) or "ms" not in target or "pan" not in target:
            raise ValueError("Expected `target` to be a dict with keys 'ms' and 'pan'.")
        return target

    def _append_ms_pan(self, preds: Tensor, target: Any) -> None:
        target = self._ms_pan(target)
        self.preds.append(_narrow(preds))
        self.ms.append(_narrow(target["ms"]))
        self.pan.append(_narrow(target["pan"]))


class SpectralDistortionIndex(_PanSharpening):
    """D_lambda of fused images against the low-resolution multispectral ones.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralDistortionIndex
        >>> metric = SpectralDistortionIndex(device="cpu")
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> metric.update(preds, preds * 0.9 + 0.05)
        >>> round(float(metric.compute()), 4)
        0.0
    """

    higher_is_better = False

    def __init__(self, p: int = 1, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__("preds", "target", **kwargs)
        self.p = p
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(_narrow(preds))
        self.target.append(_narrow(target))

    def compute(self) -> Tensor:
        return spectral_distortion_index(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.p,
                                         self.reduction)


class SpatialDistortionIndex(_PanSharpening):
    """D_s of fused images, given ``target={"ms": ..., "pan": ...}``; the
    low-resolution pan is made from the pan at compute.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpatialDistortionIndex
        >>> metric = SpatialDistortionIndex(device="cpu")
        >>> preds = (torch.sin(torch.linspace(0.0, 6.0, 32)) * 0.4 + 0.5).repeat(1, 3, 32, 1)
        >>> ms = (torch.sin(torch.linspace(0.0, 6.0, 16)) * 0.4 + 0.5).repeat(1, 3, 16, 1)
        >>> metric.update(preds, {"ms": ms, "pan": preds * 0.95})
        >>> round(float(metric.compute()), 4)
        0.0099
    """

    higher_is_better = False

    def __init__(self, norm_order: int = 1, window_size: int = 7, reduction: str = "elementwise_mean",
                 **kwargs: Any) -> None:
        super().__init__("preds", "ms", "pan", **kwargs)
        self.norm_order = norm_order
        self.window_size = window_size
        self.reduction = reduction

    def update(self, preds: Tensor, target: Dict[str, Tensor]) -> None:
        self._append_ms_pan(preds, target)

    def compute(self) -> Tensor:
        return spatial_distortion_index(dim_zero_cat(self.preds), dim_zero_cat(self.ms), dim_zero_cat(self.pan),
                                        None, self.norm_order, self.window_size, self.reduction)


class QualityWithNoReference(_PanSharpening):
    """QNR of fused images, given ``target={"ms": ..., "pan": ...}``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import QualityWithNoReference
        >>> metric = QualityWithNoReference(device="cpu")
        >>> preds = (torch.sin(torch.linspace(0.0, 6.0, 32)) * 0.4 + 0.5).repeat(1, 3, 32, 1)
        >>> ms = (torch.sin(torch.linspace(0.0, 6.0, 16)) * 0.4 + 0.5).repeat(1, 3, 16, 1)
        >>> metric.update(preds, {"ms": ms, "pan": preds * 0.95})
        >>> round(float(metric.compute()), 4)
        0.9897
    """

    higher_is_better = True

    def __init__(self, alpha: float = 1.0, beta: float = 1.0, norm_order: int = 1, window_size: int = 7,
                 reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__("preds", "ms", "pan", **kwargs)
        self.alpha = alpha
        self.beta = beta
        self.norm_order = norm_order
        self.window_size = window_size
        self.reduction = reduction

    def update(self, preds: Tensor, target: Dict[str, Tensor]) -> None:
        self._append_ms_pan(preds, target)

    def compute(self) -> Tensor:
        return quality_with_no_reference(dim_zero_cat(self.preds), dim_zero_cat(self.ms), dim_zero_cat(self.pan),
                                         None, self.alpha, self.beta, self.norm_order, self.window_size,
                                         self.reduction)
