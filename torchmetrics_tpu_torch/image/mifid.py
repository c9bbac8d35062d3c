"""Memorization-informed FID.

Counterpart of ``torchmetrics_tpu/image/mifid.py``: FID over stored real
and fake features (``cat`` states), divided by a memorisation penalty, the
mean over fake features of the least cosine distance to a real (training)
feature. The covariance and cosine products run with cuBLAS pinned to full
float32. ``normalize`` is stored and never applied, as in the JAX package.
"""
from typing import Any, Callable, Union

import torch

from ..functional.image.helper import highest_fp32_matmuls
from ..metric import Metric
from ..utils.data import dim_zero_cat
from .fid import _compute_fid, _features, _resolve_feature_extractor

Tensor = torch.Tensor


def _normalize_rows(x: Tensor) -> Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)


def _compute_cosine_distance(features1: Tensor, features2: Tensor, cosine_distance_eps: float = 0.1) -> Tensor:
    f1, f2 = _normalize_rows(features1), _normalize_rows(features2)
    with highest_fp32_matmuls():
        d = 1.0 - torch.abs(torch.matmul(f1, f2.T))
    mean_min_d = torch.mean(torch.amin(d, dim=1))
    return torch.where(mean_min_d < cosine_distance_eps, mean_min_d, torch.ones_like(mean_min_d))


class MemorizationInformedFrechetInceptionDistance(Metric):
    """FID divided by a memorisation penalty (cosine distance to the train set).

    Example (a feature callable):
        >>> import torch
        >>> from torchmetrics_tpu_torch import MemorizationInformedFrechetInceptionDistance
        >>> def feat(imgs):
        ...     flat = imgs.reshape(imgs.shape[0], -1).float()
        ...     return torch.stack([flat.mean(dim=1), flat.std(dim=1)], dim=1)
        >>> mifid = MemorizationInformedFrechetInceptionDistance(feature=feat, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> mifid.update(torch.rand(8, 3, 16, 16, generator=g), real=True)
        >>> mifid.update(torch.rand(8, 3, 16, 16, generator=g) * 0.5, real=False)
        >>> float(mifid.compute()) > 0
        True
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = False
    plot_lower_bound = 0.0
    feature_network = "inception"
    jittable = False

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        cosine_distance_eps: float = 0.1,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception = _resolve_feature_extractor(feature, "MemorizationInformedFrechetInceptionDistance",
                                                    self.device)
        if not (isinstance(cosine_distance_eps, float) and 0 < cosine_distance_eps <= 1):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.cosine_distance_eps = cosine_distance_eps
        self.normalize = normalize
        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def update(self, imgs: Tensor, real: bool) -> None:
        features = _features(self.inception, imgs)
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tensor:
        real = dim_zero_cat(self.real_features)
        fake = dim_zero_cat(self.fake_features)
        mu1, mu2 = torch.mean(real, dim=0), torch.mean(fake, dim=0)
        with highest_fp32_matmuls():
            sigma1 = torch.cov(real.T)
            sigma2 = torch.cov(fake.T)
        fid = _compute_fid(mu1, sigma1, mu2, sigma2)
        distance = _compute_cosine_distance(fake, real, self.cosine_distance_eps)
        return fid / (distance + 1e-15)
