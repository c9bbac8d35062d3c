"""Kernel inception distance: polynomial-kernel MMD over stored features.

Counterpart of ``torchmetrics_tpu/image/kid.py``: ``cat`` states of the
real and the fake features; compute draws ``subsets`` subsets of
``subset_size`` rows from each side and averages the unbiased polynomial
MMD estimate. The subsets come from one ``np.random.RandomState(seed)``
kept by the metric and advanced at every compute, as in the JAX package,
so two computes in a row give that package's two values; the row indices
are uploaded to the features' device. The Gram products run with cuBLAS
pinned to full float32. ``normalize`` is stored and never applied, as in
the JAX package.
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..functional.image.helper import highest_fp32_matmuls
from ..metric import Metric
from ..utils.data import dim_zero_cat
from .fid import _features, _resolve_feature_extractor

Tensor = torch.Tensor


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    with highest_fp32_matmuls():
        return (torch.matmul(f1, f2.T) * gamma + coef) ** degree


def poly_mmd(f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None,
             coef: float = 1.0) -> Tensor:
    """Unbiased MMD^2 estimate with a polynomial kernel."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    m = f_real.shape[0]
    kt_xx_sum = (torch.sum(k_11) - torch.sum(torch.diagonal(k_11))) / (m * (m - 1))
    kt_yy_sum = (torch.sum(k_22) - torch.sum(torch.diagonal(k_22))) / (m * (m - 1))
    k_xy_sum = torch.sum(k_12) / (m * m)
    return kt_xx_sum + kt_yy_sum - 2 * k_xy_sum


class KernelInceptionDistance(Metric):
    """Polynomial-kernel MMD between the real and the fake feature sets;
    compute returns ``(kid_mean, kid_std)``.

    Example (a feature callable):
        >>> import torch
        >>> from torchmetrics_tpu_torch import KernelInceptionDistance
        >>> def feat(imgs):
        ...     flat = imgs.reshape(imgs.shape[0], -1).float()
        ...     return torch.stack([flat.mean(dim=1), flat.std(dim=1)], dim=1)
        >>> kid = KernelInceptionDistance(feature=feat, subsets=3, subset_size=4, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> kid.update(torch.rand(8, 3, 16, 16, generator=g), real=True)
        >>> kid.update(torch.rand(8, 3, 16, 16, generator=g) * 0.5, real=False)
        >>> kid_mean, kid_std = kid.compute()
        >>> round(float(kid_mean), 2)
        0.17
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
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        seed: int = 42,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception = _resolve_feature_extractor(feature, "KernelInceptionDistance", self.device)
        for name, val in (("subsets", subsets), ("subset_size", subset_size), ("degree", degree)):
            if not (isinstance(val, int) and val > 0):
                raise ValueError(f"Argument `{name}` expected to be a positive int")
        self.subsets = subsets
        self.subset_size = subset_size
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or a positive float")
        self.gamma = gamma
        self.coef = coef
        self.reset_real_features = reset_real_features
        self.normalize = normalize
        self._rng = np.random.RandomState(seed)
        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def update(self, imgs: Tensor, real: bool) -> None:
        features = _features(self.inception, imgs)
        (self.real_features if real else self.fake_features).append(features)

    def compute(self) -> Tuple[Tensor, Tensor]:
        real = dim_zero_cat(self.real_features)
        fake = dim_zero_cat(self.fake_features)
        n_r, n_f = real.shape[0], fake.shape[0]
        if min(n_r, n_f) < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        vals = []
        for _ in range(self.subsets):
            r_idx = torch.as_tensor(self._rng.choice(n_r, self.subset_size, replace=False), device=real.device)
            f_idx = torch.as_tensor(self._rng.choice(n_f, self.subset_size, replace=False), device=fake.device)
            vals.append(poly_mmd(real[r_idx], fake[f_idx], self.degree, self.gamma, self.coef))
        vals_t = torch.stack(vals)
        return torch.mean(vals_t), torch.std(vals_t)

    def reset(self) -> None:
        if self.reset_real_features:
            super().reset()
            return
        self._flush_pending()
        saved = self.__dict__["real_features"]  # a reset installs a new empty state and leaves this one as it is
        super().reset()
        self.__dict__["real_features"] = saved
