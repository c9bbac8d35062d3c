"""Learned perceptual image patch similarity (LPIPS).

Counterpart of ``torchmetrics_tpu/image/lpip.py``: float32 sums of the
per-pair distances and of the pair count. ``net_type`` is ``'alex'``,
``'vgg'`` or ``'squeeze'`` (the converted backbone from the weight cache,
on the metric's device, or the guidance error) or any callable
``(img1, img2) -> (N,)``, such as the network of
:func:`~torchmetrics_tpu_torch.models.make_lpips`.
"""
from typing import Any, Callable, Union

import torch

from ..metric import Metric

Tensor = torch.Tensor


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS perceptual distance between image pairs.

    Example (a distance callable; inputs in [-1, 1]):
        >>> import torch
        >>> from torchmetrics_tpu_torch import LearnedPerceptualImagePatchSimilarity
        >>> def patch_distance(a, b):
        ...     return ((a - b) ** 2).mean(dim=(1, 2, 3))
        >>> lpips = LearnedPerceptualImagePatchSimilarity(net_type=patch_distance, device="cpu")
        >>> lpips.update(torch.zeros(4, 3, 16, 16), torch.full((4, 3, 16, 16), 0.5))
        >>> float(lpips.compute())
        0.25
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    feature_network = "net"
    jittable = False

    def __init__(
        self,
        net_type: Union[str, Callable] = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        from ..models.lpips import resolve_pretrained_distance

        self.net = resolve_pretrained_distance(net_type, "LPIPS", "net_type", self.device)
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.normalize = normalize
        self.add_state("sum_scores", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        if self.normalize:  # [0, 1] -> [-1, 1]
            img1 = 2 * img1 - 1
            img2 = 2 * img2 - 1
        loss = torch.as_tensor(self.net(img1, img2)).reshape(-1)
        self.sum_scores = self.sum_scores + torch.sum(loss)
        self.total = self.total + loss.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
