"""Inception score: stored class logits -> the exponentiated mean KL to the
marginal.

Counterpart of ``torchmetrics_tpu/image/inception.py``: a ``cat`` state of
logits; compute permutes the rows with ``np.random.RandomState(42)`` (a new
generator at each compute, as in the JAX package; the permutation is
uploaded to the logits' device) and splits them into ``splits`` groups.
``normalize`` is stored and never applied, as in the JAX package.
"""
from typing import Any, Callable, Tuple, Union

import numpy as np
import torch

from ..metric import Metric
from ..utils.data import dim_zero_cat
from .fid import _features, _resolve_feature_extractor

Tensor = torch.Tensor


class InceptionScore(Metric):
    """Exp-KL sharpness and diversity score over class logits; compute
    returns ``(score_mean, score_std)``.

    Example (a logits callable):
        >>> import torch
        >>> from torchmetrics_tpu_torch import InceptionScore
        >>> def logits_net(imgs):
        ...     flat = imgs.reshape(imgs.shape[0], -1).float()
        ...     return torch.stack([flat.mean(dim=1), flat.std(dim=1), flat.max(dim=1).values], dim=1)
        >>> inception = InceptionScore(feature=logits_net, splits=2, device="cpu")
        >>> inception.update(torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0)))
        >>> score_mean, score_std = inception.compute()
        >>> round(float(score_mean), 4)
        1.0
    """

    higher_is_better = True
    is_differentiable = False
    full_state_update = False
    plot_lower_bound = 0.0
    feature_network = "inception"
    jittable = False

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception = _resolve_feature_extractor(feature, "InceptionScore", self.device)
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Integer input to argument `splits` must be larger than 0")
        self.splits = splits
        self.normalize = normalize
        self.add_state("features", [], dist_reduce_fx="cat")

    def update(self, imgs: Tensor) -> None:
        self.features.append(_features(self.inception, imgs))

    def compute(self) -> Tuple[Tensor, Tensor]:
        features = dim_zero_cat(self.features)
        idx = torch.as_tensor(np.random.RandomState(42).permutation(features.shape[0]), device=features.device)
        features = features[idx]
        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        n = (features.shape[0] // self.splits) * self.splits
        prob_s = prob[:n].reshape(self.splits, -1, prob.shape[-1])
        log_prob_s = log_prob[:n].reshape(self.splits, -1, log_prob.shape[-1])

        mean_prob = torch.mean(prob_s, dim=1, keepdim=True)
        kl = prob_s * (log_prob_s - torch.log(torch.clamp(mean_prob, min=1e-20)))
        kl = torch.exp(torch.mean(torch.sum(kl, dim=2), dim=1))
        return torch.mean(kl), torch.std(kl)
