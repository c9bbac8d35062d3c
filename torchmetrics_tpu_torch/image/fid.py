"""Frechet inception distance: streaming feature moments, never the features.

Counterpart of ``torchmetrics_tpu/image/fid.py``: a running sum, an
outer-product sum and a count of the real and of the fake features (all
``"sum"``-reduced), sized at the first update, when the feature width is
known; compute takes the trace of the matrix square root through two
symmetric eigendecompositions, tr(sqrtm(S1 S2)) =
sum(sqrt(eig(S1^{1/2} S2 S1^{1/2}))), each of its matrix scaled by a power
of two (exact) so that LAPACK's float32 ``eigh`` stays finite.

The states and counts are float32, as in the JAX package (upstream keeps
them in float64). The covariance and square-root products run with cuBLAS
pinned to full float32, whatever the caller set, as the JAX package pins
them to ``Precision.HIGHEST``; ``eigh`` runs on cuSOLVER on a card and
LAPACK on the CPU. ``normalize`` is stored and never applied, as in the
JAX package (upstream scales [0, 1] images to uint8).

``feature`` is a tap of the FID-InceptionV3 (64, 192, 768, 2048), whose
converted weights are read from the weight cache (see
:mod:`~torchmetrics_tpu_torch.models.pretrained`), or any callable mapping
(N, C, H, W) images to (N, D) features, such as the extractor of
:func:`~torchmetrics_tpu_torch.models.make_fid_inception`.
"""
from typing import Any, Callable, Union

import torch

from ..functional.image.helper import highest_fp32_matmuls
from ..metric import Metric

Tensor = torch.Tensor


def _power_of_two_scale(mat: Tensor) -> Tensor:
    """The power of two nearest the largest magnitude of ``mat`` (1 for a
    zero matrix), on its device: dividing by it is exact."""
    top = torch.amax(torch.abs(mat))
    return torch.where(top > 0, torch.exp2(torch.round(torch.log2(top))), torch.ones_like(top))


def _eigh(mat: Tensor):
    """``torch.linalg.eigh`` of ``mat`` scaled by a power of two, so that its
    entries are of order one, and the eigenvalues scaled back: the same
    decomposition, exactly, of the same matrix. LAPACK's float32 ``eigh``
    returns NaN for some covariances whose entries are all ~1e-7 (a random
    Inception's 2048 features), where ``jnp.linalg.eigh`` does not."""
    scale = _power_of_two_scale(mat)
    vals, vecs = torch.linalg.eigh(mat / scale)
    return vals * scale, vecs


def _eigvalsh(mat: Tensor) -> Tensor:
    scale = _power_of_two_scale(mat)
    return torch.linalg.eigvalsh(mat / scale) * scale


def _sqrtm_psd(mat: Tensor) -> Tensor:
    """Symmetric PSD matrix square root via eigendecomposition."""
    vals, vecs = _eigh(mat)
    vals = torch.clamp(vals, min=0.0)
    with highest_fp32_matmuls():
        return torch.matmul(vecs * torch.sqrt(vals)[None, :], vecs.T)


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor) -> Tensor:
    """Parity: JAX ``image/fid.py:39``."""
    diff = mu1 - mu2
    s1h = _sqrtm_psd(sigma1)
    with highest_fp32_matmuls():
        covmean_sq = torch.matmul(torch.matmul(s1h, sigma2), s1h)
        dot = torch.dot(diff, diff)
    vals = torch.clamp(_eigvalsh(covmean_sq), min=0.0)
    tr_covmean = torch.sum(torch.sqrt(vals))
    return dot + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * tr_covmean


def _resolve_feature_extractor(feature: Union[int, str, Callable], metric_name: str,
                               device: torch.device) -> Callable:
    """A callable passes through; a tap id loads the cached FID-InceptionV3
    onto ``device`` or raises the guidance error when the cache is absent."""
    if callable(feature):
        return feature
    if isinstance(feature, (int, str)):  # tap id: 64/192/768/2048 or 'logits_unbiased'
        valid = (64, 192, 768, 2048, 1008, "logits_unbiased")
        if feature not in valid:
            raise ValueError(
                f"Input to argument `feature` must be one of {valid}, but got {feature!r}"
            )
        from ..models.pretrained import fid_inception_extractor, weights_dir

        extractor = fid_inception_extractor(feature, device)
        if extractor is not None:
            return extractor
        raise ModuleNotFoundError(
            f"Metric `{metric_name}` with `feature={feature!r}` requires the pretrained FID-InceptionV3 weights, "
            f"which were not found in the weights cache ({weights_dir()}). On a machine with network access run "
            "`python tools/fetch_weights.py fid` once (download + checksum + convert; the reference "
            "auto-downloads the same torch-fidelity checkpoint at construction). Alternatively pass any "
            "callable mapping (N, C, H, W) images to (N, D) features as `feature=`."
        )
    raise TypeError(f"Got unknown input to argument `feature`: {feature}")


def _features(extractor: Callable, imgs: Tensor) -> Tensor:
    return torch.as_tensor(extractor(imgs)).to(torch.float32)


class FrechetInceptionDistance(Metric):
    """Frechet distance between the real and the fake feature distributions.

    Updates eagerly (``jittable = False``): the network and the first
    update's state sizing stay out of a graph.

    Example (a feature callable; real Inception features need the converted
    checkpoint or :func:`~torchmetrics_tpu_torch.models.make_fid_inception`):
        >>> import torch
        >>> from torchmetrics_tpu_torch import FrechetInceptionDistance
        >>> def feat(imgs):
        ...     flat = imgs.reshape(imgs.shape[0], -1).float()
        ...     return torch.stack([flat.mean(dim=1), flat.std(dim=1)], dim=1)
        >>> fid = FrechetInceptionDistance(feature=feat, device="cpu")
        >>> g = torch.Generator().manual_seed(0)
        >>> fid.update(torch.rand(8, 3, 16, 16, generator=g), real=True)
        >>> fid.update(torch.rand(8, 3, 16, 16, generator=g) * 0.5, real=False)
        >>> round(float(fid.compute()), 2)
        0.08
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
        reset_real_features: bool = True,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception = _resolve_feature_extractor(feature, "FrechetInceptionDistance", self.device)
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        # sized at the first update, when the feature width is known
        self._num_features: int = -1
        self._states_added = False

    def _ensure_states(self, d: int) -> None:
        if self._states_added:
            return
        self._num_features = d
        for side in ("real", "fake"):
            self.add_state(f"{side}_features_sum", torch.zeros(d, dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_cov_sum", torch.zeros(d, d, dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state(f"{side}_features_num_samples", torch.tensor(0.0), dist_reduce_fx="sum")
        self._states_added = True

    def update(self, imgs: Tensor, real: bool) -> None:
        features = _features(self.inception, imgs)
        self._ensure_states(features.shape[-1])
        f_sum = torch.sum(features, dim=0)
        with highest_fp32_matmuls():
            f_cov = torch.matmul(features.T, features)
        n = float(features.shape[0])
        side = "real" if real else "fake"
        setattr(self, f"{side}_features_sum", getattr(self, f"{side}_features_sum") + f_sum)
        setattr(self, f"{side}_features_cov_sum", getattr(self, f"{side}_features_cov_sum") + f_cov)
        setattr(self, f"{side}_features_num_samples", getattr(self, f"{side}_features_num_samples") + n)

    def compute(self) -> Tensor:
        n_r = self.real_features_num_samples
        n_f = self.fake_features_num_samples
        mean_real = self.real_features_sum / n_r
        mean_fake = self.fake_features_sum / n_f
        cov_real = (self.real_features_cov_sum - n_r * torch.outer(mean_real, mean_real)) / (n_r - 1)
        cov_fake = (self.fake_features_cov_sum - n_f * torch.outer(mean_fake, mean_fake)) / (n_f - 1)
        return _compute_fid(mean_real, cov_real, mean_fake, cov_fake)

    def reset(self) -> None:
        if not self._states_added or self.reset_real_features:
            super().reset()
            return
        names = ("real_features_sum", "real_features_cov_sum", "real_features_num_samples")
        saved = {k: getattr(self, k) for k in names}
        super().reset()
        self._install_state(saved)
