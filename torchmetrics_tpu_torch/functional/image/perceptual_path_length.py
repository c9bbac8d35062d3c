"""Perceptual path length (functional).

Counterpart of ``torchmetrics_tpu/functional/image/perceptual_path_length.py``:
sample two latent batches, nudge the first toward the second by
``epsilon`` (lerp, slerp_any or slerp_unit), and average the perceptual
distance between the generated image pairs divided by ``epsilon**2``,
after dropping the distances outside the discard quantiles. The loop over
batches stays on the host. Conditional labels come from
``np.random.RandomState(seed)``, as in the JAX package, uploaded to the
latents' device. ``resize`` resizes bilinearly with antialiasing, as
``jax.image.resize(method="bilinear")`` does by default.
"""
from typing import Any, Callable, Optional, Protocol, Tuple, Union, runtime_checkable

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = ["GeneratorType", "perceptual_path_length"]


@runtime_checkable
class GeneratorType(Protocol):
    """What PPL needs of a generator: ``sample(num_samples) -> latents``
    and a call on latents (and integer labels when conditional) returning
    (N, C, H, W) images; a conditional generator also has an integer
    ``num_classes``. A typing Protocol, as in the JAX package, so an
    ``nn.Module`` with a ``sample`` method qualifies as it is."""

    def sample(self, num_samples: int) -> Tensor:  # pragma: no cover - protocol
        ...

    def __call__(self, *args: Any) -> Tensor:  # pragma: no cover - protocol
        ...


_EPS = 1e-7


def _interpolate(latents1: Tensor, latents2: Tensor, epsilon: float, interpolation_method: str) -> Tensor:
    """Nudge ``latents1`` toward ``latents2`` by ``epsilon``; zero or
    collinear latent pairs fall back to lerp through a mask."""
    lerp = latents1 + (latents2 - latents1) * epsilon
    if interpolation_method == "lerp":
        return lerp
    norm1 = torch.sqrt(torch.sum(latents1**2, dim=-1, keepdim=True))
    norm2 = torch.sqrt(torch.sum(latents2**2, dim=-1, keepdim=True))
    l1n = latents1 / torch.clamp(norm1, min=_EPS)
    l2n = latents2 / torch.clamp(norm2, min=_EPS)
    d = torch.sum(l1n * l2n, dim=-1, keepdim=True)
    mask_lerp = (norm1 < _EPS) | (norm2 < _EPS) | (d > 1 - _EPS) | (d < -1 + _EPS)
    omega = torch.arccos(torch.clamp(d, -1.0, 1.0))
    denom = torch.clamp(torch.sin(omega), min=_EPS)
    out = (torch.sin((1 - epsilon) * omega) / denom) * latents1 + (torch.sin(epsilon * omega) / denom) * latents2
    out = torch.where(mask_lerp, lerp, out)
    if interpolation_method == "slerp_unit":
        out = out / torch.clamp(torch.sqrt(torch.sum(out**2, dim=-1, keepdim=True)), min=_EPS)
    return out


def _resize(imgs: Tensor, size: int) -> Tensor:
    return F.interpolate(imgs, size=(size, size), mode="bilinear", align_corners=False, antialias=True)


def perceptual_path_length(
    generator: Any,
    distance_fn: Union[str, Callable[[Tensor, Tensor], Tensor]] = "vgg",
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    resize: Optional[int] = 64,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    seed: int = 42,
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(mean, std, distances)`` of the generator's perceptual path length.

    ``distance_fn`` is a perceptual distance (an LPIPS network, say); a
    string preset loads the cached pretrained LPIPS onto the card, or
    raises the guidance error.

    Example:
        >>> import torch
        >>> class Generator:
        ...     def __init__(self):
        ...         self.g = torch.Generator().manual_seed(1)
        ...     def sample(self, num_samples):
        ...         return torch.randn(num_samples, 8, generator=self.g)
        ...     def __call__(self, z):
        ...         return torch.tanh(z[:, :3, None, None] * torch.ones(1, 3, 16, 16))
        >>> def distance(a, b):
        ...     return ((a - b) ** 2).sum(dim=(1, 2, 3))
        >>> mean, std, dist = perceptual_path_length(Generator(), distance, num_samples=16, batch_size=8,
        ...                                          resize=None)
        >>> dist.shape
        torch.Size([14])
    """
    from ...models.lpips import resolve_pretrained_distance

    distance_fn = resolve_pretrained_distance(distance_fn, "perceptual_path_length", "distance_fn")
    if not hasattr(generator, "sample"):
        raise NotImplementedError(
            "The generator must have a `sample` method returning latents (GeneratorType protocol)."
        )
    if interpolation_method not in ("lerp", "slerp_any", "slerp_unit"):
        raise ValueError(f"Interpolation method {interpolation_method} not supported.")
    if conditional and not isinstance(getattr(generator, "num_classes", None), int):
        raise AttributeError("The generator must have an integer `num_classes` attribute when `conditional=True`.")

    rng = np.random.RandomState(seed)
    distances = []
    remaining = num_samples
    while remaining > 0:
        bsz = min(batch_size, remaining)
        latents1 = torch.as_tensor(generator.sample(bsz))
        latents2 = _interpolate(latents1, torch.as_tensor(generator.sample(bsz)), epsilon, interpolation_method)
        if conditional:
            labels = torch.as_tensor(rng.randint(0, generator.num_classes, (bsz,)), device=latents1.device)
            imgs1, imgs2 = generator(latents1, labels), generator(latents2, labels)
        else:
            imgs1, imgs2 = generator(latents1), generator(latents2)
        if resize is not None:
            imgs1, imgs2 = _resize(imgs1, resize), _resize(imgs2, resize)
        distances.append(torch.as_tensor(distance_fn(imgs1, imgs2)).reshape(-1) / (epsilon**2))
        remaining -= bsz
    dist = torch.cat(distances)
    if lower_discard is not None or upper_discard is not None:
        lo = torch.quantile(dist, lower_discard or 0.0)
        hi = torch.quantile(dist, upper_discard or 1.0)
        dist = dist[(dist >= lo) & (dist <= hi)]
    return torch.mean(dist), torch.std(dist), dist
