"""Perceptual path length.

Counterpart of ``torchmetrics_tpu/image/perceptual_path_length.py``: the
class keeps the generator of its last update (no tensor state) and
computes :func:`~torchmetrics_tpu_torch.functional.image.perceptual_path_length`
over it.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..functional.image.perceptual_path_length import perceptual_path_length
from ..metric import Metric

Tensor = torch.Tensor


class PerceptualPathLength(Metric):
    """Perceptual smoothness of a generator's latent space; compute returns
    ``(mean, std, distances)``.

    The generator follows :class:`~torchmetrics_tpu_torch.functional.image.GeneratorType`:
    ``sample(num_samples) -> latents`` and a call on latents. It is kept as
    a plain attribute, never a submodule, so moving or saving the metric
    leaves it alone. ``distance_fn`` is a perceptual distance (an LPIPS
    network, say) or a string preset loaded from the weight cache onto the
    metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import PerceptualPathLength
        >>> class Generator:
        ...     def __init__(self):
        ...         self.g = torch.Generator().manual_seed(1)
        ...     def sample(self, num_samples):
        ...         return torch.randn(num_samples, 8, generator=self.g)
        ...     def __call__(self, z):
        ...         return torch.tanh(z[:, :3, None, None] * torch.ones(1, 3, 16, 16))
        >>> def distance(a, b):
        ...     return ((a - b) ** 2).sum(dim=(1, 2, 3))
        >>> ppl = PerceptualPathLength(distance_fn=distance, num_samples=16, batch_size=8, resize=None,
        ...                            device="cpu")
        >>> ppl.update(Generator())
        >>> ppl_mean, ppl_std, distances = ppl.compute()
        >>> distances.shape
        torch.Size([14])
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    jittable = False

    def __init__(self, distance_fn: Union[str, Callable] = "vgg", num_samples: int = 10_000,
                 conditional: bool = False, batch_size: int = 128, interpolation_method: str = "lerp",
                 epsilon: float = 1e-4, resize: Optional[int] = 64, lower_discard: Optional[float] = 0.01,
                 upper_discard: Optional[float] = 0.99, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        from ..models.lpips import resolve_pretrained_distance

        self.distance_fn = resolve_pretrained_distance(distance_fn, type(self).__name__, "distance_fn", self.device)
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        object.__setattr__(self, "_generator", None)

    def update(self, generator: Any) -> None:
        object.__setattr__(self, "_generator", generator)  # not a submodule, even when an nn.Module

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        if self._generator is None:
            raise RuntimeError("No generator has been provided via `update`.")
        return perceptual_path_length(
            self._generator, self.distance_fn, self.num_samples, self.conditional, self.batch_size,
            self.interpolation_method, self.epsilon, self.resize, self.lower_discard, self.upper_discard,
        )
