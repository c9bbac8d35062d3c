"""Learned perceptual image patch similarity (functional).

Counterpart of ``torchmetrics_tpu/functional/image/lpips.py``. ``net_type``
is a callable ``(img1, img2) -> (N,) distances``, such as the network of
:func:`~torchmetrics_tpu_torch.models.make_lpips`; every string preset
raises, as in the JAX package (the class loads the cached backbone).
"""
from typing import Callable, Union

import torch

Tensor = torch.Tensor

__all__ = ["learned_perceptual_image_patch_similarity"]


def learned_perceptual_image_patch_similarity(
    img1: Tensor,
    img2: Tensor,
    net_type: Union[str, Callable] = "alex",
    reduction: str = "mean",
    normalize: bool = False,
) -> Tensor:
    """One-shot LPIPS between two image batches ``(N, 3, H, W)``.

    Example:
        >>> import torch
        >>> a = torch.zeros(2, 3, 8, 8)
        >>> b = torch.ones(2, 3, 8, 8)
        >>> def mse(x, y):
        ...     return ((x - y) ** 2).mean(dim=(1, 2, 3))
        >>> float(learned_perceptual_image_patch_similarity(a, b, net_type=mse))
        1.0
    """
    if isinstance(net_type, str):
        valid_net_type = ("vgg", "alex", "squeeze")
        if net_type not in valid_net_type:
            raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
        raise ModuleNotFoundError(
            f"LPIPS with the pretrained `{net_type}` backbone requires torchvision weights that cannot be "
            "downloaded in this offline environment. Pass a callable `(img1, img2) -> distances` instead "
            "(see torchmetrics_tpu_torch.models.lpips for the network definition and weight conversion)."
        )
    if not callable(net_type):
        raise ValueError("Argument `net_type` must be a string preset or a callable")
    valid_reduction = ("mean", "sum")
    if reduction not in valid_reduction:
        raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
    if not isinstance(normalize, bool):
        raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
    if normalize:  # [0, 1] -> [-1, 1]
        img1 = 2 * img1 - 1
        img2 = 2 * img2 - 1
    loss = torch.as_tensor(net_type(img1, img2)).reshape(-1)
    return torch.mean(loss) if reduction == "mean" else torch.sum(loss)
