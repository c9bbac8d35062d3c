"""Image gradients. Counterpart of ``torchmetrics_tpu/functional/image/gradients.py``."""
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """(dy, dx) of a (B, C, H, W) batch: forward differences along H and W,
    each shaped like ``img``, with a zero last row (dy) and column (dx).

    Example:
        >>> import torch
        >>> img = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
        >>> dy, dx = image_gradients(img)
        >>> dy[0, 0, 0].tolist(), dx[0, 0, 0].tolist()
        ([4.0, 4.0, 4.0, 4.0], [1.0, 1.0, 1.0, 0.0])
    """
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"The `img` expects a value of <Tensor> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")
    if img.dtype == torch.bool or img.is_complex():
        raise TypeError(f"The `img` expects a numeric dtype but got {img.dtype}")
    dy = F.pad(img[..., 1:, :] - img[..., :-1, :], (0, 0, 0, 1))
    dx = F.pad(img[..., :, 1:] - img[..., :, :-1], (0, 1, 0, 0))
    return dy, dx
