"""Shared image filters: Gaussian and uniform windows, the depthwise
convolution, padding and 2x average pooling.

Counterpart of ``torchmetrics_tpu/functional/image/helper.py``. The
filters are library calls: ``torch.nn.functional.conv2d`` with
``groups=C`` (depthwise, valid padding) and ``avg_pool2d``.

Full float32: the JAX filter runs at ``Precision.HIGHEST`` because a
lower-precision product puts ~1e-3 relative error into the
``E[x^2] - E[x]^2`` moments of SSIM, UQI and VIF. On a card, cuDNN
multiplies float32 convolutions in TF32 while ``torch.backends.cudnn``
allows it, which it does by default, so :func:`depthwise_conv2d` pins
cuDNN's float32 convolution precision to IEEE for its call and restores the
caller's setting after it, whatever that was.

Windows are built with torch ops on the input's device, once per
configuration (a bounded cache), so an update body reads a resident tensor
and copies nothing from the host; a window first asked for while a CUDA
graph is being captured is built inside the graph and not cached, since its
values exist only once the graph replays. ``gaussian_kernel_3d`` and
``depthwise_conv3d`` of the JAX module have no caller there and are not
ported.
"""
import functools
from contextlib import contextmanager
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _window_cache(make: Callable, size: int = 64) -> Callable:
    """``make(*key)`` cached per key (whose last entry is the device); a
    miss while the current CUDA stream captures a graph builds the tensor
    inside the graph and does not keep it."""
    cache: Dict[tuple, Tensor] = {}

    @functools.wraps(make)
    def get(*key):
        window = cache.get(key)
        if window is None:
            window = make(*key)
            device = key[-1]
            capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
            if not capturing and len(cache) < size:
                cache[key] = window
        return window

    return get


def _gaussian_1d(kernel_size: int, sigma: float, device: torch.device) -> Tensor:
    x = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / torch.sum(g)


@_window_cache
def _gaussian_2d(channels: int, kernel_size: Tuple[int, int], sigma: Tuple[float, float],
                 device: torch.device) -> Tensor:
    k2d = torch.outer(_gaussian_1d(kernel_size[0], sigma[0], device), _gaussian_1d(kernel_size[1], sigma[1], device))
    return k2d.expand((channels, 1) + tuple(k2d.shape)).contiguous()


@_window_cache
def _uniform_2d(channels: int, kernel_size: Tuple[int, int], device: torch.device) -> Tensor:
    return torch.full((channels, 1, *kernel_size), 1.0 / (kernel_size[0] * kernel_size[1]), dtype=torch.float32,
                      device=device)


def gaussian_kernel_2d(channels: int, kernel_size: Sequence[int], sigma: Sequence[float],
                       device: torch.device) -> Tensor:
    """(C, 1, kh, kw) depthwise Gaussian window, float32, on ``device``."""
    return _gaussian_2d(channels, (int(kernel_size[0]), int(kernel_size[1])),
                        (float(sigma[0]), float(sigma[1])), torch.device(device))


def uniform_kernel_2d(channels: int, kernel_size: Sequence[int], device: torch.device) -> Tensor:
    """(C, 1, kh, kw) depthwise mean window, float32, on ``device``."""
    return _uniform_2d(channels, (int(kernel_size[0]), int(kernel_size[1])), torch.device(device))


@contextmanager
def ieee_fp32_convolutions():
    """cuDNN multiplies float32 convolutions in float32 inside the block,
    whatever the caller's TF32 setting, legacy ``allow_tf32`` or per-op
    (restored on exit)."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    if prev == "ieee":
        yield
        return
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


@contextmanager
def highest_fp32_matmuls():
    """cuBLAS multiplies float32 matmuls in float32 inside the block,
    whatever the caller set (``torch.set_float32_matmul_precision``, legacy
    ``allow_tf32`` or per-backend; restored on exit): the counterpart of
    ``precision=Precision.HIGHEST`` on the JAX package's covariance, Gram
    and cosine products and network matmuls."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    if prev == "ieee":
        yield
        return
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev


def depthwise_conv2d(x: Tensor, kernel: Tensor) -> Tensor:
    """x: (N, C, H, W); kernel: (C, 1, kh, kw); valid padding, full float32."""
    with ieee_fp32_convolutions():
        return F.conv2d(x, kernel, groups=x.shape[1])


def reflect_pad_2d(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    """Reflection about the edge sample (numpy's ``reflect``)."""
    return F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")


def symmetric_pad_2d(x: Tensor, top: int, bottom: int, left: int, right: int) -> Tensor:
    """Reflection that repeats the edge sample (numpy's ``symmetric``, which
    ``torch.nn.functional.pad`` lacks), for pads no larger than the image."""
    height, width = x.shape[-2:]
    x = torch.cat([x[..., :top, :].flip(-2), x, x[..., height - bottom:, :].flip(-2)], dim=-2)
    return torch.cat([x[..., :left].flip(-1), x, x[..., width - right:].flip(-1)], dim=-1)


def avg_pool2d(x: Tensor, window: int = 2) -> Tensor:
    """Non-overlapping average pooling (MS-SSIM's downsampling)."""
    return F.avg_pool2d(x, window, window)
