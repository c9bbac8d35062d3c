"""Structural similarity (SSIM) and multi-scale SSIM.

Counterpart of ``torchmetrics_tpu/functional/image/ssim.py``: reflect-pad,
depthwise Gaussian or uniform window, crop the pad margins, per-sample mean;
MS-SSIM over a 2x average-pooled pyramid with the standard betas.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ...utils.checks import _check_same_shape
from .helper import avg_pool2d, depthwise_conv2d, gaussian_kernel_2d, reflect_pad_2d, uniform_kernel_2d

Tensor = torch.Tensor


def _ssim_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)} and target: "
            f"{tuple(target.shape)}."
        )
    return preds.to(torch.float32), target.to(torch.float32)


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Per-sample SSIM (with the contrast sensitivity or the full SSIM map
    when asked). The moments stay raw, unclamped: an epsilon-negative
    variance keeps SSIM exactly 1 for identical inputs."""
    if not isinstance(kernel_size, Sequence):
        kernel_size = (kernel_size, kernel_size)
    if not isinstance(sigma, Sequence):
        sigma = (sigma, sigma)

    if data_range is None:
        data_range = torch.max(torch.stack([preds.max() - preds.min(), target.max() - target.min()]))
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    channel = preds.shape[1]
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds_p = reflect_pad_2d(preds, pad_h, pad_w)
    target_p = reflect_pad_2d(target, pad_h, pad_w)
    if gaussian_kernel:
        kernel = gaussian_kernel_2d(channel, kernel_size, sigma, preds.device)
    else:
        kernel = uniform_kernel_2d(channel, kernel_size, preds.device)

    input_list = torch.cat([preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p], dim=0)
    outputs = depthwise_conv2d(input_list, kernel)
    n = preds.shape[0]
    mu_pred = outputs[:n]
    mu_target = outputs[n : 2 * n]
    mu_pred_sq = mu_pred * mu_pred
    mu_target_sq = mu_target * mu_target
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = outputs[2 * n : 3 * n] - mu_pred_sq
    sigma_target_sq = outputs[3 * n : 4 * n] - mu_target_sq
    sigma_pred_target = outputs[4 * n :] - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2
    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    ssim_idx = ssim_full[..., pad_h:-pad_h, pad_w:-pad_w] if pad_h and pad_w else ssim_full
    per_sample = torch.mean(ssim_idx.reshape(n, -1), dim=-1)

    if return_contrast_sensitivity:
        cs = upper / lower
        cs = cs[..., pad_h:-pad_h, pad_w:-pad_w] if pad_h and pad_w else cs
        return per_sample, torch.mean(cs.reshape(n, -1), dim=-1)
    if return_full_image:
        return per_sample, ssim_full
    return per_sample


def _ssim_reduce(vals: Tensor, reduction: Optional[str]) -> Tensor:
    if reduction == "elementwise_mean":
        return torch.mean(vals)
    if reduction == "sum":
        return torch.sum(vals)
    return vals


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """SSIM of (N, C, H, W) batches.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 16).repeat(2, 3, 16, 1)
        >>> round(float(structural_similarity_index_measure(preds, preds * 0.9 + 0.05)), 4)
        0.9945
    """
    preds, target = _ssim_check_inputs(preds, target)
    out = _ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
                       return_full_image, return_contrast_sensitivity)
    if isinstance(out, tuple):
        return _ssim_reduce(out[0], reduction), out[1]
    return _ssim_reduce(out, reduction)


def _multiscale_ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Sequence[float] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """Per-sample MS-SSIM, with the JAX package's two size gates as they are
    (the second divides by ``(len(betas) - 1) ** 2``)."""
    sim_list: List[Tensor] = []
    cs_list: List[Tensor] = []
    h, w = preds.shape[-2], preds.shape[-1]
    kh = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    kw = kernel_size if isinstance(kernel_size, int) else kernel_size[1]
    if h < 2 ** len(betas) or w < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    betas_div = max(1, len(betas) - 1) ** 2
    if h // betas_div <= kh - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kh},"
            f" the image height must be larger than {(kh - 1) * betas_div}."
        )
    if w // betas_div <= kw - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kw},"
            f" the image width must be larger than {(kw - 1) * betas_div}."
        )
    for i in range(len(betas)):
        sim, cs = _ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
                               return_contrast_sensitivity=True)
        sim_list.append(sim)
        cs_list.append(cs)
        if i < len(betas) - 1:
            preds = avg_pool2d(preds, 2)
            target = avg_pool2d(target, 2)
    sim_stack = torch.stack(sim_list)  # (S, N)
    cs_stack = torch.stack(cs_list)
    if normalize == "relu":
        sim_stack = torch.relu(sim_stack)
        cs_stack = torch.relu(cs_stack)
    mcs_and_ssim = torch.cat([cs_stack[:-1], sim_stack[-1:]], dim=0)
    if normalize == "simple":
        mcs_and_ssim = (mcs_and_ssim + 1) / 2
    # the betas as the JAX package holds them (float32), as Python numbers:
    # a tensor of them would be a host-to-device copy inside a CUDA graph
    exponents = torch.tensor(betas, dtype=torch.float32).tolist()
    return torch.prod(torch.stack([row**e for row, e in zip(mcs_and_ssim, exponents)]), dim=0)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Sequence[float] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """MS-SSIM of (N, C, H, W) batches.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 48).repeat(2, 3, 48, 1)
        >>> round(float(multiscale_structural_similarity_index_measure(preds, preds * 0.9 + 0.05, kernel_size=3)), 4)
        0.9953
    """
    if not isinstance(betas, (tuple, list)) or not all(isinstance(b, float) for b in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple or list of floats")
    if normalize is not None and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    vals = _multiscale_ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas,
                                   normalize)
    return _ssim_reduce(vals, reduction)
