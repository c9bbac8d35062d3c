"""Visual information fidelity (VIF-p, pixel domain): four scales of
Gaussian windows (17, 9, 5 and 3 wide) with ``::2`` decimation and the GSM
channel model. Counterpart of ``torchmetrics_tpu/functional/image/vif.py``."""
import torch

from ...utils.checks import _check_same_shape
from .helper import depthwise_conv2d, gaussian_kernel_2d

Tensor = torch.Tensor


def _vif_per_channel(preds: Tensor, target: Tensor, sigma_n_sq: float) -> Tensor:
    """preds/target: (N, H, W), one channel."""
    preds = preds[:, None]
    target = target[:, None]
    eps = 1e-10
    preds_vif = torch.zeros(preds.shape[0], device=preds.device)
    target_vif = torch.zeros(preds.shape[0], device=preds.device)
    for scale in range(4):
        n = 2.0 ** (4 - scale) + 1.0
        kernel = gaussian_kernel_2d(1, (int(n), int(n)), (n / 5.0, n / 5.0), preds.device)
        if scale > 0:
            preds = depthwise_conv2d(preds, kernel)[:, :, ::2, ::2]
            target = depthwise_conv2d(target, kernel)[:, :, ::2, ::2]
        mu_p = depthwise_conv2d(preds, kernel)
        mu_t = depthwise_conv2d(target, kernel)
        mu_p_sq, mu_t_sq, mu_pt = mu_p**2, mu_t**2, mu_p * mu_t
        sigma_p_sq = torch.clamp(depthwise_conv2d(preds**2, kernel) - mu_p_sq, min=0.0)
        sigma_t_sq = torch.clamp(depthwise_conv2d(target**2, kernel) - mu_t_sq, min=0.0)
        sigma_pt = depthwise_conv2d(preds * target, kernel) - mu_pt

        g = sigma_pt / (sigma_t_sq + eps)
        sv_sq = sigma_p_sq - g * sigma_pt
        zero = torch.zeros_like(g)

        g = torch.where(sigma_t_sq >= eps, g, zero)
        sv_sq = torch.where(sigma_t_sq >= eps, sv_sq, sigma_p_sq)
        sigma_t_sq = torch.where(sigma_t_sq >= eps, sigma_t_sq, zero)

        g = torch.where(sigma_p_sq >= eps, g, zero)
        sv_sq = torch.where(sigma_p_sq >= eps, sv_sq, zero)

        sv_sq = torch.where(g >= 0, sv_sq, sigma_p_sq)
        g = torch.clamp(g, min=0.0)
        sv_sq = torch.clamp(sv_sq, min=eps)

        preds_vif_scale = torch.log2(1.0 + g**2 * sigma_t_sq / (sv_sq + sigma_n_sq))
        preds_vif = preds_vif + torch.sum(preds_vif_scale, dim=(1, 2, 3))
        target_vif = target_vif + torch.sum(torch.log2(1.0 + sigma_t_sq / sigma_n_sq), dim=(1, 2, 3))
    return preds_vif / (target_vif + eps)


def visual_information_fidelity(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """VIF of (N, C, H, W) batches at least 41 x 41, averaged over channels
    and samples.

    Example:
        >>> import torch
        >>> preds = torch.linspace(0.1, 0.9, 48).repeat(2, 3, 48, 1)
        >>> round(float(visual_information_fidelity(preds, preds * 0.9 + 0.05)), 4)
        1.2344
    """
    _check_same_shape(preds, target)
    if preds.shape[-1] < 41 or preds.shape[-2] < 41:
        raise ValueError(f"Invalid size of preds. Expected at least 41x41, but got {tuple(preds.shape[-2:])}!")
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    per_channel = [_vif_per_channel(preds[:, i], target[:, i], sigma_n_sq) for i in range(preds.shape[1])]
    return torch.mean(torch.stack(per_channel)) if preds.shape[1] > 1 else torch.mean(per_channel[0])
