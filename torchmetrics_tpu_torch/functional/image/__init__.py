"""Functional image metrics: plain functions on tensors.

Counterpart of ``torchmetrics_tpu/functional/image/``, with its ``__all__``.
"""
from .d_lambda import quality_with_no_reference, spatial_distortion_index, spectral_distortion_index
from .gradients import image_gradients
from .lpips import learned_perceptual_image_patch_similarity
from .perceptual_path_length import GeneratorType, perceptual_path_length
from .psnr import peak_signal_noise_ratio
from .psnrb import peak_signal_noise_ratio_with_blocked_effect
from .rmse_sw import (error_relative_global_dimensionless_synthesis, relative_average_spectral_error,
                      root_mean_squared_error_using_sliding_window)
from .sam import spectral_angle_mapper
from .scc import spatial_correlation_coefficient
from .ssim import multiscale_structural_similarity_index_measure, structural_similarity_index_measure
from .tv import total_variation
from .uqi import universal_image_quality_index
from .vif import visual_information_fidelity

__all__ = [
    "GeneratorType",
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "learned_perceptual_image_patch_similarity",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "perceptual_path_length",
    "quality_with_no_reference",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spatial_correlation_coefficient",
    "spatial_distortion_index",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "visual_information_fidelity",
]
