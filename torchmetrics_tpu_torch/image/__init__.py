"""Image metrics. Counterpart of ``torchmetrics_tpu/image/``, with its
``__all__``."""
from .fid import FrechetInceptionDistance
from .inception import InceptionScore
from .kid import KernelInceptionDistance
from .lpip import LearnedPerceptualImagePatchSimilarity
from .mifid import MemorizationInformedFrechetInceptionDistance
from .perceptual_path_length import PerceptualPathLength
from .psnr import PeakSignalNoiseRatio, PeakSignalNoiseRatioWithBlockedEffect
from .simple import (ErrorRelativeGlobalDimensionlessSynthesis, QualityWithNoReference, RelativeAverageSpectralError,
                     RootMeanSquaredErrorUsingSlidingWindow, SpatialCorrelationCoefficient, SpatialDistortionIndex,
                     SpectralAngleMapper, SpectralDistortionIndex, TotalVariation, UniversalImageQualityIndex,
                     VisualInformationFidelity)
from .ssim import MultiScaleStructuralSimilarityIndexMeasure, StructuralSimilarityIndexMeasure

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "PerceptualPathLength",
    "QualityWithNoReference",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpatialCorrelationCoefficient",
    "SpatialDistortionIndex",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
]
