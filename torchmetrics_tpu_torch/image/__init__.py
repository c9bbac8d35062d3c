"""Image metrics. Counterpart of ``torchmetrics_tpu/image/``, with its
``__all__`` but for the six that need network weights (FID, KID, IS, MiFID,
LPIPS and PPL), which are not ported yet."""
from .psnr import PeakSignalNoiseRatio, PeakSignalNoiseRatioWithBlockedEffect
from .simple import (ErrorRelativeGlobalDimensionlessSynthesis, QualityWithNoReference, RelativeAverageSpectralError,
                     RootMeanSquaredErrorUsingSlidingWindow, SpatialCorrelationCoefficient, SpatialDistortionIndex,
                     SpectralAngleMapper, SpectralDistortionIndex, TotalVariation, UniversalImageQualityIndex,
                     VisualInformationFidelity)
from .ssim import MultiScaleStructuralSimilarityIndexMeasure, StructuralSimilarityIndexMeasure

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
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
