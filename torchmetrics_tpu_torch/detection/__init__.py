"""Detection metrics. Counterpart of ``torchmetrics_tpu/detection/``, with its ``__all__``."""
from .iou import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
)
from .mean_ap import MeanAveragePrecision
from .panoptic_qualities import ModifiedPanopticQuality, PanopticQuality

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
