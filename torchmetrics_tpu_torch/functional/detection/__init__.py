"""Functional detection metrics. Counterpart of ``torchmetrics_tpu/functional/detection/``, with its ``__all__``."""
from .box_ops import (
    box_area,
    box_ciou_matrix,
    box_convert,
    box_diou_matrix,
    box_giou_matrix,
    box_iou_matrix,
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
)
from .panoptic_quality import modified_panoptic_quality, panoptic_quality

__all__ = [
    "box_area",
    "box_convert",
    "box_ciou_matrix",
    "box_diou_matrix",
    "box_giou_matrix",
    "box_iou_matrix",
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
]
