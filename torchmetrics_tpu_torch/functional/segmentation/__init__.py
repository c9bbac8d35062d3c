"""Segmentation morphology toolbox. Counterpart of ``torchmetrics_tpu/functional/segmentation/``, with its ``__all__``."""
from .utils import (
    binary_dilation,
    binary_erosion,
    check_if_binarized,
    distance_transform,
    generate_binary_structure,
    get_neighbour_tables,
    mask_edges,
    surface_distance,
    table_contour_length,
    table_surface_area,
)

__all__ = [
    "binary_dilation",
    "binary_erosion",
    "check_if_binarized",
    "distance_transform",
    "generate_binary_structure",
    "get_neighbour_tables",
    "mask_edges",
    "surface_distance",
    "table_contour_length",
    "table_surface_area",
]
