"""Multimodal functional metrics. Counterpart of ``torchmetrics_tpu/functional/multimodal/``, with its ``__all__``."""
from .clip_iqa import clip_image_quality_assessment
from .clip_score import clip_score

__all__ = ["clip_image_quality_assessment", "clip_score"]
