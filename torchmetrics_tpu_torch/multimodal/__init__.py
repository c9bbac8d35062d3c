"""Multimodal metrics: CLIPScore and CLIP-IQA. Counterpart of ``torchmetrics_tpu/multimodal/``, with its ``__all__``."""
from .clip_iqa import CLIPImageQualityAssessment
from .clip_score import CLIPScore

__all__ = ["CLIPImageQualityAssessment", "CLIPScore"]
