"""CLIP-IQA metric class.

Counterpart of ``torchmetrics_tpu/multimodal/clip_iqa.py``: per-image
positive-prompt probabilities in a ``"cat"`` state; compute gives the
per-image scores (one prompt: (N,), several: a dict by name). The prompt
anchors are computed once, at construction. Eager (``jittable = False``).
"""
from typing import Any, Dict, Tuple, Union

import torch

from ..functional.multimodal.clip_iqa import _CLIP_IQA_MODEL, _clip_iqa_anchors, _clip_iqa_update, _format_prompts
from ..functional.multimodal.clip_score import _resolve_model
from ..metric import Metric
from ..utils.data import dim_zero_cat

Tensor = torch.Tensor


class CLIPImageQualityAssessment(Metric):
    """CLIP-IQA: no-reference image quality by a prompt-pair softmax.

    ``model_name_or_path`` takes ``"clip_iqa"`` (``openai/clip-vit-base-patch16``),
    another ``transformers`` CLIP with local files, or an injected
    ``(model, processor)`` pair (the protocol of :class:`CLIPScore`).

    Example (a tiny injected model):
        >>> import torch
        >>> from torchmetrics_tpu_torch import CLIPImageQualityAssessment
        >>> class TinyClip:
        ...     def get_image_features(self, pixel_values):
        ...         flat = pixel_values.reshape(pixel_values.shape[0], -1)
        ...         return torch.stack([flat.mean(1), flat.std(1)], dim=1)
        ...     def get_text_features(self, input_ids, attention_mask):
        ...         return torch.stack([input_ids[:, 0].float(), 1.0 - input_ids[:, 0].float()], dim=1)
        >>> def processor(text=None, images=None, return_tensors="np", padding=True):
        ...     if images is not None:
        ...         return {"pixel_values": torch.stack(list(images))}
        ...     ids = torch.tensor([[int(t.startswith("Good"))] for t in text])
        ...     return {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
        >>> metric = CLIPImageQualityAssessment(model_name_or_path=(TinyClip(), processor), device="cpu")
        >>> metric.update(torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(3)))
        >>> metric.compute().shape
        torch.Size([2])
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    feature_network = "model"
    jittable = False

    def __init__(
        self,
        model_name_or_path: Union[str, Tuple[Any, Any]] = "clip_iqa",
        data_range: float = 1.0,
        prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._prompts_flat, self.prompts_names = _format_prompts(prompts)
        self.data_range = float(data_range)
        if model_name_or_path == "clip_iqa":
            model_name_or_path = _CLIP_IQA_MODEL
        self.model, self.processor = _resolve_model(model_name_or_path, "CLIPImageQualityAssessment", self.device)
        self.anchors = _clip_iqa_anchors(self._prompts_flat, self.model, self.processor, self.device)
        self.add_state("probs_list", [], dist_reduce_fx="cat")

    def update(self, images: Tensor) -> None:
        """Accumulate per-image positive-prompt probabilities."""
        self.probs_list.append(_clip_iqa_update(images, self.anchors, self.model, self.processor, self.data_range))

    def compute(self) -> Union[Tensor, Dict[str, Tensor]]:
        probs = dim_zero_cat(self.probs_list)  # (N, P)
        if len(self.prompts_names) == 1:
            return probs[:, 0].squeeze()
        return {name: probs[:, i] for i, name in enumerate(self.prompts_names)}
