"""CLIP image quality assessment (CLIP-IQA).

Counterpart of ``torchmetrics_tpu/functional/multimodal/clip_iqa.py``: each
image is scored against prompt pairs ("Good photo." / "Bad photo."); the
score for a pair is the softmax over the two logits 100 * cosine, taken at
the positive prompt. The prompts' (2P, D) text embeddings (the anchors) are
computed once; each batch is one image-encoder forward, a (N, D) @ (D, 2P)
product and a softmax over the pairs.
"""
from typing import Any, Dict, List, Tuple, Union

import torch

from ...metric import resolve_device
from ..image.helper import highest_fp32_matmuls
from .clip_score import _image_features, _resolve_model, _text_features

Tensor = torch.Tensor

# the built-in prompt pairs
_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}

_CLIP_IQA_MODEL = "openai/clip-vit-base-patch16"  # what the "clip_iqa" name stands for


def _format_prompts(prompts: Tuple[Union[str, Tuple[str, str]], ...]) -> Tuple[List[str], List[str]]:
    """Expand prompt keywords / custom pairs into a flat prompt list + names."""
    if not isinstance(prompts, tuple):
        raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
    names: List[str] = []
    flat: List[str] = []
    count = 0
    for p in prompts:
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"All elements of `prompts` must be one of {list(_PROMPTS.keys())} "
                    f"if not custom tuple prompts, got {p}."
                )
            names.append(p)
            flat.extend(_PROMPTS[p])
        elif isinstance(p, tuple):
            if len(p) != 2 or not all(isinstance(s, str) for s in p):
                raise ValueError("If a tuple is provided in argument `prompts`, it must be of length 2")
            names.append(f"user_defined_{count}")
            flat.extend(p)
            count += 1
        else:
            raise ValueError("Argument `prompts` must be a tuple containing strings or tuples of strings")
    return flat, names


def _clip_iqa_anchors(prompts_flat: List[str], model: Any, processor: Any, device: torch.device) -> Tensor:
    """(2P, D) normalized anchor embeddings, computed once."""
    return _text_features(prompts_flat, model, processor, device)


def _clip_iqa_update(images: Tensor, anchors: Tensor, model: Any, processor: Any, data_range: float = 1.0) -> Tensor:
    """(N, P) positive-prompt probabilities per image."""
    imgs = images.to(torch.float32) / float(data_range)
    feats = _image_features(imgs, model, processor, anchors.device)
    # logits are scaled by 100, so TF32 products would move the softmax at the 1e-3 level
    with highest_fp32_matmuls():
        logits = 100.0 * feats @ anchors.T
    pairs = logits.reshape(feats.shape[0], -1, 2)
    return torch.softmax(pairs, dim=-1)[..., 0]


def clip_image_quality_assessment(
    images: Tensor,
    model_name_or_path: Union[str, Tuple[Any, Any]] = "clip_iqa",
    data_range: float = 1.0,
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
    *,
    device=None,
) -> Union[Tensor, Dict[str, Tensor]]:
    """One-shot CLIP-IQA: one prompt gives (N,) scores, several a dict by name.

    Example (a tiny injected model):
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.multimodal import clip_image_quality_assessment
        >>> class Tiny:
        ...     def get_image_features(self, pixel_values):
        ...         return torch.stack([pixel_values.mean((1, 2, 3)), pixel_values.std((1, 2, 3))], 1)
        ...     def get_text_features(self, input_ids, attention_mask):
        ...         return torch.stack([input_ids[:, 0].float(), 1.0 - input_ids[:, 0].float()], 1)
        >>> def processor(text=None, images=None, return_tensors="np", padding=True):
        ...     if images is not None:
        ...         return {"pixel_values": torch.stack(images)}
        ...     ids = torch.tensor([[int(t.startswith("Good"))] for t in text])
        ...     return {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
        >>> images = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
        >>> clip_image_quality_assessment(images, (Tiny(), processor), device="cpu").shape
        torch.Size([2])
    """
    device = resolve_device(device)
    flat, names = _format_prompts(prompts)
    name = _CLIP_IQA_MODEL if model_name_or_path == "clip_iqa" else model_name_or_path
    model, processor = _resolve_model(name, "clip_image_quality_assessment", device)
    anchors = _clip_iqa_anchors(flat, model, processor, device)
    probs = _clip_iqa_update(images, anchors, model, processor, data_range)
    if len(names) == 1:
        return probs[:, 0]
    return {name: probs[:, i] for i, name in enumerate(names)}
