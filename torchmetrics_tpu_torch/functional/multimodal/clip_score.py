"""CLIPScore: CLIP image/text (or image/image, text/text) alignment.

Counterpart of ``torchmetrics_tpu/functional/multimodal/clip_score.py``:
score = 100 * cosine of the two sides' L2-normalized embeddings per pair,
summed; the mean is clamped at 0. The model is a ``transformers``
``CLIPModel`` loaded from a local path or cache (the torch class where the
JAX package loads ``FlaxCLIPModel``), or an injected ``(model, processor)``
pair: ``model`` exposes ``get_image_features``/``get_text_features`` and
``processor(text=..., images=..., return_tensors="np")`` returns arrays
(numpy or tensors, which go to the model's device). The forwards run
under ``no_grad`` with float32 matmuls and convolutions in full precision
(CLIP's patch embedding is a convolution).
"""
from typing import Any, Optional, Tuple, Union

import torch

from ...metric import resolve_device
from ...utils.data import on_device
from ...utils.imports import _TRANSFORMERS_AVAILABLE, ModuleNotFoundHint
from ...utils.prints import rank_zero_warn
from ..image.helper import highest_fp32_matmuls, ieee_fp32_convolutions

Tensor = torch.Tensor

_DEFAULT_MODEL = "openai/clip-vit-large-patch14"


def _resolve_model(model_name_or_path: Union[str, Tuple[Any, Any]], metric_name: str,
                   device: Optional[torch.device] = None) -> Tuple[Any, Any]:
    """A ``(model, processor)`` pair: an injected one as it is, or a
    ``transformers`` CLIP from local files (never the network), on ``device``.
    Without ``transformers``, or without the files, it raises
    ``ModuleNotFoundError``."""
    if isinstance(model_name_or_path, tuple):
        model, processor = model_name_or_path
        return model, processor
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundHint(metric_name, "transformers", "multimodal")
    from transformers import AutoProcessor, CLIPModel

    try:
        model = CLIPModel.from_pretrained(model_name_or_path, local_files_only=True)
        processor = AutoProcessor.from_pretrained(model_name_or_path, local_files_only=True)
    except (OSError, ValueError) as err:  # no local files (the network is never asked), or no such path
        raise ModuleNotFoundError(
            f"`{metric_name}` could not load the CLIP model {model_name_or_path!r} from local files. "
            "Pass a local path or a `(model, processor)` pair instead."
        ) from err
    return model.to(device).eval(), processor


def _model_device(model: Any, default: torch.device) -> torch.device:
    """Where the model's parameters live; ``default`` for a model without any."""
    params = getattr(model, "parameters", None)
    first = next(iter(params()), None) if callable(params) else None
    return default if first is None else first.device


def _forward(fn, *args: Tensor) -> Tensor:
    # the counterpart of the JAX package's default_matmul_precision("highest")
    with torch.no_grad(), highest_fp32_matmuls(), ieee_fp32_convolutions():
        return fn(*args)


def _image_features(images, model: Any, processor: Any, device: torch.device) -> Tensor:
    """L2-normalized image embeddings, on ``device``."""
    if not isinstance(images, (list, tuple)):
        images = [images] if images.ndim == 3 else list(images)
    if not all(i.ndim == 3 for i in images):
        raise ValueError("Expected all images to be 3d but found image that has either more or less")
    processed = processor(images=list(images), return_tensors="np")
    pixels = on_device(processed["pixel_values"], _model_device(model, device))
    feats = _forward(model.get_image_features, pixels).to(device)
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def _text_features(text, model: Any, processor: Any, device: torch.device) -> Tensor:
    """L2-normalized text embeddings, on ``device``; captions past the text
    model's ``max_position_embeddings`` are cut, with a warning."""
    if not isinstance(text, (list, tuple)):
        text = [text]
    processed = processor(text=list(text), return_tensors="np", padding=True)
    model_device = _model_device(model, device)
    input_ids = on_device(processed["input_ids"], model_device)
    mask = on_device(processed["attention_mask"], model_device)
    max_pos = getattr(getattr(getattr(model, "config", None), "text_config", None), "max_position_embeddings", None)
    if max_pos is not None and input_ids.shape[-1] > max_pos:
        rank_zero_warn(
            f"Encountered caption longer than max_position_embeddings={max_pos}. Will truncate captions to this "
            "length. If longer captions are needed, initialize with a model that supports longer sequences",
            UserWarning,
        )
        input_ids = input_ids[..., :max_pos]
        mask = mask[..., :max_pos]
    feats = _forward(model.get_text_features, input_ids, mask).to(device)
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def _detect_modality(x) -> str:
    """'image' for arrays of pixels, 'text' for strings."""
    if isinstance(x, str):
        return "text"
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ValueError("Source and target cannot be empty lists")
        return "text" if isinstance(x[0], str) else "image"
    return "image"


def _features(x, model: Any, processor: Any, device: torch.device) -> Tensor:
    if _detect_modality(x) == "image":
        return _image_features(x, model, processor, device)
    return _text_features(x, model, processor, device)


def _clip_score_update(source, target, model: Any, processor: Any, device: torch.device) -> Tuple[Tensor, int]:
    """Sum of 100 * cosine over the pairs, and the pair count."""
    src_feats = _features(source, model, processor, device)
    tgt_feats = _features(target, model, processor, device)
    if src_feats.shape[0] != tgt_feats.shape[0]:
        raise ValueError(
            f"Expected the number of source and target examples to be the same but got {src_feats.shape[0]} "
            f"and {tgt_feats.shape[0]}"
        )
    score = 100.0 * torch.sum(src_feats * tgt_feats, dim=-1)
    return torch.sum(score), src_feats.shape[0]


def clip_score(
    source,
    target,
    model_name_or_path: Union[str, Tuple[Any, Any]] = _DEFAULT_MODEL,
    *,
    device=None,
) -> Tensor:
    """One-shot CLIPScore: ``max(100 * mean cosine, 0)``.

    Example (a tiny injected model; see :class:`~torchmetrics_tpu_torch.CLIPScore`):
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.multimodal import clip_score
        >>> class Tiny:
        ...     def get_image_features(self, pixel_values):
        ...         return pixel_values.flatten(1)[:, :4]
        ...     def get_text_features(self, input_ids, attention_mask):
        ...         return torch.ones(input_ids.shape[0], 4)
        >>> def processor(text=None, images=None, return_tensors="np", padding=True):
        ...     if images is not None:
        ...         return {"pixel_values": torch.stack(images)}
        ...     return {"input_ids": torch.zeros(len(text), 2, dtype=torch.int64),
        ...             "attention_mask": torch.ones(len(text), 2, dtype=torch.int64)}
        >>> images = torch.ones(2, 3, 4, 4)
        >>> round(float(clip_score(images, ["a cat", "a dog"], (Tiny(), processor), device="cpu")), 1)
        100.0
    """
    device = resolve_device(device)
    model, processor = _resolve_model(model_name_or_path, "clip_score", device)
    score_sum, n = _clip_score_update(source, target, model, processor, device)
    return torch.clamp(score_sum / n, min=0.0)
