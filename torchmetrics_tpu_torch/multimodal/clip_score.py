"""CLIPScore metric class.

Counterpart of ``torchmetrics_tpu/multimodal/clip_score.py``: ``score`` and
``n_samples`` sum states, compute = clamp(score / n, min=0). The update runs
a processor and a model on Python inputs, so it is eager
(``jittable = False``).
"""
from typing import Any, Tuple, Union

import torch

from ..functional.multimodal.clip_score import _DEFAULT_MODEL, _clip_score_update, _resolve_model
from ..metric import Metric

Tensor = torch.Tensor


class CLIPScore(Metric):
    """CLIP image/text (or image/image, text/text) alignment score.

    ``max(100 * cosine, 0)`` averaged over pairs. ``model_name_or_path``
    takes a ``transformers`` CLIP with local files (resolved with
    ``CLIPModel`` and ``AutoProcessor``) or an injected ``(model, processor)``
    pair: ``model`` exposes ``get_image_features`` / ``get_text_features``,
    ``processor`` maps images or text to arrays or tensors.

    Example (a tiny injected model):
        >>> import torch
        >>> from torchmetrics_tpu_torch import CLIPScore
        >>> emb = torch.randn(100, 4, generator=torch.Generator().manual_seed(7)).abs()
        >>> class TinyClip:
        ...     def get_image_features(self, pixel_values):
        ...         flat = pixel_values.reshape(pixel_values.shape[0], -1)
        ...         return torch.stack([flat.mean(1), flat.std(1), flat.amin(1), flat.amax(1)], dim=1)
        ...     def get_text_features(self, input_ids, attention_mask):
        ...         m = attention_mask[..., None].float()
        ...         return (emb[input_ids] * m).sum(1) / m.sum(1)
        >>> def processor(text=None, images=None, return_tensors="np", padding=True):
        ...     if images is not None:
        ...         return {"pixel_values": torch.stack(list(images))}
        ...     ids = torch.zeros((len(text), 4), dtype=torch.int64)
        ...     mask = torch.zeros((len(text), 4), dtype=torch.int64)
        ...     for i, t in enumerate(text):
        ...         toks = [sum(map(ord, w)) % 100 for w in t.split()][:4]
        ...         ids[i, :len(toks)] = torch.tensor(toks)
        ...         mask[i, :len(toks)] = 1
        ...     return {"input_ids": ids, "attention_mask": mask}
        >>> metric = CLIPScore(model_name_or_path=(TinyClip(), processor), device="cpu")
        >>> metric.update(torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(2)), ["a photo of a cat"])
        >>> round(float(metric.compute()), 1) > 0
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0
    feature_network = "model"
    jittable = False  # a host processor in the update

    def __init__(self, model_name_or_path: Union[str, Tuple[Any, Any]] = _DEFAULT_MODEL, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.model, self.processor = _resolve_model(model_name_or_path, "CLIPScore", self.device)
        self.add_state("score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, source, target) -> None:
        """Accumulate 100 * cosine similarity over (source, target) pairs."""
        score_sum, n = _clip_score_update(source, target, self.model, self.processor, self.device)
        self.score = self.score + score_sum
        self.n_samples = self.n_samples + n

    def compute(self) -> Tensor:
        return torch.clamp(self.score / self.n_samples, min=0.0)
