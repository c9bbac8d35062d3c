"""Perplexity metric class.

Counterpart of ``torchmetrics_tpu/text/perplexity.py``: two float32 sum
states; the update reads nothing back to the host, so a metric on the card
captures it into a CUDA graph like any capturable metric.
"""
from typing import Any, Optional

import torch

from ..functional.text.perplexity import _perplexity_compute, _perplexity_update
from ..metric import Metric

Tensor = torch.Tensor


class Perplexity(Metric):
    """Perplexity over token logits or probabilities.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import Perplexity
        >>> metric = Perplexity(device="cpu")
        >>> logits = torch.log(torch.tensor([[[0.7, 0.2, 0.1], [0.2, 0.7, 0.1]]]))
        >>> metric.update(logits, torch.tensor([[0, 1]]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.4286
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("count", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        total, count = _perplexity_update(preds, target, self.ignore_index)
        self.total_log_probs = self.total_log_probs + total
        self.count = self.count + count

    def compute(self) -> Tensor:
        return _perplexity_compute(self.total_log_probs, self.count)
