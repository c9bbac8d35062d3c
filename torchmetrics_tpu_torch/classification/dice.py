"""Dice metric class.

Counterpart of ``torchmetrics_tpu/classification/dice.py``: a
``MulticlassStatScores`` that keeps its update, so it shares a compute group
with a ``MulticlassAccuracy`` (or F1, precision, ...) of the same
``num_classes`` and ``ignore_index``.
"""
from typing import Any, Optional

import torch

from ..functional.classification.dice import _dice_from_counts
from .stat_scores import MulticlassStatScores

Tensor = torch.Tensor


class Dice(MulticlassStatScores):
    """Multiclass Dice (micro by default, as in the reference).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import Dice
        >>> metric = Dice(num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.9, 0.05, 0.05], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.6, 0.1]])
        >>> metric.update(preds, torch.tensor([0, 1, 2, 0]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    full_state_update = False

    def __init__(self, num_classes: Optional[int] = None, average: Optional[str] = "micro",
                 threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        if num_classes is None:
            raise ValueError("`Dice` requires `num_classes`; for binary inputs use `BinaryF1Score` "
                             "(identical to binary dice).")
        super().__init__(num_classes, 1, average, "global", ignore_index, validate_args, **kwargs)
        self.threshold = threshold

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._final_state()
        return _dice_from_counts(tp, fp, fn, self.average)
