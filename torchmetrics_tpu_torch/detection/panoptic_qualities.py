"""PanopticQuality and ModifiedPanopticQuality metric classes.

Counterpart of ``torchmetrics_tpu/detection/panoptic_qualities.py``: fixed
``(num_categories,)`` sum states, a float32 ``iou_sum`` and int32 true
positive, false positive and false negative counts, updated over
``(B, *spatial, 2)`` (category, instance) maps on the metric's device; each
sample's table of intersections is one bincount launch
(:mod:`..functional.detection.panoptic_quality`). The update reads the card
(segment counts, the matched pairs), so it runs eagerly, as in the JAX
package.
"""
from typing import Any, Collection

import numpy as np
import torch

from ..functional.detection.panoptic_quality import (
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _validate_inputs,
)
from ..metric import Metric

Tensor = torch.Tensor


class PanopticQuality(Metric):
    """Panoptic Quality for panoptic segmentations (things + stuffs).

    Counterpart of ``torchmetrics_tpu.PanopticQuality``. Inputs are integer
    maps ``(B, *spatial, 2)`` whose last dimension holds ``(category_id,
    instance_id)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import PanopticQuality
        >>> metric = PanopticQuality(things={0}, stuffs={1}, device="cpu")
        >>> img = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [1, 0]]])
        >>> metric.update(img[None], img[None])
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    jittable = False  # segment discovery reads the card
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    _modified: bool = False

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.things, self.stuffs = _parse_categories(things, stuffs)
        self.allow_unknown_preds_category = allow_unknown_preds_category
        n_cat = len(self.things) + len(self.stuffs)
        self.add_state("iou_sum", torch.zeros(n_cat, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("true_positives", torch.zeros(n_cat, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_positives", torch.zeros(n_cat, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_negatives", torch.zeros(n_cat, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        _validate_inputs(preds, target)
        iou_sum, tp, fp, fn = _panoptic_quality_update(
            preds,
            target,
            self.things,
            self.stuffs,
            self.allow_unknown_preds_category,
            modified_stuffs=self.stuffs if self._modified else None,
        )
        # one copy to the device; the batch's float64 sums round to float32
        # before the add, as the JAX state does (the counts are exact in float64)
        batch = torch.tensor(np.stack([iou_sum, tp, fp, fn]), dtype=torch.float64, device=self.device)
        self.iou_sum = self.iou_sum + batch[0].to(torch.float32)
        self.true_positives = self.true_positives + batch[1].to(torch.int32)
        self.false_positives = self.false_positives + batch[2].to(torch.int32)
        self.false_negatives = self.false_negatives + batch[3].to(torch.int32)

    def compute(self) -> Tensor:
        states = torch.stack([self.iou_sum.to(torch.float64), self.true_positives.to(torch.float64),
                              self.false_positives.to(torch.float64), self.false_negatives.to(torch.float64)])
        iou_sum, tp, fp, fn = states.cpu().numpy()
        pq = _panoptic_quality_compute(iou_sum, tp.astype("int64"), fp.astype("int64"), fn.astype("int64"))
        return torch.tensor(pq, dtype=torch.float32, device=self.device)


class ModifiedPanopticQuality(PanopticQuality):
    """Modified PQ: stuff categories scored per pixel (IoU > 0, one segment).

    Counterpart of ``torchmetrics_tpu.ModifiedPanopticQuality``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ModifiedPanopticQuality
        >>> metric = ModifiedPanopticQuality(things={0}, stuffs={1}, device="cpu")
        >>> img = torch.tensor([[[0, 0], [0, 0], [1, 0]], [[0, 0], [1, 0], [1, 0]]])
        >>> metric.update(img[None], img[None])
        >>> round(float(metric.compute()), 4)
        1.0
    """

    _modified = True
