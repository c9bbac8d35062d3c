"""IoU-family detection metrics.

Counterpart of ``torchmetrics_tpu/detection/iou.py``: per-image pairwise
overlap matrices kept as object list states (``dist_reduce_fx=None``,
gathered across processes with ``all_gather_object``), label matching via
``respect_labels``, a per-class breakdown via ``class_metrics``.

The update reads nothing back from the card: the inputs are validated by
their shapes, and each image's (N, M) float32 matrix is computed on the
boxes' device and appended. The compute concatenates the matrices once and
takes the means of the valid entries, overall and per target class, in
float64 on the card (the JAX package takes float32 numpy means: the two
agree within a few float32 ulp).
"""
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..functional.detection.box_ops import _variant_update, box_convert
from ..metric import Metric

Tensor = torch.Tensor

_ALLOWED_BOX_FORMATS = ("xyxy", "xywh", "cxcywh")


def _leading(x: Any) -> int:
    """Number of items along dim 0, 0 for an empty input (shape only)."""
    x = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    return x.shape[0] if x.numel() else 0


def _input_validator(
    preds: Sequence[Dict[str, Any]],
    targets: Sequence[Dict[str, Any]],
    iou_type: str = "bbox",
    ignore_score: bool = False,
) -> None:
    """Validate list-of-dict detection inputs by their shapes; parity ``detection/helpers.py:19``."""
    item_key = {"bbox": "boxes", "segm": "masks"}[iou_type]
    if not isinstance(preds, Sequence) or isinstance(preds, (str, bytes)):
        raise ValueError(f"Expected argument `preds` to be of type Sequence, but got {preds}")
    if not isinstance(targets, Sequence) or isinstance(targets, (str, bytes)):
        raise ValueError(f"Expected argument `target` to be of type Sequence, but got {targets}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )
    pred_keys = [item_key, "labels"] + ([] if ignore_score else ["scores"])
    for k in pred_keys:
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in [item_key, "labels"]:
        if any(k not in t for t in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    def n_items(item):
        value = item[item_key]
        if isinstance(value, (list, tuple)) and (not value or isinstance(value[0], dict)):
            return len(value)  # RLE dicts
        return _leading(value)

    def n_flat(x):
        return torch.as_tensor(x).numel() if not isinstance(x, torch.Tensor) else x.numel()

    for i, item in enumerate(targets):
        n_item, n_lab = n_items(item), n_flat(item["labels"])
        if n_item != n_lab:
            raise ValueError(
                f"Input '{item_key}' and labels of sample {i} in targets have a"
                f" different length (expected {n_item} labels, got {n_lab})"
            )
    if ignore_score:
        return
    for i, item in enumerate(preds):
        n_item, n_lab, n_sc = n_items(item), n_flat(item["labels"]), n_flat(item["scores"])
        if not (n_item == n_lab == n_sc):
            raise ValueError(
                f"Input '{item_key}', labels and scores of sample {i} in predictions have a"
                f" different length (expected {n_item} labels and scores, got {n_lab} labels and {n_sc} scores)"
            )


def _as_on(x: Any, device: torch.device, dtype: Optional[torch.dtype] = None) -> Tensor:
    """``x`` as a tensor on ``device``; a tensor on another device raises
    (the port makes no hidden copies)."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"the metric lives on {device} but got an input on {x.device}; move the input first")
    return torch.as_tensor(x, dtype=dtype, device=device)


def _fix_empty_boxes(boxes: Tensor, device: torch.device) -> Tensor:
    b = _as_on(boxes, device, torch.float32)
    if b.numel() == 0:
        return torch.zeros((0, 4), dtype=torch.float32, device=device)
    return b.reshape(-1, 4)


class IntersectionOverUnion(Metric):
    """Mean pairwise IoU over matched-label box pairs.

    Counterpart of ``torchmetrics_tpu.IntersectionOverUnion``. Accepts
    ``preds``/``target`` as lists of per-image dicts with ``boxes``/``labels``
    (+``scores`` in preds, unused here) of tensors on the metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import IntersectionOverUnion
        >>> metric = IntersectionOverUnion(device="cpu")
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 8.0, 58.0, 62.0]]), "labels": torch.tensor([0])}]
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["iou"]), 4)
        0.8569
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True
    jittable = False  # ragged per-image inputs and list states

    _iou_type: str = "iou"
    _invalid_val: float = -1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if box_format not in _ALLOWED_BOX_FORMATS:
            raise ValueError(f"Expected argument `box_format` to be one of {_ALLOWED_BOX_FORMATS} but got {box_format}")
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        self.class_metrics = class_metrics
        self.respect_labels = respect_labels

        self.add_state("groundtruth_labels", [], dist_reduce_fx=None)
        self.add_state("iou_matrix", [], dist_reduce_fx=None)

    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:
        _input_validator(preds, target, ignore_score=True)
        dev = self.device
        for p, t in zip(preds, target):
            det_boxes = box_convert(_fix_empty_boxes(p["boxes"], dev), self.box_format, "xyxy")
            gt_boxes = box_convert(_fix_empty_boxes(t["boxes"], dev), self.box_format, "xyxy")
            gt_labels = _as_on(t["labels"], dev).reshape(-1)
            self.groundtruth_labels.append(gt_labels)
            mat = _variant_update(self._iou_type, det_boxes, gt_boxes, self.iou_threshold, self._invalid_val)
            if self.respect_labels:
                p_labels = _as_on(p["labels"], dev).reshape(-1)
                label_eq = p_labels[:, None] == gt_labels[None, :]
                mat = torch.where(label_eq, mat, self._invalid_val)
            self.iou_matrix.append(mat)

    def compute(self) -> Dict[str, Tensor]:
        dev = self.device
        mats = list(self.iou_matrix)
        labels = [g.reshape(-1) for g in self.groundtruth_labels]
        flat = torch.cat([m.reshape(-1) for m in mats]) if mats else torch.zeros(0, device=dev)
        valid = flat != self._invalid_val
        total = torch.where(valid, flat.to(torch.float64), 0.0).sum()
        score = (total / valid.sum()).to(torch.float32)  # nan when nothing is valid, as the JAX mean
        results: Dict[str, Tensor] = {self._iou_type: score}
        if self.class_metrics:
            # each entry's class is its column's target label
            cols = [torch.broadcast_to(gl[None, :], m.shape).reshape(-1) for m, gl in zip(mats, labels)]
            col_labels = torch.cat(cols) if cols else torch.zeros(0, dtype=torch.int64, device=dev)
            gt_labels = torch.cat(labels) if labels else torch.zeros(0, dtype=torch.int64, device=dev)
            classes = torch.unique(gt_labels)
            which = torch.searchsorted(classes, col_labels[valid]) if classes.numel() else col_labels[valid]
            sums = torch.zeros(classes.numel(), dtype=torch.float64, device=dev).index_add_(
                0, which, flat[valid].to(torch.float64))
            counts = torch.zeros(classes.numel(), dtype=torch.int64, device=dev).index_add_(
                0, which, torch.ones_like(which))
            per_class = (sums / counts).to(torch.float32)  # nan for a class with no valid entry
            for i, cl in enumerate(classes.tolist()):
                results[f"{self._iou_type}/cl_{int(cl)}"] = per_class[i]
        return results


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """Counterpart of ``torchmetrics_tpu.GeneralizedIntersectionOverUnion``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import GeneralizedIntersectionOverUnion
        >>> metric = GeneralizedIntersectionOverUnion(device="cpu")
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 8.0, 58.0, 62.0]]), "labels": torch.tensor([0])}]
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["giou"]), 4)
        0.851
    """

    _iou_type = "giou"
    _invalid_val = -1.0


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    """Counterpart of ``torchmetrics_tpu.DistanceIntersectionOverUnion``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import DistanceIntersectionOverUnion
        >>> metric = DistanceIntersectionOverUnion(device="cpu")
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 8.0, 58.0, 62.0]]), "labels": torch.tensor([0])}]
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["diou"]), 4)
        0.8569
    """

    _iou_type = "diou"
    _invalid_val = -1.0


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """Counterpart of ``torchmetrics_tpu.CompleteIntersectionOverUnion`` (invalid sentinel -2).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CompleteIntersectionOverUnion
        >>> metric = CompleteIntersectionOverUnion(device="cpu")
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[12.0, 8.0, 58.0, 62.0]]), "labels": torch.tensor([0])}]
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["ciou"]), 4)
        0.8569
    """

    _iou_type = "ciou"
    _invalid_val = -2.0
