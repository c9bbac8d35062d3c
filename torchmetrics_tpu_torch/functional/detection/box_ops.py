"""Pairwise bounding-box overlap (IoU / GIoU / DIoU / CIoU) on tensors.

Counterpart of ``torchmetrics_tpu/functional/detection/box_ops.py``: one
vectorised family over ``(N, 4)`` / ``(M, 4)`` corner boxes, in float32 on
the boxes' device, with the JAX package's formulas and operation order.
CIoU's ``atan`` is the one transcendental: XLA's and CUDA's ``atanf`` may
differ by an ulp.
"""
import math
from typing import Optional

import torch

Tensor = torch.Tensor

_EPS = 1e-7  # matches torchvision's eps in distance/complete IoU


def box_convert(boxes: Tensor, in_fmt: str = "xyxy", out_fmt: str = "xyxy") -> Tensor:
    """Convert ``(N, 4)`` boxes between ``xyxy`` / ``xywh`` / ``cxcywh``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import box_convert
        >>> box_convert(torch.tensor([[10.0, 20.0, 4.0, 6.0]]), "xywh", "xyxy")
        tensor([[10., 20., 14., 26.]])
    """
    if in_fmt == out_fmt:
        return boxes
    if in_fmt == "xywh":
        x, y, w, h = torch.split(boxes, 1, dim=-1)
        xyxy = torch.cat([x, y, x + w, y + h], dim=-1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = torch.split(boxes, 1, dim=-1)
        xyxy = torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    elif in_fmt == "xyxy":
        xyxy = boxes
    else:
        raise ValueError(f"Unsupported box format {in_fmt!r}")
    if out_fmt == "xyxy":
        return xyxy
    x1, y1, x2, y2 = torch.split(xyxy, 1, dim=-1)
    if out_fmt == "xywh":
        return torch.cat([x1, y1, x2 - x1, y2 - y1], dim=-1)
    if out_fmt == "cxcywh":
        return torch.cat([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)
    raise ValueError(f"Unsupported box format {out_fmt!r}")


def box_area(boxes: Tensor) -> Tensor:
    """Area of ``(N, 4)`` xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _pairwise_inter_union(preds: Tensor, target: Tensor):
    lt = torch.maximum(preds[:, None, :2], target[None, :, :2])
    rb = torch.minimum(preds[:, None, 2:], target[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(preds)[:, None] + box_area(target)[None, :] - inter
    return inter, union


def box_iou_matrix(preds: Tensor, target: Tensor) -> Tensor:
    """Pairwise IoU matrix ``(N, M)``; torchvision ``box_iou`` semantics."""
    inter, union = _pairwise_inter_union(preds, target)
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def _enclosing_wh(preds: Tensor, target: Tensor) -> Tensor:
    lt = torch.minimum(preds[:, None, :2], target[None, :, :2])
    rb = torch.maximum(preds[:, None, 2:], target[None, :, 2:])
    return rb - lt


def box_giou_matrix(preds: Tensor, target: Tensor) -> Tensor:
    """Pairwise Generalized IoU: ``iou - (C - union) / C`` over enclosing box C."""
    inter, union = _pairwise_inter_union(preds, target)
    iou = inter / (union + _EPS)
    wh = torch.clamp(_enclosing_wh(preds, target), min=0.0)
    enclose = wh[..., 0] * wh[..., 1]
    return iou - (enclose - union) / (enclose + _EPS)


def _center_dist_terms(preds: Tensor, target: Tensor):
    iou = box_iou_matrix(preds, target)
    # squared diagonal of the smallest enclosing box
    wh = _enclosing_wh(preds, target)
    diag2 = wh[..., 0] ** 2 + wh[..., 1] ** 2 + _EPS
    cp = (preds[:, :2] + preds[:, 2:]) / 2
    ct = (target[:, :2] + target[:, 2:]) / 2
    d = cp[:, None, :] - ct[None, :, :]
    rho2 = d[..., 0] ** 2 + d[..., 1] ** 2
    return iou, rho2 / diag2


def box_diou_matrix(preds: Tensor, target: Tensor) -> Tensor:
    """Pairwise Distance IoU: ``iou - rho^2 / c^2``."""
    iou, penalty = _center_dist_terms(preds, target)
    return iou - penalty


def box_ciou_matrix(preds: Tensor, target: Tensor) -> Tensor:
    """Pairwise Complete IoU: DIoU minus the aspect-ratio consistency term."""
    iou, penalty = _center_dist_terms(preds, target)
    wp = preds[:, 2] - preds[:, 0]
    hp = preds[:, 3] - preds[:, 1]
    wt = target[:, 2] - target[:, 0]
    ht = target[:, 3] - target[:, 1]
    v = (4.0 / (math.pi**2)) * (
        torch.atan(wt / (ht + _EPS))[None, :] - torch.atan(wp / (hp + _EPS))[:, None]
    ) ** 2
    alpha = (v / (1.0 - iou + v + _EPS)).detach()
    return iou - penalty - alpha * v


_MATRIX_FNS = {
    "iou": box_iou_matrix,
    "giou": box_giou_matrix,
    "diou": box_diou_matrix,
    "ciou": box_ciou_matrix,
}


def _variant_update(
    variant: str, preds: Tensor, target: Tensor, iou_threshold: Optional[float], replacement_val: float = 0.0
) -> Tensor:
    """Matrix with sub-threshold entries replaced; parity ``_iou_update`` et al."""
    mat = _MATRIX_FNS[variant](torch.as_tensor(preds, dtype=torch.float32),
                               torch.as_tensor(target, dtype=torch.float32))
    if iou_threshold is not None:
        mat = torch.where(mat < iou_threshold, replacement_val, mat)
    return mat


def _variant_compute(mat: Tensor, aggregate: bool = True) -> Tensor:
    if not aggregate:
        return mat
    return torch.mean(torch.diagonal(mat)) if mat.numel() > 0 else torch.tensor(0.0, device=mat.device)


def _make_public(variant: str, doc_name: str):
    def fn(
        preds: Tensor,
        target: Tensor,
        iou_threshold: Optional[float] = None,
        replacement_val: float = 0.0,
        aggregate: bool = True,
    ) -> Tensor:
        mat = _variant_update(variant, preds, target, iou_threshold, replacement_val)
        return _variant_compute(mat, aggregate)

    fn.__name__ = doc_name
    fn.__qualname__ = doc_name
    fn.__doc__ = (
        f"Compute {variant.upper()} between two sets of ``(N, 4)`` xyxy boxes.\n\n"
        "With ``aggregate=True`` (default) returns the mean of the matrix\n"
        "diagonal (matched pairs); otherwise the full pairwise matrix.\n"
        f"Counterpart of ``torchmetrics_tpu.functional.detection.{doc_name}``."
    )
    return fn


intersection_over_union = _make_public("iou", "intersection_over_union")
generalized_intersection_over_union = _make_public("giou", "generalized_intersection_over_union")
distance_intersection_over_union = _make_public("diou", "distance_intersection_over_union")
complete_intersection_over_union = _make_public("ciou", "complete_intersection_over_union")
