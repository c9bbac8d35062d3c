"""MeanAveragePrecision (COCO mAP / mAR).

Counterpart of ``torchmetrics_tpu/detection/mean_ap.py``. The states are
per-image tensors on the metric's device in object list states
(``dist_reduce_fx=None``, gathered across processes with
``all_gather_object``): xyxy boxes converted in float64 (float32 to float64
is exact, and ``x + w`` and ``cx - w / 2`` round alike on both sides, so the
boxes are bitwise the JAX package's), float64 scores, int64 labels, crowds
and areas. Dense masks stay on the device as bool; RLE dicts (pycocotools'
compressed strings decoded) stay host arrays. The update reads nothing back
from the card.

The compute concatenates each tensor state and copies it to the host once
(not once per image), then runs the COCO protocol of
:mod:`..functional.detection.coco_eval` on the host, where dense masks'
intersections are one product per image on the device.
"""
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import _native
from ..functional.detection.coco_eval import (
    DEFAULT_IOU_THRESHOLDS,
    DEFAULT_MAX_DETS,
    DEFAULT_REC_THRESHOLDS,
    evaluate_detections,
    summarize,
)
from ..metric import Metric
from .iou import _as_on, _input_validator

Tensor = torch.Tensor

_TENSOR_STATES = ("detection_box", "detection_scores", "detection_labels", "groundtruth_box",
                  "groundtruth_labels", "groundtruth_crowds", "groundtruth_area")


def _validate_iou_type_arg(iou_type: Union[str, Tuple[str, ...]]) -> Tuple[str, ...]:
    allowed = ("bbox", "segm")
    if isinstance(iou_type, str):
        iou_type = (iou_type,)
    if any(tp not in allowed for tp in iou_type):
        raise ValueError(f"Expected argument `iou_type` to be one of {allowed} or a list of, but got {iou_type}")
    return tuple(iou_type)


def _host_split(tensors: List[Tensor]) -> List[np.ndarray]:
    """Per-image tensors as host arrays: one concatenation and one copy."""
    if not tensors:
        return []
    flat = torch.cat([t.flatten(1) if t.dim() > 1 else t for t in tensors]).cpu().numpy()
    out, start = [], 0
    for t in tensors:
        n = t.shape[0]
        out.append(flat[start:start + n].reshape(t.shape))
        start += n
    return out


class MeanAveragePrecision(Metric):
    """COCO-protocol mean average precision / recall for object detection.

    Accepts ``preds``/``target`` as lists of per-image dicts (``boxes``,
    ``scores``, ``labels``, optional ``masks``/``iscrowd``/``area``) of
    tensors on the metric's device. Output dict keys: ``map, map_50, map_75,
    map_{small,medium,large}, mar_{maxdets...}, mar_{small,medium,large},
    map_per_class, mar_<last>_per_class, classes``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanAveragePrecision
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> preds = [{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "labels": torch.tensor([0])}]
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()["map"]), 4)
        1.0
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True
    jittable = False  # ragged per-image inputs and list states

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "native",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if box_format not in ("xyxy", "xywh", "cxcywh"):
            raise ValueError(f"Expected argument `box_format` to be one of ('xyxy', 'xywh', 'cxcywh') but got {box_format}")
        self.box_format = box_format
        self.iou_type = _validate_iou_type_arg(iou_type)
        if iou_thresholds is not None and not isinstance(iou_thresholds, (list, tuple)):
            raise ValueError(f"Expected argument `iou_thresholds` to either be `None` or a list of floats but got {iou_thresholds}")
        if rec_thresholds is not None and not isinstance(rec_thresholds, (list, tuple)):
            raise ValueError(f"Expected argument `rec_thresholds` to either be `None` or a list of floats but got {rec_thresholds}")
        if max_detection_thresholds is not None and not isinstance(max_detection_thresholds, (list, tuple)):
            raise ValueError(f"Expected argument `max_detection_thresholds` to either be `None` or a list of ints but got {max_detection_thresholds}")
        self.iou_thresholds = list(iou_thresholds) if iou_thresholds is not None else DEFAULT_IOU_THRESHOLDS.tolist()
        self.rec_thresholds = list(rec_thresholds) if rec_thresholds is not None else DEFAULT_REC_THRESHOLDS.tolist()
        self.max_detection_thresholds = sorted(
            max_detection_thresholds if max_detection_thresholds is not None else DEFAULT_MAX_DETS
        )
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(extended_summary, bool):
            raise ValueError("Expected argument `extended_summary` to be a boolean")
        self.extended_summary = extended_summary
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        self.average = average
        if backend not in ("native", "cpp"):
            raise ValueError(f"Expected argument `backend` to be one of ('native', 'cpp') but got {backend}")
        self.backend = backend  # kept for the JAX signature: both name the one host C++ path

        self.add_state("detection_box", [], dist_reduce_fx=None)
        self.add_state("detection_mask", [], dist_reduce_fx=None)
        self.add_state("detection_scores", [], dist_reduce_fx=None)
        self.add_state("detection_labels", [], dist_reduce_fx=None)
        self.add_state("groundtruth_box", [], dist_reduce_fx=None)
        self.add_state("groundtruth_mask", [], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", [], dist_reduce_fx=None)
        self.add_state("groundtruth_crowds", [], dist_reduce_fx=None)
        self.add_state("groundtruth_area", [], dist_reduce_fx=None)

    def update(self, preds: List[Dict[str, Any]], target: List[Dict[str, Any]]) -> None:
        """Append per-image detections/groundtruths; reads nothing from the card."""
        for tp in self.iou_type:
            _input_validator(preds, target, iou_type=tp)
        dev = self.device
        no_boxes = torch.zeros((0, 4), dtype=torch.float64, device=dev)
        for item in preds:
            self.detection_box.append(self._boxes_xyxy(item) if "bbox" in self.iou_type else no_boxes)
            self.detection_mask.append(self._masks(item) if "segm" in self.iou_type else None)
            self.detection_scores.append(_as_on(item["scores"], dev, torch.float64).reshape(-1))
            self.detection_labels.append(_as_on(item["labels"], dev).reshape(-1).to(torch.int64))
        for item in target:
            self.groundtruth_box.append(self._boxes_xyxy(item) if "bbox" in self.iou_type else no_boxes)
            self.groundtruth_mask.append(self._masks(item) if "segm" in self.iou_type else None)
            labels = _as_on(item["labels"], dev).reshape(-1).to(torch.int64)
            self.groundtruth_labels.append(labels)
            crowds = item["iscrowd"] if "iscrowd" in item else torch.zeros(labels.shape[0], device=dev)
            self.groundtruth_crowds.append(_as_on(crowds, dev).reshape(-1).to(torch.int64))
            area = item["area"] if "area" in item else torch.zeros(0, dtype=torch.float64, device=dev)
            self.groundtruth_area.append(_as_on(area, dev).reshape(-1).to(torch.float64))

    def _boxes_xyxy(self, item: Dict[str, Any]) -> Tensor:
        dev = self.device
        boxes = _as_on(item["boxes"], dev, torch.float64)
        if boxes.numel() == 0:
            return torch.zeros((0, 4), dtype=torch.float64, device=dev)
        boxes = boxes.reshape(-1, 4)
        # convert in float64: 32-bit arithmetic here could flip a borderline
        # IoU exactly at an evaluation threshold
        if self.box_format == "xywh":
            x, y, w, h = boxes.unbind(1)
            boxes = torch.stack([x, y, x + w, y + h], dim=1)
        elif self.box_format == "cxcywh":
            cx, cy, w, h = boxes.unbind(1)
            boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=1)
        return boxes

    def _masks(self, item: Dict[str, Any]):
        """Dense (N, H, W) bool masks on the device, or COCO RLE dicts kept
        encoded on the host: their IoU runs on the run lengths
        (``_native.rle_iou``), never decoded."""
        masks = item["masks"]
        if isinstance(masks, (list, tuple)) and len(masks) and isinstance(masks[0], dict):
            out = []
            for m in masks:
                counts = m["counts"]
                if isinstance(counts, (bytes, str)):  # pycocotools compressed form
                    counts = _native.rle_from_coco_string(counts)
                out.append({"size": tuple(m["size"]), "counts": np.asarray(counts, np.uint32)})
            return out
        masks = _as_on(masks, self.device)
        if masks.numel() == 0:
            return torch.zeros((0, 1, 1), dtype=torch.bool, device=self.device)
        return masks.to(torch.bool)

    def _host_states(self) -> Dict[str, List[np.ndarray]]:
        """Every tensor state on the host: one copy per state."""
        return {name: _host_split(list(getattr(self, name))) for name in _TENSOR_STATES}

    def compute(self) -> Dict[str, Any]:
        dev = self.device
        host = self._host_states()
        result: Dict[str, Any] = {}
        n_img = len(host["detection_labels"])

        def f32(x) -> Tensor:
            return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

        for i_type in self.iou_type:
            prefix = "" if len(self.iou_type) == 1 else f"{i_type}_"
            dets, gts = [], []
            for i in range(n_img):
                d = {"scores": host["detection_scores"][i], "labels": host["detection_labels"][i]}
                g = {
                    "labels": host["groundtruth_labels"][i],
                    "iscrowd": host["groundtruth_crowds"][i],
                    "area": host["groundtruth_area"][i],
                }
                if i_type == "bbox":
                    d["boxes"] = host["detection_box"][i]
                    g["boxes"] = host["groundtruth_box"][i]
                else:
                    d["masks"] = self.detection_mask[i]
                    g["masks"] = self.groundtruth_mask[i]
                dets.append(d)
                gts.append(g)

            def evaluate(class_agnostic: bool) -> Dict[str, np.ndarray]:
                return evaluate_detections(
                    dets, gts, iou_type=i_type,
                    iou_thresholds=np.asarray(self.iou_thresholds),
                    rec_thresholds=np.asarray(self.rec_thresholds),
                    max_dets=self.max_detection_thresholds,
                    class_agnostic=class_agnostic,
                )

            ev = evaluate(self.average == "micro")
            summ = summarize(ev)
            for key in ("map", "map_50", "map_75", "map_small", "map_medium", "map_large",
                        "mar_small", "mar_medium", "mar_large"):
                result[f"{prefix}{key}"] = f32(summ[key])
            for md in self.max_detection_thresholds:
                result[f"{prefix}mar_{md}"] = f32(summ[f"mar_{md}"])

            if self.extended_summary:
                result[f"{prefix}ious"] = {k: f32(v) for k, v in ev["ious"].items()}
                result[f"{prefix}precision"] = f32(ev["precision"])
                result[f"{prefix}recall"] = f32(ev["recall"])
                result[f"{prefix}scores"] = f32(ev["scores"])

            last_md = self.max_detection_thresholds[-1]
            if self.class_metrics:
                if self.average == "micro":
                    # per-class numbers require a macro pass (reference :555-560)
                    summ = summarize(evaluate(False))
                result[f"{prefix}map_per_class"] = f32(summ["map_per_class"])
                result[f"{prefix}mar_{last_md}_per_class"] = f32(summ["mar_per_class"])
            else:
                result[f"{prefix}map_per_class"] = f32([-1.0])
                result[f"{prefix}mar_{last_md}_per_class"] = f32([-1.0])
        labels = host["detection_labels"] + host["groundtruth_labels"]
        classes = sorted({int(c) for lab in labels for c in lab.tolist()})
        result["classes"] = torch.tensor(classes, dtype=torch.int32, device=dev)
        return result
