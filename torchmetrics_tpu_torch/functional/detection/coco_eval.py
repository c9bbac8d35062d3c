"""COCO-protocol mAP evaluation core.

Counterpart of ``torchmetrics_tpu/functional/detection/coco_eval.py``: the
COCOeval matching and accumulation algorithm on the host, in float64 numpy,
through this package's copy of the host C++ library (:mod:`.._native`):
one batched call for the pairwise box IoU of every (image, class) cell and
one for the staging and greedy matching of every cell over all area ranges
and IoU thresholds. The code path is the JAX package's, so every output is
bitwise its.

Dense masks (``(N, H, W)`` bool tensors) stay where they live: their
intersections and areas are one float64 product per image on the masks'
device, read back once per image. Intersections and areas of 0/1 masks are
exact integers in float64, and the union, the crowd rule and the division
run on the host as the JAX package writes them, so mask IoUs are bitwise
its. RLE masks are host arrays and go through ``_native.rle_iou``.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _native

# COCO default parameter space: the reference builds these with
# torch.linspace in float32, so t=0.6 is really 0.60000002 and an IoU of
# exactly 0.6 does NOT match there; the same float32 grid keeps results
# bitwise.
DEFAULT_IOU_THRESHOLDS = np.linspace(0.5, 0.95, int(np.round((0.95 - 0.5) / 0.05)) + 1, dtype=np.float32).astype(np.float64)
DEFAULT_REC_THRESHOLDS = np.linspace(0.0, 1.0, int(np.round(1.0 / 0.01)) + 1, dtype=np.float32).astype(np.float64)
DEFAULT_MAX_DETS = (1, 10, 100)
AREA_RANGES = {
    "all": (0.0, 1e5**2),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e5**2),
}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _is_rle_list(masks) -> bool:
    return isinstance(masks, list) and (len(masks) == 0 or isinstance(masks[0], dict))


def _as_rle_list(masks) -> list:
    """Normalize masks to an RLE dict list, encoding dense (N, H, W) input on the host."""
    if _is_rle_list(masks):
        return list(masks)
    dense = _host(masks).astype(np.uint8)
    return [{"size": dense.shape[1:], "counts": _native.rle_encode(m)} for m in dense]


def rle_iou_np(dt, gt, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of COCO RLE mask lists without decoding."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float64)
    return _native.rle_iou([m["counts"] for m in dt], [m["counts"] for m in gt], iscrowd)


def _as_mask_tensor(masks) -> torch.Tensor:
    masks = masks if isinstance(masks, torch.Tensor) else torch.from_numpy(np.asarray(masks))
    return masks.to(torch.bool)


def dense_mask_overlaps(dt, gt) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(intersections (n_dt, n_gt), dt areas, gt areas) of dense (N, H, W)
    masks, float64 on the host: one float64 product on the masks' device
    and one read back. Exact: each is an integer count of pixels."""
    dt, gt = _as_mask_tensor(dt), _as_mask_tensor(gt)
    n_dt, n_gt = dt.shape[0], gt.shape[0]
    if dt.numel() == 0 or gt.numel() == 0:
        areas = [m.flatten(1).sum(1).to(torch.float64).cpu().numpy() for m in (dt, gt)]
        return np.zeros((n_dt, n_gt), np.float64), areas[0], areas[1]
    dtf = dt.flatten(1).to(torch.float64)
    gtf = gt.flatten(1).to(torch.float64)
    packed = torch.cat([(dtf @ gtf.T).reshape(-1), dtf.sum(1), gtf.sum(1)]).cpu().numpy()
    inter = packed[: n_dt * n_gt].reshape(n_dt, n_gt)
    return inter, packed[n_dt * n_gt: n_dt * n_gt + n_dt], packed[n_dt * n_gt + n_dt:]


def _overlap_iou(inter: np.ndarray, a_dt: np.ndarray, a_gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    union = a_dt[:, None] + a_gt[None, :] - inter
    union = np.where(np.asarray(iscrowd)[None, :].astype(bool), a_dt[:, None], union)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def accumulate(
    cells_by_key: Dict[Tuple[int, str], List[Tuple]],
    classes: Sequence[int],
    iou_thresholds: np.ndarray,
    rec_thresholds: np.ndarray,
    max_dets: Sequence[int],
    area_keys: Sequence[str] = ("all", "small", "medium", "large"),
) -> Dict[str, np.ndarray]:
    """PR accumulation over all (class, area, maxDet) cells.

    ``cells_by_key`` maps ``(cls, area)`` to that key's per-image
    ``(matched, ignored, scores, n_pos)`` matching outputs in image order,
    evaluated at the LARGEST maxDet (see :func:`evaluate_detections`);
    smaller maxDets slice the per-image score-ordered columns, exactly like
    pycocotools' ``accumulate`` slices ``evaluateImg``'s maxDets[-1] run.
    Returns ``precision`` of shape ``(T, R, K, A, M)`` and ``recall``
    ``(T, K, A, M)`` (COCOeval layout), plus ``scores`` ``(T, R, K, A, M)``.
    """
    n_t, n_r = len(iou_thresholds), len(rec_thresholds)
    n_k, n_a, n_m = len(classes), len(area_keys), len(max_dets)
    precision = -np.ones((n_t, n_r, n_k, n_a, n_m))
    recall = -np.ones((n_t, n_k, n_a, n_m))
    scores_out = -np.ones((n_t, n_r, n_k, n_a, n_m))

    for ki, cls in enumerate(classes):
        for ai, area in enumerate(area_keys):
            cells = cells_by_key.get((cls, area), ())
            n_gt = sum(c[3] for c in cells)
            if n_gt == 0 or not cells:
                continue
            for mi, max_det in enumerate(max_dets):
                scores = np.concatenate([c[2][:max_det] for c in cells])
                order = np.argsort(-scores, kind="mergesort")
                scores = scores[order]
                matched = np.concatenate([c[0][:, :max_det] for c in cells], axis=1)[:, order]
                ignored = np.concatenate([c[1][:, :max_det] for c in cells], axis=1)[:, order]

                tps = matched & ~ignored
                fps = ~matched & ~ignored
                tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                n_d = tp_cum.shape[1]
                # float32 like the reference: the recall grid is the float32
                # quantization of linspace(0,1,101), and exact float64
                # recalls (e.g. 2/5) land on the wrong side of float32(0.4)
                # in searchsorted
                rc = (tp_cum / n_gt).astype(np.float32)  # (T, N)
                pr = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
                recall[:, ki, ai, mi] = rc[:, -1] if n_d else 0.0
                # precision envelope: monotone non-increasing from the right
                pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                for ti in range(n_t):
                    inds = np.searchsorted(rc[ti], rec_thresholds, side="left")
                    valid = inds < n_d
                    q = np.zeros(n_r)
                    ss = np.zeros(n_r)
                    q[valid] = pr[ti, inds[valid]]
                    ss[valid] = scores[inds[valid]]
                    precision[ti, :, ki, ai, mi] = q
                    scores_out[ti, :, ki, ai, mi] = ss
    return {"precision": precision, "recall": recall, "scores": scores_out}


def evaluate_detections(
    detections: List[Dict],
    groundtruths: List[Dict],
    iou_type: str = "bbox",
    iou_thresholds: Optional[np.ndarray] = None,
    rec_thresholds: Optional[np.ndarray] = None,
    max_dets: Sequence[int] = DEFAULT_MAX_DETS,
    class_agnostic: bool = False,
) -> Dict[str, np.ndarray]:
    """Full COCO evaluation over per-image dicts.

    Each detection dict: ``boxes`` (N,4 xyxy) or ``masks`` (N,H,W bool, a
    tensor on any device or an array, or an RLE dict list), ``scores``
    (N,), ``labels`` (N,). Each groundtruth dict: ``boxes``/``masks``,
    ``labels``, optional ``iscrowd`` (N,), optional ``area`` (N,). Boxes,
    scores, labels, crowds and areas are host arrays. Returns the COCOeval
    accumulation arrays + the class list.
    """
    iou_thresholds = DEFAULT_IOU_THRESHOLDS if iou_thresholds is None else np.asarray(iou_thresholds)
    rec_thresholds = DEFAULT_REC_THRESHOLDS if rec_thresholds is None else np.asarray(rec_thresholds)
    max_dets = tuple(sorted(max_dets))

    classes = set()
    for d in detections:
        classes.update(np.asarray(d["labels"]).reshape(-1).tolist())
    for g in groundtruths:
        classes.update(np.asarray(g["labels"]).reshape(-1).tolist())
    classes = [0] if class_agnostic else sorted(int(c) for c in classes)

    area_keys = tuple(AREA_RANGES)
    max_det_cap = max_dets[-1]
    ious_map: Dict[Tuple[int, int], np.ndarray] = {}
    # one record per (image, class): context for the batched staging call
    cell_meta: List[Tuple] = []
    iou_cells: List[Tuple] = []  # (dt boxes, gt boxes, crowd) for the bbox IoU batch
    for img_idx, (det, gt) in enumerate(zip(detections, groundtruths)):
        dt_labels = np.asarray(det["labels"]).reshape(-1)
        gt_labels = np.asarray(gt["labels"]).reshape(-1)
        if class_agnostic:
            dt_labels = np.zeros_like(dt_labels)
            gt_labels = np.zeros_like(gt_labels)
        dt_scores = np.asarray(det["scores"], np.float64).reshape(-1)
        gt_crowd = np.asarray(gt.get("iscrowd", np.zeros(len(gt_labels)))).reshape(-1).astype(bool)

        overlaps = None
        if iou_type == "bbox":
            dt_geom = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
            gt_geom = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
            dt_areas = (dt_geom[:, 2] - dt_geom[:, 0]) * (dt_geom[:, 3] - dt_geom[:, 1])
            gt_areas = (gt_geom[:, 2] - gt_geom[:, 0]) * (gt_geom[:, 3] - gt_geom[:, 1])
        elif _is_rle_list(det["masks"]) or _is_rle_list(gt["masks"]):
            # a dense side is encoded to RLE on the host
            dt_geom = _as_rle_list(det["masks"])
            gt_geom = _as_rle_list(gt["masks"])
            dt_areas = np.asarray([_native.rle_area(m["counts"]) for m in dt_geom], np.float64)
            gt_areas = np.asarray([_native.rle_area(m["counts"]) for m in gt_geom], np.float64)
        else:
            # the image's dense masks: every (dt, gt) intersection at once,
            # on the masks' device; each class cell takes its block
            overlaps = dense_mask_overlaps(det["masks"], gt["masks"])
            dt_areas, gt_areas = overlaps[1], overlaps[2]
        if "area" in gt and np.asarray(gt["area"]).size:
            gt_areas = np.asarray(gt["area"], np.float64).reshape(-1)

        for cls in classes:
            d_sel = np.nonzero(dt_labels == cls)[0]
            g_sel = np.nonzero(gt_labels == cls)[0]
            if len(d_sel) == 0 and len(g_sel) == 0:
                continue
            if overlaps is not None:
                inter, a_dt, a_gt = overlaps
                ious_full = _overlap_iou(inter[np.ix_(d_sel, g_sel)], a_dt[d_sel], a_gt[g_sel], gt_crowd[g_sel])
            elif iou_type == "bbox":
                # bbox IoU is deferred into ONE batched C++ call below
                ious_full = None
                iou_cells.append((dt_geom[d_sel], gt_geom[g_sel], gt_crowd[g_sel]))
            else:  # RLE dict lists index elementwise
                ious_full = rle_iou_np([dt_geom[i] for i in d_sel], [gt_geom[j] for j in g_sel], gt_crowd[g_sel])
            cell_meta.append((
                img_idx, cls, ious_full, dt_scores[d_sel], gt_crowd[g_sel],
                gt_areas[g_sel], dt_areas[d_sel],
            ))

    if iou_cells:
        iou_views, iou_flat = _native.box_iou_batch(*zip(*iou_cells), return_flat=True)
    else:
        iou_views, iou_flat = [], None
    iou_results = iter(iou_views)
    area_lo = np.asarray([AREA_RANGES[a][0] for a in area_keys])
    area_hi = np.asarray([AREA_RANGES[a][1] for a in area_keys])
    stage_ious: List[np.ndarray] = []
    stage_scores: List[np.ndarray] = []
    stage_dareas: List[np.ndarray] = []
    stage_gareas: List[np.ndarray] = []
    stage_crowd: List[np.ndarray] = []
    for img_idx, cls, ious_full, scores_sel, crowd_sel, g_areas, d_areas in cell_meta:
        if ious_full is None:
            ious_full = next(iou_results)
        stage_ious.append(ious_full)
        stage_scores.append(scores_sel)
        stage_dareas.append(d_areas)
        stage_gareas.append(g_areas)
        stage_crowd.append(crowd_sel.astype(np.uint8))

    # staging (score ordering, per-area gt ignore-sorting) and greedy
    # matching in ONE C++ call for the whole epoch; matching runs once per
    # (img, cls, area) at the LARGEST maxDet (smaller maxDets are column
    # slices at accumulate time: greedy matching of the top-k prefix is
    # independent of later detections, pycocotools semantics). A pure-bbox
    # epoch's stage_ious are in-order views of the IoU batch's flat buffer,
    # which then skips a full re-flatten.
    all_bbox = len(iou_cells) == len(cell_meta)
    staged = _native.coco_stage_match_batch(
        stage_ious, stage_scores, stage_dareas, stage_gareas, stage_crowd,
        area_lo, area_hi, iou_thresholds, max_det_cap,
        ious_prebuilt=iou_flat if (all_bbox and iou_flat is not None) else None,
    )
    # (cls, area) -> cells in image order (cell_meta iterates images in order)
    cells_by_key: Dict[Tuple[int, str], List[Tuple]] = {}
    for (img_idx, cls, _ious, scores_sel, *_rest), cell_ious, (order, matched, ignored, npos) in zip(
        cell_meta, stage_ious, staged
    ):
        # extended-summary convention follows pycocotools computeIoU: rows in
        # score order, truncated to maxDets[-1]: exactly the staged `order`
        # (the fancy indexing also detaches the block from the epoch-wide
        # flat IoU buffer)
        ious_map[(img_idx, cls)] = cell_ious[order]
        scores_sorted = scores_sel[order]
        for a, area in enumerate(area_keys):
            cells_by_key.setdefault((cls, area), []).append(
                (matched[a], ignored[a], scores_sorted, int(npos[a])))

    out = accumulate(cells_by_key, classes, iou_thresholds, rec_thresholds, max_dets, area_keys)
    out["ious"] = ious_map
    out["classes"] = np.asarray(classes, np.int64)
    out["iou_thresholds"] = iou_thresholds
    out["rec_thresholds"] = rec_thresholds
    out["max_dets"] = np.asarray(max_dets)
    return out


def summarize(eval_out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """COCO summary numbers from the accumulation arrays (mean over valid)."""
    precision = eval_out["precision"]  # (T, R, K, A, M)
    recall = eval_out["recall"]  # (T, K, A, M)
    iou_t = eval_out["iou_thresholds"]
    max_dets = eval_out["max_dets"].tolist()
    area_idx = {k: i for i, k in enumerate(AREA_RANGES)}
    m_last = len(max_dets) - 1

    def _ap(t_sel=None, area="all"):
        p = precision[:, :, :, area_idx[area], m_last]
        if t_sel is not None:
            sel = np.isclose(iou_t, t_sel)
            if not sel.any():
                return np.float32(-1.0)
            p = p[sel]
        p = p[p > -1]
        return np.float32(p.mean()) if p.size else np.float32(-1.0)

    def _ar(mi, area="all"):
        r = recall[:, :, area_idx[area], mi]
        r = r[r > -1]
        return np.float32(r.mean()) if r.size else np.float32(-1.0)

    res = {
        "map": _ap(),
        "map_50": _ap(0.5),
        "map_75": _ap(0.75),
        "map_small": _ap(area="small"),
        "map_medium": _ap(area="medium"),
        "map_large": _ap(area="large"),
        "mar_small": _ar(m_last, "small"),
        "mar_medium": _ar(m_last, "medium"),
        "mar_large": _ar(m_last, "large"),
    }
    for mi, md in enumerate(max_dets):
        res[f"mar_{md}"] = _ar(mi)
    # per-class ap/ar at the largest maxDet over the "all" range
    k = precision.shape[2]
    map_pc, mar_pc = np.full(k, -1.0, np.float32), np.full(k, -1.0, np.float32)
    for ki in range(k):
        p = precision[:, :, ki, area_idx["all"], m_last]
        p = p[p > -1]
        map_pc[ki] = p.mean() if p.size else -1.0
        r = recall[:, ki, area_idx["all"], m_last]
        r = r[r > -1]
        mar_pc[ki] = r.mean() if r.size else -1.0
    res["map_per_class"] = map_pc
    res["mar_per_class"] = mar_pc
    return res
