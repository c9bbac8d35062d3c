"""The port's detection domain against the JAX package, on the CPU.

Box matrices, conversions and the IoU-family functionals and classes are
held bitwise for IoU, GIoU and DIoU (the functionals' diagonal means
within one float32 ulp: torch and XLA sum in another order); CIoU within
2.4e-7 absolute (two
float32 ulp at 1.0: torch's and XLA's ``atan`` differ by an ulp on some
inputs, and ``iou - penalty - alpha * v`` keeps that error absolute). The
classes' means are float64 on the port's side and float32 numpy means on
the JAX side: within 1e-6 relative.

``MeanAveragePrecision`` runs the same host COCO protocol through a
byte-identical C++ library, so every output key must be bitwise the JAX
package's on every scene. A two-rank gloo run must equal one process.
"""
import datetime
import importlib
import time
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as P
from torchmetrics_tpu import _native as JN
from torchmetrics_tpu.functional.detection import box_ops as JB
from torchmetrics_tpu_torch.functional.detection import box_ops as PB

CPU = {"device": "cpu"}
CIOU_ATOL = 2.4e-7
MEAN_RTOL = 1e-6


def _boxes(rng, n, scale=100.0):
    b = (rng.rand(n, 4) * scale).astype(np.float32)
    b[:, 2:] += b[:, :2] + (rng.rand(n, 2) * scale / 2).astype(np.float32)
    return b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _within_ulp(got, want, where=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, where
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want))), (where, got, want)


def _bitwise(got, want, where=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), (where, got, want)


# ---------------------------------------------------------------- box ops
@pytest.mark.parametrize("name", ["box_iou_matrix", "box_giou_matrix", "box_diou_matrix", "box_ciou_matrix"])
def test_pairwise_matrices_match_jax(name):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    b[:5] = a[:5]  # exact matches
    b[5] = [10, 10, 10, 20]  # a degenerate box
    got = getattr(PB, name)(_t(a), _t(b))
    want = np.asarray(getattr(JB, name)(jnp.asarray(a), jnp.asarray(b)))
    if name == "box_ciou_matrix":
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=CIOU_ATOL)
    else:
        _bitwise(got, want, name)


@pytest.mark.parametrize("in_fmt", ["xyxy", "xywh", "cxcywh"])
@pytest.mark.parametrize("out_fmt", ["xyxy", "xywh", "cxcywh"])
def test_box_convert_matches_jax(in_fmt, out_fmt):
    a = _boxes(np.random.RandomState(1), 25)
    _bitwise(PB.box_convert(_t(a), in_fmt, out_fmt), JB.box_convert(jnp.asarray(a), in_fmt, out_fmt))
    _bitwise(PB.box_area(_t(a)), JB.box_area(jnp.asarray(a)))


def test_box_convert_refuses_unknown_formats():
    a = _t(_boxes(np.random.RandomState(1), 2))
    with pytest.raises(ValueError, match="Unsupported box format"):
        PB.box_convert(a, "xyzw", "xyxy")
    with pytest.raises(ValueError, match="Unsupported box format"):
        PB.box_convert(a, "xyxy", "xyzw")


@pytest.mark.parametrize("fn", ["intersection_over_union", "generalized_intersection_over_union",
                                "distance_intersection_over_union", "complete_intersection_over_union"])
@pytest.mark.parametrize("kw", [{}, {"iou_threshold": 0.4, "replacement_val": -3.0}, {"aggregate": False}])
def test_functionals_match_jax(fn, kw):
    rng = np.random.RandomState(2)
    a = _boxes(rng, 12)
    b = a + rng.randn(12, 4).astype(np.float32) * 4
    got = getattr(P.functional.detection, fn)(_t(a), _t(b), **kw)
    want = getattr(J.functional.detection, fn)(jnp.asarray(a), jnp.asarray(b), **kw)
    if fn.startswith("complete"):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=CIOU_ATOL)
    elif kw.get("aggregate", True):
        _within_ulp(got, want, fn)
    else:
        _bitwise(got, want, fn)


def test_functional_of_no_boxes_is_zero():
    empty = torch.zeros((0, 4))
    got = P.functional.detection.intersection_over_union(empty, empty)
    want = J.functional.detection.intersection_over_union(jnp.zeros((0, 4)), jnp.zeros((0, 4)))
    _bitwise(got, want)


# ---------------------------------------------------------------- IoU classes
IOU_CLASSES = ["IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
               "CompleteIntersectionOverUnion"]


def _iou_scenes(seed=3, n_img=4):
    """Per-image (preds, targets) numpy dicts; image 2 has no predictions
    and image 3 no targets."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i in range(n_img):
        n_gt = 0 if i == 3 else 5
        gt = _boxes(rng, n_gt) if n_gt else np.zeros((0, 4), np.float32)
        det = (np.concatenate([gt + rng.randn(n_gt, 4).astype(np.float32) * 3, _boxes(rng, 2)])
               if i != 2 else np.zeros((0, 4), np.float32))
        preds.append({"boxes": det, "scores": rng.rand(len(det)).astype(np.float32),
                      "labels": rng.randint(0, 3, len(det))})
        targets.append({"boxes": gt, "labels": rng.randint(0, 3, n_gt)})
    return preds, targets


def _to_torch(items):
    return [{k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in d.items()} for d in items]


@pytest.mark.parametrize("cls", IOU_CLASSES)
@pytest.mark.parametrize("kw", [{}, {"iou_threshold": 0.5}, {"respect_labels": False, "class_metrics": True},
                                {"class_metrics": True, "box_format": "cxcywh"}])
def test_iou_classes_match_jax(cls, kw):
    preds, targets = _iou_scenes()
    ours, ref = getattr(P, cls)(**kw, **CPU), getattr(J, cls)(**kw)
    for lo, hi in ((0, 2), (2, 4)):
        ours.update(_to_torch(preds[lo:hi]), _to_torch(targets[lo:hi]))
        ref.update(preds[lo:hi], targets[lo:hi])
    for got, want in zip(ours.iou_matrix, ref.iou_matrix):
        if cls.startswith("Complete"):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=CIOU_ATOL)
        else:
            _bitwise(got, want, "iou_matrix")
    got, want = ours.compute(), ref.compute()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=MEAN_RTOL, atol=0, err_msg=k)


def test_iou_class_with_no_valid_pair_is_nan():
    ours = P.IntersectionOverUnion(class_metrics=True, **CPU)
    ours.update([{"boxes": torch.tensor([[0.0, 0, 1, 1]]), "labels": torch.tensor([0])}],
                [{"boxes": torch.tensor([[5.0, 5, 6, 6]]), "labels": torch.tensor([1])}])
    res = ours.compute()
    assert torch.isnan(res["iou"]) and torch.isnan(res["iou/cl_1"])


def test_iou_update_takes_tensors_on_the_metric_device_only():
    ours = P.IntersectionOverUnion(**CPU)
    meta = [{"boxes": torch.zeros((1, 4), device="meta"), "labels": torch.tensor([0])}]
    with pytest.raises(ValueError, match="lives on cpu"):
        ours.update(meta, meta)


@pytest.mark.parametrize("cls", IOU_CLASSES)
def test_iou_docstring_values(cls):
    want = {"IntersectionOverUnion": 0.8569, "GeneralizedIntersectionOverUnion": 0.851,
            "DistanceIntersectionOverUnion": 0.8569, "CompleteIntersectionOverUnion": 0.8569}[cls]
    m = getattr(P, cls)(**CPU)
    m.update([{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "scores": torch.tensor([0.9]),
               "labels": torch.tensor([0])}],
             [{"boxes": torch.tensor([[12.0, 8.0, 58.0, 62.0]]), "labels": torch.tensor([0])}])
    assert round(float(m.compute()[m._iou_type]), 4) == want


@pytest.mark.parametrize("bad, match", [
    ({"box_format": "xyzw"}, "box_format"),
    ({"class_metrics": 1}, "class_metrics"),
    ({"respect_labels": "yes"}, "respect_labels"),
])
def test_iou_argument_errors_match_jax(bad, match):
    with pytest.raises(ValueError, match=match) as ours:
        P.IntersectionOverUnion(**bad, **CPU)
    with pytest.raises(ValueError) as ref:
        J.IntersectionOverUnion(**bad)
    assert str(ours.value) == str(ref.value)


def test_input_validator_errors_match_jax():
    from torchmetrics_tpu.detection.iou import _input_validator as jv
    from torchmetrics_tpu_torch.detection.iou import _input_validator as pv

    good = {"boxes": np.zeros((2, 4), np.float32), "labels": np.zeros(2, np.int64), "scores": np.zeros(2)}
    cases = [
        ("not a list", [good]),
        ([good], [good, good]),
        ([{"labels": good["labels"], "scores": good["scores"]}], [good]),
        ([good], [{"boxes": good["boxes"]}]),
        ([good], [{"boxes": good["boxes"], "labels": np.zeros(3)}]),
        ([{**good, "scores": np.zeros(1)}], [good]),
    ]
    for preds, targets in cases:
        with pytest.raises(ValueError) as ref:
            jv(preds, targets)
        p = preds if isinstance(preds, str) else _to_torch(preds)
        with pytest.raises(ValueError) as ours:
            pv(p, _to_torch(targets))
        assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------- mAP scenes
def _sparse(rng, n_img=6, n_classes=3, crowd=False):
    out = []
    for _ in range(n_img):
        n_gt, n_dt = rng.randint(1, 6), rng.randint(0, 8)
        gt = _boxes(rng, n_gt, 200.0)
        dt = np.concatenate([gt[: min(n_gt, n_dt)] + rng.randn(min(n_gt, n_dt), 4).astype(np.float32) * 5,
                             _boxes(rng, max(0, n_dt - n_gt), 200.0)])
        g = {"boxes": gt, "labels": rng.randint(0, n_classes, n_gt)}
        if crowd:
            g["iscrowd"] = (rng.rand(n_gt) < 0.3).astype(np.int64)
        out.append(({"boxes": dt, "scores": rng.rand(len(dt)).astype(np.float32),
                     "labels": rng.randint(0, n_classes, len(dt))}, g))
    return out


def _one(gts, glabels, dets, scores, dlabels):
    return [({"boxes": np.asarray(dets, np.float32), "scores": np.asarray(scores, np.float32),
              "labels": np.asarray(dlabels, np.int64)},
             {"boxes": np.asarray(gts, np.float32), "labels": np.asarray(glabels, np.int64)})]


def _grid(rng):
    gts, dets, scores, glabels, dlabels = [], [], [], [], []
    for gy in range(6):
        for gx in range(6):
            x, y = 12 + gx * 55, 12 + gy * 55
            w, h = 40 + rng.rand() * 10, 40 + rng.rand() * 10
            gts.append([x, y, x + w, y + h])
            glabels.append((gx + gy) % 4)
            for k, off in enumerate((1.0, 8.0, 20.0)):
                dets.append([x + off, y + off * 0.6, x + w + off * 0.8, y + h + off * 0.5])
                scores.append(0.95 - 0.1 * k - 0.001 * (gx + gy))
                dlabels.append((gx + gy) % 4)
    return _one(gts, glabels, dets, scores, dlabels)


def _nested(rng):
    gts, dets, scores, glabels, dlabels = [], [], [], [], []
    for c, (cx, cy) in enumerate([(80, 80), (240, 80), (160, 240)]):
        for i, half in enumerate((10, 28, 75)):  # areas 400 / 3136 / 22500
            gts.append([cx - half, cy - half, cx + half, cy + half])
            glabels.append(c)
            jit = rng.rand() * 2
            dets.append([cx - half + jit, cy - half + jit, cx + half + jit, cy + half + jit])
            scores.append(0.9 - 0.15 * i)
            dlabels.append(c)
            mid = half * 0.6
            dets.append([cx - mid, cy - mid, cx + mid, cy + mid])
            scores.append(0.55)
            dlabels.append(c)
    return _one(gts, glabels, dets, scores, dlabels)


def _stack(rng):
    gts, dets, scores, glabels, dlabels = [], [], [], [], []
    for s, (x, y) in enumerate([(30, 30), (150, 30), (90, 150)]):
        for c in range(4):
            gts.append([x, y, x + 60, y + 60])
            glabels.append(c)
            dets.append([x + rng.rand() * 3, y + rng.rand() * 3, x + 60, y + 60])
            scores.append(0.9 - 0.05 * c - 0.01 * s)
            dlabels.append(c if (s + c) % 3 else (c + 1) % 4)
    return _one(gts, glabels, dets, scores, dlabels)


def _ladder(rng):
    gts, dets, scores, glabels, dlabels = [], [], [], [], []
    for g in range(4):
        x, y = 20 + g * 90, 40
        gts.append([x, y, x + 70, y + 70])
        glabels.append(g % 2)
        for k in range(10):
            d = rng.rand() * 4
            dets.append([x + d, y + d, x + 70 + d, y + 70 + d])
            scores.append(0.99 - 0.09 * k)
            dlabels.append(g % 2)
    return _one(gts, glabels, dets, scores, dlabels) * 2  # equal scores across images too


def _clutter(rng):
    gts, dets, scores, glabels, dlabels = [], [], [], [], []
    for _ in range(25):
        x, y = rng.rand(2) * 260
        w, h = (rng.rand(2) * (60 if rng.rand() < 0.5 else 18)) + 5
        gts.append([x, y, x + w, y + h])
        glabels.append(rng.randint(0, 3))
    gt_arr = np.asarray(gts)
    for _ in range(60):
        d = np.sort((gt_arr[rng.randint(0, 25)] + rng.randn(4) * 6).reshape(2, 2), axis=0).reshape(4)
        d[2:] = np.maximum(d[2:], d[:2] + 1.0)
        dets.append(d.tolist())
        scores.append(float(rng.rand()))
        dlabels.append(rng.randint(0, 3))
    return _one(gts, glabels, dets, scores, dlabels)


def _with_areas(rng):
    scene = _sparse(rng, n_img=5)
    for _, g in scene:  # explicit areas straddling the COCO ranges
        g["area"] = (rng.choice([500.0, 1024.0, 5000.0, 9216.0, 20000.0], len(g["labels"])))
    return scene


SCENES = {"sparse": _sparse, "crowds": lambda rng: _sparse(rng, crowd=True), "grid": _grid, "nested": _nested,
          "stack": _stack, "ladder": _ladder, "clutter": _clutter, "areas": _with_areas}


def _scene(name):
    return SCENES[name](np.random.RandomState(sum(map(ord, name))))


def _results_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert sorted(got[k]) == sorted(w), k
            for kk in w:
                _bitwise(got[k][kk], w[kk], f"{k}{kk}")
        else:
            _bitwise(got[k], w, k)


def _torch_item(d):
    out = {}
    for k, v in d.items():
        out[k] = _t(v) if isinstance(v, np.ndarray) else v
    return out


def _run_map(scene, batch=2, **kw):
    ours, ref = P.MeanAveragePrecision(**kw, **CPU), J.MeanAveragePrecision(**kw)
    for i in range(0, len(scene), batch):
        chunk = scene[i:i + batch]
        ref.update([d for d, _ in chunk], [g for _, g in chunk])
        ours.update([_torch_item(d) for d, _ in chunk], [_torch_item(g) for _, g in chunk])
    return ours.compute(), ref.compute()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_map_scenes_match_jax_bitwise(name):
    _results_equal(*_run_map(_scene(name), class_metrics=True))


@pytest.mark.parametrize("kw", [
    {"max_detection_thresholds": [1, 3, 7]},
    {"average": "micro"},
    {"average": "micro", "class_metrics": True},
    {"extended_summary": True},
    {"iou_thresholds": [0.3, 0.6, 0.75], "rec_thresholds": [0.0, 0.25, 0.5, 1.0]},
    {"box_format": "xywh"},
    {"box_format": "cxcywh", "class_metrics": True},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_map_options_match_jax_bitwise(kw):
    _results_equal(*_run_map(_scene("clutter") + _scene("crowds"), **kw))


def _masks_from_boxes(boxes, h, w):
    m = np.zeros((len(boxes), h, w), bool)
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(boxes)):
        m[i, int(y1):max(int(y2), int(y1) + 1), int(x1):max(int(x2), int(x1) + 1)] = True
    return m


def _segm_scene(seed, n_img=4, h=40, w=48):
    rng = np.random.RandomState(seed)
    out = []
    for d, g in _sparse(rng, n_img=n_img, crowd=True):
        scale = np.array([w, h, w, h], np.float32) / 320.0
        d = {**d, "boxes": d["boxes"] * scale}
        g = {**g, "boxes": g["boxes"] * scale}
        d["masks"] = _masks_from_boxes(d["boxes"], h, w)
        g["masks"] = _masks_from_boxes(g["boxes"], h, w)
        out.append((d, g))
    return out


def _rle(masks, compressed):
    out = []
    for m in masks:
        counts = JN.rle_encode(m.astype(np.uint8))
        out.append({"size": list(m.shape), "counts": JN.rle_to_coco_string(counts) if compressed else counts})
    return out


@pytest.mark.parametrize("iou_type", ["segm", ("bbox", "segm")])
def test_map_dense_masks_match_jax_bitwise(iou_type):
    _results_equal(*_run_map(_segm_scene(5), iou_type=iou_type, class_metrics=True))


@pytest.mark.parametrize("compressed", [False, True])
def test_map_rle_masks_match_jax_bitwise(compressed):
    scene = [({**d, "masks": _rle(d["masks"], compressed)}, {**g, "masks": _rle(g["masks"], compressed)})
             for d, g in _segm_scene(6)]
    scene[1] = (scene[1][0], {**scene[1][1], "masks": _segm_scene(6)[1][1]["masks"]})  # one dense side
    _results_equal(*_run_map(scene, iou_type="segm", extended_summary=True))


def test_map_segm_dense_equals_rle():
    dense = _segm_scene(7)
    rle = [({**d, "masks": _rle(d["masks"], True)}, {**g, "masks": _rle(g["masks"], False)}) for d, g in dense]
    got_dense, _ = _run_map(dense, iou_type="segm")
    got_rle, _ = _run_map(rle, iou_type="segm")
    _results_equal(got_dense, got_rle)


def test_map_states_live_on_the_metric_device_and_update_appends_only():
    m = P.MeanAveragePrecision(iou_type=("bbox", "segm"), **CPU)
    d, g = _segm_scene(8, n_img=1)[0]
    m.update([_torch_item(d)], [_torch_item(g)])
    assert m.detection_box[0].dtype == torch.float64 and m.detection_scores[0].dtype == torch.float64
    assert m.detection_labels[0].dtype == torch.int64 and m.groundtruth_crowds[0].dtype == torch.int64
    assert m.detection_mask[0].dtype == torch.bool and m.detection_mask[0].shape == (len(d["labels"]), 40, 48)
    assert m.groundtruth_area[0].shape == (0,)


def test_map_docstring_value_and_empty_inputs():
    m = P.MeanAveragePrecision(**CPU)
    m.update([{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "scores": torch.tensor([0.9]),
               "labels": torch.tensor([0])}],
             [{"boxes": torch.tensor([[10.0, 10.0, 60.0, 60.0]]), "labels": torch.tensor([0])}])
    assert round(float(m.compute()["map"]), 4) == 1.0
    empty = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int64)}
    _results_equal(*_run_map([(empty, {"boxes": empty["boxes"], "labels": empty["labels"]})] + _scene("sparse")))


@pytest.mark.parametrize("bad", [{"box_format": "xyzw"}, {"iou_type": "keypoints"}, {"iou_thresholds": 0.5},
                                 {"rec_thresholds": 0.5}, {"max_detection_thresholds": 10},
                                 {"class_metrics": 1}, {"extended_summary": 1}, {"average": "weighted"},
                                 {"backend": "pycocotools"}])
def test_map_argument_errors_match_jax(bad):
    with pytest.raises(ValueError) as ours:
        P.MeanAveragePrecision(**bad, **CPU)
    with pytest.raises(ValueError) as ref:
        J.MeanAveragePrecision(**bad)
    assert str(ours.value) == str(ref.value)


def test_dense_mask_iou_is_one_product_per_image(monkeypatch):
    coco = importlib.import_module("torchmetrics_tpu_torch.functional.detection.coco_eval")
    calls = []
    real = coco.dense_mask_overlaps
    monkeypatch.setattr(coco, "dense_mask_overlaps", lambda dt, gt: calls.append(1) or real(dt, gt))
    scene = _segm_scene(9, n_img=3)
    _run_map(scene, iou_type="segm")
    assert len(calls) == 3


# ---------------------------------------------------------------- two gloo ranks
WORLD = 2
DEADLINE_S = 120


def _rank_scene(rank):
    scene = _scene("clutter") + _scene("crowds")
    return scene[rank::2]


def _gloo_map_rank(rank, init_file, out_dir):
    import pathlib

    out_dir = pathlib.Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        m = P.MeanAveragePrecision(class_metrics=True, **CPU)
        for d, g in _rank_scene(rank):
            m.update([_torch_item(d)], [_torch_item(g)])
        torch.save(m.compute(), out_dir / f"rank{rank}.pt")
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_map_synced_over_two_gloo_ranks_equals_one_process(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_map_rank, args=(r, str(tmp_path / "init"), str(tmp_path)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = [f.read_text() for f in sorted(tmp_path.glob("rank*.err"))]
    assert not errors, "\n".join(errors)
    assert not hung and [p.exitcode for p in procs] == [0] * WORLD
    one = P.MeanAveragePrecision(class_metrics=True, **CPU)
    for rank in range(WORLD):  # the gathered lists extend in rank order
        for d, g in _rank_scene(rank):
            one.update([_torch_item(d)], [_torch_item(g)])
    want = one.compute()
    for r in range(WORLD):
        _results_equal(torch.load(tmp_path / f"rank{r}.pt", weights_only=False), want)
