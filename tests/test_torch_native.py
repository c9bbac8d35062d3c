"""The port's host C++ library against the JAX package's, bitwise, on the CPU.

``torchmetrics_tpu_torch/_native.py`` builds its own byte-identical copy of
``tm_native.cpp`` with ``g++`` and the JAX package's flags; every entry
point must give the JAX package's function of the same name bitwise on the
same seeded inputs, the C++ code must agree with the port's ``*_plain``
numpy versions (box IoU within four float64 ulp: ``-march=native`` may
contract the union into an FMA, which moves it by up to an ulp of
``a_area + b_area``), and a missing compiler must raise, never fall back to
numpy.
"""
import filecmp
import pathlib

import numpy as np
import pytest

from torchmetrics_tpu import _native as J
from torchmetrics_tpu_torch import _native as P

REPO = pathlib.Path(__file__).resolve().parent.parent


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _within_ulps(got, want, ulps=4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= ulps * np.spacing(np.abs(want))), np.abs(got - want).max()


def _tokens(rng, n, vocab, max_len):
    return [[f"w{t}" for t in rng.randint(0, vocab, rng.randint(0, max_len + 1))] for _ in range(n)]


def _boxes(rng, n, scale=100.0):
    b = rng.rand(n, 4) * scale
    b[:, 2:] += b[:, :2] + 1.0
    return b


def _stage_cells(rng, n_cells, with_nan):
    ious, scores, d_areas, g_areas, crowds = [], [], [], [], []
    for _ in range(n_cells):
        D, G = rng.randint(0, 9), rng.randint(0, 7)
        iou = rng.rand(D, G)
        sc = np.round(rng.rand(D), 1)  # a coarse grid: ties exercise the stable order
        if with_nan and D and G:
            iou[rng.randint(D), rng.randint(G)] = np.nan
            sc[rng.randint(D)] = np.nan
        ious.append(iou)
        scores.append(sc)
        d_areas.append(rng.rand(D) * 10000)
        g_areas.append(rng.rand(G) * 10000)
        crowds.append((rng.rand(G) < 0.2).astype(np.uint8))
    return ious, scores, d_areas, g_areas, crowds


def _rand_mask(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    y0, x0 = rng.randint(0, h - 3), rng.randint(0, w - 3)
    m[y0:y0 + rng.randint(2, h - y0), x0:x0 + rng.randint(2, w - x0)] = 1
    m[rng.rand(h, w) < 0.05] ^= 1  # ragged runs
    return m


def test_source_is_a_byte_identical_copy():
    assert filecmp.cmp(REPO / "torchmetrics_tpu_torch" / "csrc" / "tm_native.cpp",
                       REPO / "torchmetrics_tpu" / "_native" / "tm_native.cpp", shallow=False)


def test_build_uses_the_jax_flags_and_lands_in_build():
    assert P.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
    lib = P.build()
    assert lib.parent == REPO / "torchmetrics_tpu_torch" / "_build" and lib.exists()
    assert P.build() == lib  # keyed: a second call reuses the build


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_distances_match_jax_and_plain(seed):
    rng = np.random.RandomState(seed)
    preds, targets = _tokens(rng, 25, 6, 12), _tokens(rng, 25, 6, 12)
    preds[0], targets[1] = [], []
    got = P.edit_distance_batch(preds, targets)
    _same(got, J.edit_distance_batch(preds, targets))
    _same(got, P.edit_distance_batch_plain(preds, targets))
    counts = P.edit_distance_counts_batch(preds, targets)
    _same(counts, J.edit_distance_counts_batch(preds, targets))
    _same(counts, P.edit_distance_counts_batch_plain(preds, targets))
    # substitutions + deletions + insertions is the distance
    np.testing.assert_array_equal(counts[:, :3].sum(1), got)


def test_edit_distances_of_an_empty_batch():
    _same(P.edit_distance_batch([], []), J.edit_distance_batch([], []))
    _same(P.edit_distance_counts_batch([], []), J.edit_distance_counts_batch([], []))


@pytest.mark.parametrize("shape", [(4, 7), (7, 4), (5, 5), (1, 6)])
@pytest.mark.parametrize("ties", [False, True])
def test_linear_sum_assignment_matches_jax_and_scipy(shape, ties):
    rng = np.random.RandomState(sum(shape) + ties)
    cost = rng.randint(0, 3, shape).astype(np.float64) if ties else rng.rand(*shape)
    got = P.linear_sum_assignment(cost)
    want = J.linear_sum_assignment(cost)
    for g, w in zip(got, want):
        _same(g, w)
    r, c = P.linear_sum_assignment_plain(cost)
    assert cost[got].sum() == cost[r, c].sum()
    if not ties:
        _same(got[0], r)
        _same(got[1], c)


def test_linear_sum_assignment_infeasible_raises():
    cost = np.full((2, 2), np.inf)
    with pytest.raises(ValueError, match="infeasible"):
        P.linear_sum_assignment(cost)


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_codec_matches_jax_and_plain(seed):
    rng = np.random.RandomState(seed)
    for h, w in ((17, 23), (1, 9), (8, 1)):
        m = _rand_mask(rng, h, w) if h > 3 and w > 3 else (rng.rand(h, w) < 0.5).astype(np.uint8)
        counts = P.rle_encode(m)
        _same(counts, J.rle_encode(m))
        _same(counts, P.rle_encode_plain(m))
        dec = P.rle_decode(counts, h, w)
        _same(dec, J.rle_decode(counts, h, w))
        _same(dec, P.rle_decode_plain(counts, h, w))
        _same(dec, m)
        assert P.rle_area(counts) == J.rle_area(counts) == P.rle_area_plain(counts) == int(m.sum())
    full = np.ones((3, 4), np.uint8)
    _same(P.rle_encode(full), J.rle_encode(full))


def test_compressed_strings_round_trip_like_jax():
    rng = np.random.RandomState(3)
    for _ in range(5):
        counts = P.rle_encode(_rand_mask(rng, 40, 30))
        s = P.rle_to_coco_string(counts)
        assert s == J.rle_to_coco_string(counts)
        back = P.rle_from_coco_string(s)
        _same(back, J.rle_from_coco_string(s))
        _same(back, counts)
        _same(P.rle_from_coco_string(s.decode()), back)


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_iou_with_crowds_matches_jax_and_plain(seed):
    rng = np.random.RandomState(seed)
    dt = [P.rle_encode(_rand_mask(rng, 20, 24)) for _ in range(5)]
    gt = [P.rle_encode(_rand_mask(rng, 20, 24)) for _ in range(4)]
    crowd = np.array([0, 1, 0, 1], np.uint8)
    got = P.rle_iou(dt, gt, crowd)
    _same(got, J.rle_iou(dt, gt, crowd))
    np.testing.assert_allclose(got, P.rle_iou_plain(dt, gt, crowd), rtol=0, atol=1e-15)
    _same(P.rle_iou([], gt, crowd), J.rle_iou([], gt, crowd))


@pytest.mark.parametrize("seed", [0, 1])
def test_box_iou_with_crowds_matches_jax_and_plain(seed):
    rng = np.random.RandomState(seed)
    dt, gt = _boxes(rng, 30), _boxes(rng, 12)
    dt[3] = gt[2]  # an exact match
    crowd = rng.rand(12) < 0.3
    got = P.box_iou(dt, gt, crowd)
    _same(got, J.box_iou(dt, gt, crowd))
    _within_ulps(got, P.box_iou_plain(dt, gt, crowd))
    _same(P.box_iou(dt[:0], gt, crowd), J.box_iou(dt[:0], gt, crowd))


def test_box_iou_batch_matches_jax_and_plain():
    rng = np.random.RandomState(7)
    cells = [(_boxes(rng, rng.randint(0, 9)), _boxes(rng, g), (rng.rand(g) < 0.2).astype(np.uint8))
             for g in rng.randint(0, 7, 12)]
    dts, gts, crowds = (list(x) for x in zip(*cells))
    got, (flat, off) = P.box_iou_batch(dts, gts, crowds, return_flat=True)
    want, (j_flat, j_off) = J.box_iou_batch(dts, gts, crowds, return_flat=True)
    _same(flat, j_flat)
    _same(off, j_off)
    for g, w, p in zip(got, want, P.box_iou_batch_plain(dts, gts, crowds)):
        _same(g, w)
        _within_ulps(g, p)
    assert P.box_iou_batch([], [], []) == [] and P.box_iou_batch([], [], [], return_flat=True) == ([], None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_match_matches_jax_and_plain(seed):
    rng = np.random.RandomState(seed)
    ious = np.round(rng.rand(9, 6), 2)
    ignore = (rng.rand(6) < 0.3).astype(np.uint8)
    crowd = (rng.rand(6) < 0.3).astype(np.uint8)
    thrs = np.linspace(0.5, 0.95, 10)
    got = P.coco_match(ious, ignore, crowd, thrs)
    for g, w, p in zip(got, J.coco_match(ious, ignore, crowd, thrs), P.coco_match_plain(ious, ignore, crowd, thrs)):
        _same(g, w)
        _same(g, p)


@pytest.mark.parametrize("with_nan", [False, True])
@pytest.mark.parametrize("prebuilt", [False, True])
def test_coco_stage_match_batch_matches_jax_and_plain(with_nan, prebuilt):
    rng = np.random.RandomState(11 + with_nan)
    ious, scores, d_areas, g_areas, crowds = _stage_cells(rng, 20, with_nan)
    lo, hi = np.array([0.0, 0.0, 1024.0, 9216.0]), np.array([1e10, 1024.0, 9216.0, 1e10])
    thrs = np.linspace(0.5, 0.95, 10)
    kw = {}
    if prebuilt:
        off = np.zeros(len(ious), np.int64)
        np.cumsum([i.size for i in ious][:-1], out=off[1:])
        kw["ious_prebuilt"] = (np.concatenate([i.ravel() for i in ious]), off)
    got = P.coco_stage_match_batch(ious, scores, d_areas, g_areas, crowds, lo, hi, thrs, 5, **kw)
    want = J.coco_stage_match_batch(ious, scores, d_areas, g_areas, crowds, lo, hi, thrs, 5, **kw)
    plain = P.coco_stage_match_batch_plain(ious, scores, d_areas, g_areas, crowds, lo, hi, thrs, 5)
    assert len(got) == len(want) == len(plain) == 20
    for g_cell, w_cell, p_cell in zip(got, want, plain):
        for g, w, p in zip(g_cell, w_cell, p_cell):
            _same(g, w)
            if not with_nan:  # NaN scores sort differently in numpy's argsort
                _same(g, p)


def test_missing_compiler_raises_and_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(P.shutil, "which", lambda name: None)
    P._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            P.box_iou(np.zeros((1, 4)), np.ones((1, 4)), np.zeros(1))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            P.edit_distance_batch(["a"], ["b"])
    finally:
        P._library.cache_clear()


def test_failed_build_raises_with_the_compilers_stderr(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(P, "SOURCE", bad)
    monkeypatch.setattr(P, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed to build") as info:
        P.build()
    assert "error" in str(info.value)
    assert not list((tmp_path / "_build").glob("*.so"))
