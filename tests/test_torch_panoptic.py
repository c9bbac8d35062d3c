"""Panoptic quality of the port against the JAX package, on the CPU.

The port counts each sample's table of intersections with one int32
``weighted_bincount`` and adds the matched IoUs in float64 in the JAX
package's order, so the four states (float32 ``iou_sum``, int32 true
positives, false positives and false negatives) must be bitwise the JAX
package's, and so must the float64 functional values.
"""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as P
from torchmetrics_tpu.functional.detection import modified_panoptic_quality as j_modified
from torchmetrics_tpu.functional.detection import panoptic_quality as j_pq
from torchmetrics_tpu_torch.functional.detection import modified_panoptic_quality as p_modified
from torchmetrics_tpu_torch.functional.detection import panoptic_quality as p_pq

PQ = importlib.import_module("torchmetrics_tpu_torch.functional.detection.panoptic_quality")
JPQ = importlib.import_module("torchmetrics_tpu.functional.detection.panoptic_quality")
CPU = {"device": "cpu"}
THINGS, STUFFS = {0, 1, 2}, {6, 7}
VOID, UNKNOWN = 255, 99


def _scene(seed, batch=3, shape=(24, 32), unknown=True):
    """Seeded (B, *shape, 2) maps: thing instances and stuff regions, target
    void pixels (category 255), and predictions that shift, split, relabel
    and (with ``unknown``) paint unknown categories."""
    rng = np.random.RandomState(seed)
    full = (batch, *shape)
    cat = rng.choice(sorted(STUFFS), size=full)
    inst = np.zeros(full, np.int64)
    coords = np.indices(shape)
    for b in range(batch):
        for k in range(rng.randint(3, 7)):
            lo = [rng.randint(0, max(1, s - 3)) for s in shape]
            hi = [lo[d] + rng.randint(2, max(3, shape[d] // 2 + 1)) for d in range(len(shape))]
            box = np.all([(coords[d] >= lo[d]) & (coords[d] < hi[d]) for d in range(len(shape))], axis=0)
            cat[b][box] = rng.choice(sorted(THINGS))
            inst[b][box] = k + 1
    target = np.stack([cat, inst], -1)
    target[..., 0][rng.rand(*full) < 0.08] = VOID
    preds = np.stack([cat, inst], -1).copy()
    preds = np.roll(preds, rng.randint(-2, 3), axis=1)
    flip = rng.rand(*full) < 0.05
    preds[..., 0][flip] = rng.choice(sorted(THINGS | STUFFS), size=int(flip.sum()))
    preds[..., 1][rng.rand(*full) < 0.03] += 1
    if unknown:
        preds[..., 0][rng.rand(*full) < 0.04] = UNKNOWN
    return preds, target


def _states(m):
    return [m.iou_sum, m.true_positives, m.false_positives, m.false_negatives]


def _bitwise(got, want, where=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
    assert got.tobytes() == want.tobytes(), (where, got, want)


def _update_tuples_equal(preds, target, modified, allow=True, things=THINGS, stuffs=STUFFS):
    got = PQ._panoptic_quality_update(torch.from_numpy(preds), torch.from_numpy(target), things, stuffs, allow,
                                      stuffs if modified else None)
    want = JPQ._panoptic_quality_update(preds, target, things, stuffs, allow, stuffs if modified else None)
    for g, w, name in zip(got, want, ("iou_sum", "tp", "fp", "fn")):
        _bitwise(g, w, name)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("modified", [False, True])
def test_update_statistics_match_jax_bitwise(seed, modified):
    _update_tuples_equal(*_scene(seed), modified)


@pytest.mark.parametrize("cls", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_classes_match_jax_bitwise(cls):
    ours = getattr(P, cls)(things=THINGS, stuffs=STUFFS, allow_unknown_preds_category=True, **CPU)
    ref = getattr(J, cls)(things=THINGS, stuffs=STUFFS, allow_unknown_preds_category=True)
    for seed in range(3):
        preds, target = _scene(10 + seed)
        ours.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    for got, want, name in zip(_states(ours), _states(ref), ("iou_sum", "tp", "fp", "fn")):
        _bitwise(got, want, name)
    _bitwise(ours.compute(), ref.compute(), "compute")


@pytest.mark.parametrize("modified", [False, True])
def test_functionals_match_jax_bitwise(modified):
    preds, target = _scene(4)
    p_fn, j_fn = (p_modified, j_modified) if modified else (p_pq, j_pq)
    got = p_fn(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS, allow_unknown_preds_category=True)
    want = j_fn(preds, target, THINGS, STUFFS, allow_unknown_preds_category=True)
    assert got.dtype == torch.float64
    assert got.item() == float(want)


def test_three_dimensional_spatial_input():
    preds, target = _scene(5, batch=2, shape=(4, 10, 12))
    assert preds.shape == (2, 4, 10, 12, 2)
    for modified in (False, True):
        _update_tuples_equal(preds, target, modified)


def test_samples_sharing_keys_do_not_merge():
    """Two samples with the same (category, instance) keys: segments are per sample."""
    a = np.zeros((1, 4, 4, 2), np.int64)
    a[0, :2, :, 0] = 1
    b = a.copy()
    b[0, :, :2, 0] = 2
    preds = np.concatenate([a, b])
    target = np.concatenate([b, a])
    _, tp, fp, fn = _update_tuples_equal(preds, target, False, things={0, 1, 2}, stuffs=set())
    merged = _update_tuples_equal(preds.reshape(1, 8, 4, 2), target.reshape(1, 8, 4, 2), False,
                                  things={0, 1, 2}, stuffs=set())
    assert not (np.array_equal(tp, merged[1]) and np.array_equal(fp, merged[2]))


def test_void_rules_at_and_past_half():
    """A target segment over half covered by unknown predictions is no false
    negative, a predicted segment over half on target void is no false
    positive; at exactly half both count."""
    things, stuffs = {1, 2, 3, 4}, set()
    pred = np.zeros((1, 4, 8, 2), np.int64)
    target = np.zeros((1, 4, 8, 2), np.int64)
    target[0, :, :4, 0] = 1  # target segment A: 16 pixels
    pred[0, :, :3, 0] = UNKNOWN  # 12 of A's 16 under unknown predictions
    pred[0, :, 3, 0] = 2
    target[0, :, 4:6, 0] = 3  # target segment B: 8 pixels
    pred[0, :2, 4:6, 0] = UNKNOWN  # exactly half of B under unknown
    pred[0, 2:, 4:6, 0] = 4
    target[0, :, 6:, 0] = VOID  # 8 void target pixels
    pred[0, :, 6:, 0] = 4  # 8 of predicted segment 4's 12 pixels on void
    pred[0, :, 6:, 1] = 1
    for modified in (False, True):
        _update_tuples_equal(pred, target, modified, things=things, stuffs=stuffs)
    got = _update_tuples_equal(pred, target, False, things=things, stuffs=stuffs)
    assert got[3][0] == 0 and got[3][2] == 1  # A is no FN, B (exactly half) is one


def test_unknown_categories_raise_like_jax():
    preds, target = _scene(6)
    with pytest.raises(ValueError) as ref:
        J.PanopticQuality(things=THINGS, stuffs=STUFFS).update(jnp.asarray(preds), jnp.asarray(target))
    m = P.PanopticQuality(things=THINGS, stuffs=STUFFS, **CPU)
    with pytest.raises(ValueError, match="Unknown categories found") as ours:
        m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert str(ours.value) == str(ref.value)
    assert int(m.true_positives.sum()) == 0  # nothing was added


def test_duplicate_categories_warn_like_jax():
    for things, stuffs in (([0, 0, 1], [6]), ([0, 1], [6, 6])):
        with warnings.catch_warnings(record=True) as ours:
            warnings.simplefilter("always")
            P.PanopticQuality(things=things, stuffs=stuffs, **CPU)
        with warnings.catch_warnings(record=True) as ref:
            warnings.simplefilter("always")
            J.PanopticQuality(things=things, stuffs=stuffs)
        assert [str(w.message) for w in ours] == [str(w.message) for w in ref] != []


@pytest.mark.parametrize("things, stuffs", [([0.5], [1]), ([0], ["a"]), ([0, 1], [1, 2]), ([], [])])
def test_category_errors_match_jax(things, stuffs):
    with pytest.raises((TypeError, ValueError)) as ref:
        J.PanopticQuality(things=things, stuffs=stuffs)
    with pytest.raises(type(ref.value)) as ours:
        P.PanopticQuality(things=things, stuffs=stuffs, **CPU)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("p_shape, t_shape", [((1, 4, 4, 2), (1, 4, 5, 2)), ((4, 2), (4, 2)),
                                              ((1, 4, 4, 3), (1, 4, 4, 3))])
def test_input_errors_match_jax(p_shape, t_shape):
    with pytest.raises(ValueError) as ref:
        j_pq(np.zeros(p_shape, np.int64), np.zeros(t_shape, np.int64), THINGS, STUFFS)
    with pytest.raises(ValueError) as ours:
        p_pq(torch.zeros(p_shape, dtype=torch.int64), torch.zeros(t_shape, dtype=torch.int64), THINGS, STUFFS)
    assert str(ours.value) == str(ref.value)


def test_table_is_one_bincount_per_sample(monkeypatch):
    calls = []
    real = PQ.weighted_bincount

    def spy(idx, weights=None, num_bins=0):
        calls.append((idx.dtype, weights, num_bins))
        return real(idx, weights, num_bins)

    monkeypatch.setattr(PQ, "weighted_bincount", spy)
    preds, target = _scene(7, batch=3)
    m = P.ModifiedPanopticQuality(things=THINGS, stuffs=STUFFS, allow_unknown_preds_category=True, **CPU)
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert len(calls) == 3
    assert all(dtype == torch.int32 and w is None for dtype, w, _ in calls)


def test_table_too_large_for_int32_raises(monkeypatch):
    monkeypatch.setattr(PQ, "MAX_TABLE_BINS", 10)
    preds, target = _scene(8, batch=1)
    with pytest.raises(ValueError, match="table of intersections"):
        p_pq(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS, allow_unknown_preds_category=True)


def test_states_dtypes_and_class_flags():
    m = P.PanopticQuality(things=THINGS, stuffs=STUFFS, **CPU)
    assert [s.dtype for s in _states(m)] == [torch.float32, torch.int32, torch.int32, torch.int32]
    assert m.plot_lower_bound == 0.0 and m.plot_upper_bound == 1.0 and not P.PanopticQuality.jittable
    assert P.ModifiedPanopticQuality._modified and not P.PanopticQuality._modified
