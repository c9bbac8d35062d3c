"""The port's segmentation toolbox against the JAX package, on the CPU.

Seeded binary masks go through both packages. Structuring elements,
erosions, dilations, edges, neighbour codes and areas, both neighbour
tables and the taxicab and chessboard distance transforms are bitwise
equal; the Euclidean transform and surface distances agree within
``RTOL`` relative (and are bitwise here too, which the tests do not
require), and the Euclidean transform is held against
``scipy.ndimage.distance_transform_edt`` in float64. Distance-transform
phases taken in chunks of lines equal one piece.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp
from jax import lax

import torchmetrics_tpu.functional.segmentation as JF
import torchmetrics_tpu_torch.functional.segmentation as PF
from torchmetrics_tpu_torch.functional.segmentation import utils as PU

RTOL = 1e-5
ATOL = 1e-6
METRICS = ["euclidean", "taxicab", "chessboard"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _mask(seed, shape, p=0.6):
    return (np.random.RandomState(seed).rand(*shape) < p).astype(np.int32)


def _blob(seed, shape):
    """A mask of a few filled balls, so erosions and edges are not trivial."""
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    out = np.zeros(shape, bool)
    for _ in range(3):
        centre = rng.rand(len(shape)) * np.array(shape)
        out |= np.linalg.norm(grid - centre, axis=-1) < rng.uniform(2, max(shape) / 3)
    return out.astype(np.int32)


def _equal(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert got.numpy().dtype == want.dtype or (got.dtype == torch.float32 and want.dtype == np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rank,connectivity", [(2, 0), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3)])
def test_binary_structure_is_bitwise(rank, connectivity):
    _equal(PF.generate_binary_structure(rank, connectivity), JF.generate_binary_structure(rank, connectivity))


@pytest.mark.parametrize("border_value", [0, 1])
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("shape", [(2, 1, 13, 11), (1, 2, 7, 9, 6)])
def test_erosion_is_bitwise(shape, connectivity, border_value):
    img = np.maximum(_blob(0, shape[2:]), _mask(1, shape[2:], 0.1))[None, None].repeat(shape[0], 0).repeat(shape[1], 1)
    img = img.astype(np.float32)
    structure = JF.generate_binary_structure(len(shape) - 2, connectivity)
    got = PF.binary_erosion(_t(img), _t(np.array(structure)), border_value=border_value)
    _equal(got, JF.binary_erosion(jnp.asarray(img), structure, border_value=border_value))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shape", [(2, 1, 13, 11), (1, 1, 7, 9, 6)])
def test_dilation_is_bitwise(shape, dtype):
    img = _mask(2, shape, 0.15).astype(dtype)
    _equal(PF.binary_dilation(_t(img)), JF.binary_dilation(jnp.asarray(img)))
    asym = np.zeros((3,) * (len(shape) - 2), bool)
    asym[(1,) * (len(shape) - 2)] = True
    asym[(0,) * (len(shape) - 2)] = True  # not symmetric: dilation mirrors it
    _equal(PF.binary_dilation(_t(img), _t(asym)), JF.binary_dilation(jnp.asarray(img), jnp.asarray(asym)))


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["rank", "binary", "dilation_rank"])
def test_morphology_errors_match_jax(case):
    img = _mask(3, (1, 1, 5, 5)).astype(np.float32)
    if case == "rank":
        img = img[0]
    elif case == "binary":
        img = img * 2
    fn_p, fn_j = (PF.binary_dilation, JF.binary_dilation) if case == "dilation_rank" else \
        (PF.binary_erosion, JF.binary_erosion)
    if case == "dilation_rank":
        img = img[0, 0]
    assert _message(lambda: fn_p(_t(img))) == _message(lambda: fn_j(jnp.asarray(img)))


@pytest.mark.parametrize("sampling", [None, (1.0, 1.0), (1.5, 0.5)])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(9, 12), (3, 8, 10), (2, 2, 6, 7)])
def test_distance_transform_matches_jax(shape, metric, sampling):
    x = _mask(4, shape, 0.8)
    x[..., 0, :] = 1  # a line with no background along the first phase's axis
    got = PF.distance_transform(_t(x), sampling=sampling, metric=metric)
    want = np.asarray(JF.distance_transform(jnp.asarray(x), sampling=sampling, metric=metric))
    assert got.dtype == torch.float32
    if metric == "euclidean":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        _equal(got, want)


def test_distance_transform_without_background_is_inf_like_jax():
    x = np.ones((4, 5), np.int32)
    got = PF.distance_transform(_t(x))
    assert torch.all(torch.isinf(got))
    _equal(got, JF.distance_transform(jnp.asarray(x)))


@pytest.mark.parametrize("sampling", [None, (2.0, 0.7)])
def test_euclidean_transform_against_scipy_in_float64(sampling):
    x = _mask(5, (3, 21, 17), 0.85)
    got = PF.distance_transform(_t(x), sampling=sampling).numpy().astype(np.float64)
    want = np.stack([ndimage.distance_transform_edt(s, sampling=sampling) for s in x])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("metric", METRICS)
def test_phase_chunks_equal_one_piece(monkeypatch, metric):
    x = _t(_mask(6, (5, 11, 13), 0.8))
    whole = PF.distance_transform(x, metric=metric)
    monkeypatch.setattr(PU, "DT_CHUNK", 13 * 13 * 7)  # 7 lines a chunk, a ragged last one
    assert torch.equal(PF.distance_transform(x, metric=metric), whole)


@pytest.mark.parametrize("metric", METRICS)
def test_scipy_engine_matches_jax(metric):
    x = _mask(7, (10, 12), 0.7)
    got = PF.distance_transform(_t(x), metric=metric, engine="scipy")
    assert got.dtype == torch.float32
    _equal(got, JF.distance_transform(jnp.asarray(x), metric=metric, engine="scipy"))


@pytest.mark.parametrize("kwargs", [{"metric": "cityblock"}, {"engine": "cuda"}, {"sampling": (1.0, 1.0, 1.0)}])
def test_distance_transform_errors_match_jax(kwargs):
    x = _mask(8, (4, 4))
    assert _message(lambda: PF.distance_transform(_t(x), **kwargs)) == \
        _message(lambda: JF.distance_transform(jnp.asarray(x), **kwargs))


@pytest.mark.parametrize("spacing", [(1.0, 1.0), (0.5, 2.0), (1.0, 1.0, 1.0), (2.0, 0.5, 1.5)])
def test_neighbour_tables_are_bitwise(spacing):
    table, kernel = PF.get_neighbour_tables(spacing, device="cpu")
    jtable, jkernel = JF.get_neighbour_tables(spacing)
    _equal(table, jtable)
    _equal(kernel, jkernel)


def test_neighbour_table_errors_match_jax():
    assert _message(lambda: PF.get_neighbour_tables((1.0,), device="cpu")) == \
        _message(lambda: JF.get_neighbour_tables((1.0,)))


@pytest.mark.parametrize("crop", [True, False])
@pytest.mark.parametrize("spacing", [None, "unit", "scaled"])
@pytest.mark.parametrize("shape", [(14, 17), (8, 9, 7)])
def test_mask_edges_are_bitwise(shape, spacing, crop):
    p, t = _blob(9, shape), _blob(10, shape)
    sp = None if spacing is None else ((1.0,) * len(shape) if spacing == "unit" else (0.5, 2.0, 1.5)[:len(shape)])
    got = PF.mask_edges(_t(p), _t(t), crop=crop, spacing=sp)
    want = JF.mask_edges(jnp.asarray(p), jnp.asarray(t), crop=crop, spacing=sp)
    assert len(got) == len(want) == (2 if sp is None else 4)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("shape", [(14, 17), (8, 9, 7)])
def test_neighbour_codes_are_bitwise(shape):
    p, t = _blob(15, shape), _blob(16, shape)
    table, kernel = JF.get_neighbour_tables((1.0,) * len(shape))
    vol = jnp.stack([jnp.asarray(p), jnp.asarray(t)]).astype(jnp.float32)[:, None]
    spec = ("NCHW", "OIHW", "NCHW") if len(shape) == 2 else ("NCDHW", "OIDHW", "NCDHW")
    dn = lax.conv_dimension_numbers(vol.shape, (1, 1) + kernel.shape, spec)
    want = lax.conv_general_dilated(vol, kernel[None, None], (1,) * len(shape), "VALID", dimension_numbers=dn,
                                    precision=lax.Precision.HIGHEST)[:, 0].astype(jnp.int32)
    got = PU.neighbour_codes(_t(np.stack([p, t])), _t(np.array(kernel)))
    _equal(got, want)
    assert int(got.max()) == len(table) - 1 and int(got.min()) == 0


@pytest.mark.parametrize("spacing", [None, (1.0, 1.0)])
def test_mask_edges_of_empty_masks_match_jax(spacing):
    z = np.zeros((6, 7), np.int32)
    got = PF.mask_edges(_t(z), _t(z), spacing=spacing)
    for g, w in zip(got, JF.mask_edges(jnp.asarray(z), jnp.asarray(z), spacing=spacing)):
        _equal(g, w)


@pytest.mark.parametrize("case", ["shape", "rank", "binary", "spacing"])
def test_mask_edges_errors_match_jax(case):
    p, t, kwargs = _blob(11, (6, 6)), _blob(12, (6, 6)), {}
    if case == "shape":
        t = t[:5]
    elif case == "rank":
        p, t = p[0], t[0]
    elif case == "binary":
        p = p * 3
    else:
        kwargs["spacing"] = (1.0, 1.0, 1.0)
    assert _message(lambda: PF.mask_edges(_t(p), _t(t), **kwargs)) == \
        _message(lambda: JF.mask_edges(jnp.asarray(p), jnp.asarray(t), **kwargs))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(16, 13), (3, 12, 10)])
def test_surface_distance_matches_jax(shape, metric):
    p, t = _blob(13, shape), _blob(14, shape)
    got = PF.surface_distance(_t(p), _t(t), distance_metric=metric, spacing=(1.0, 2.0))
    want = np.asarray(JF.surface_distance(jnp.asarray(p), jnp.asarray(t), distance_metric=metric, spacing=(1.0, 2.0)))
    assert got.shape == want.shape == (int(p.sum()),)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
