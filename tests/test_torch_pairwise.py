"""The port's pairwise distance and similarity matrices against the JAX package, on the CPU.

Seeded numpy inputs go through both packages, with and without ``y``, under
every reduction and ``zero_diagonal`` setting. Cosine, linear, Manhattan and
Minkowski agree within ``RTOL`` relative and ``ATOL`` absolute; Euclidean
within ``EUCLID_ATOL`` absolute, since its ``|x|^2 + |y|^2 - 2 x.y``
expansion cancels. A self-distance kept on the diagonal is the square root
of that cancellation's residue (about 1e-6 in both packages, 1e-3 after the
root), so distances below ``NEAR_ZERO`` are held squared. Manhattan and
Minkowski taken in row chunks equal one piece.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torchmetrics_tpu.functional as JF
import torchmetrics_tpu_torch.functional as PF
from torchmetrics_tpu_torch.functional import pairwise as PP

RTOL = 1e-5
ATOL = 1e-6
EUCLID_ATOL = 1e-4
NEAR_ZERO = 0.05
NAMES = ["pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity",
         "pairwise_manhattan_distance", "pairwise_minkowski_distance"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(seed, n=23, m=17, d=9):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.randn(m, d).astype(np.float32)


def _close(name, got, want):
    got, want = got.numpy().astype(np.float64), np.asarray(want).astype(np.float64)
    assert got.shape == want.shape
    if name == "pairwise_euclidean_distance":
        small = want < NEAR_ZERO
        np.testing.assert_allclose(np.where(small, got**2, got), np.where(small, want**2, want), rtol=0,
                                   atol=EUCLID_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("zero_diagonal", [None, True, False])
@pytest.mark.parametrize("reduction", [None, "mean", "sum", "none"])
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_matrices_match_jax(name, with_y, reduction, zero_diagonal):
    x, y = _inputs(0)
    args_p = (_t(x), _t(y) if with_y else None)
    args_j = (jnp.asarray(x), jnp.asarray(y) if with_y else None)
    got = getattr(PF, name)(*args_p, reduction=reduction, zero_diagonal=zero_diagonal)
    want = getattr(JF, name)(*args_j, reduction=reduction, zero_diagonal=zero_diagonal)
    assert got.dtype == torch.float32
    if name == "pairwise_euclidean_distance" and not with_y and zero_diagonal is False and reduction == "sum":
        # each row sum holds its diagonal's root of a cancellation residue: take
        # the diagonals out (held squared by _close on the whole matrices)
        got_m, want_m = PF.pairwise_euclidean_distance(_t(x), zero_diagonal=False), \
            JF.pairwise_euclidean_distance(jnp.asarray(x), zero_diagonal=False)
        _close(name, got_m, want_m)
        got, want = got - got_m.diagonal(), np.asarray(want) - np.diagonal(np.asarray(want_m))
    _close(name, got, want)


@pytest.mark.parametrize("exponent", [1, 1.5, 3.0, 4])
def test_minkowski_exponents_match_jax(exponent):
    x, y = _inputs(1)
    _close("minkowski", PF.pairwise_minkowski_distance(_t(x), _t(y), exponent=exponent),
           JF.pairwise_minkowski_distance(jnp.asarray(x), jnp.asarray(y), exponent=exponent))


def test_integer_and_double_inputs_compute_in_float32_like_jax():
    x = np.arange(12, dtype=np.int64).reshape(4, 3)
    for name in NAMES:
        got = getattr(PF, name)(_t(x))
        assert got.dtype == torch.float32
        _close(name, got, getattr(JF, name)(jnp.asarray(x)))
    _close("linear", PF.pairwise_linear_similarity(_t(x.astype(np.float64))),
           JF.pairwise_linear_similarity(jnp.asarray(x.astype(np.float64))))


@pytest.mark.parametrize("name", ["pairwise_manhattan_distance", "pairwise_minkowski_distance"])
def test_row_chunks_equal_one_piece(monkeypatch, name):
    x, y = _inputs(2, n=31, m=11, d=6)
    whole = getattr(PF, name)(_t(x), _t(y))
    monkeypatch.setattr(PP, "BROADCAST_CHUNK", 11 * 6 * 4)  # 4 rows a chunk, a ragged last one
    torch.testing.assert_close(getattr(PF, name)(_t(x), _t(y)), whole, rtol=1e-6, atol=0)
    assert whole.shape == (31, 11)


def test_zero_diagonal_of_a_wide_matrix():
    x, y = _inputs(3, n=3, m=5)
    got = PF.pairwise_manhattan_distance(_t(x), _t(y), zero_diagonal=True)
    assert torch.all(got.diagonal() == 0) and torch.all(got[:, 3:] > 0)
    _close("manhattan", got, JF.pairwise_manhattan_distance(jnp.asarray(x), jnp.asarray(y), zero_diagonal=True))


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["x_rank", "y_rank", "y_width", "reduction", "exponent"])
def test_errors_match_jax(case):
    x, y = _inputs(4)
    kwargs, name = {}, "pairwise_minkowski_distance"
    if case == "x_rank":
        x = x[None]
    elif case == "y_rank":
        y = y[0]
    elif case == "y_width":
        y = y[:, :4]
    elif case == "reduction":
        kwargs["reduction"] = "max"
    else:
        kwargs["exponent"] = 0.5
    assert _message(lambda: getattr(PF, name)(_t(x), _t(y), **kwargs)) == \
        _message(lambda: getattr(JF, name)(jnp.asarray(x), jnp.asarray(y), **kwargs))
