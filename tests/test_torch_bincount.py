"""Port's weighted_bincount (plain PyTorch version on the CPU) against the JAX
package's Pallas kernel in interpret mode and against numpy.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there. Here the plain version and the wrapper's
dispatch are checked.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchmetrics_tpu.ops import weighted_bincount as jax_weighted_bincount
from torchmetrics_tpu_torch.ops import bincount as port_bincount
from torchmetrics_tpu_torch.ops import weighted_bincount, weighted_bincount_plain


def _jax_pallas(idx, w, bins):
    w = None if w is None else jnp.asarray(w)
    return np.asarray(jax_weighted_bincount(jnp.asarray(idx), w, bins, force_pallas=True, interpret=True))


@pytest.mark.parametrize("n,bins", [(10, 7), (5000, 100), (4096, 512), (33000, 2048)])
def test_weighted_matches_jax_pallas_and_numpy(n, bins):
    rng = np.random.RandomState(n)
    idx = rng.randint(0, bins, n)
    w = rng.rand(n).astype(np.float32)
    ours = weighted_bincount(torch.from_numpy(idx), torch.from_numpy(w), bins)
    assert ours.dtype == torch.float32 and ours.shape == (bins,)
    ref = np.bincount(idx, weights=w, minlength=bins).astype(np.float32)
    # float32 sums in another order than the float64 numpy oracle and the
    # Pallas tile reduction: agree to float32 rounding of sums of ~n/bins terms
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), _jax_pallas(idx, w, bins), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,bins", [(5000, 100), (33000, 2048)])
def test_zero_one_weights_are_bitwise(n, bins):
    """0/1 weights (the metric path's masks) sum exactly in any order."""
    rng = np.random.RandomState(n + 1)
    idx = rng.randint(0, bins, n).astype(np.int32)
    w = (rng.rand(n) < 0.8).astype(np.float32)
    ours = weighted_bincount(torch.from_numpy(idx), torch.from_numpy(w), bins).numpy()
    np.testing.assert_array_equal(ours, _jax_pallas(idx, w, bins))
    np.testing.assert_array_equal(ours, np.bincount(idx, weights=w, minlength=bins).astype(np.float32))


def test_unweighted_counts_int32_exact():
    rng = np.random.RandomState(7)
    idx = rng.randint(0, 300, 40000).astype(np.int64)
    ours = weighted_bincount(torch.from_numpy(idx), None, 300)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.bincount(idx, minlength=300))
    jax_out = _jax_pallas(idx, None, 300)
    assert jax_out.dtype == np.int32
    np.testing.assert_array_equal(ours.numpy(), jax_out)


def test_masks_out_of_range():
    idx = np.array([-1, 0, 1, 99, 100, 5, -70000, 2**31 - 1])
    ours = weighted_bincount(torch.from_numpy(idx), None, 100).numpy()
    ref = np.bincount(np.array([0, 1, 99, 5]), minlength=100)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, _jax_pallas(idx, None, 100))


def test_empty_input_gives_zeros():
    out = weighted_bincount(torch.zeros(0, dtype=torch.int32), torch.zeros(0), 6)
    assert out.dtype == torch.float32 and torch.equal(out, torch.zeros(6))
    out = weighted_bincount(torch.zeros(0, dtype=torch.int64), None, 3)
    assert out.dtype == torch.int32 and torch.equal(out, torch.zeros(3, dtype=torch.int32))
    np.testing.assert_array_equal(_jax_pallas(np.zeros(0, np.int32), None, 3), np.zeros(3))


def test_multidim_indices_flatten():
    idx = torch.tensor([[0, 1], [1, 3]])
    w = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    assert weighted_bincount(idx, w, 4).tolist() == [1.0, 5.0, 0.0, 4.0]


def test_invalid_arguments_raise():
    with pytest.raises(ValueError, match="num_bins"):
        weighted_bincount(torch.tensor([0, 1]), None, 0)
    with pytest.raises(ValueError, match="weights"):
        weighted_bincount(torch.tensor([0, 1]), torch.ones(3), 4)
    with pytest.raises(TypeError, match="integer"):
        weighted_bincount(torch.tensor([0.0, 1.0]), None, 4)


def test_non_cpu_non_cuda_tensor_raises():
    """Only CPU tensors take the plain version; nothing else falls back to it."""
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        weighted_bincount(idx, None, 4)


def test_plain_version_is_only_for_cpu(monkeypatch):
    """A CUDA tensor goes to the launch path, never to the plain version."""
    calls = []
    monkeypatch.setattr(port_bincount, "_launch", lambda idx, w, bins: calls.append(bins) or "launched")
    monkeypatch.setattr(port_bincount, "weighted_bincount_plain", lambda *a: pytest.fail("plain version used"))

    class FakeCuda:
        type = "cuda"

    idx = torch.zeros(3, dtype=torch.int32)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: FakeCuda()))
    assert port_bincount.weighted_bincount(idx, None, 5) == "launched"
    assert calls == [5]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(port_bincount.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        port_bincount._nvcc()


@pytest.mark.parametrize(
    "n,bins,sms,expect",
    [
        (1024, 100, 132, (1, 100)),  # one block writes the output directly
        (102_400, 6_500, 132, (16, 6_500)),
        (1_000_000, 65_000, 132, (31, 32_500)),  # two bin tiles
        (10**8, 1000, 132, (264, 1000)),  # capped at about two blocks per SM
    ],
)
def test_launch_plan(n, bins, sms, expect):
    grid_x, tile = port_bincount.launch_plan(n, bins, sms)
    assert (grid_x, tile) == expect
    assert tile <= port_bincount.MAX_TILE_BINS and tile * -(-bins // tile) >= bins


def test_plain_matches_torch_bincount():
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(rng.randint(0, 333, 10000))
    w = torch.from_numpy(rng.rand(10000).astype(np.float32))
    ours = weighted_bincount_plain(idx, w, 333)
    torch.testing.assert_close(ours, torch.bincount(idx, w, minlength=333).to(torch.float32), rtol=1e-5, atol=1e-4)


def test_utils_match_jax():
    """The ported data/compute helpers against their JAX counterparts."""
    from torchmetrics_tpu.utils import compute as jc
    from torchmetrics_tpu.utils import data as jd
    from torchmetrics_tpu_torch.utils import compute as pc
    from torchmetrics_tpu_torch.utils import data as pd

    rng = np.random.RandomState(11)
    # non-negative labels: for negative ones the JAX package's _bincount
    # differs by backend (jnp.bincount counts them in bin 0 on the CPU, the
    # TPU kernel drops them); the port follows the kernel and drops them
    labels = rng.randint(0, 7, 50).astype(np.int32)
    np.testing.assert_array_equal(pd._bincount(torch.from_numpy(labels), 5).numpy(),
                                  np.asarray(jd._bincount(jnp.asarray(labels), 5)))
    probs = rng.rand(8, 5, 3).astype(np.float32)
    for k in (1, 2):
        np.testing.assert_array_equal(pd.select_topk(torch.from_numpy(probs), k).numpy(),
                                      np.asarray(jd.select_topk(jnp.asarray(probs), k)))
    lab = rng.randint(0, 5, (8, 3))
    np.testing.assert_array_equal(pd.to_onehot(torch.from_numpy(lab), 5).numpy(),
                                  np.asarray(jd.to_onehot(jnp.asarray(lab), 5)))
    parts = [rng.rand(3, 2).astype(np.float32), rng.rand(1, 2).astype(np.float32)]
    for name in ("dim_zero_cat", "dim_zero_sum", "dim_zero_mean", "dim_zero_max", "dim_zero_min"):
        np.testing.assert_allclose(getattr(pd, name)([torch.from_numpy(x) for x in parts]).numpy(),
                                   np.asarray(getattr(jd, name)([jnp.asarray(x) for x in parts])), rtol=1e-6)
    num, den = rng.randint(0, 4, 10).astype(np.int32), rng.randint(0, 3, 10).astype(np.int32)
    np.testing.assert_array_equal(pc._safe_divide(torch.from_numpy(num), torch.from_numpy(den), 0.5).numpy(),
                                  np.asarray(jc._safe_divide(jnp.asarray(num), jnp.asarray(den), 0.5)))
    x, y = np.sort(rng.rand(2, 9).astype(np.float32), axis=-1), rng.rand(2, 9).astype(np.float32)
    np.testing.assert_allclose(pc._auc_compute_without_check(torch.from_numpy(x), torch.from_numpy(y), 1.0).numpy(),
                               np.asarray(jc._auc_compute_without_check(jnp.asarray(x), jnp.asarray(y), 1.0)),
                               rtol=1e-6)
    logits = (rng.randn(6, 4) * 3).astype(np.float32)
    for norm in ("sigmoid", "softmax"):
        np.testing.assert_allclose(pc.normalize_logits_if_needed(torch.from_numpy(logits), norm).numpy(),
                                   np.asarray(jc.normalize_logits_if_needed(jnp.asarray(logits), norm)),
                                   rtol=1e-6, atol=1e-7)
