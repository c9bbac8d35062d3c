"""The t-digest compress kernel's plain version, its routing and its vmap rule, on the CPU.

``ops/tdigest.py`` ``tdigest_compress_sorted_plain`` is the CUDA kernel's
oracle and the CPU path. Here it is held against:

- a sequential oracle written as the JAX package writes the scan
  (``torchmetrics_tpu/sketches/tdigest.py:78-88``): one Python loop over
  float32 scalars for the walk, the kernel's blocked float64 running sum
  (each block of ``BLOCK`` weights in order, then the block totals in
  order) rounded to float32 for the cumulative weight, float32 sums in
  order within each slot. The k1
  scale values come from the module's ``k_scale`` over the whole array (the
  same float32 ``asin``), so the test checks the walk, the sums and the
  clamp bitwise;
- the JAX package's ``tdigest_compress`` on the same (unsorted) centroids:
  weights bitwise wherever they are integers below 2^24 (every step is then
  exact), means within 1e-6 relative.

On a CUDA tensor the entry launches the kernel or raises; the test swaps
the launch for a recorder, as the bincount's routing test does. The kernel
itself is held against this plain version by ``chip_smoke.py``.
"""
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchmetrics_tpu.sketches import tdigest as JT
from torchmetrics_tpu_torch.ops import bincount as port_bincount
from torchmetrics_tpu_torch.ops import tdigest as port_tdigest
from torchmetrics_tpu_torch.ops.tdigest import k_scale, tdigest_compress_sorted, tdigest_compress_sorted_plain
from torchmetrics_tpu_torch.sketches.tdigest import _sort_centroids, tdigest_compress

MEAN_RTOL = 1e-6


def _sequential_sum(w: np.ndarray) -> np.ndarray:
    """Running float64 sum of float32 weights in order, each prefix rounded to float32."""
    acc = 0.0
    cum = np.empty_like(w)
    for i, wi in enumerate(w):
        acc += float(wi)
        cum[i] = np.float32(acc)
    return cum


def _blocked_sum(w: np.ndarray) -> np.ndarray:
    """The kernel's running sum: float64 chains within blocks of BLOCK weights,
    a float64 chain over the block totals, one add and one round to float32."""
    cum = np.empty_like(w)
    offset = 0.0
    for lo in range(0, len(w), port_tdigest.BLOCK):
        within = 0.0
        for i in range(lo, min(lo + port_tdigest.BLOCK, len(w))):
            within += float(w[i])
            cum[i] = np.float32(offset + within)
        offset += within
    return cum


def _oracle(centroids: np.ndarray, compression: int) -> np.ndarray:
    """One sorted (M, 2) list, sequentially, as the JAX scan body reads."""
    mean = centroids[:, 0].astype(np.float32)
    w = centroids[:, 1].astype(np.float32)
    cum = _blocked_sum(w)
    safe = np.float32(max(cum[-1], np.float32(1e-38)))
    q_left = ((cum - w) / safe).astype(np.float32)
    q_right = (cum / safe).astype(np.float32)
    k_right = k_scale(torch.from_numpy(q_right), compression).numpy()
    k_left = k_scale(torch.from_numpy(q_left), compression).numpy()
    slot = 0
    k_start = k_scale(torch.zeros(1), compression).numpy()[0]
    slots = np.empty(len(w), np.int64)
    for i in range(len(w)):
        if w[i] > 0 and np.float32(k_right[i] - k_start) > 1.0 and q_left[i] > 0:
            slot += 1
            k_start = k_left[i]
        slots[i] = min(slot, compression - 1)
    sum_w = np.zeros(compression, np.float32)
    sum_mw = np.zeros(compression, np.float32)
    for i in range(len(w)):
        if w[i] > 0:
            sum_w[slots[i]] = np.float32(sum_w[slots[i]] + w[i])
            sum_mw[slots[i]] = np.float32(sum_mw[slots[i]] + np.float32(mean[i] * w[i]))
    with np.errstate(divide="ignore", invalid="ignore"):
        new_mean = np.where(sum_w > 0, sum_mw / np.maximum(sum_w, np.float32(1e-38)), np.inf).astype(np.float32)
    return np.stack([new_mean, sum_w], axis=1)


def _digests(seed: int, s: int, m: int, compression: int, weights: str) -> torch.Tensor:
    """S sorted lists of M rows: a digest body's C empty slots and M - C observations."""
    rng = np.random.RandomState(seed)
    n = m - compression
    vals = rng.lognormal(0.0, 1.0, (s, n)).astype(np.float32)
    if weights == "unit":
        w = np.ones((s, n), np.float32)
    elif weights == "integer":
        w = rng.randint(0, 4, (s, n)).astype(np.float32)  # zeros drop observations
    elif weights == "decayed":  # a decayed digest's weights: powers of 2^(-1/32) over 64 halvings
        w = (rng.rand(s, n) * 3 * np.exp2(-rng.randint(0, 64 * 32, (s, n)) / 32)).astype(np.float32)
    else:
        w = (rng.rand(s, n) * 3).astype(np.float32)
    pts = np.stack([np.where(w > 0, vals, np.inf), w], axis=-1)
    body = np.tile(np.asarray([[np.inf, 0.0]], np.float32), (s, compression, 1))
    cent = torch.from_numpy(np.concatenate([body, pts], axis=1).astype(np.float32))
    return torch.stack([_sort_centroids(c) for c in cent])


CASES = [
    (0, 1, 80, 16, "unit"),
    (1, 3, 300, 16, "integer"),
    (2, 2, 1300, 32, "unit"),  # past one walk window of 512
    (3, 4, 700, 64, "random"),
    (4, 1, 5000, 64, "integer"),
    (5, 5, 64, 16, "unit"),
    (6, 2, 2100, 128, "random"),
    (7, 1, 40, 32, "unit"),  # fewer observations than slots
    (8, 2, 3 * 256 - 1, 16, "decayed"),  # across running-sum blocks: 3 B - 1, 3 B, 3 B + 1
    (9, 2, 3 * 256, 16, "decayed"),
    (10, 2, 3 * 256 + 1, 32, "random"),
    (11, 3, 200, 16, "decayed"),  # fewer centroids than one block
    (12, 1, 65_664, 128, "integer"),  # one latency update: 65,536 values into a 128-slot digest
]


@pytest.mark.parametrize("seed,s,m,compression,weights", CASES)
def test_plain_version_equals_the_sequential_scan_bitwise(seed, s, m, compression, weights):
    cent = _digests(seed, s, m, compression, weights)
    got = tdigest_compress_sorted_plain(cent, compression)
    assert got.shape == (s, compression, 2) and got.dtype == torch.float32
    for r in range(s):
        np.testing.assert_array_equal(got[r].numpy(), _oracle(cent[r].numpy(), compression))


@pytest.mark.parametrize("seed,s,m,compression,weights", [c for c in CASES if c[4] in ("unit", "integer")])
def test_blocked_running_sum_is_the_sequential_sum_for_integer_weights(seed, s, m, compression, weights):
    """Every partial sum of integers below 2^24 is exact, so the order does not matter."""
    w = _digests(seed, s, m, compression, weights)[..., 1]
    got = port_tdigest.blocked_running_sum(w)
    np.testing.assert_array_equal(got.numpy(), torch.cumsum(w, dim=-1, dtype=torch.float64).to(torch.float32).numpy())
    for r in range(s):
        np.testing.assert_array_equal(got[r].numpy(), _sequential_sum(w[r].numpy()))


@pytest.mark.parametrize("seed,s,m,compression,weights", [c for c in CASES if c[4] not in ("unit", "integer")])
def test_blocked_running_sum_equals_the_blocked_oracle(seed, s, m, compression, weights):
    w = _digests(seed, s, m, compression, weights)[..., 1]
    got = port_tdigest.blocked_running_sum(w)
    for r in range(s):
        np.testing.assert_array_equal(got[r].numpy(), _blocked_sum(w[r].numpy()))


def test_blocked_order_is_the_contract_where_float64_rounds():
    """Block 0 ends on a float32 tie, 2^60 + 2^36; block 1 adds ones. In order,
    each one is lost to float64 rounding and the tie rounds to even (2^60);
    blocked, block 1's 256 ones are exact and lift every later prefix past it."""
    b = port_tdigest.BLOCK
    w = np.zeros(3 * b, np.float32)
    w[0], w[1], w[b:2 * b] = 2.0 ** 60, 2.0 ** 36, 1.0
    got = port_tdigest.blocked_running_sum(torch.from_numpy(w)[None])[0].numpy()
    np.testing.assert_array_equal(got, _blocked_sum(w))
    assert _sequential_sum(w)[-1] == np.float32(2.0 ** 60) and got[-1] == np.float32(2.0 ** 60 + 2.0 ** 37)


def test_block_constant_matches_the_kernel_source():
    text = port_tdigest.SOURCE.read_text()
    found = re.search(r"constexpr int kBlock = (\d+);", text)
    assert found and int(found.group(1)) == port_tdigest.BLOCK


@pytest.mark.parametrize("s,m,sms,want", [(1, 65_664, 132, 16), (1, 1_024, 132, 1), (8, 65_664, 132, 16),
                                           (16, 65_664, 132, 8), (17, 65_664, 132, 4), (40, 65_664, 132, 2),
                                           (256, 4_224, 132, 1), (256, 65_664, 132, 1), (1, 8_192, 4, 4)])
def test_cluster_size_spreads_few_large_digests(s, m, sms, want):
    assert port_tdigest.cluster_size(s, m, sms) == want


@pytest.mark.parametrize("seed,s,m,compression,weights", [c for c in CASES if c[4] in ("unit", "integer")])
def test_compress_matches_jax_weights_bitwise_means_within_1e6(seed, s, m, compression, weights):
    """The JAX function sorts its own input; the port sorts with two stable sorts."""
    cent = _digests(seed, s, m, compression, weights)
    rng = np.random.RandomState(seed + 100)
    for r in range(s):
        shuffled = cent[r].numpy()[rng.permutation(m)]
        want = np.asarray(JT.tdigest_compress(jnp.asarray(shuffled), compression))
        got = tdigest_compress(torch.from_numpy(shuffled), compression).numpy()
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        finite = np.isfinite(want[:, 0])
        np.testing.assert_array_equal(np.isfinite(got[:, 0]), finite)
        np.testing.assert_allclose(got[finite, 0], want[finite, 0], rtol=MEAN_RTOL, atol=0)


def test_empty_and_all_zero_weight_digests():
    """Total 0: every slot empty ([+inf, 0]), as the JAX package gives it."""
    cent = torch.tensor([[[math.inf, 0.0]] * 20], dtype=torch.float32)
    got = tdigest_compress_sorted_plain(cent, 8)
    want = np.asarray(JT.tdigest_compress(jnp.asarray(cent[0].numpy()), 8))
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert torch.all(torch.isinf(got[0, :, 0])) and torch.all(got[0, :, 1] == 0)


def test_ties_in_mean_sort_by_weight_then_keep_order():
    rows = torch.tensor([[2.0, 3.0], [1.0, 2.0], [2.0, 1.0], [1.0, 2.0], [math.inf, 0.0]])
    got = _sort_centroids(rows)
    want = rows.numpy()[np.lexsort((rows[:, 1].numpy(), rows[:, 0].numpy()))]
    np.testing.assert_array_equal(got.numpy(), want)


def test_vmap_folds_the_vmapped_axis_into_the_digests_bitwise():
    cent = _digests(11, 6, 400, 16, "integer")
    batched = tdigest_compress_sorted(cent, 16)
    one_by_one = torch.func.vmap(lambda c: tdigest_compress_sorted(c[None], 16)[0])(cent)
    assert torch.equal(one_by_one, batched)
    nested = torch.func.vmap(torch.func.vmap(lambda c: tdigest_compress_sorted(c[None], 16)[0]))(cent.view(2, 3, 400, 2))
    assert torch.equal(nested.reshape(6, 16, 2), batched)
    # the sorting front end vmaps too
    unsorted = cent[:, torch.randperm(400, generator=torch.Generator().manual_seed(0))]
    assert torch.equal(torch.func.vmap(lambda c: tdigest_compress(c, 16))(unsorted), batched)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    cent = _digests(12, 2, 200, 16, "unit")
    before = tdigest_compress_sorted.launches
    assert torch.equal(tdigest_compress_sorted(cent, 16), tdigest_compress_sorted_plain(cent, 16))
    assert tdigest_compress_sorted.launches == before


def test_cuda_tensors_go_to_the_launch_never_to_the_plain_version(monkeypatch):
    calls = []

    def fake_launch(centroids, compression):
        calls.append((tuple(centroids.shape), compression))
        return torch.zeros(centroids.shape[0], compression, 2)

    monkeypatch.setattr(port_tdigest, "_launch", fake_launch)
    monkeypatch.setattr(port_tdigest, "tdigest_compress_sorted_plain", lambda *a: pytest.fail("plain version used"))

    class FakeCuda:
        type = "cuda"

    fake = FakeCuda()
    cent = torch.zeros(3, 40, 2)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: fake))
    assert port_tdigest.tdigest_compress_sorted(cent, 8).shape == (3, 8, 2)
    assert calls == [((3, 40, 2), 8)]


@pytest.mark.parametrize("shape,compression", [((40, 2), 8), ((2, 40, 3), 8), ((2, 40, 2), 4), ((2, 0, 2), 8)])
def test_bad_shapes_and_compressions_raise(shape, compression):
    with pytest.raises(ValueError):
        tdigest_compress_sorted(torch.zeros(shape), compression)


def test_other_devices_raise():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tdigest_compress_sorted(torch.zeros(1, 20, 2, device="meta"), 8)


def test_graph_launch_records_count_both_kernels():
    """A CUDA graph's capture records the t-digest launches as it does the
    bincount's, and a replay adds them back."""
    start_t, start_b = tdigest_compress_sorted.launches, port_bincount.weighted_bincount.launches
    with port_bincount.recording_launches() as record:
        tdigest_compress_sorted.launches += 2
        port_bincount.weighted_bincount.launches += 1
    assert record.count == 1 and record.counts[tdigest_compress_sorted] == 2
    assert tdigest_compress_sorted.launches == start_t and port_bincount.weighted_bincount.launches == start_b
    port_bincount.count_replayed_launches(record)
    assert tdigest_compress_sorted.launches == start_t + 2 and port_bincount.weighted_bincount.launches == start_b + 1
    tdigest_compress_sorted.launches, port_bincount.weighted_bincount.launches = start_t, start_b


def test_build_without_nvcc_raises_naming_the_source(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(port_bincount.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found: the CUDA kernel in .*tdigest.cu"):
        port_bincount._nvcc(port_tdigest.SOURCE)


def test_k_scale_factor_is_the_float32_of_the_jax_constant():
    for c in (16, 64, 128):
        want = float(np.float32(JT.tdigest_delta(c) / (2.0 * math.pi)))
        assert port_tdigest.k_scale_factor(c) == want
