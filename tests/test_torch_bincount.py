"""Port's weighted_bincount and weighted_bincount_batched (plain PyTorch
versions on the CPU) against the JAX package's ``weighted_bincount`` and
``jax.vmap`` of it, through its scatter path and its Pallas kernel in
interpret mode, and against numpy.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there. Here the plain versions, the wrappers'
dispatch and the host-side launch plan are checked.
"""
import ctypes
import re

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchmetrics_tpu.ops import weighted_bincount as jax_weighted_bincount
from torchmetrics_tpu_torch.ops import bincount as port_bincount
from torchmetrics_tpu_torch.ops import (
    weighted_bincount,
    weighted_bincount_batched,
    weighted_bincount_batched_plain,
    weighted_bincount_plain,
)


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

    def fake_launch(idx, w, bins, rows):
        calls.append((tuple(idx.shape), None if w is None else tuple(w.shape), bins, rows))
        return torch.zeros(rows, bins)

    monkeypatch.setattr(port_bincount, "_launch", fake_launch)
    monkeypatch.setattr(port_bincount, "weighted_bincount_plain", lambda *a: pytest.fail("plain version used"))
    monkeypatch.setattr(port_bincount, "weighted_bincount_batched_plain",
                        lambda *a: pytest.fail("plain version used"))

    class FakeCuda:
        type = "cuda"

    idx = torch.zeros(3, dtype=torch.int32)
    w = torch.ones(2, 3)
    fake_device = FakeCuda()
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: fake_device))
    assert port_bincount.weighted_bincount(idx, None, 5).shape == (5,)
    assert port_bincount.weighted_bincount_batched(idx, w, 4).shape == (2, 4)
    assert calls == [((3,), None, 5, 1), ((3,), (2, 3), 4, 2)]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(port_bincount.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        port_bincount._nvcc()


def _check_plan_invariants(plan, n, rows, out_rows, bins, weighted, sms):
    """What every plan keeps: its shared memory within one CTA's, all bins
    covered, the partial histograms added into the output (smem plans of
    several CTAs) no more bytes than the inputs, and a grid that follows the
    SM count."""
    assert port_bincount.smem_bytes(plan, out_rows) <= port_bincount.SMEM_BYTES
    assert plan.tiles * plan.tile_bins >= bins and (plan.tiles == 1) == (plan.tile_bins == bins)
    if plan.kind == "smem":
        in_bytes = 4 * rows * n + (4 * out_rows * n if weighted else 0)
        assert plan.ctas == 1 or plan.ctas * out_rows * bins * 4 <= in_bytes
        assert plan.ctas <= max(1, sms) and plan.chunks == 1
    elif plan.kind == "global":
        assert plan.ctas <= sms * port_bincount.GLOBAL_CTAS_PER_SM and plan.tiles == 1 and plan.chunks == 1
    else:
        assert weighted and rows == 1 and out_rows >= port_bincount.ROWS_PLAN_MIN_ROWS
        assert plan.ctas == -(-out_rows // port_bincount.rows_tile_cols(out_rows)) * plan.tiles * plan.chunks
        assert plan.tiles <= port_bincount.MAX_GRID_YZ and plan.chunks <= port_bincount.MAX_GRID_YZ


@pytest.mark.parametrize(
    "n,rows,out_rows,bins,weighted,expect",
    [
        # stat scores, one batched call: one CTA writes the output directly
        (1024, 3, 3, 100, True, ("smem", 1, 1, 100)),
        (1000, 3, 3, 1000, True, ("smem", 1, 1, 1000)),
        # binned curve at C=100, shared idx: 13,000 counters fit one CTA; 23
        # CTAs count disjoint inputs, capped by the merge bound
        (102_400, 1, 2, 6_500, True, ("smem", 23, 1, 6_500)),
        # binned curve at C=1000: 130,000 counters do not fit one CTA, so
        # every input is added into the zeroed output; 489 CTAs of 2,048 reads
        (1_000_000, 1, 2, 65_000, True, ("global", 489, 1, 65_000)),
        # the 1-D entry at that shape
        (1_000_000, 1, 1, 65_000, True, ("global", 489, 1, 65_000)),
        # 2,000,000 reads: the grid's cap, four CTAs an SM
        (1_000_000, 2, 2, 65_000, False, ("global", 528, 1, 65_000)),
        # more weight rows than the kernel specialises, counters past one CTA:
        # one input a thread, one CTA an SM
        (300_000, 1, 6, 20_000, True, ("global", 132, 1, 20_000, 1, False)),
        # 1,000,000 bins: one tile, no input read twice
        (1_000_000, 1, 1, 1_000_000, True, ("global", 489, 1, 1_000_000)),
        # many inputs, few bins: one CTA per SM
        (10**8, 1, 1, 1000, True, ("smem", 132, 1, 1000)),
        # binary pixel curve (32 masks of 256 x 256), shared idx: 130 counters
        # in each of 132 CTAs
        (2_097_152, 1, 2, 65, True, ("smem", 132, 1, 65)),
        # COCO multilabel curve (80 labels, batch 1,024): 20 CTAs
        (81_920, 1, 2, 5_200, True, ("smem", 20, 1, 5_200)),
        # Cityscapes confusion matrix (one 1024 x 2048 image, 19^2 cells),
        # int32: 132 CTAs that each hold the 361 counters
        (2_097_152, 1, 1, 361, False, ("smem", 132, 1, 361)),
        # Cityscapes stat scores (Dice, pixel accuracy): 3 rows of 2,097,152
        (2_097_152, 3, 3, 19, True, ("smem", 132, 1, 19)),
        # ImageNet-1k calibration (50,000 samples, 15 bins), three weight rows
        # over one shared index: 13 CTAs
        (50_000, 1, 3, 15, True, ("smem", 13, 1, 15)),
    ],
)
def test_launch_plan(n, rows, out_rows, bins, weighted, expect):
    """The plans of PERF.md's kernel table: the shared-memory plan where the
    counters fit one CTA, else global reductions."""
    plan = port_bincount.launch_plan(n, rows, out_rows, bins, weighted, 132)
    assert plan == port_bincount.LaunchPlan(*expect)
    _check_plan_invariants(plan, n, rows, out_rows, bins, weighted, 132)


@pytest.mark.parametrize(
    "n,rows,out_rows,bins,weighted,ctas",
    [
        # ImageNet-1k confusion matrix: 1,000 samples into 1,000,000 cells, int32
        (1000, 1, 1, 1_000_000, False, 2),
        # as many inputs as half the bins
        (500_000, 1, 1, 1_000_000, False, 245),
        # weighted, shared idx: two weight rows over 200,000 bins each
        (10_000, 1, 2, 200_000, True, 20),
        # per-row idx, int32: the count-min update's shape at a twentieth
        (5_000, 3, 3, 100_000, False, 30),
    ],
)
def test_launch_plan_global(n, rows, out_rows, bins, weighted, ctas):
    """Counters that do not fit one CTA, at any number of inputs: each input
    goes straight into the zeroed output, one tile of all bins. Calls below
    131,072 index reads take one input a thread, 512 a CTA, up to one CTA an
    SM; larger ones 16-byte vectors, 2,048 reads a CTA."""
    plan = port_bincount.launch_plan(n, rows, out_rows, bins, weighted, 132)
    assert plan == port_bincount.LaunchPlan("global", ctas, 1, bins,
                                            vectors=rows * n >= port_bincount.GLOBAL_VECTOR_INPUTS and
                                            (not weighted or out_rows // rows <= 2))
    _check_plan_invariants(plan, n, rows, out_rows, bins, weighted, 132)


@pytest.mark.parametrize(
    "n,rows,out_rows,bins,weighted,kind",
    [
        # one input past half the bins: still global (no cut-over by inputs)
        (500_001, 1, 1, 1_000_000, False, "global"),
        # few inputs, but the counters fit one CTA: the single-CTA plan
        (10, 1, 1, 40_000, False, "smem"),
        (10, 1, 2, 20_000, True, "smem"),
    ],
)
def test_launch_plan_kind_follows_the_counters(n, rows, out_rows, bins, weighted, kind):
    plan = port_bincount.launch_plan(n, rows, out_rows, bins, weighted, 132)
    assert plan.kind == kind
    _check_plan_invariants(plan, n, rows, out_rows, bins, weighted, 132)


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
def test_launch_plan_scales_with_sm_count(sms):
    """The grid follows the card, not N: at most GLOBAL_CTAS_PER_SM CTAs an
    SM for global reductions, one for the shared-memory plan, and the rows
    plan's chunks no more than fill the SMs."""
    for shape in ((1_000_000, 1, 2, 65_000, True), (102_400, 1, 2, 6_500, True), (50_000, 1, 2048, 1000, True)):
        plan = port_bincount.launch_plan(*shape, sms)
        _check_plan_invariants(plan, *shape, sms)
        if plan.kind == "rows":
            # two column tiles of 1,024 rows times the bin tiles and chunks: one wave where it can
            assert plan.ctas <= max(sms, 2 * plan.tiles) and (plan.chunks == 1 or plan.ctas <= sms)


def test_plan_struct_mirrors_the_kernel_source():
    """The ctypes structure and ``struct Plan`` in csrc/bincount.cu agree
    field by field, in order (the layout is the C ABI's on both sides)."""
    src = port_bincount.SOURCE.read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(int|unsigned long long) (\w+);", body, re.M)
    sizes = {"int": 4, "unsigned long long": 8}
    ours = [(ctypes.sizeof(t), name) for name, t in port_bincount._PlanStruct._fields_]
    assert [(sizes[t], name) for t, name in fields] == ours


def _jax_vmap(idx, w, bins, shared, **kw):
    """``jax.vmap`` of the JAX package's weighted_bincount over the rows."""
    if w is None:
        return np.asarray(jax.vmap(lambda i: jax_weighted_bincount(i, None, bins, **kw))(jnp.asarray(idx)))
    fn = jax.vmap(lambda i, ww: jax_weighted_bincount(i, ww, bins, **kw), in_axes=(None if shared else 0, 0))
    return np.asarray(fn(jnp.asarray(idx), jnp.asarray(w)))


def _batched_inputs(seed, s, n, bins, shared, zero_one):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-3, bins + 3, n if shared else (s, n)).astype(np.int32)  # a few out of range
    w = ((rng.rand(s, n) < 0.7) if zero_one else rng.rand(s, n)).astype(np.float32)
    return idx, w


@pytest.mark.parametrize("shared", [True, False], ids=["shared_idx", "per_row_idx"])
@pytest.mark.parametrize("s,n,bins", [(1, 500, 7), (2, 5000, 100), (3, 4096, 1500), (5, 20_000, 6_500)])
def test_batched_matches_jax_vmap(shared, s, n, bins):
    idx, w = _batched_inputs(n + s, s, n, bins, shared, zero_one=False)
    ours = weighted_bincount_batched(torch.from_numpy(idx), torch.from_numpy(w), bins)
    assert ours.dtype == torch.float32 and ours.shape == (s, bins)
    # float32 sums in another order than XLA's scatter: agree to float32
    # rounding of sums of ~n/bins terms
    np.testing.assert_allclose(ours.numpy(), _jax_vmap(idx, w, bins, shared), rtol=1e-5, atol=1e-4)
    # 0/1 weights (the metric path's masks) are exact in any order
    idx, w = _batched_inputs(n + s + 1, s, n, bins, shared, zero_one=True)
    ours = weighted_bincount_batched(torch.from_numpy(idx), torch.from_numpy(w), bins).numpy()
    np.testing.assert_array_equal(ours, _jax_vmap(idx, w, bins, shared))


@pytest.mark.parametrize("shared", [True, False], ids=["shared_idx", "per_row_idx"])
@pytest.mark.parametrize("zero_one", [True, False], ids=["zero_one", "random_f32"])
def test_batched_matches_jax_pallas_vmap(shared, zero_one):
    """Against vmap over the Pallas kernel (its sequential batching rule) in
    interpret mode, at small sizes."""
    s, n, bins = 3, 3000, 300
    idx, w = _batched_inputs(17, s, n, bins, shared, zero_one)
    ours = weighted_bincount_batched(torch.from_numpy(idx), torch.from_numpy(w), bins).numpy()
    ref = _jax_vmap(idx, w, bins, shared, force_pallas=True, interpret=True)
    if zero_one:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("force_pallas", [False, True], ids=["scatter", "pallas"])
def test_batched_unweighted_counts_int32(force_pallas):
    rng = np.random.RandomState(23)
    idx = rng.randint(-50, 350, (4, 2000)).astype(np.int32)
    ours = weighted_bincount_batched(torch.from_numpy(idx), None, 300)
    assert ours.dtype == torch.int32 and ours.shape == (4, 300)
    kw = dict(force_pallas=True, interpret=True) if force_pallas else {}
    ref = _jax_vmap(idx, None, 300, shared=False, **kw)
    assert ref.dtype == np.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    for r in range(4):
        keep = idx[r][(idx[r] >= 0) & (idx[r] < 300)]
        np.testing.assert_array_equal(ours[r].numpy(), np.bincount(keep, minlength=300))


def test_batched_masks_out_of_range_per_row():
    """An out-of-range index of one row never lands in a neighbouring row."""
    idx = torch.tensor([[-1, 0, 4, 5, 9], [5, -5, 3, 2**31 - 1, 4]])
    w = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0], [6.0, 7.0, 8.0, 9.0, 10.0]])
    ours = weighted_bincount_batched(idx, w, 5)
    assert ours.tolist() == [[2.0, 0.0, 0.0, 0.0, 3.0], [0.0, 0.0, 0.0, 8.0, 10.0]]
    shared = weighted_bincount_batched(idx[0], w, 5)
    assert shared.tolist() == [[2.0, 0.0, 0.0, 0.0, 3.0], [7.0, 0.0, 0.0, 0.0, 8.0]]


def test_batched_empty_and_single_row():
    out = weighted_bincount_batched(torch.zeros(0, dtype=torch.int32), torch.zeros(3, 0), 4)
    assert out.dtype == torch.float32 and torch.equal(out, torch.zeros(3, 4))
    out = weighted_bincount_batched(torch.zeros(2, 0, dtype=torch.int64), None, 3)
    assert out.dtype == torch.int32 and torch.equal(out, torch.zeros(2, 3, dtype=torch.int32))
    rng = np.random.RandomState(29)
    idx = torch.from_numpy(rng.randint(0, 50, 777))
    w = torch.from_numpy(rng.rand(777).astype(np.float32))
    one = weighted_bincount_batched(idx, w[None], 50)
    assert one.shape == (1, 50)
    assert torch.equal(one[0], weighted_bincount(idx, w, 50))
    assert torch.equal(weighted_bincount_batched(idx[None], None, 50)[0], weighted_bincount(idx, None, 50))


def test_batched_invalid_arguments_raise():
    with pytest.raises(ValueError, match="num_bins"):
        weighted_bincount_batched(torch.zeros(2, 3, dtype=torch.int32), None, 0)
    with pytest.raises(ValueError, match=r"\(S, N\) indices"):
        weighted_bincount_batched(torch.zeros(3, dtype=torch.int32), None, 4)
    with pytest.raises(ValueError, match=r"\(S, N\)"):
        weighted_bincount_batched(torch.zeros(3, dtype=torch.int32), torch.ones(3), 4)
    with pytest.raises(ValueError, match="indices of shape"):
        weighted_bincount_batched(torch.zeros(4, dtype=torch.int32), torch.ones(2, 3), 4)
    with pytest.raises(ValueError, match="indices of shape"):
        weighted_bincount_batched(torch.zeros(3, 3, dtype=torch.int32), torch.ones(2, 3), 4)
    with pytest.raises(TypeError, match="integer"):
        weighted_bincount_batched(torch.zeros(2, 3), None, 4)


def test_batched_plain_is_per_row_plain():
    rng = np.random.RandomState(31)
    idx = torch.from_numpy(rng.randint(-2, 90, (3, 1000)).astype(np.int32))
    w = torch.from_numpy(rng.rand(3, 1000).astype(np.float32))
    out = weighted_bincount_batched_plain(idx, w, 88)
    for r in range(3):
        assert torch.equal(out[r], weighted_bincount_plain(idx[r], w[r], 88))


@pytest.mark.parametrize(
    "case",
    ["confmat_cityscapes", "confmat_imagenet1k", "calibration_imagenet1k"],
)
def test_slice_shapes_scaled_down_match_jax_vmap(case):
    """The confusion-matrix and calibration calls of this slice, at a
    tenth or less of their size: int32 counts over C^2 cells with dropped
    (masked) indices, a call with far fewer inputs than bins (the global
    plan's shape), and three float32 weight rows over 15 bins."""
    rng = np.random.RandomState(43)
    if case == "confmat_cityscapes":
        idx = rng.randint(-1, 361, (1, 20_000)).astype(np.int32)  # -1: an ignored pixel
        ours = weighted_bincount_batched(torch.from_numpy(idx), None, 361)
        np.testing.assert_array_equal(ours.numpy(), _jax_vmap(idx, None, 361, shared=False))
    elif case == "confmat_imagenet1k":
        idx = rng.randint(0, 10_000, (1, 100)).astype(np.int32)
        ours = weighted_bincount_batched(torch.from_numpy(idx), None, 10_000)
        np.testing.assert_array_equal(ours.numpy(), _jax_vmap(idx, None, 10_000, shared=False))
    else:
        conf = rng.rand(5000).astype(np.float32)
        idx = np.clip((conf * 15).astype(np.int32), 0, 14)
        w = np.stack([np.ones_like(conf), conf, (rng.rand(5000) < 0.7).astype(np.float32)])
        ours = weighted_bincount_batched(torch.from_numpy(idx), torch.from_numpy(w), 15).numpy()
        ref = _jax_vmap(idx, w, 15, shared=True)
        # counts and 0/1 accuracy sums are exact; confidence sums agree to
        # float32 rounding of ~330 terms a bin
        np.testing.assert_array_equal(ours[[0, 2]], ref[[0, 2]])
        np.testing.assert_allclose(ours[1], ref[1], rtol=1e-5)


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
