"""The bincount kernel's rows plan, for a shared index with many float32
weight rows, on the CPU.

A shared index of at least ``ROWS_PLAN_MIN_ROWS`` weight rows takes the rows
plan: one launch whatever the number of rows, bin tiles where shared memory
does not hold every bin, sample chunks that fill the SMs, and the weights
read through their strides, so that the per-cluster sums of (N, D) features
take their transpose ``data.T`` without a copy. The launches run on the
card; here the plans, the strides handed to the kernel and the op's CUDA
branch (with ``_launch`` standing in as the plain version) are checked, and
the plain version, fed ``data.T``, is held against ``jax.ops.segment_sum``
and the intrinsic clustering scores against the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.clustering as JF
import torchmetrics_tpu_torch.functional.clustering as PF
from torchmetrics_tpu_torch.ops import bincount

H100_SMS = 132


def _rows_plan_invariants(plan, n, out_rows, bins, sms):
    assert plan.kind == "rows"
    assert bincount.smem_bytes(plan, out_rows) <= bincount.SMEM_BYTES
    assert plan.tiles * plan.tile_bins >= bins > (plan.tiles - 1) * plan.tile_bins
    col_tiles = -(-out_rows // bincount.rows_tile_cols(out_rows))
    assert plan.ctas == col_tiles * plan.tiles * plan.chunks
    assert plan.tiles <= bincount.MAX_GRID_YZ and plan.chunks <= bincount.MAX_GRID_YZ
    # chunks only where column and bin tiles leave SMs idle, never more than fill them
    per_sm = max(1, min(bincount.SM_THREADS // bincount.THREADS,
                        bincount.SM_SMEM_BYTES // bincount.smem_bytes(plan, out_rows)))
    assert plan.chunks == 1 or col_tiles * plan.tiles * plan.chunks <= sms * per_sm
    assert plan.chunks == 1 or -(-n // plan.chunks) >= bincount.ROWS_MIN_CHUNK // 2


@pytest.mark.parametrize("rows,expect", [(2048, ("rows", 132, 33, 31, 2)), (512, ("rows", 132, 22, 46, 6)),
                                         (120, ("rows", 78, 6, 167, 13))])
def test_a_shared_index_of_many_weight_rows_takes_the_rows_plan(rows, expect):
    """Rows the cluster plan could not stage (it refused these shapes): one
    launch of column tiles (up to 1,024 rows), bin tiles as shared memory
    holds them, and chunks of the 50,000 samples that fill the 132 SMs (two
    CTAs an SM at 512 rows)."""
    plan = bincount.launch_plan(50_000, 1, rows, 1000, True, H100_SMS)
    assert plan == bincount.LaunchPlan(*expect)
    _rows_plan_invariants(plan, 50_000, rows, 1000, H100_SMS)


@pytest.mark.parametrize("bins", [15, 1000, 20_000, 65_000])
@pytest.mark.parametrize("rows", [1, 2, 6, 31, 32, 100, 300, 2048])
def test_every_shared_row_count_plans_in_one_launch(rows, bins):
    """Every number of weight rows over one shared index has a plan, which
    is the rows plan from a full column tile of rows on."""
    plan = bincount.launch_plan(50_000, 1, rows, bins, True, H100_SMS)
    assert (plan.kind == "rows") == (rows >= bincount.ROWS_PLAN_MIN_ROWS)
    assert bincount.smem_bytes(plan, rows) <= bincount.SMEM_BYTES
    if plan.kind == "rows":
        _rows_plan_invariants(plan, 50_000, rows, bins, H100_SMS)


def test_cluster_sums_of_imagenet_embeddings_take_one_launch():
    # 2,048 float32 feature rows over 50,000 labels of 1,000 clusters: two
    # column tiles of 1,024 rows, 33 bin tiles of 31 (124 KB of sums each;
    # 21 tiles of 48 would fill shared memory) and two chunks of 25,000
    # samples: 132 CTAs, one an SM
    plan = bincount.launch_plan(50_000, 1, 2048, 1000, True, H100_SMS)
    assert plan == bincount.LaunchPlan("rows", 132, 33, 31, 2)
    assert bincount.smem_bytes(plan, 2048) == (8192 + 16) * 4 + 31 * 1025 * 4


@pytest.mark.parametrize("bins,tiles,chunks", [(48, 2, 13), (49, 4, 13), (1000, 33, 2), (10_000, 264, 1),
                                               (65_000, 1383, 1)])
def test_rows_plan_tiles_the_bins_past_shared_memory(bins, tiles, chunks):
    """Bins past what one CTA's shared memory holds (48 rows of 1,025 floats
    beside the sample list) take bin tiles of equal size, each reading every
    label and only its own samples' weights; up to twice the fewest tiles,
    where the SMs then read fewer bytes over the grid's waves (10,000 bins:
    the fewest, 209 tiles, would leave 110 of 132 SMs idle in the last of
    four waves; 264 fill them)."""
    plan = bincount.launch_plan(50_000, 1, 2048, bins, True, H100_SMS)
    fewest = -(-bins // 48)
    assert plan.tiles == tiles and plan.chunks == chunks and fewest <= tiles <= 2 * fewest
    assert plan.tile_bins == -(-bins // tiles)
    _rows_plan_invariants(plan, 50_000, 2048, bins, H100_SMS)


@pytest.mark.parametrize("sms,n,ctas,chunks", [(132, 50_000, 132, 2), (114, 50_000, 112, 2), (78, 50_000, 78, 1),
                                              (132, 4_000, 84, 1)])
def test_rows_plan_chunks_fill_the_sms(sms, n, ctas, chunks):
    plan = bincount.launch_plan(n, 1, 2048, 1000, True, sms)
    assert plan.ctas == ctas and plan.chunks == chunks
    _rows_plan_invariants(plan, n, 2048, 1000, sms)


def test_the_rows_plan_reads_the_transpose_as_it_lies(monkeypatch):
    """The transpose of a contiguous (N, S) matrix reaches the kernel
    uncopied, and its plan structure carries strides (1, S); contiguous rows
    carry (N, 1). The other plans take contiguous rows, with the structure
    of the shape's single cached plan."""
    monkeypatch.setattr(bincount, "_sm_count", lambda device: H100_SMS)
    bincount._kernel_plan.cache_clear()
    bincount._rows_struct.cache_clear()
    try:
        data = torch.randn(300, 40)
        rows_plan, st, _ = bincount._kernel_plan(0, 300, 1, 40, 9, True)
        assert rows_plan.kind == "rows" and rows_plan == bincount.launch_plan(300, 1, 40, 9, True, H100_SMS)
        w = bincount._kernel_weights(rows_plan, data.T)
        assert w.data_ptr() == data.data_ptr() and w.stride() == (1, 40)
        rows_st, _ = bincount._rows_struct(0, 300, 40, 9, w.stride())
        assert (rows_st.w_row_stride, rows_st.w_col_stride) == (1, 40)
        assert (rows_st.kind, rows_st.tiles, rows_st.chunks) == (bincount.KINDS["rows"], rows_plan.tiles,
                                                                 rows_plan.chunks)
        w = bincount._kernel_weights(rows_plan, data.T.contiguous())
        assert (bincount._rows_struct(0, 300, 40, 9, w.stride())[0].w_row_stride, w.stride()) == (300, (300, 1))
        other, st, _ = bincount._kernel_plan(0, 300, 1, 6, 9, True)
        assert other.kind != "rows" and (st.w_row_stride, st.w_col_stride) == (300, 1)
        w = bincount._kernel_weights(other, data.T[:6])
        assert w.is_contiguous() and torch.equal(w, data.T[:6])
        assert bincount._kernel_weights(other, None) is None
    finally:
        bincount._kernel_plan.cache_clear()
        bincount._rows_struct.cache_clear()


@pytest.mark.parametrize("chunks,kernels", [(1, 1), (2, 2), (5, 2)])
def test_the_rows_plan_of_several_chunks_runs_two_kernels(chunks, kernels):
    """The rows plan of several sample chunks runs its histogram, then the
    merge of the chunks: the wrapper counts both."""
    plan = bincount.LaunchPlan("rows", 132 * chunks, 33, 31, chunks)
    assert plan.kernels == kernels
    assert bincount.LaunchPlan("global", 2, 1, 1_000_000, vectors=False).kernels == 1
    assert bincount.launch_plan(50_000, 1, 2048, 1000, True, H100_SMS).kernels == 2


def _fake_kernel(monkeypatch, launches):
    def fake_launch(idx, weights, num_bins, out_rows):
        assert weights.shape[0] == out_rows
        launches.append((out_rows, tuple(weights.stride())))
        return bincount.weighted_bincount_batched_plain(idx, weights, num_bins)

    monkeypatch.setattr(bincount, "_on_kernel_device", lambda idx: True)
    monkeypatch.setattr(bincount, "_launch", fake_launch)


def test_many_rows_are_one_launch_equal_to_one_plain_call(monkeypatch):
    launches = []
    _fake_kernel(monkeypatch, launches)
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(rng.randint(-5, 1005, 3000).astype(np.int32))
    data = torch.from_numpy(rng.randn(3000, 130).astype(np.float32))
    got = bincount._bincount_batched_op(idx, data.T, 1000)
    assert launches == [(130, (1, 130))]  # the (N, S) data's transpose, as it lies
    assert torch.equal(got, bincount.weighted_bincount_batched_plain(idx, data.T.contiguous(), 1000))
    launches.clear()
    bincount.weighted_bincount_batched(idx, data.T, 1000)
    assert launches == [(130, (1, 130))]


# ------------------------------------------------------ CPU parity of the rows plan's function

def _segment_inputs(seed, n, s, bins):
    rng = np.random.RandomState(seed)
    labels = rng.randint(-3, bins + 3, n).astype(np.int32)  # a few out of range, dropped
    data = (rng.randn(n, s) * rng.choice([1.0, 100.0], s)).astype(np.float32)
    return labels, data


@pytest.mark.parametrize("n,s,bins", [(3000, 130, 1005), (2000, 32, 7), (700, 64, 300), (64, 33, 1000)])
def test_plain_version_of_data_t_matches_segment_sum(n, s, bins):
    """The plain version fed ``data.T`` of a contiguous (N, S) array against
    the JAX package's ``jax.ops.segment_sum`` of the same numpy inputs,
    within 1e-5 relative (float32 sums in another order)."""
    labels, data = _segment_inputs(n + s, n, s, bins)
    got = bincount.weighted_bincount_batched_plain(torch.from_numpy(labels), torch.from_numpy(data).T, bins)
    assert got.shape == (s, bins) and got.dtype == torch.float32
    keep = (labels >= 0) & (labels < bins)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data[keep]), jnp.asarray(labels[keep]), num_segments=bins))
    np.testing.assert_allclose(got.numpy().T, want, rtol=1e-5, atol=1e-5 * float(np.abs(data).max()))
    # and the batched entry takes the same view
    assert torch.equal(bincount.weighted_bincount_batched(torch.from_numpy(labels), torch.from_numpy(data).T, bins),
                       got)


def _embeddings(seed, n, dim, k):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, k, n)
    data = (3.0 * rng.randn(k, dim)[labels] + rng.randn(n, dim)).astype(np.float32)
    return data, (7 * labels - 4).astype(np.int32)


# the widths of tests/test_torch_clustering.py's embeddings: 33 features
# take the rows plan on the card, 5 do not
EMBEDDINGS = {"six_clusters": _embeddings(0, 240, 5, 6), "wide": _embeddings(2, 120, 33, 9)}


@pytest.mark.parametrize("case", sorted(EMBEDDINGS))
@pytest.mark.parametrize("name", ["calinski_harabasz_score", "davies_bouldin_score", "dunn_index"])
def test_intrinsic_scores_of_the_cluster_sums_match_jax(name, case):
    data, labels = EMBEDDINGS[case]
    got = getattr(PF, name)(torch.from_numpy(data), torch.from_numpy(labels))
    want = getattr(JF, name)(jnp.asarray(data), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
