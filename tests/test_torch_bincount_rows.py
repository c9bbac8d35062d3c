"""The bincount kernel's plan for a shared index with many weight rows, on the CPU.

A cluster stages every input stream, the index and each weight row, in
shared memory, so a shared index with more weight rows than that holds has
no cluster plan: ``launch_plan`` raises ``NoLaunchPlan`` (it used to search
for a number of tiles forever), and ``weighted_bincount_batched`` launches
the rows in groups that ``shared_rows_per_launch`` sizes. The launches run
on the card; here the op's CUDA branch runs with ``_launch`` standing in as
the plain version, so the grouping and the concatenation are held bitwise
against one plain call.
"""
import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.ops import bincount

H100_SMS = 132


@pytest.mark.parametrize("rows", [2048, 512, 120])
def test_a_shared_index_of_too_many_weight_rows_has_no_plan(rows):
    with pytest.raises(bincount.NoLaunchPlan, match="cannot stage"):
        bincount.launch_plan(50_000, 1, rows, 1000, True, H100_SMS)


@pytest.mark.parametrize("bins", [15, 1000, 20_000, 65_000])
@pytest.mark.parametrize("rows", [1, 2, 6, 57, 58, 100, 300, 2048])
def test_every_shared_row_count_plans_or_refuses(rows, bins):
    group = bincount.shared_rows_per_launch(50_000, rows, bins)
    assert 1 <= group <= rows
    bincount.launch_plan(50_000, 1, group, bins, True, H100_SMS)  # the group has a plan
    if group < rows:
        with pytest.raises(bincount.NoLaunchPlan):
            bincount.launch_plan(50_000, 1, rows, bins, True, H100_SMS)


def test_cluster_sums_of_imagenet_embeddings_take_groups_of_57_rows():
    # 2,048 float32 feature rows over 50,000 labels of 1,000 clusters: 57 rows of
    # 1,000 counters fill one CTA's shared memory
    assert bincount.shared_rows_per_launch(50_000, 2048, 1000) == 57
    plan = bincount.launch_plan(50_000, 1, 57, 1000, True, H100_SMS)
    assert plan.cluster == 1 and plan.tiles == 1 and not plan.sparse
    # past the sparse plan's cut-over every row fits: nothing is staged
    assert bincount.shared_rows_per_launch(1000, 2048, 100_000) == 2048


def test_grouped_launches_equal_one_plain_call(monkeypatch):
    launches = []

    def fake_launch(idx, weights, num_bins, out_rows):
        assert weights.shape[0] == out_rows
        launches.append(out_rows)
        return bincount.weighted_bincount_batched_plain(idx, weights, num_bins)

    monkeypatch.setattr(bincount, "_on_kernel_device", lambda idx: True)
    monkeypatch.setattr(bincount, "_launch", fake_launch)
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(rng.randint(-5, 1005, 3000).astype(np.int32))
    weights = torch.from_numpy(rng.randn(130, 3000).astype(np.float32))
    got = bincount._bincount_batched_op(idx, weights, 1000)
    assert launches == [57, 57, 16]
    assert torch.equal(got, bincount.weighted_bincount_batched_plain(idx, weights, 1000))
    launches.clear()
    bincount._bincount_batched_op(idx, weights[:57], 1000)
    assert launches == [57]
