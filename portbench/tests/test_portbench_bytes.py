"""The byte counts of the per-layer rooflines against counts by hand, at each
cell's full size, and the generator's shapes against them."""
import importlib.util

import pytest
import torch
from conftest import CELLS, ROOT, tiny_cell

from portbench import spec
from portbench.generate import batch_sizes, epoch_batches, make_pool

P = 1024 * 2048  # pixels of a Cityscapes image
IMAGENET = [256] * 195 + [80]  # timm's batches of the 50,000 images


def _mean(count) -> float:
    return sum(count(n) for n in IMAGENET) / len(IMAGENET)


HAND = {
    # histograms: stat scores (target index, predicted index, hit weight: 12 bytes a sample; 3 counters a
    # class) and the curve (bin index and positive weight: 8 bytes a score; positive and all counters of
    # 1000 classes x 65 bins), over an update of n images, averaged over the epoch's updates
    "imagenet1k_val.binned": {"histograms": _mean(lambda n: 12 * n + 12 * 1000 + 8 * n * 1000 + 8 * 1000 * 65),
                              "inputs": 4 * 256 * 1000 + 8 * 256,
                              "states": 2 * (8 * 4 * 1000 + 8 * 64 * 1000 * 4), "appends": 0},
    # confusion (joint index: 4 bytes a pixel; 19 x 19 counters) and stat scores (12 bytes a pixel)
    "cityscapes_val.logits": {"histograms": 4 * P + 4 * 361 + 12 * P + 12 * 19,
                              "inputs": 4 * 19 * P + 8 * P, "states": 2 * (8 * 361 + 8 * 4 * 19), "appends": 0},
    "imagenet1k_val.exact": {"histograms": 0, "inputs": 4 * 256 * 1000 + 8 * 256, "states": 2 * 8,
                             "appends": _mean(lambda n: 4 * n * 1000 + 8 * n)},
    "cityscapes_val.labels": {"histograms": 4 * P + 4 * 361 + 12 * P + 12 * 19,
                              "inputs": 8 * P + 8 * P, "states": 2 * (8 * 361 + 8 * 4 * 19), "appends": 0},
}


def _metric(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec_ = importlib.util.spec_from_file_location(f"test_metric_{name}", path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


def _input_bytes(cell, batch=None) -> int:
    """Bytes of a full batch's inputs (of ``batch`` samples where given)."""
    c = cell.config
    n = c["batch"] if batch is None else batch
    if cell.traffic["preds"] == "scores":
        return 4 * n * c["num_classes"] + 8 * n
    pixels = n * c["height"] * c["width"]
    return (4 * c["num_classes"] if cell.traffic["preds"] == "logits" else 8) * pixels + 8 * pixels


@pytest.mark.parametrize("name", CELLS)
def test_byte_counts_match_the_hand_counts(name):
    cell = spec.find_cell(name)
    hand = HAND[name]
    assert _metric("bincount_roofline_pct").histogram_bytes(cell) == pytest.approx(hand["histograms"], rel=1e-12)
    assert spec.update_work_bytes(cell, "states") == hand["states"]
    assert spec.update_work_bytes(cell, "appends") == pytest.approx(hand["appends"], rel=1e-12)
    assert _input_bytes(cell) == hand["inputs"]
    compulsory = _metric("update_roofline_pct").compulsory_bytes(cell, _input_bytes(cell))
    assert compulsory == hand["inputs"] + hand["states"] + hand["appends"]


@pytest.mark.parametrize("name", CELLS)
def test_the_generator_makes_what_the_counts_assume(name):
    cell = tiny_cell(name)
    pool = make_pool(cell.config, cell.traffic, 4, 3, torch.device("cpu"))
    assert len(pool) == 4
    sizes = batch_sizes(cell.config)
    assert all(pool.nbytes(i) == _input_bytes(cell, sizes[i % len(sizes)]) for i in range(4))
    assert pool.samples(epoch_batches(0, len(sizes), 4)) == cell.config["images"]
    again = make_pool(cell.config, cell.traffic, 4, 3, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(pool.preds + pool.target, again.preds + again.target))
    other = make_pool(cell.config, cell.traffic, 4, 4, torch.device("cpu"))
    assert not torch.equal(pool.preds[0], other.preds[0])


def test_size_expressions():
    assert spec.evaluate("2 * (a + 1) - b // 2", {"a": 3, "b": 5}) == 6
    with pytest.raises(spec.SpecError):
        spec.evaluate("a ** 2", {"a": 3})
    with pytest.raises(spec.SpecError):
        spec.evaluate("__import__('os')", {})


def test_the_segmentation_traffic_is_what_its_sources_give():
    """The label maps hold the published class shares in regions, and the
    predictions score as the cited segmenter does, in expectation and on a
    few images at full size."""
    import json

    from portbench.generate import class_shares, expected_scores
    from portbench.reference import common

    cell = spec.find_cell("cityscapes_val.labels")
    config = cell.config
    expected = expected_scores(config)
    assert expected["miou"] == pytest.approx(config["calibrated_to"]["miou"], abs=1e-3)
    assert expected["pixel_accuracy"] == pytest.approx(config["calibrated_to"]["pixel_accuracy"], abs=1e-3)
    pool = make_pool(config, cell.traffic, 4, 9, torch.device("cpu"))
    args = cell.metric_args({})
    parts = [common.confusion_partial(p, t, args, torch.float64)["confmat"] for p, t in zip(pool.preds, pool.target)]
    cm = sum(parts)
    tp, rows, cols = cm.diagonal(), cm.sum(1), cm.sum(0)
    assert float(tp.sum() / cm.sum()) == pytest.approx(expected["pixel_accuracy"], abs=0.01)
    share = rows / rows.sum()
    assert float((share[:3] - class_shares(config)[:3]).abs().max()) < 0.05  # road, sidewalk, building
    ignored = sum(int((t == config["ignore_index"]).sum()) for t in pool.target) / (4 * 1024 * 2048)
    assert ignored == pytest.approx(config["ignore_share"], abs=0.03)
    r = config["region_px"]
    target = pool.target[0][0]
    assert torch.equal(target[::r, ::r].repeat_interleave(r, 0).repeat_interleave(r, 1), target)  # whole regions
    assert json.dumps(config["class_names"]).count(",") == config["num_classes"] - 1
