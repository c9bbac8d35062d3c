"""The inputs of a cell, made on the device from the seed.

One generator reads the configuration (``task`` and its data parameters) and
the mix (``preds``: ``scores``, ``logits`` or ``labels``). Every seed gives the
same sizes; only the values change. An epoch is ``images`` samples in batches
of ``batch``, the last one holding the rest, as an evaluation loader that
keeps its last batch gives them. The pool holds ``pool`` batches, batch ``i``
of the size of an epoch's batch ``i % updates``; epoch ``e`` feeds batches
``(e * updates + k) % pool`` for ``k`` in ``range(updates)``.
"""
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

Tensor = torch.Tensor


@dataclass
class Pool:
    preds: List[Tensor]
    target: List[Tensor]

    def __len__(self) -> int:
        return len(self.preds)

    def nbytes(self, i: int) -> int:
        return self.preds[i].nbytes + self.target[i].nbytes

    def samples(self, batches: Tuple[int, ...]) -> int:
        """The samples (images) of the given batches."""
        return sum(self.target[i].shape[0] for i in batches)


def batch_sizes(config: dict) -> List[int]:
    """The sizes of one epoch's batches, in order."""
    images, batch = config["images"], config["batch"]
    return [batch] * (images // batch) + ([images % batch] if images % batch else [])


def pool_sizes(config: dict, pool: int) -> List[int]:
    sizes = batch_sizes(config)
    if pool % len(sizes) and len(set(sizes)) > 1:
        raise ValueError(f"a pool of {pool} batches does not keep the epoch's {len(sizes)} batch sizes in place")
    return [sizes[i % len(sizes)] for i in range(pool)]


def epoch_batches(epoch: int, updates: int, pool: int) -> Tuple[int, ...]:
    return tuple((epoch * updates + k) % pool for k in range(updates))


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def make_pool(config: dict, traffic: dict, pool: int, seed: int, device: torch.device) -> Pool:
    g = generator(seed, device)
    sizes = pool_sizes(config, pool)
    if config["task"] == "classification":
        return _classification(config, traffic, sizes, g, device)
    if config["task"] == "segmentation":
        return _segmentation(config, traffic, sizes, g, device)
    raise ValueError(f"no generator for task {config['task']!r}")


def _classification(config: dict, traffic: dict, sizes: List[int], g: torch.Generator, device) -> Pool:
    """Softmax scores (batch, classes) of each image against its label: the
    true class's logit raised by ``u * true_logit_raise``, u uniform in [0, 1).
    The batches are row ranges of one tensor of every sample."""
    if traffic["preds"] != "scores":
        raise ValueError(f"classification has scores, not {traffic['preds']!r}")
    n, c = sum(sizes), config["num_classes"]
    target = torch.randint(0, c, (n,), generator=g, device=device)
    scores = torch.randn((n, c), generator=g, device=device)
    raise_ = config["true_logit_raise"] * torch.rand((n, 1), generator=g, device=device)
    scores.scatter_add_(1, target.unsqueeze(1), raise_)
    for rows in scores.split(max(sizes)):  # in place, a batch at a time: no second copy of the pool
        rows.copy_(torch.softmax(rows, dim=-1))
    return Pool(list(scores.split(sizes)), list(target.split(sizes)))


def class_shares(config: dict) -> Tensor:
    """Each class's share of the labelled pixels, float64, summing to 1."""
    shares = torch.tensor(config["class_pixel_shares"], dtype=torch.float64)
    return shares / shares.sum()


def error_rates(config: dict) -> Tensor:
    """The chance that an error cell of class k is predicted wrong:
    ``error_rate * (share_k / largest share) ** -error_exponent``, at most 1.
    Rare classes are missed more often, as a segmenter's per-class IoU shows."""
    shares = class_shares(config)
    return torch.clamp(config["error_rate"] * (shares / shares.max()) ** (-config["error_exponent"]), max=1.0)


def expected_scores(config: dict) -> Dict[str, float]:
    """The pixel accuracy and mIoU that :func:`_segmentation`'s predictions
    have in expectation over the labelled pixels: a wrong cell draws its class
    from the shares, so class k keeps s_k (1 - e_k + e_k s_k) of its pixels and
    takes s_k (sum_i s_i e_i - s_k e_k) from the others."""
    s, e = class_shares(config), error_rates(config)
    tp = s * (1 - e + e * s)
    fn = s * e * (1 - s)
    fp = s * ((s * e).sum() - s * e)
    return {"pixel_accuracy": float(tp.sum()), "miou": float((tp / (tp + fn + fp)).mean())}


def _draw(cdf: Tensor, shape: Tuple[int, ...], g: torch.Generator) -> Tensor:
    u = torch.rand(shape, generator=g, device=cdf.device)
    return torch.clamp(torch.searchsorted(cdf, u), max=cdf.numel() - 1)


def _segmentation(config: dict, traffic: dict, sizes: List[int], g: torch.Generator, device) -> Pool:
    """Per image, a label map of square regions of ``region_px`` pixels, each
    of one class drawn from ``class_pixel_shares`` or, with chance
    ``ignore_share``, set to ``ignore_index``; the predicted label map, in
    cells of ``error_cell_px`` pixels, each kept or, with its class's
    :func:`error_rates`, set to a class drawn from the shares (every cell of
    an ignored region is drawn). The mix gets the predicted map (int64) or
    float32 logits (batch, classes, H, W): randn with ``logit_margin`` added
    at the predicted class, so their argmax is the predicted map."""
    if traffic["preds"] not in ("logits", "labels"):
        raise ValueError(f"segmentation has logits or labels, not {traffic['preds']!r}")
    c, h, w = config["num_classes"], config["height"], config["width"]
    r, q = config["region_px"], config["error_cell_px"]
    if h % r or w % r or r % q:
        raise ValueError(f"{h}x{w} images need regions that tile them ({r}) and error cells that tile a region ({q})")
    shares = class_shares(config)
    ignore = config["ignore_share"]
    region_cdf = torch.cumsum(torch.cat([shares * (1 - ignore), torch.tensor([ignore], dtype=torch.float64)]), 0)
    region_cdf = region_cdf.to(torch.float32).to(device)
    class_cdf = torch.cumsum(shares, 0).to(torch.float32).to(device)
    wrong_rate = torch.cat([error_rates(config), torch.ones(1, dtype=torch.float64)]).to(torch.float32).to(device)
    preds, targets = [], []
    for n in sizes:
        region = _draw(region_cdf, (n, h // r, w // r), g)  # class c stands for an ignored region
        cell = region.repeat_interleave(r // q, 1).repeat_interleave(r // q, 2)
        wrong = torch.rand(cell.shape, generator=g, device=device) < wrong_rate[cell]
        cell = torch.where(wrong, _draw(class_cdf, cell.shape, g), cell)
        pred = cell.repeat_interleave(q, 1).repeat_interleave(q, 2)
        target = region.repeat_interleave(r, 1).repeat_interleave(r, 2)
        targets.append(torch.where(target == c, config["ignore_index"], target))
        if traffic["preds"] == "logits":
            logits = torch.randn((n, c, h, w), generator=g, device=device)
            logits.scatter_add_(1, pred.unsqueeze(1), torch.full((n, 1, h, w), config["logit_margin"], device=device))
            preds.append(logits)
        else:
            preds.append(pred)
        del region, cell, wrong, pred, target
    return Pool(preds, targets)
