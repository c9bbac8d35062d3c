#!/usr/bin/env python3
"""Time bench config 2's update with tracing and the ledger off, in one or
more checkouts of the port, on one CUDA card.

    python3 untraced_update_timing.py [--trees DIR [DIR ...]] [--passes 5] [--updates 2000]

Each tree (default: this script's own) runs in a process of its own, one
after another in the order given, so that ``--trees old . . old`` holds two
versions of the package against each other within one call on one card.
Each process imports ``torchmetrics_tpu_torch`` from its tree (the kernel
builds there), makes the inputs of ``chip_smoke.py`` phase ``a14`` (a) on
the card (seed 1814: 202 batches of 1,024 rows over C=100), updates the
fused collection (MulticlassAccuracy, MulticlassF1Score,
MulticlassAUROC(thresholds=64)) twice to capture its graph, then times
``--passes`` passes of ``--updates`` updates each, cycling over the other
200 batches: a host clock that ends in a synchronise, as phase ``a14`` (a)
times its untraced twin. Prints the card's name and power limit, one JSON
line per tree, and a summary line with each tree's median and spread.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

NUM_CLASSES = 100
BATCH = 1024
BATCHES = 200  # cycled, after the 2 warm-up batches


def time_tree(tree: str, passes: int, updates: int) -> dict:
    """The child: ms an update over each pass, in ``tree``'s package."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score

    if not os.path.abspath(tm.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {tm.__file__}, not the package of {tree}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1814)
    preds = torch.softmax(torch.randn(2 + BATCHES, BATCH, NUM_CLASSES, generator=g, device=dev), dim=-1)
    target = torch.randint(0, NUM_CLASSES, (2 + BATCHES, BATCH), generator=g, device=dev)
    kw = dict(num_classes=NUM_CLASSES, validate_args=False, device=dev)
    coll = tm.MetricCollection({
        "acc": MulticlassAccuracy(average="micro", **kw),
        "f1": MulticlassF1Score(average="macro", **kw),
        "auroc": MulticlassAUROC(thresholds=64, **kw),
    })
    for i in range(2):
        coll.update(preds[i], target[i])
    order = [2 + i % BATCHES for i in range(updates)]
    ms = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in order:
            coll.update(preds[i], target[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / updates * 1e3)
    value = {k: float(v) for k, v in coll.compute().items()}
    return {"tree": tree, "ms_per_update": ms, "median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "passes": passes, "updates_per_pass": updates, "compute": value,
            "torch": torch.__version__, "card": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[os.path.dirname(os.path.abspath(__file__))])
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--updates", type=int, default=2000)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(time_tree(args.child, args.passes, args.updates)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("untraced_update_timing.py needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for tree in args.trees:
        child = [sys.executable, os.path.abspath(__file__), "--child", os.path.abspath(tree),
                 "--passes", str(args.passes), "--updates", str(args.updates)]
        out = subprocess.run(child, capture_output=True, text=True, cwd=os.path.abspath(tree))
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        run = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    if len({json.dumps(r["compute"], sort_keys=True) for r in runs}) != 1:
        print("the trees' computes differ", file=sys.stderr)
        return 1
    print(json.dumps({"summary": [{"tree": r["tree"], "median": r["median"], "min": r["min"], "max": r["max"]}
                                  for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
