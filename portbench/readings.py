"""The two readings a cell's ``value_err`` limit is set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 --seconds 3

For each of ``--seeds`` it makes a whole run of the timed path (set-up, a
window of ``--seconds``, the comparison) and prints the run's ``value_err``:
the largest of these over a dozen seeds or more is the lower reading. For each
of ``--control-seeds`` it makes the cell's inputs and prints the control's
``value_err``, the reference computed in bfloat16 in the program's place,
over every distinct epoch a run feeds: the smallest of these is the upper
reading. One JSON object a line. Needs the card, like ``run.py``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)

    import torch

    from portbench import compare, harness, spec
    from portbench.generate import epoch_batches, make_pool

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = spec.load_benchmark(ROOT)
    cell = spec.find_cell(args.workload, ROOT, bench)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        result, _ = harness.run_cell(cell, bench, seed, args.seconds, False, device, time.perf_counter(),
                                     lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"workload": cell.name, "kind": "program", "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "value_err": result["checks"]["value_err"]["value"],
                          "count_err": result["checks"]["count_err"]["value"]}),
              flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        pool = make_pool(cell.config, cell.traffic, cell.workload["pool"], seed, device)
        comps = {epoch_batches(e, cell.updates_per_epoch, len(pool)) for e in range(len(pool))}
        t0 = time.perf_counter()
        err, per_member = compare.control_err(cell, pool, comps)
        print(json.dumps({"workload": cell.name, "kind": "control_bfloat16", "seed": seed, "value_err": err,
                          "by_member": per_member, "epochs": len(comps), "s": time.perf_counter() - t0}), flush=True)
        del pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
