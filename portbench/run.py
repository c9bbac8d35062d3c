"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, without a
card (or with fewer than the cell asks for), without the program, and when
JAX or the JAX package was loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness, spec

    _log(f"set-up: torch imported at {time.perf_counter() - T_START:.3f} s")

    bench = spec.load_benchmark(ROOT)
    cell = spec.find_cell(args.workload, ROOT, bench)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"{args.workload} needs {chips} CUDA device(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import torchmetrics_tpu_torch  # noqa: F401
    except ImportError as exc:
        _log(f"the program is not in this checkout: {exc}")
        return 2
    result, lines = harness.run_cell(cell, bench, args.seed, args.seconds, bool(args.trace),
                                     torch.device("cuda", 0), T_START, _log)
    found = harness.forbidden_modules()
    if found:
        _log("JAX or the JAX package was loaded in this process: " + ", ".join(found[:20]))
        return 3
    for line in lines:
        _log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout, not portbench/: the program and this package import from there
    os.environ["USE_FLAX"] = "0"  # a library of the program's that can load JAX by itself must not
    # Triton's kernels and Python's bytecode cached at fixed places inside the checkout, so only the
    # first run there compiles them; without a bytecode cache (PYTHONDONTWRITEBYTECODE, a read-only
    # install) every run's set-up would compile torch's modules anew
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")
    sys.pycache_prefix = str(ROOT / ".portbench_cache" / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
