#!/usr/bin/env python3
"""Ablations of the weighted-bincount CUDA kernel on one CUDA card.

    python3 bincount_ablation.py [--parts plans,source,sparse]

Three parts, one JSON line per measurement. The first two at the metric
path's shapes (binned curve at C=1000 through the batched entry and the 1-D
entry, binned curve at C=100, stat scores at C=1000):

1. plans: the kernel's own plan beside others with a different cluster size
   or number of clusters, each checked against the plain version, so the
   plan's choice can be read against its neighbours;
2. source: copies of csrc/bincount.cu with one part switched off or
   replaced (no counting adds, integer instead of float32 shared-memory
   adds, no merge, no memset), built and timed beside the unchanged source,
   to apportion the kernel's time. These copies give wrong counts on
   purpose; only the unchanged source is checked;
3. sparse: the sparse plan (global atomics into the zeroed output) beside
   the plan the kernel would use without it, over counters that do not fit
   one CTA and a sweep of inputs per row, each checked against the plain
   version and timed beside torch.bincount's device time; this sets
   SPARSE_BINS_PER_INPUT, the cut-over between the two.

Times are device ms per call (chip_smoke.time_ms). It needs nvcc and one
card, and prints the card's name and power limit first.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from chip_smoke import card_line, library_device_ms, time_ms
from torchmetrics_tpu_torch.ops import bincount

ABLATIONS = {
    "no_adds": [("{ red_local(smem_addr(hist + counter(a, s, lb)), v); }",
                 "{ if (v == T(-7)) red_local(smem_addr(hist + counter(a, s, lb)), v); }")],
    "int_adds": [('asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");',
                  'asm volatile("red.shared.add.s32 [%0], %1;" ::"r"(addr), "r"(__float_as_int(v)) : "memory");')],
    "no_merge": [("        bulk_reduce(out + g0 + lead + off,", "        if (a.n < 0) bulk_reduce(out + g0 + lead + off,")],
    "no_merge_no_memset": [
        ("        bulk_reduce(out + g0 + lead + off,", "        if (a.n < 0) bulk_reduce(out + g0 + lead + off,"),
        ("  if (a.reduce) {\n    const cudaError_t err =\n        cudaMemsetAsync",
         "  if (a.reduce && a.n < 0) {\n    const cudaError_t err =\n        cudaMemsetAsync"),
    ],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cases(device):
    g = torch.Generator(device=device).manual_seed(0)

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=g, device=device, dtype=torch.int32)

    def mask01(shape):
        return (torch.rand(shape, generator=g, device=device) < 0.9).to(torch.float32)

    return [
        ("curve_c1000_t64", ints((1_000_000,), 65_000), mask01((2, 1_000_000)), 65_000),
        ("curve_c1000_t64_1d", ints((1_000_000,), 65_000), mask01((1, 1_000_000)), 65_000),
        ("curve_c100_t64", ints((102_400,), 6_500), mask01((2, 102_400)), 6_500),
        ("stat_scores_c1000", ints((3, 1000), 1000), mask01((3, 1000)), 1000),
    ]


def forced_plan(cluster: int, clusters: int, rows: int, out_rows: int, bins: int):
    """The plan launch_plan would make at this cluster size, with ``clusters``
    clusters; None when the counters do not fit."""
    if cluster == 1:
        return bincount.LaunchPlan(clusters, 1, 1, bins, bins, 0)
    streams = 1 + out_rows // rows
    plan = bincount.LaunchPlan(clusters, cluster, 1, bins, bincount._align4(-(-bins // cluster)), 0)
    room = bincount.SMEM_BYTES - bincount.smem_bytes(plan, out_rows, streams)
    chv = min(bincount.MAX_STAGE_VECTORS, room // (2 * cluster * 16 * streams)) // 32 * 32
    return plan._replace(chv=chv) if chv >= bincount.MIN_STAGE_VECTORS else None


SWEEPS = {
    "curve_c1000_t64": [(4, 16), (4, 33), (8, 16), (16, 8)],
    "curve_c1000_t64_1d": [(2, 45), (2, 66), (4, 23)],
    "curve_c100_t64": [(1, 64), (1, 132), (2, 23), (4, 23)],
}


def run_plans(device) -> None:
    own_plan = bincount.launch_plan
    for name, idx, w, bins in cases(device):
        rows = idx.shape[0] if idx.dim() == 2 else 1
        want = bincount.weighted_bincount_batched_plain(idx, w, bins)
        default = own_plan(idx.shape[-1], rows, w.shape[0], bins, True,
                           torch.cuda.get_device_properties(device).multi_processor_count)
        plans = [("default", default)] + [
            ("sweep", forced_plan(cl, n, rows, w.shape[0], bins)) for cl, n in SWEEPS.get(name, [])]
        for label, plan in plans:
            if plan is None:
                continue
            bincount.launch_plan = lambda *args, plan=plan: plan
            bincount._kernel_plan.cache_clear()
            got = bincount.weighted_bincount_batched(idx, w, bins)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {plan}: not bitwise equal to the plain version")
            ms, host_ms, covered = time_ms(lambda: bincount.weighted_bincount_batched(idx, w, bins))
            emit({"part": "plans", "case": name, "plan": label, **plan._asdict(), "ms": ms, "host_ms": host_ms,
                  "ms_covered": covered})
        bincount.launch_plan = own_plan
        bincount._kernel_plan.cache_clear()


def build_variant(name: str, source: str, out_dir: str) -> str:
    src_path = os.path.join(out_dir, f"{name}.cu")
    lib_path = os.path.join(out_dir, f"{name}.so")
    with open(src_path, "w") as f:
        f.write(source)
    subprocess.run([bincount._nvcc(), *bincount.NVCC_FLAGS, "-o", lib_path, src_path], check=True,
                   capture_output=True, text=True)
    return lib_path


def load_variant(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    lib.tm_bincount.argtypes = [ctypes.c_void_p] * 5
    lib.tm_bincount.restype = ctypes.c_int
    lib.tm_bincount_error_string.argtypes = [ctypes.c_int]
    lib.tm_bincount_error_string.restype = ctypes.c_char_p
    return lib


def run_source(device) -> None:
    source = bincount.SOURCE.read_text()
    variants = {"unchanged": source}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"ablation {name}: source line not found: {old!r}")
            text = text.replace(old, new)
        variants[name] = text
    own_library = bincount._library
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load_variant(build_variant(name, text, tmp)) for name, text in variants.items()}
        for name, lib in libs.items():
            bincount._library = lambda lib=lib: lib
            for case, idx, w, bins in cases(device):
                if name == "unchanged":
                    got = bincount.weighted_bincount_batched(idx, w, bins)
                    torch.cuda.synchronize()
                    if not torch.equal(got, bincount.weighted_bincount_batched_plain(idx, w, bins)):
                        raise AssertionError(f"{case}: not bitwise equal to the plain version")
                ms, _, covered = time_ms(lambda: bincount.weighted_bincount_batched(idx, w, bins))
                emit({"part": "source", "variant": name, "case": case, "ms": ms, "ms_covered": covered})
    bincount._library = own_library


# (rows, out_rows, bins, weighted, spread) families and the inputs per row
# swept: the ImageNet-1k confusion matrix's 1,000,000 int32 cells (bin tiles
# of clusters of 16 without the sparse plan), the same with every input on
# the 1,000 diagonal cells (a perfect classifier: contended atomics),
# 100,000 int32 cells (a cluster of 4) and the binned curve's two weight
# rows of 65,000 bins (clusters of 4), from far fewer inputs than bins to
# more inputs than bins
SPARSE_SWEEP = [
    ((1, 1, 1_000_000, False, "uniform"),
     (1000, 4000, 16_000, 62_500, 125_000, 250_000, 500_000, 1_000_000, 2_000_000, 4_000_000)),
    ((1, 1, 1_000_000, False, "diagonal"), (1000, 62_500, 500_000, 1_000_000)),
    ((1, 1, 100_000, False, "uniform"), (1000, 6250, 12_500, 25_000, 50_000, 100_000, 200_000, 400_000, 1_600_000)),
    ((1, 2, 65_000, True, "uniform"), (1000, 4000, 8125, 16_250, 32_500, 65_000, 130_000, 260_000, 1_000_000)),
]


def run_sparse(device) -> None:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    own_plan, own_cut = bincount.launch_plan, bincount.SPARSE_BINS_PER_INPUT
    g = torch.Generator(device=device).manual_seed(0)
    for (rows, out_rows, bins, weighted, spread), ns in SPARSE_SWEEP:
        for n in ns:
            shape = (rows, n) if not weighted else (n,)
            if spread == "diagonal":  # cell c * (C + 1) of a C x C matrix
                side = round(bins**0.5)
                idx = torch.randint(0, side, shape, generator=g, device=device, dtype=torch.int32) * (side + 1)
            else:
                idx = torch.randint(0, bins, shape, generator=g, device=device, dtype=torch.int32)
            w = (torch.rand((out_rows, n), generator=g, device=device) < 0.9).to(torch.float32) if weighted else None
            want = bincount.weighted_bincount_batched_plain(idx, w, bins)
            bincount.SPARSE_BINS_PER_INPUT = 2**62  # never sparse: the plan without it
            dense = own_plan(n, rows, out_rows, bins, weighted, sms)
            bincount.SPARSE_BINS_PER_INPUT = own_cut
            sparse = bincount.LaunchPlan(max(1, min(sms, -(-rows * n // bincount.SPARSE_INPUTS_PER_CTA))), 1, 1,
                                         bins, bins, 0, sparse=True)
            row = {"part": "sparse", "rows": rows, "out_rows": out_rows, "bins": bins, "weighted": weighted,
                   "spread": spread, "n": n,
                   "bins_per_input": bins / n, "own_plan_sparse": own_plan(n, rows, out_rows, bins, weighted,
                                                                           sms).sparse,
                   "library_device_ms": library_device_ms(idx, w, bins)}
            for label, plan in (("dense", dense), ("sparse", sparse)):
                bincount.launch_plan = lambda *args, plan=plan: plan
                bincount._kernel_plan.cache_clear()
                got = bincount.weighted_bincount_batched(idx, w, bins)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"sparse sweep {bins} bins, n={n}, {plan}: not bitwise equal to the plain "
                                         "version")
                row[f"{label}_ms"], _, row[f"{label}_covered"] = time_ms(
                    lambda: bincount.weighted_bincount_batched(idx, w, bins))
                row[f"{label}_plan"] = plan._asdict()
            bincount.launch_plan = own_plan
            bincount._kernel_plan.cache_clear()
            emit(row)


PARTS = {"plans": run_plans, "source": run_source, "sparse": run_sparse}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default=",".join(PARTS), help="comma-separated parts to run, in order")
    parts = parser.parse_args().parts.split(",")
    if not torch.cuda.is_available():
        print("bincount_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    emit({"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda})
    device = torch.device("cuda")
    for part in parts:
        PARTS[part](device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
