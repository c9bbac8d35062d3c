#!/usr/bin/env python3
"""Ablations of the weighted-bincount CUDA kernel on one CUDA card.

    python3 bincount_ablation.py [--parts plans,source,sparse,baseline] [--baseline DIR]

One JSON line per measurement. Parts:

1. plans: at the shapes whose counters do not fit one CTA (the binned curve
   at C=1000 through the batched and the 1-D entry, the count-min update,
   Fleiss' count, 1,000,000 bins, two unweighted rows, six weight rows) and
   at the cluster sums' rows plan, the kernel's own plan beside neighbours:
   fewer or more CTAs, vectors or one input a thread (vectors only at one
   or two weight rows an index row), fewer or more sample
   chunks; each checked against the plain version, so the plan's choice can
   be read against its neighbours;
2. source: copies of csrc/bincount.cu with one part switched off or replaced
   (no counting adds, integer instead of float32 shared-memory adds, no
   merge, no memset; the rows plan's batch of 4 or 16 samples, and no adds),
   built and timed beside the unchanged source, to apportion the time of
   the shared-memory plan at the metric path's shapes and of the rows plan
   at the cluster sums'. The copies without adds give wrong counts on
   purpose; only the unchanged source is checked;
3. sparse: over counters that do not fit one CTA, a sweep of inputs per
   counter from 1/16 to 64 at those shapes (and a skewed one, every input on
   the 1,000 diagonal cells of a 1,000 x 1,000 confusion matrix): this
   tree's global plan as planned, with 16-byte vectors at 512, 2,048 and
   8,192 index reads a CTA (at one or two weight rows an index row) and
   with one input a thread (512 a CTA, up to
   one CTA an SM), beside the plans
   of the tree under --baseline (its thread-block cluster plan and its
   sparse plan), torch.bincount's device time and the plain version, each
   checked against the plain version. This sets the global plan's place;
4. baseline: every timed case of chip_smoke.py's phase kernel through this
   tree's entries and through those of the tree under --baseline, in turns
   (baseline, this, this, baseline), each checked against the plain version;
   device ms and host ms (the enqueue of one call through the entry and its
   custom operator) of each turn.

--baseline names the root of another checkout of the repository (say, the
parent commit unpacked by ``git archive`` into a directory .gitignore
lists); its ops/bincount.py is loaded under another name, its custom
operators registered under another namespace, and builds its own
csrc/bincount.cu into its own _build/. Times are device ms per call
(chip_smoke.time_ms). It needs nvcc and one card, and prints the card's name
and power limit first.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

from chip_smoke import TIMED_CASES, card_line, kernel_cases, library_device_ms, time_ms
from torchmetrics_tpu_torch.ops import bincount

# the metric path's shared-memory shapes, and the rows plan's
SMEM_CASES = ("curve_c100_t64", "stat_scores_c1000", "curve_binary_pixel_t64", "stat_scores_cityscapes")
ROWS_CASES = ("cluster_sums_imagenet1k", "cluster_sums_10k_clusters")
# name: (edits of the source, the cases it is timed at)
ABLATIONS = {
    "no_adds": ([("  auto add = [&](int s, int b, T v) { red_local(smem_addr(hist + counter(a, s, b)), v); };",
                  "  auto add = [&](int s, int b, T v) { if (v == T(-7)) red_local(smem_addr(hist + counter(a, s, b)), v); };")],
                SMEM_CASES),
    "int_adds": ([('asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");',
                   'asm volatile("red.shared.add.s32 [%0], %1;" ::"r"(addr), "r"(__float_as_int(v)) : "memory");')],
                 SMEM_CASES),
    "no_merge": ([("        bulk_reduce(out + g0 + lead + off,", "        if (a.n < 0) bulk_reduce(out + g0 + lead + off,")],
                 SMEM_CASES),
    "no_merge_no_memset": ([
        ("        bulk_reduce(out + g0 + lead + off,", "        if (a.n < 0) bulk_reduce(out + g0 + lead + off,"),
        ("  if (a.reduce && (err = cudaMemsetAsync", "  if (a.reduce && a.n < 0 && (err = cudaMemsetAsync"),
    ], SMEM_CASES),
    # the rows plan's batch of samples a warp loads before adding them
    "rows_batch_4": ([("constexpr int kRowsBatch = 8;", "constexpr int kRowsBatch = 4;")], ROWS_CASES),
    "rows_batch_16": ([("constexpr int kRowsBatch = 8;", "constexpr int kRowsBatch = 16;")], ROWS_CASES),
    # its block of labels listed between barriers: 2,048 instead of 8,192
    "rows_block_2048": ([("constexpr int kRowsGroups = 16;", "constexpr int kRowsGroups = 4;"),
                         ("constexpr int kRowsShift = 13;", "constexpr int kRowsShift = 11;")], ROWS_CASES),
    # the rows plan without its adds into shared memory: its loads and lists alone
    "rows_no_adds": ([("        if (lo_ok) row[c_lo] += t.lo[k];\n        if (hi_ok) row[c_hi] += t.hi[k];",
                       "        if (t.lo[k] == -7.0f) row[c_lo] += t.hi[k];")], ROWS_CASES),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_baseline(root: Path):
    """ops/bincount.py of the tree at ``root``, as a module of its own. Its
    custom operators are registered under the namespace ``tm_baseline``
    instead of this tree's, so its entries go through the same dispatch as
    this tree's and their host times compare."""
    path = root / "torchmetrics_tpu_torch" / "ops" / "bincount.py"
    spec = importlib.util.spec_from_file_location("baseline_bincount", path)
    module = importlib.util.module_from_spec(spec)
    custom_op = torch.library.custom_op

    def renamed(name, *args, **kwargs):
        return custom_op(name.replace("torchmetrics_tpu_torch::", "tm_baseline::"), *args, **kwargs)

    with mock.patch.object(torch.library, "custom_op", renamed):
        spec.loader.exec_module(module)
    return module


def entry(module, name, idx, w, bins):
    if name == "1d":
        return lambda: module.weighted_bincount(idx, w, bins)
    return lambda: module.weighted_bincount_batched(idx, w, bins)


def check(label, got, want, exact) -> None:
    torch.cuda.synchronize()
    if exact:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{label}: not bitwise equal to the plain version")
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


class forced_plan:
    """Within the block, every call of this tree's kernel takes ``plan``."""

    def __init__(self, plan):
        self.plan = plan

    def __enter__(self):
        self.own = bincount.launch_plan
        bincount.launch_plan = lambda *args: self.plan
        bincount._kernel_plan.cache_clear()
        bincount._rows_struct.cache_clear()

    def __exit__(self, *exc):
        bincount.launch_plan = self.own
        bincount._kernel_plan.cache_clear()
        bincount._rows_struct.cache_clear()


class baseline_plan:
    """Within the block, the baseline tree's kernel takes its own plan
    with its sparse plan ("sparse": always where its counters do not fit
    one CTA, "cluster": never) or as it chooses (None)."""

    def __init__(self, module, sparse):
        self.module, self.sparse = module, sparse

    def __enter__(self):
        self.own = self.module.SPARSE_BINS_PER_INPUT
        if self.sparse is not None:
            self.module.SPARSE_BINS_PER_INPUT = 0 if self.sparse == "sparse" else 2**62
        self.module._kernel_plan.cache_clear()

    def __exit__(self, *exc):
        self.module.SPARSE_BINS_PER_INPUT = self.own
        self.module._kernel_plan.cache_clear()


# the shapes of counters past one CTA, named as chip_smoke.py's kernel cases
# at their own size: (name, entry, index rows, weight rows, bins, weighted,
# index pattern)
FAMILIES = [
    ("curve_c1000_t64", "batched", 1, 2, 65_000, True, "uniform"),
    ("curve_c1000_t64_1d", "1d", 1, 1, 65_000, True, "uniform"),
    ("countmin_popularity", "batched", 4, 4, 65_536, False, "uniform"),
    ("fleiss_cifar10h", "1d", 1, 1, 100_000, False, "raters"),
    ("past_cluster", "1d", 1, 1, 1_000_000, True, "uniform"),
    ("unweighted_int32", "batched", 2, 2, 65_000, False, "uniform"),
    ("six_rows_cluster", "batched", 1, 6, 20_000, True, "uniform"),
    ("confmat_diagonal", "1d", 1, 1, 1_000_000, False, "diagonal"),
]
RATIOS = (1 / 16, 1 / 4, 1, 4, 16, 64)
# global plan: index reads per CTA swept (the grid capped at GLOBAL_CTAS_PER_SM CTAs an SM)
GLOBAL_PER_CTA = (512, 2048, 8192)


def family_inputs(g, device, family, ratio):
    """Inputs at ``ratio`` index reads per counter (n = ratio x bins per
    index row). Fleiss' index is image * 10 + each rater's class over 10,000
    images; the diagonal one the cells c * 1,001 of a 1,000 x 1,000 matrix."""
    name, kind, rows, wrows, bins, weighted, pattern = family
    n = max(1, round(ratio * bins))
    shape = (rows, n) if rows > 1 else (n,)
    if pattern == "raters":
        images = bins // 10
        n = images * max(1, round(n / images))
        idx = (torch.arange(images, device=device, dtype=torch.int32).repeat_interleave(n // images) * 10
               + torch.randint(0, 10, (n,), generator=g, device=device, dtype=torch.int32))
    elif pattern == "diagonal":
        idx = torch.randint(0, 1000, shape, generator=g, device=device, dtype=torch.int32) * 1001
    else:
        idx = torch.randint(0, bins, shape, generator=g, device=device, dtype=torch.int32)
    w = None
    if weighted:
        w = (torch.rand((wrows, n), generator=g, device=device) < 0.9).to(torch.float32)
        if kind == "1d":
            w = w[0]
    return idx, w, bins, n


def plain_of(kind, idx, w, bins):
    if kind == "1d":
        return bincount.weighted_bincount_plain(idx, w, bins)
    return bincount.weighted_bincount_batched_plain(idx, w, bins)


def run_plans(device, baseline) -> None:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    names = {family[0] for family in FAMILIES}
    for name, kind, idx, w, bins, exact in kernel_cases(device):
        if name not in names:
            continue
        n = idx.shape[-1]
        rows = idx.shape[0] if idx.dim() == 2 else 1
        out_rows = w.shape[0] if w is not None and w.dim() == 2 else rows
        own = bincount.launch_plan(n, rows, out_rows, bins, w is not None, sms)
        want = plain_of(kind, idx, w, bins)
        plans = [("default", own)]
        for scale in (0.25, 0.5, 2, 4):
            ctas = max(1, min(sms * bincount.GLOBAL_CTAS_PER_SM, round(own.ctas * scale)))
            plans.append((f"ctas_x{scale}", own._replace(ctas=ctas)))
        if out_rows // rows <= 2:  # vectors take one or two weight rows an index row
            plans.append(("scalar" if own.vectors else "vectors", own._replace(vectors=not own.vectors)))
        for label, plan in plans:
            with forced_plan(plan):
                call = entry(bincount, kind, idx, w, bins)
                check(f"{name} {plan}", call(), want, exact)
                ms, host_ms, covered = time_ms(call)
            emit({"part": "plans", "case": name, "n": n, "plan": label, **plan._asdict(), "ms": ms, "host_ms": host_ms,
                  "ms_covered": covered})
    g = torch.Generator(device=device).manual_seed(0)
    # the rows plan at the cluster sums' shape: chunks of the samples
    labels = torch.randint(0, 1000, (50_000,), generator=g, device=device, dtype=torch.int32)
    data = torch.randn((50_000, 2048), generator=g, device=device)
    want = bincount.weighted_bincount_batched_plain(labels, data.T, 1000)
    own = bincount.launch_plan(50_000, 1, 2048, 1000, True, sms)
    for chunks in sorted({1, 2, 4, own.chunks}):
        plan = own._replace(chunks=chunks, ctas=own.ctas // own.chunks * chunks)
        with forced_plan(plan):
            call = entry(bincount, "batched", labels, data.T, 1000)
            got = call()
            check(f"cluster sums {plan}", got, want, False)
            same = bool(torch.equal(call(), got))
            ms, host_ms, covered = time_ms(call)
        emit({"part": "plans", "case": "cluster_sums_imagenet1k", "plan": "default" if plan == own else "chunks",
              **plan._asdict(), "run_twice_bitwise": same, "ms": ms, "host_ms": host_ms, "ms_covered": covered})


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
    lib.tm_bincount.argtypes = [ctypes.c_void_p] * 6
    lib.tm_bincount.restype = ctypes.c_int
    lib.tm_bincount_error_string.argtypes = [ctypes.c_int]
    lib.tm_bincount_error_string.restype = ctypes.c_char_p
    return lib


def run_source(device, baseline) -> None:
    source = bincount.SOURCE.read_text()
    variants = {"unchanged": (source, SMEM_CASES + ROWS_CASES)}
    for name, (edits, cases) in ABLATIONS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"ablation {name}: source line not found: {old!r}")
            text = text.replace(old, new)
        variants[name] = (text, cases)
    cases = {c[0]: c for c in kernel_cases(device) if c[0] in SMEM_CASES + ROWS_CASES}
    own_library = bincount._library
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load_variant(build_variant(name, text, tmp)) for name, (text, _) in variants.items()}
        for name, lib in libs.items():
            bincount._library = lambda lib=lib: lib
            for case in variants[name][1]:
                _, kind, idx, w, bins, exact = cases[case]
                call = entry(bincount, kind, idx, w, bins)
                if name == "unchanged":
                    check(case, call(), plain_of(kind, idx, w, bins), exact)
                ms, _, covered = time_ms(call)
                emit({"part": "source", "variant": name, "case": case, "ms": ms, "ms_covered": covered})
    bincount._library = own_library


def run_sparse(device, baseline) -> None:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = torch.Generator(device=device).manual_seed(0)
    for family in FAMILIES:
        name, kind = family[0], family[1]
        ratios = (1 / 16, 1, 16) if family[6] == "diagonal" else RATIOS
        for ratio in ratios:
            idx, w, bins, n = family_inputs(g, device, family, ratio)
            rows = idx.shape[0] if idx.dim() == 2 else 1
            own = bincount.launch_plan(n, rows, max(rows, family[3]), bins, w is not None, sms)
            want = plain_of(kind, idx, w, bins)
            row = {"part": "sparse", "case": name, "n": n, "bins": bins, "inputs_per_counter": n / bins,
                   "plan": own._asdict(), "library_device_ms": library_device_ms(idx, w, bins)}
            # vectors take one or two weight rows an index row
            vectors = [(f"global_vectors_ms_per_{per}", own._replace(
                vectors=True, ctas=max(1, min(sms * bincount.GLOBAL_CTAS_PER_SM, -(-rows * n // per)))))
                for per in GLOBAL_PER_CTA] if family[3] // rows <= 2 else []
            scalar = own._replace(vectors=False, ctas=max(1, min(sms, -(-rows * n // 512))))
            variants = [("global_ms", own), *vectors, ("global_scalar_ms", scalar)]
            for label, plan in variants:
                with forced_plan(plan):
                    call = entry(bincount, kind, idx, w, bins)
                    check(f"{name} n={n} {plan}", call(), want, True)
                    row[label], _, _ = time_ms(call)
            if baseline is not None:
                for label in ("cluster", "sparse"):
                    with baseline_plan(baseline, label):
                        call = entry(baseline, kind, idx, w, bins)
                        check(f"{name} n={n} baseline {label}", call(), want, True)
                        row[f"baseline_{label}_ms"], _, _ = time_ms(call)
            row["plain_ms"], _, _ = time_ms(lambda: plain_of(kind, idx, w, bins))
            emit(row)
            del idx, w, want


def run_baseline(device, baseline) -> None:
    if baseline is None:
        raise SystemExit("bincount_ablation: part baseline needs --baseline DIR")
    for case, kind, idx, w, bins, exact in kernel_cases(device):
        if case not in TIMED_CASES or idx.shape[-1] == 0:
            continue
        want = plain_of(kind, idx, w, bins)
        row = {"part": "baseline", "case": case}
        for turn, module in enumerate((baseline, bincount, bincount, baseline)):
            call = entry(module, kind, idx, w, bins)
            with baseline_plan(baseline, None):
                check(f"{case} turn {turn}", call(), want, exact)
                ms, host_ms, _ = time_ms(call)
            tree = "baseline_" if module is baseline else ""
            row.setdefault(f"{tree}ms", []).append(ms)
            row.setdefault(f"{tree}host_ms", []).append(host_ms)
        emit(row)


PARTS = {"plans": run_plans, "source": run_source, "sparse": run_sparse, "baseline": run_baseline}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", default=",".join(PARTS), help="comma-separated parts to run, in order")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="root of another checkout whose kernel the sparse and baseline parts time beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bincount_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    emit({"card": card_line(), "torch": torch.__version__, "cuda": torch.version.cuda})
    device = torch.device("cuda")
    baseline = load_baseline(args.baseline) if args.baseline is not None else None
    for part in args.parts.split(","):
        PARTS[part](device, baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
