#!/usr/bin/env python3
"""Smoke run of torchmetrics_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises, so the exit code is
not 0 and no result line is printed:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/bincount.cu with nvcc for sm_90a, timed;
3. kernel: the CUDA kernel through weighted_bincount_batched (the metric
   path's batched calls) and weighted_bincount (1-D), against the plain
   PyTorch versions on the card, at the metric path's shapes, past the
   largest cluster and at edge cases; each call must launch once. Timed
   beside the plain version, torch.bincount (a yardstick only; the package
   never calls it: its device time from a profiler trace, and its host
   round trip) and the memory-bandwidth bound;
4. slice: a MetricCollection of MulticlassAccuracy(micro),
   MulticlassF1Score(macro) and MulticlassAUROC(thresholds=64), driven
   through update -> compute and through the pure init_state / update_state
   / compute_state API, at bench config 2's shape (C=100, batch 1024, 200
   steps) and at ImageNet-1k validation's (C=1000, batch 1000, 50 steps).
   Kernel launches are counted over each drive (3 on the first stateful
   update, then 2; 2 per pure update), states must equal a
   device="cpu" run on the same inputs bitwise, and computed values must
   agree with it within 1e-6.

The last lines are the kernels' record, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
SLEEP_CYCLES = 20_000_000  # about 10 ms of the H100's clock
VALUE_TOL = 1e-6
# kernel cases timed beside their bound, the plain version and torch.bincount
TIMED_CASES = ("stat_scores_c100", "curve_c100_t64", "stat_scores_c1000", "curve_c1000_t64",
               "curve_c1000_t64_1d", "past_cluster", "unweighted_int32", "random_f32_weights")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 5) -> tuple:
    """(device ms, host ms) per call, medians over ``rounds``.

    A sleep kernel holds the stream while the host enqueues ``reps`` calls,
    so the CUDA events around them time the calls back to back on the
    device, without the host's launch latency between them; the host time
    is the Python-side enqueue cost of one call. ``covered`` is False when
    the host took longer than the sleep, which would inflate the device time.
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev, host, covered = [], [], True
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sleep_end = torch.cuda.Event(enable_timing=True)
        sleep_start = torch.cuda.Event(enable_timing=True)
        sleep_start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        sleep_end.record()
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        covered = covered and enqueue_ms < sleep_start.elapsed_time(sleep_end)
        dev.append(start.elapsed_time(end) / reps)
        host.append(enqueue_ms / reps)
    return statistics.median(dev), statistics.median(host), covered


def kernel_cases(device):
    """(name, entry, idx, weights, num_bins, exact): the metric path's shapes
    through the batched entry, the 1-D entry at the largest of them, then
    edges. ``exact`` cases must equal the plain version bitwise."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=g, device=device, dtype=torch.int32)

    def mask01(shape):
        return (torch.rand(shape, generator=g, device=device) < 0.9).to(torch.float32)

    mis_idx, mis_w = ints((1_000_001,), -3, 65_003), mask01((2, 1_000_001))
    return [
        # stat scores at bench config 2: S=3 rows of N = batch, bins = C
        ("stat_scores_c100", "batched", ints((3, 1024), 0, 100), mask01((3, 1024)), 100, True),
        # binned curve at bench config 2: shared idx of N = batch * C, S=2, bins = C * (T + 1)
        ("curve_c100_t64", "batched", ints((102_400,), 0, 6_500), mask01((2, 102_400)), 6_500, True),
        # stat scores at ImageNet-1k
        ("stat_scores_c1000", "batched", ints((3, 1000), 0, 1000), mask01((3, 1000)), 1000, True),
        # binned curve at ImageNet-1k: 130,000 counters need a cluster
        ("curve_c1000_t64", "batched", ints((1_000_000,), 0, 65_000), mask01((2, 1_000_000)), 65_000, True),
        # the 1-D entry at that shape (one call per weight row before the batched entry)
        ("curve_c1000_t64_1d", "1d", ints((1_000_000,), 0, 65_000), mask01((1_000_000,)), 65_000, True),
        # past the largest cluster (16 CTAs of 227 KB): the bins are tiled
        ("past_cluster", "1d", ints((1_000_000,), 0, 1_000_000), mask01((1_000_000,)), 1_000_000, True),
        ("unweighted_int32", "batched", ints((2, 1_000_000), 0, 65_000), None, 65_000, True),
        ("out_of_range", "batched", ints((200_000,), -50_000, 120_000), mask01((2, 200_000)), 65_000, True),
        ("empty", "batched", ints((0,), 0, 10), mask01((2, 0)), 10, True),
        # clusters with scalar inputs: a view off 16-byte alignment (scalar
        # head and tail), ragged rows (N % 4 != 0: every input scalar), and
        # few bins with ragged rows
        ("misaligned_1d", "1d", mis_idx[1:], mis_w[0, 1:], 65_000, True),
        ("misaligned_shared", "batched", mis_idx[1:], mis_w[:, 1:], 65_000, True),
        ("ragged_per_row", "batched", ints((3, 100_001), -5, 65_005), None, 65_000, True),
        ("ragged_small_bins", "batched", ints((5, 10_001), -5, 700), mask01((5, 10_001)), 700, True),
        # more weight rows than the kernel specialises (S=6)
        ("six_rows_shared", "batched", ints((300_000,), 0, 900), mask01((6, 300_000)), 900, True),
        ("six_rows_cluster", "batched", ints((300_000,), 0, 20_000), mask01((6, 300_000)), 20_000, True),
        ("random_f32_weights", "batched", ints((1_000_000,), 0, 65_000),
         torch.rand((2, 1_000_000), generator=g, device=device), 65_000, False),
    ]


def bound_bytes(idx, w, bins: int) -> int:
    """Least bytes one call moves: every input read once, the output written once."""
    n = idx.shape[-1]
    rows = idx.shape[0] if idx.dim() == 2 else 1
    s = w.shape[0] if w is not None and w.dim() == 2 else rows
    w_bytes = 0 if w is None else s * n * 4
    return rows * n * 4 + w_bytes + s * bins * 4


def library_device_ms(idx, w, bins: int, reps: int = 10) -> float:
    """Device time of torch.bincount for the same counts, one call per row,
    summed over the rows: the kernels (and memsets) of a torch.profiler
    trace, so the host round trip by which torch.bincount sizes its output
    (a device-to-host copy and a wait) is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    idx64 = idx.long()
    rows = w.shape[0] if w is not None and w.dim() == 2 else (idx.shape[0] if idx.dim() == 2 else 1)

    def call():
        for r in range(rows):
            i = idx64 if idx64.dim() == 1 else idx64[r]
            ww = None if w is None else (w if w.dim() == 1 else w[r])
            torch.bincount(i, ww, minlength=bins)

    call()
    torch.cuda.synchronize()
    total_us = 0.0
    for _ in range(3):  # a trace that caught no device activity is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and "memcpy" not in e.name.lower())
        if total_us > 0:
            break
    if total_us <= 0:
        raise AssertionError("torch.profiler recorded no device time for torch.bincount")
    return total_us / reps / 1e3


def check_kernel(device) -> dict:
    import torch

    from torchmetrics_tpu_torch.ops import bincount

    results = []
    max_abs_err = 0.0
    for name, entry, idx, w, bins, exact in kernel_cases(device):
        if entry == "1d":
            call = lambda idx=idx, w=w, bins=bins: bincount.weighted_bincount(idx, w, bins)  # noqa: E731
            plain = lambda idx=idx, w=w, bins=bins: bincount.weighted_bincount_plain(idx, w, bins)  # noqa: E731
        else:
            call = lambda idx=idx, w=w, bins=bins: bincount.weighted_bincount_batched(idx, w, bins)  # noqa: E731
            plain = lambda idx=idx, w=w, bins=bins: bincount.weighted_bincount_batched_plain(idx, w, bins)  # noqa: E731
        before = bincount.weighted_bincount.launches
        got = call()
        launched = bincount.weighted_bincount.launches - before
        want = plain()
        torch.cuda.synchronize()
        n = idx.shape[-1]
        if n and launched != 1:
            raise AssertionError(f"kernel {name}: {launched} launches, expected 1")
        if exact:
            # int32 counts and sums of 0/1 weights are exact in any order
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"kernel {name}: not bitwise equal to the plain version")
        else:
            # float32 shared-memory atomics add in another order than
            # index_add_: agree per bin within rtol 1e-5
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        max_abs_err = max(max_abs_err, err)
        rows = idx.shape[0] if idx.dim() == 2 else 1
        s = w.shape[0] if w is not None and w.dim() == 2 else rows
        plan = bincount.launch_plan(n, rows, s, bins, w is not None, torch.cuda.get_device_properties(0).multi_processor_count)
        row = {"case": name, "entry": entry, "s": s, "n": n, "bins": bins, "shared_idx": rows == 1 and s > 1,
               "weighted": w is not None, "plan": plan._asdict(), "launches": launched,
               "bitwise": bool(torch.equal(got, want)), "max_abs_err": err}
        if n and name in TIMED_CASES:
            row["ms"], row["host_ms"], row["ms_covered"] = time_ms(call)
            row["plain_ms"], row["plain_host_ms"], row["plain_covered"] = time_ms(plain)
            row["library_device_ms"] = library_device_ms(idx, w, bins)
            # torch.bincount reads the largest index back to the host to size
            # its output, so every call waits for the device: this is a host
            # round trip per row ("library_covered" comes out False)
            idx64 = idx.long()
            w_rows = [None] * s if w is None else ([w] if w.dim() == 1 else list(w))
            i_rows = [idx64] * s if idx64.dim() == 1 else list(idx64)
            row["library_ms"], _, row["library_covered"] = time_ms(
                lambda: [torch.bincount(i, ww, minlength=bins) for i, ww in zip(i_rows, w_rows)], reps=5)
            row["bound_ms"] = bound_bytes(idx, w, bins) / HBM_BYTES_PER_S * 1e3
            row["bound_by"] = "bytes"
        results.append(row)
    return {"cases": results, "max_abs_err": max_abs_err}


def make_collection(num_classes: int, device):
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score

    return MetricCollection({
        "acc": MulticlassAccuracy(num_classes=num_classes, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes=num_classes, average="macro", validate_args=False, device=device),
        "auroc": MulticlassAUROC(num_classes=num_classes, thresholds=64, validate_args=False, device=device),
    })


def profile_updates(coll, preds, target, steps: int) -> dict:
    """Where one stateful update's time goes, from a torch.profiler trace of
    ``steps`` steady-state updates: wall time, device busy time (the union
    of the trace's device intervals), the bincount kernels' share of it, and
    the busiest device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            coll.update(preds[i], target[i])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    busy_us, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    ours = sum(v for k, v in by_name.items() if "histogram_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "profiled_updates": steps,
        "wall_ms_per_update": wall_us / steps / 1e3,
        "device_busy_ms_per_update": busy_us / steps / 1e3 if spans else None,
        "device_idle_share": 1.0 - busy_us / wall_us if spans else None,
        "bincount_kernel_ms_per_update": ours / steps / 1e3 if spans else None,
        "device_ops_per_update": len(spans) / steps,
        "top_device_ms_per_update": {k[:60]: v / steps / 1e3 for k, v in top},
    }


def run_slice(label: str, num_classes: int, batch: int, steps: int, card: str, dev) -> int:
    import torch

    from torchmetrics_tpu_torch.interop import state_to_numpy
    from torchmetrics_tpu_torch.ops.bincount import weighted_bincount

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    g = torch.Generator(device=dev).manual_seed(1234)
    preds = torch.softmax(torch.randn(steps, batch, num_classes, generator=g, device=dev), dim=-1)
    target = torch.randint(0, num_classes, (steps, batch), generator=g, device=dev)
    sync()

    # warm-up (allocator, library handles) on a throwaway collection
    warm = make_collection(num_classes, dev)
    for i in range(3):
        warm.update(preds[i], target[i])
    warm.compute()
    warm.update_state(warm.init_state(), preds[0], target[0])
    sync()

    # stateful update loop -> compute
    coll = make_collection(num_classes, dev)
    weighted_bincount.launches = 0
    coll.update(preds[0], target[0])
    sync()
    first = weighted_bincount.launches
    t0 = time.perf_counter()
    for i in range(1, steps):
        coll.update(preds[i], target[i])
    sync()
    loop_s = time.perf_counter() - t0
    later = weighted_bincount.launches - first
    values = coll.compute()
    sync()
    if first != 3 or later != 2 * (steps - 1):
        raise AssertionError(f"{label}: stateful launches {first} then {later}, expected 3 then {2 * (steps - 1)}")
    if coll.compute_groups != {0: ["acc", "f1"], 1: ["auroc"]}:
        raise AssertionError(f"{label}: compute groups {coll.compute_groups}")

    # pure API
    weighted_bincount.launches = 0
    t0 = time.perf_counter()
    state = coll.init_state()
    for i in range(steps):
        state = coll.update_state(state, preds[i], target[i])
    sync()
    pure_s = time.perf_counter() - t0
    pure_launches = weighted_bincount.launches
    pure_values = coll.compute_state(state)
    if pure_launches != 2 * steps:
        raise AssertionError(f"{label}: pure launches {pure_launches}, expected {2 * steps}")

    # the same run on the CPU (the kernel's plain version) over the same inputs
    ref = make_collection(num_classes, "cpu")
    preds_cpu, target_cpu = preds.cpu(), target.cpu()
    for i in range(steps):
        ref.update(preds_cpu[i], target_cpu[i])
    ref_values = ref.compute()

    gpu_states = state_to_numpy(coll)
    pure_states = state_to_numpy(state)
    for member, ref_state in state_to_numpy(ref).items():
        for key, want in ref_state.items():
            for got, how in ((gpu_states[member][key], "stateful"), (pure_states[member][key], "pure")):
                if got.dtype != want.dtype or not (got == want).all():
                    raise AssertionError(f"{label}: {how} state {member}.{key} differs from the CPU run")
    for key, want in ref_values.items():
        for got, how in ((values[key], "stateful"), (pure_values[key], "pure")):
            got = got.cpu()
            if not torch.isfinite(got).all() or got.shape != want.shape:
                raise AssertionError(f"{label}: {how} {key} = {got}")
            if abs(float(got) - float(want)) > VALUE_TOL:
                raise AssertionError(f"{label}: {how} {key} {float(got)} vs CPU {float(want)}")
    # accuracy against its definition
    direct = (preds.argmax(-1) == target).double().mean().item()
    if abs(direct - float(values["acc"])) > VALUE_TOL:
        raise AssertionError(f"{label}: accuracy {float(values['acc'])} vs direct {direct}")

    breakdown = None
    if dev.type == "cuda":
        prof_coll = make_collection(num_classes, dev)
        prof_coll.update(preds[0], target[0])  # group discovery, outside the trace
        breakdown = profile_updates(prof_coll, preds[1:], target[1:], min(20, steps - 1))

    emit({
        "phase": "slice", "shape": label, "num_classes": num_classes, "batch": batch, "steps": steps,
        "thresholds": 64, "launches_first_update": first, "launches_per_later_update": later / (steps - 1),
        "launches_per_pure_update": pure_launches / steps,
        "stateful_updates_per_s": (steps - 1) / loop_s, "stateful_ms_per_update": loop_s / (steps - 1) * 1e3,
        "pure_updates_per_s": steps / pure_s, "pure_ms_per_update": pure_s / steps * 1e3,
        "values": {k: float(v) for k, v in values.items()}, "states_equal_cpu": True,
        "profile": breakdown, "card": card,
    })
    return first + later + pure_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import torchmetrics_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from torchmetrics_tpu_torch.ops import bincount

    card = card_line()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    lib = bincount.build()
    bincount._library()
    emit({"phase": "build", "library": lib.name, "seconds": time.perf_counter() - t0})

    kernel = check_kernel(torch.device("cuda"))
    emit({"phase": "kernel", "card": card, **kernel})

    dev = torch.device("cuda")
    launches = 0
    launches += run_slice("bench_config2", num_classes=100, batch=1024, steps=200, card=card, dev=dev)
    launches += run_slice("imagenet1k_val", num_classes=1000, batch=1000, steps=50, card=card, dev=dev)

    main_case = next(c for c in kernel["cases"] if c["case"] == "curve_c1000_t64")
    emit({"kernels": [{
        "name": "weighted_bincount",
        "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
        "replaces": "torchmetrics_tpu/ops/bincount.py:38",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "library_device_ms": main_case["library_device_ms"],
        "library_ms_is": "host round trip per row (torch.bincount sizes its output on the host)",
        "host_ms": main_case["host_ms"],
        "shape": {"s": main_case["s"], "n": main_case["n"], "bins": main_case["bins"], "shared_idx": True,
                  "weighted": True},
    }]})
    print(f"card: {card}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
