"""Time the t-digest compress kernel pass by pass: the earlier one-CTA design and the current one.

    git show <commit>:torchmetrics_tpu_torch/csrc/tdigest.cu > _archive_check/tdigest_one_cta.cu
    python3 tdigest_pass_breakdown.py _archive_check/tdigest_one_cta.cu

Builds copies of two sources, each whole and cut short with a ``return``
before a pass (``nvcc -Xptxas -v``): the given one, a kernel of the earlier
design (one CTA per digest; its passes marked "// pass 2: the slot walk" and
"// pass 3: per-slot sums"), and the current ``csrc/tdigest.cu`` (cut before
"// pass 1, continued", "// pass 2: cum, from", "// pass 3: the walk" and
"// pass 4: per-slot sums", where every CTA of a cluster returns together).
Times each at ``chip_smoke.TDIGEST_CASES`` on the same inputs with
``chip_smoke.time_ms`` (device ms per call, median of 5 rounds of 20 calls
behind a sleep kernel), ``--repeats`` times in turns. Each whole kernel is
checked bitwise against the plain version on the host (the earlier one summed
the weights in one chain: it is not checked on the decayed input). Needs a card;
writes ``chiprun_out/tdigest_pass_breakdown.json``.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ONE_CTA_CUTS = {"pass 1": "  // pass 2: the slot walk", "passes 1-2": "  // pass 3: per-slot sums"}
CURRENT_CUTS = {"pass 1 (totals)": "  // pass 1, continued", "pass 1 (with the scan)": "  // pass 2: cum, from",
                "passes 1-2": "  // pass 3: the walk", "passes 1-3": "  // pass 4: per-slot sums"}


def build(text: str, cuts: dict, out: Path, tag: str, argtypes: list) -> dict:
    from torchmetrics_tpu_torch.ops import bincount

    variants = {"whole": text}
    for name, marker in cuts.items():
        if marker not in text:
            raise SystemExit(f"{tag}: the source has no line {marker!r}")
        variants[name] = text.replace(marker, "  return;\n" + marker)
    libs = {}
    for name, body in variants.items():
        stem = f"{tag}_{len(libs)}"
        cu, so = out / f"{stem}.cu", out / f"{stem}.so"
        cu.write_text(body)
        proc = subprocess.run([bincount._nvcc(cu), *bincount.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag} {name}:\n{proc.stderr}")
        print(tag, name, [line.strip() for line in proc.stderr.splitlines() if "registers" in line], flush=True)
        lib = ctypes.CDLL(str(so))
        lib.tm_tdigest_compress.argtypes = argtypes
        lib.tm_tdigest_compress.restype = ctypes.c_int
        if hasattr(lib, "tm_tdigest_prepare") and lib.tm_tdigest_prepare() != 0:
            raise SystemExit(f"{tag} {name}: setup failed")
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("source", type=Path, help="a csrc/tdigest.cu of the one-CTA design")
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tdigest_pass_breakdown: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from torchmetrics_tpu_torch.ops import tdigest

    out = Path(tempfile.mkdtemp())
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old = build(args.source.read_text(), ONE_CTA_CUTS, out, "one-CTA", [ptr, i32, i32, i32, f32, ptr, ptr, ptr, ptr])
    new = build(tdigest.SOURCE.read_text(), CURRENT_CUTS, out, "current",
                [ptr, i32, i32, i32, f32, i32, ptr, ptr, ptr, ptr, ptr])
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(7)
    card = chip_smoke.card_line()
    rows = []
    for s, m, c, kind in chip_smoke.TDIGEST_CASES:
        cent = chip_smoke._tdigest_kernel_input(g, dev, s, m, c, kind).contiguous()
        host = tdigest.tdigest_compress_sorted_plain(cent.cpu(), c)
        scale = tdigest.k_scale_factor(c)
        stream = torch.cuda.current_stream().cuda_stream
        cluster = tdigest.cluster_size(s, m, sms)
        o_old, o_new = torch.empty((s, c, 2), device=dev), torch.empty((s, c, 2), device=dev)
        cum, st_old = torch.empty((s, m), device=dev), torch.empty((s, c), dtype=torch.int32, device=dev)
        wsum = torch.empty((s, -(-m // tdigest.BLOCK) + 1), dtype=torch.float64, device=dev)
        kv = torch.empty((s, tdigest.kv_floats(m)), device=dev)
        st_new = torch.empty((s, c + 1), dtype=torch.int32, device=dev)
        calls = {}
        for name, lib in old.items():
            calls[f"one-CTA {name}"] = (lambda lib=lib: lib.tm_tdigest_compress(
                cent.data_ptr(), s, m, c, scale, cum.data_ptr(), st_old.data_ptr(), o_old.data_ptr(), stream))
        for name, lib in new.items():
            calls[f"current {name}"] = (lambda lib=lib: lib.tm_tdigest_compress(
                cent.data_ptr(), s, m, c, scale, cluster, wsum.data_ptr(), kv.data_ptr(), st_new.data_ptr(),
                o_new.data_ptr(), stream))
        for name, call in calls.items():
            if call() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            if name == "current whole" and not torch.equal(o_new.cpu(), host):
                raise AssertionError(f"S={s}, M={m}, {kind}: the current kernel differs from the plain version")
            if name == "one-CTA whole" and kind != "decayed" and not torch.equal(o_old.cpu(), host):
                raise AssertionError(f"S={s}, M={m}, {kind}: the one-CTA kernel differs from the plain version")
        times = {name: [] for name in calls}
        for _ in range(args.repeats):
            for name, call in calls.items():
                times[name].append(chip_smoke.time_ms(call)[0])
        rows.append({"s": s, "m": m, "c": c, "input": kind, "cluster": cluster, "ms": times, "card": card})
        print(json.dumps(rows[-1]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "tdigest_pass_breakdown.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
