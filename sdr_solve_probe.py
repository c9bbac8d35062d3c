#!/usr/bin/env python3
"""Whether SDR's batched Toeplitz solve can be captured in a CUDA graph, by linear-algebra backend.

    python3 sdr_solve_probe.py

For each backend torch offers for ``torch.linalg`` on the card (the default,
cuSOLVER and MAGMA) and each batch of symmetric positive definite 512 x 512
systems (16, 32 and 64, and one), it tries to capture
``torch.linalg.solve_ex(..., check_errors=False)``, the call
``functional/audio/sdr.py`` makes, and ``cholesky_ex`` + ``cholesky_solve``
for comparison, in a CUDA graph, and prints one JSON line a case: whether
the capture succeeded, whether its replay equals the eager result, and the
host-clock ms of one call, eager and replayed (10 calls between two
synchronisations), after a line with the card's name and power limit.
``SignalDistortionRatio`` updates eagerly because the default backend's
batched LU is MAGMA's, which capture refuses. Needs a card.
"""
import json
import subprocess
import sys
import time

SIZE = 512
BATCHES = (16, 32, 64, 1)
REPS = 10


def _systems(torch, g, dev, batch: int):
    """(R, b): autocorrelation Toeplitz matrices of random signals and right-hand sides."""
    x = torch.randn(batch, 4 * SIZE, device=dev, generator=g)
    r0 = torch.fft.irfft(torch.fft.rfft(x, n=8 * SIZE).abs() ** 2, n=8 * SIZE)[..., :SIZE]
    ar = torch.arange(SIZE, device=dev)
    return r0[..., (ar[:, None] - ar[None, :]).abs()].contiguous(), torch.randn(batch, SIZE, 1, device=dev,
                                                                                 generator=g)


def _ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / REPS


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sdr_solve_probe: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    for backend in ("default", "cusolver", "magma"):
        if backend != "default":
            torch.backends.cuda.preferred_linalg_library(backend)
        for batch in BATCHES:
            r, rhs = _systems(torch, g, dev, batch)
            calls = {"solve_ex": lambda: torch.linalg.solve_ex(r, rhs, check_errors=False).result,
                     "cholesky": lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky_ex(r, check_errors=False).L)}
            for name, fn in calls.items():
                want = fn()
                record = {"backend": backend, "batch": batch, "size": SIZE, "call": name,
                          "eager_ms": _ms(torch, fn)}
                try:
                    side = torch.cuda.Stream()
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        fn()
                    torch.cuda.current_stream().wait_stream(side)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        got = fn()
                    graph.replay()
                    torch.cuda.synchronize()
                    record.update(captured=True, replay_equal=bool(torch.allclose(got, want, rtol=1e-3, atol=1e-3)),
                                  replay_ms=_ms(torch, graph.replay))
                except RuntimeError as err:  # the capture was refused
                    record.update(captured=False, error=str(err).splitlines()[0][:160])
                print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
