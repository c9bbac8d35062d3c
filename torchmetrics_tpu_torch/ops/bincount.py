"""Weighted bincount: a hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``torchmetrics_tpu/ops/bincount.py`` ``weighted_bincount``
(:146), whose Pallas kernel ``_kernel`` (:38) the CUDA source
``csrc/bincount.cu`` replaces; that file's header gives the kernel's design
and its bound.

``weighted_bincount`` takes the plain version only for tensors that lie on
the CPU. A CUDA tensor goes to the kernel or raises: a failed build, a
refused launch or a tensor the kernel does not take is an error, never a
quiet switch to another path.

The kernel is built at first use, by ``nvcc`` for ``sm_90a``, from the
source in this package into ``_build/`` beside it (``.gitignore`` lists it),
keyed by a hash of the source and flags, and loaded with ``ctypes``.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bincount.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# 48 Ki four-byte bins (192 KiB) per block, under the 227 KB of shared memory
# a Hopper block may use; more bins are tiled over the grid's second axis
MAX_TILE_BINS = 48 * 1024
# a block counts at least this many inputs, so zeroing and writing its
# partial histogram never costs more than the counting itself
_MIN_INPUTS_PER_BLOCK = 4096


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the weighted_bincount CUDA kernel is built from "
        f"{SOURCE} at first use and needs the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def build() -> Path:
    """Compile ``csrc/bincount.cu`` unless a build of this exact source exists.

    The library is written to a temporary file and renamed into place, so
    concurrent processes never load a half-written file. A failed ``nvcc``
    raises with its stderr.
    """
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libtm_bincount_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {SOURCE} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.tm_weighted_bincount
    fn.argtypes = [
        ctypes.c_void_p,  # idx (int32)
        ctypes.c_void_p,  # weights (float32) or None
        ctypes.c_longlong,  # n
        ctypes.c_int,  # num_bins
        ctypes.c_int,  # grid_x
        ctypes.c_int,  # tile_bins
        ctypes.c_void_p,  # partial scratch or None
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_plan(n: int, num_bins: int, sm_count: int) -> tuple:
    """``(grid_x, tile_bins)`` for one launch: bins split into equal tiles of
    at most ``MAX_TILE_BINS``; inputs split over at most about two blocks per
    SM in all, each block taking at least ``max(4096, tile_bins)`` inputs."""
    tiles = -(-num_bins // MAX_TILE_BINS)
    tile_bins = -(-num_bins // tiles)
    per_block = max(_MIN_INPUTS_PER_BLOCK, tile_bins)
    grid_x = max(1, min(-(-n // per_block), (2 * sm_count) // tiles))
    return grid_x, tile_bins


def weighted_bincount_plain(idx: torch.Tensor, weights: Optional[torch.Tensor], num_bins: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` over the in-range indices.

    int32 out when unweighted, float32 when weighted (``torch.bincount``
    would give int64 and float64 on the CPU). Out-of-range entries are sent
    to bin 0 with weight 0, so there is no boolean indexing and no host sync.
    """
    idx = idx.reshape(-1)
    valid = (idx >= 0) & (idx < num_bins)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).to(torch.int64)
    if weights is None:
        w = valid.to(torch.int32)
        out = torch.zeros(num_bins, dtype=torch.int32, device=idx.device)
    else:
        w = torch.where(valid, weights.reshape(-1).to(torch.float32), 0.0)
        out = torch.zeros(num_bins, dtype=torch.float32, device=idx.device)
    return out.index_add_(0, safe, w)


def _launch(idx: torch.Tensor, weights: Optional[torch.Tensor], num_bins: int) -> torch.Tensor:
    dtype = torch.int32 if weights is None else torch.float32
    n = idx.numel()
    out = torch.empty(num_bins, dtype=dtype, device=idx.device)
    if n == 0:
        return out.zero_()
    if not idx.is_contiguous() or (weights is not None and not weights.is_contiguous()):
        raise ValueError("weighted_bincount kernel needs contiguous idx and weights")
    fn = _library().tm_weighted_bincount
    with torch.cuda.device(idx.device):
        grid_x, tile_bins = launch_plan(n, num_bins, _sm_count(idx.device.index))
        partial = torch.empty(grid_x * num_bins, dtype=dtype, device=idx.device) if grid_x > 1 else None
        err = fn(
            idx.data_ptr(),
            None if weights is None else weights.data_ptr(),
            n,
            num_bins,
            grid_x,
            tile_bins,
            None if partial is None else partial.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream(idx.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"weighted_bincount kernel launch failed with cudaError {err}")
    weighted_bincount.launches += 1
    return out


def weighted_bincount(idx: torch.Tensor, weights: Optional[torch.Tensor] = None,
                      num_bins: int = 0) -> torch.Tensor:
    """Sum of weights per bin over int indices in ``[0, num_bins)``.

    Indices are flattened and cast to int32; negative and out-of-range
    indices contribute nothing. ``weights=None`` counts in int32 (exact);
    weights accumulate in float32. ``n == 0`` gives zeros and
    ``num_bins <= 0`` raises, as in the JAX package.

    CPU tensors take :func:`weighted_bincount_plain`; CUDA tensors launch the
    kernel, and ``weighted_bincount.launches`` counts those launches.
    """
    if num_bins <= 0:
        raise ValueError(f"num_bins must be positive, got {num_bins}")
    idx = idx.reshape(-1)
    if idx.dtype != torch.int32:
        if idx.is_floating_point() or idx.is_complex():
            raise TypeError(f"weighted_bincount needs integer indices, got {idx.dtype}")
        idx = idx.to(torch.int32)
    if weights is not None:
        if weights.device != idx.device:
            raise ValueError(f"weights on {weights.device} but indices on {idx.device}")
        weights = weights.reshape(-1)
        if weights.numel() != idx.numel():
            raise ValueError(f"{weights.numel()} weights for {idx.numel()} indices")
        if weights.dtype != torch.float32:
            weights = weights.to(torch.float32)
    if idx.device.type == "cpu":
        return weighted_bincount_plain(idx, weights, num_bins)
    if idx.device.type != "cuda":
        raise ValueError(f"weighted_bincount runs on CUDA or CPU tensors, got {idx.device}")
    return _launch(idx, weights, num_bins)


weighted_bincount.launches = 0
