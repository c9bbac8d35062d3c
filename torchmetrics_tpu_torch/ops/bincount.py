"""Weighted bincount: a hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``torchmetrics_tpu/ops/bincount.py`` ``weighted_bincount``
(:146), whose Pallas kernel ``_kernel`` (:38) the CUDA source
``csrc/bincount.cu`` replaces; that file's header gives the kernel's design
and its bound. ``weighted_bincount_batched`` is the counterpart of
``jax.vmap(weighted_bincount)``: S histograms in one launch, with indices
shared by all S weight rows read once. The 1-D entry is its S = 1 case.

Both entries take the plain version only for tensors that lie on the CPU. A CUDA tensor goes to the kernel or raises: a failed build, a
refused launch or a tensor the kernel does not take is an error, never a
quiet switch to another path.

The kernel is built at first use, by ``nvcc`` for ``sm_90a``, from the
source in this package into ``_build/`` beside it (``.gitignore`` lists it),
keyed by a hash of the source and flags, and loaded with ``ctypes``.

Both entries call custom operators (``torch.library.custom_op``) whose
``torch.func.vmap`` rules fold the vmapped axis into the batched kernel's
rows: the counterpart of the Pallas call's ``def_vmap`` (JAX :100-110).

Launch counts under CUDA graphs: ``weighted_bincount.launches`` is a host
counter, bumped where ``_launch`` enqueues the kernels of a call (two for
the rows plan of several sample chunks, else one). Inside a graph
capture that host code runs once and the kernel does not run at all, and a
replay runs the kernel with no host code. :func:`recording_launches` takes
the capture's counts back off, for every wrapper in ``COUNTED_KERNELS``, and
keeps them as the graph's launches per replay; :func:`count_replayed_launches`
adds them at every replay, so each counter stays the number of kernels that
ran.
"""
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bincount.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# shared memory one Hopper CTA may use (227 KB), and one SM holds (228 KB)
SMEM_BYTES = 232_448
SM_SMEM_BYTES = 233_472
# threads of every CTA the kernels launch, and the most one SM runs
THREADS = 512
SM_THREADS = 2048
# up to this many index reads, with counters that fit one CTA, one CTA counts
# everything and writes the output directly: one launch, no merge
SINGLE_CTA_INPUTS = 16_384
# a CTA of a multi-CTA shared-memory plan counts at least about this many
# inputs, so that zeroing and flushing its counters stays small against the
# counting
MIN_INPUTS_PER_CTA = 4096
# global plan (counters that do not fit one CTA): from GLOBAL_VECTOR_INPUTS
# index reads on, 16-byte vectors and GLOBAL_INPUTS_PER_CTA reads a CTA (a
# vector a thread) up to GLOBAL_CTAS_PER_SM CTAs an SM; below, and for more
# than two weight rows over a shared index, one input a thread,
# GLOBAL_SMALL_INPUTS_PER_CTA a CTA, up to one CTA an SM.
# bincount_ablation.py's sweep set all three (PERF.md)
GLOBAL_VECTOR_INPUTS = 131_072
GLOBAL_INPUTS_PER_CTA = 2048
GLOBAL_SMALL_INPUTS_PER_CTA = 512
GLOBAL_CTAS_PER_SM = SM_THREADS // THREADS
# rows plan: a shared index with at least this many float32 weight rows (one
# CTA's column tile) sums them per bin in shared memory, in a fixed order
ROWS_PLAN_MIN_ROWS = 32
# rows plan, mirrored from csrc/bincount.cu: weight rows ("columns") a warp
# owns and a CTA at most (16 warps), labels a CTA lists per block
ROWS_WARP_COLS = 64
ROWS_CTA_COLS = 1024
ROWS_BLOCK = 8192
# rows plan: samples a chunk holds at least, when chunks fill the SMs
ROWS_MIN_CHUNK = 4096
# the most CTAs along a grid's y or z
MAX_GRID_YZ = 65_535


def _nvcc(source: Path = SOURCE) -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        f"nvcc not found: the CUDA kernel in {source} is built at first use and needs the CUDA toolkit "
        "(set CUDA_HOME or put nvcc on PATH)"
    )


def build_library(source: Path, stem: str) -> Path:
    """Compile ``source`` into ``_build/lib{stem}_{hash}.so`` unless a build of
    this exact source and these flags exists.

    The library is written to a temporary file and renamed into place, so
    concurrent processes never load a half-written file. A failed ``nvcc``
    raises with its stderr.
    """
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{stem}_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(source), *NVCC_FLAGS, "-o", tmp, str(source)], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build() -> Path:
    """Compile ``csrc/bincount.cu`` (see :func:`build_library`)."""
    return build_library(SOURCE, "tm_bincount")


class _PlanStruct(ctypes.Structure):
    """Mirrors ``struct Plan`` in ``csrc/bincount.cu``."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("wrows", ctypes.c_int),
        ("num_bins", ctypes.c_int),
        ("kind", ctypes.c_int),
        ("ctas", ctypes.c_int),
        ("vectors", ctypes.c_int),
        ("tiles", ctypes.c_int),
        ("tile_bins", ctypes.c_int),
        ("chunks", ctypes.c_int),
        ("w_row_stride", ctypes.c_int),
        ("w_col_stride", ctypes.c_int),
        ("device", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.tm_bincount.argtypes = [
        ctypes.c_void_p,  # const Plan*
        ctypes.c_void_p,  # idx (int32)
        ctypes.c_void_p,  # weights (float32) or None
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # scratch (rows plan of several chunks) or None
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tm_bincount.restype = ctypes.c_int
    lib.tm_bincount_error_string.argtypes = [ctypes.c_int]
    lib.tm_bincount_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# the plan kinds, as ``struct Plan`` numbers them
KINDS = {"smem": 0, "global": 1, "rows": 2}


class LaunchPlan(NamedTuple):
    """How one call is laid out.

    ``smem``: ``ctas`` CTAs that each hold every counter in shared memory;
    several add theirs into a zeroed output. ``global``: ``ctas`` CTAs that
    add every input straight into the zeroed output. ``rows``: ``ctas`` CTAs,
    column tiles of up to 1,024 weight rows times ``tiles`` tiles of
    ``tile_bins`` bins times ``chunks`` chunks of the samples, whose sums a
    second kernel adds in chunk order. ``vectors``: the first two read
    16-byte vectors where the inputs allow, else one input a thread."""

    kind: str
    ctas: int
    tiles: int
    tile_bins: int
    chunks: int = 1
    vectors: bool = True

    @property
    def kernels(self) -> int:
        """Kernels one call runs: two for the rows plan of several chunks
        (its histogram, then the merge of the chunks), else one."""
        return 2 if self.chunks > 1 else 1


class NoLaunchPlan(ValueError):
    """No layout of the kernel fits a call (the rows plan's bin tiles past
    the grid's limit)."""


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align4(x: int) -> int:
    return _cdiv(x, 4) * 4


def smem_bytes(plan: LaunchPlan, out_rows: int) -> int:
    """Shared memory of one CTA, as the kernel lays it out: ``smem``, the
    ``out_rows`` rows of counters padded to 16-byte phase; ``global`` none;
    ``rows``, a block's list of samples, a count a warp and ``tile_bins``
    rows of float32 sums, one a column of the tile and a pad word."""
    if plan.kind == "smem":
        return _cdiv(out_rows * (_align4(plan.tile_bins) + 4) * 4, 16) * 16
    if plan.kind == "rows":
        return (ROWS_BLOCK + THREADS // 32) * 4 + plan.tile_bins * (rows_tile_cols(out_rows) + 1) * 4
    return 0


def rows_tile_cols(out_rows: int) -> int:
    """The rows plan's columns a CTA: the weight rows rounded up to a warp's
    64, at most ``ROWS_CTA_COLS``."""
    return min(ROWS_CTA_COLS, _cdiv(out_rows, ROWS_WARP_COLS) * ROWS_WARP_COLS)


def _rows_cost(n: int, out_rows: int, num_bins: int, tiles: int, chunks: int, waves: int, sm_count: int) -> float:
    """The rows plan's bytes an SM reads, for choosing its grid: each wave's
    CTA reads its chunk's labels and the weights of its tile's share of them
    (labels spread evenly over the bins), and with several chunks the second
    kernel reads the partial sums and writes the output."""
    chunk = _cdiv(n, chunks)
    per_cta = 4 * chunk + chunk / tiles * rows_tile_cols(out_rows) * 4
    merge = (chunks + 1) * out_rows * num_bins * 4 / sm_count if chunks > 1 else 0.0
    return waves * per_cta + merge


def launch_plan(n: int, rows: int, out_rows: int, num_bins: int, weighted: bool, sm_count: int) -> LaunchPlan:
    """Plan for ``rows`` index rows of ``n`` inputs into ``out_rows`` x
    ``num_bins`` counters.

    A shared index of at least ``ROWS_PLAN_MIN_ROWS`` float32 weight rows
    takes the rows plan: column tiles of up to ``ROWS_CTA_COLS`` rows, bin
    tiles of at most as many bins as shared memory holds (each tile reads
    every label and only its own samples' weights), and chunks of at least
    ``ROWS_MIN_CHUNK`` samples, at most one wave of them. Among up to twice
    the fewest bin tiles and the chunks that fit, it takes the grid whose
    SMs read the fewest bytes over its waves (``_rows_cost``). One call,
    whatever the number of rows (two kernels where there are several
    chunks: the histogram, then their merge); a fixed order of adds.

    Otherwise, when every counter fits one CTA, each CTA holds them all: one
    CTA for small calls (at most ``SINGLE_CTA_INPUTS`` index reads), else a
    grid of such CTAs reading disjoint inputs: at most one CTA per SM, at
    most what keeps the partial histograms added into the output (CTAs x
    counters x 4 bytes) within the input bytes, and at most what gives each
    CTA ``MIN_INPUTS_PER_CTA`` inputs.

    Counters that do not fit one CTA take the global plan, adding each input
    into the zeroed output with global reductions: from
    ``GLOBAL_VECTOR_INPUTS`` index reads on, 16-byte vectors and a grid of
    ``GLOBAL_INPUTS_PER_CTA`` reads a CTA, up to ``GLOBAL_CTAS_PER_SM`` CTAs
    an SM; below, and for more than two weight rows over a shared index, one
    input a thread and ``GLOBAL_SMALL_INPUTS_PER_CTA`` a CTA, up to one CTA
    an SM (bincount_ablation.py's sweep, PERF.md).
    """
    inputs = rows * n
    if weighted and rows == 1 and out_rows >= ROWS_PLAN_MIN_ROWS:
        tile_cap = (SMEM_BYTES - smem_bytes(LaunchPlan("rows", 1, 1, 0), out_rows)) // (
            (rows_tile_cols(out_rows) + 1) * 4)
        tiles = _cdiv(num_bins, tile_cap)
        if tiles > MAX_GRID_YZ:
            raise NoLaunchPlan(f"no kernel plan for {out_rows} weight rows into {num_bins} bins: "
                               f"{tiles} bin tiles of {tile_cap}")
        col_tiles = _cdiv(out_rows, rows_tile_cols(out_rows))
        best = None
        for t in range(tiles, min(2 * tiles, num_bins, MAX_GRID_YZ) + 1):
            if (t - 1) * _cdiv(num_bins, t) >= num_bins:
                continue  # the last tile would hold no bin
            plan = LaunchPlan("rows", 1, t, _cdiv(num_bins, t))
            slots = sm_count * max(1, min(SM_THREADS // THREADS, SM_SMEM_BYTES // smem_bytes(plan, out_rows)))
            for chunks in range(1, max(1, min(slots // (col_tiles * t), _cdiv(n, ROWS_MIN_CHUNK))) + 1):
                ctas = col_tiles * t * chunks
                cost = _rows_cost(n, out_rows, num_bins, t, chunks, _cdiv(ctas, slots), sm_count)
                if best is None or cost < best[0]:
                    best = (cost, plan._replace(ctas=ctas, chunks=chunks))
        return best[1]
    whole = LaunchPlan("smem", 1, 1, num_bins)
    if smem_bytes(whole, out_rows) <= SMEM_BYTES:
        if inputs <= SINGLE_CTA_INPUTS:
            return whole
        in_bytes = 4 * inputs + (4 * out_rows * n if weighted else 0)
        merge_cap = max(1, in_bytes // (4 * out_rows * num_bins))
        return whole._replace(ctas=max(1, min(sm_count, merge_cap, _cdiv(inputs, MIN_INPUTS_PER_CTA))))
    if inputs < GLOBAL_VECTOR_INPUTS or (weighted and out_rows // rows > 2):
        ctas = max(1, min(sm_count, _cdiv(inputs, GLOBAL_SMALL_INPUTS_PER_CTA)))
        return LaunchPlan("global", ctas, 1, num_bins, vectors=False)
    ctas = max(1, min(sm_count * GLOBAL_CTAS_PER_SM, _cdiv(inputs, GLOBAL_INPUTS_PER_CTA)))
    return LaunchPlan("global", ctas, 1, num_bins)


@functools.lru_cache(maxsize=None)
def _kernel_plan(device_index: int, n: int, rows: int, out_rows: int, num_bins: int, weighted: bool) -> tuple:
    """(plan, plan structure, its address), built once per shape; the cache
    keeps the structure alive for its address. The structure's weight
    strides are those of contiguous rows; the rows plan's come from
    :func:`_rows_struct`."""
    p = launch_plan(n, rows, out_rows, num_bins, weighted, _sm_count(device_index))
    st = _plan_struct(p, device_index, n, rows, out_rows, num_bins, (n, 1))
    return p, st, ctypes.addressof(st)


def _plan_struct(p: LaunchPlan, device_index: int, n: int, rows: int, out_rows: int, num_bins: int,
                 w_strides: tuple) -> _PlanStruct:
    return _PlanStruct(n, rows, out_rows if rows == 1 else 1, num_bins, KINDS[p.kind], p.ctas, int(p.vectors),
                       p.tiles, p.tile_bins, p.chunks, *w_strides, device_index)


@functools.lru_cache(maxsize=None)
def _rows_struct(device_index: int, n: int, out_rows: int, num_bins: int, w_strides: tuple) -> tuple:
    """(plan structure, its address) of a rows-plan call whose weights lie
    with (row, input) strides ``w_strides`` in elements."""
    p = _kernel_plan(device_index, n, 1, out_rows, num_bins, True)[0]
    st = _plan_struct(p, device_index, n, 1, out_rows, num_bins, w_strides)
    return st, ctypes.addressof(st)


def weighted_bincount_batched_plain(idx: torch.Tensor, weights: Optional[torch.Tensor],
                                    num_bins: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` over row-offset indices.

    ``idx`` (S, N), or (N,) shared when ``weights`` (S, N) is given; out
    (S, num_bins), int32 when unweighted, float32 when weighted
    (``torch.bincount`` would give int64 and float64 on the CPU).
    Out-of-range entries are sent to counter 0 with weight 0, so there is no
    boolean indexing and no host sync.
    """
    rows = idx.shape[0] if weights is None else weights.shape[0]
    idx = idx.expand(rows, idx.shape[-1])
    valid = (idx >= 0) & (idx < num_bins)
    offsets = torch.arange(rows, device=idx.device)[:, None] * num_bins
    flat = torch.where(valid, idx.to(torch.int64) + offsets, 0).reshape(-1)
    if weights is None:
        w = valid.to(torch.int32)
        out = torch.zeros(rows * num_bins, dtype=torch.int32, device=idx.device)
    else:
        w = torch.where(valid, weights.to(torch.float32), 0.0)
        out = torch.zeros(rows * num_bins, dtype=torch.float32, device=idx.device)
    return out.index_add_(0, flat, w.reshape(-1)).reshape(rows, num_bins)


def weighted_bincount_plain(idx: torch.Tensor, weights: Optional[torch.Tensor], num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of the 1-D entry: the batched one at S = 1."""
    w = None if weights is None else weights.reshape(1, -1)
    return weighted_bincount_batched_plain(idx.reshape(1, -1), w, num_bins)[0]


def _kernel_weights(plan: LaunchPlan, weights: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The weights as the kernel reads them: the rows plan's as they lie,
    copied only where a stride would not fit an int32; the other plans' as
    contiguous rows."""
    if weights is None:
        return None
    if plan.kind != "rows" or max(weights.stride()) >= 2**31:
        return weights.contiguous()
    return weights


def _launch(idx: torch.Tensor, weights: Optional[torch.Tensor], num_bins: int, out_rows: int) -> torch.Tensor:
    """One call of the kernel for (out_rows, num_bins) counters; ``idx`` is
    (N,) or (out_rows, N) int32, ``weights`` (out_rows, N) float32 or None.
    The rows plan reads the weights through their strides (the transpose of
    a contiguous (N, S) matrix, strides (1, S), as it lies; see
    :func:`_kernel_weights`). Counts the kernels the call ran: two for the rows plan of several
    chunks, else one."""
    dtype = torch.int32 if weights is None else torch.float32
    n = idx.shape[-1]
    rows = idx.shape[0] if idx.dim() == 2 else 1
    out = torch.empty((out_rows, num_bins), dtype=dtype, device=idx.device)
    if n == 0:
        return out.zero_()
    if rows * n >= 2**31 or out_rows * n >= 2**31 or out_rows * num_bins >= 2**31:
        raise ValueError(f"weighted_bincount kernel counts below 2^31 inputs and counters, got "
                         f"{rows} x {n} indices, {out_rows} x {num_bins} counters")
    idx = idx.contiguous()
    device = idx.device.index
    plan, _, st = _kernel_plan(device, n, rows, out_rows, num_bins, weights is not None)
    weights = _kernel_weights(plan, weights)
    scratch = None
    if plan.kind == "rows":
        _, st = _rows_struct(device, n, out_rows, num_bins, weights.stride())
        if plan.chunks > 1:
            scratch = torch.empty((plan.chunks, out_rows, num_bins), dtype=torch.float32, device=idx.device)
    lib = _library()
    err = lib.tm_bincount(
        st,
        idx.data_ptr(),
        None if weights is None else weights.data_ptr(),
        out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(idx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"weighted_bincount kernel launch failed: cudaError {err} "
                           f"({lib.tm_bincount_error_string(err).decode()})")
    weighted_bincount.launches += plan.kernels
    if _RECORDING:
        note_launch("weighted_bincount", bound_bytes(idx, weights, num_bins))
        if plan.chunks > 1:  # the merge reads the chunks' sums and writes the output
            note_launch("weighted_bincount", (plan.chunks + 1) * out_rows * num_bins * 4)
    return out


def bound_bytes(idx: torch.Tensor, w: Optional[torch.Tensor], bins: int) -> int:
    """Least bytes one call moves: every input read once (indices as
    int32, weights as float32), the output written once. ``idx`` is (N,)
    or (S, N), ``w`` None, (N,) or (S, N)."""
    n = idx.shape[-1]
    rows = idx.shape[0] if idx.dim() == 2 else 1
    s = w.shape[0] if w is not None and w.dim() == 2 else rows
    w_bytes = 0 if w is None else s * n * 4
    return rows * n * 4 + w_bytes + s * bins * 4


def _as_int32_indices(idx: torch.Tensor) -> torch.Tensor:
    if idx.dtype == torch.int32:
        return idx
    if idx.is_floating_point() or idx.is_complex():
        raise TypeError(f"weighted_bincount needs integer indices, got {idx.dtype}")
    return idx.to(torch.int32)


def _on_kernel_device(idx: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA ones (kernel)."""
    if idx.device.type == "cpu":
        return False
    if idx.device.type != "cuda":
        raise ValueError(f"weighted_bincount runs on CUDA or CPU tensors, got {idx.device}")
    return True


# The two entries run as custom operators, so that ``torch.func.vmap``
# batches through them by the rules below (the counterpart of the Pallas
# call's ``def_vmap``, JAX ``ops/bincount.py:100-110``): the vmapped axis is
# folded into the batched entry's S rows, so one launch covers the whole
# vmapped axis (every tenant of a ``TenantStack``). Each operator's body
# takes the plain version for CPU tensors and launches the kernel for CUDA
# ones, and counts the launch there.
@torch.library.custom_op("torchmetrics_tpu_torch::weighted_bincount", mutates_args=())
def _bincount_op(idx: torch.Tensor, weights: Optional[torch.Tensor], num_bins: int) -> torch.Tensor:
    if not _on_kernel_device(idx):
        return weighted_bincount_plain(idx, weights, num_bins)
    return _launch(idx, None if weights is None else weights.view(1, -1), num_bins, 1).view(num_bins)


@torch.library.custom_op("torchmetrics_tpu_torch::weighted_bincount_batched", mutates_args=())
def _bincount_batched_op(idx: torch.Tensor, weights: Optional[torch.Tensor], num_bins: int) -> torch.Tensor:
    if not _on_kernel_device(idx):
        return weighted_bincount_batched_plain(idx, weights, num_bins)
    return _launch(idx, weights, num_bins, idx.shape[0] if weights is None else weights.shape[0])


@_bincount_op.register_fake
def _(idx, weights, num_bins):
    return idx.new_empty((num_bins,), dtype=torch.int32 if weights is None else torch.float32)


@_bincount_batched_op.register_fake
def _(idx, weights, num_bins):
    rows = idx.shape[0] if weights is None else weights.shape[0]
    return idx.new_empty((rows, num_bins), dtype=torch.int32 if weights is None else torch.float32)


def _batched_first(x: Optional[torch.Tensor], dim: Optional[int], size: int) -> Optional[torch.Tensor]:
    """``x`` with its vmapped axis first, or broadcast along a new first axis."""
    if x is None:
        return None
    return x.movedim(dim, 0) if dim is not None else x.expand(size, *x.shape)


@_bincount_op.register_vmap
def _(info, in_dims, idx, weights, num_bins):
    """B 1-D calls are one batched call of B rows: over the shared index when
    only the weights are batched, else over B rows of indices."""
    idx_dim, w_dim = in_dims[:2]
    if idx_dim is None:  # one index shared by B weight rows: read once
        return _bincount_batched_op(idx, weights.movedim(w_dim, 0), num_bins), 0
    rows = idx.movedim(idx_dim, 0)
    return _bincount_batched_op(rows, _batched_first(weights, w_dim, info.batch_size), num_bins), 0


@_bincount_batched_op.register_vmap
def _(info, in_dims, idx, weights, num_bins):
    """B batched calls of S rows are one call of B * S rows; an index shared
    by the S rows of each call stays shared when it is not batched."""
    b = info.batch_size
    idx_dim, w_dim = in_dims[:2]
    if weights is None:
        rows = idx.movedim(idx_dim, 0)
        s, n = rows.shape[1], rows.shape[2]
        return _bincount_batched_op(rows.reshape(b * s, n), None, num_bins).view(b, s, num_bins), 0
    w = _batched_first(weights, w_dim, b)
    s, n = w.shape[1], w.shape[2]
    if idx_dim is None and idx.dim() == 1:  # one index for every row of every call
        out = _bincount_batched_op(idx, w.reshape(b * s, n), num_bins)
    else:
        rows = _batched_first(idx, idx_dim, b)
        rows = rows.unsqueeze(1).expand(b, s, n) if rows.dim() == 2 else rows
        out = _bincount_batched_op(rows.reshape(b * s, n), w.reshape(b * s, n), num_bins)
    return out.view(b, s, num_bins), 0


def _weights_of(weights: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Float32 weights on the indices' device, cut off from autograd (the
    kernel has no gradient, and a state must not hold a graph)."""
    if weights.device != idx.device:
        raise ValueError(f"weights on {weights.device} but indices on {idx.device}")
    return weights.detach().to(torch.float32)


def weighted_bincount_batched(idx: torch.Tensor, weights: Optional[torch.Tensor] = None,
                              num_bins: int = 0) -> torch.Tensor:
    """S weighted bincounts in one kernel launch: ``jax.vmap`` of
    ``weighted_bincount`` over a leading axis.

    ``weights`` is (S, N) or ``None`` for int32 counts; ``idx`` is (S, N),
    or (N,) shared by all S weight rows, whose indices the kernel then reads
    once for all of them. Returns (S, num_bins). A shared index of at least
    ``ROWS_PLAN_MIN_ROWS`` float32 rows takes the rows plan (see
    :func:`launch_plan`): one call for any S, the weights read through
    their strides (the transpose ``data.T`` of (N, D) features without a
    copy), and sums added in a fixed order, so that two runs give the same
    bits. The 1-D contract holds per
    row: indices cast to int32, out-of-range ones dropped, ``N == 0`` gives
    zeros, ``num_bins <= 0`` raises.

    CPU tensors take :func:`weighted_bincount_batched_plain`; CUDA tensors
    launch the kernel, and ``weighted_bincount.launches`` counts each
    kernel a call runs (``LaunchPlan.kernels``). Under
    ``torch.func.vmap`` the vmapped calls are one call of more rows.
    """
    if num_bins <= 0:
        raise ValueError(f"num_bins must be positive, got {num_bins}")
    idx = _as_int32_indices(idx)
    if weights is None:
        if idx.dim() != 2:
            raise ValueError(f"weights=None needs (S, N) indices, got shape {tuple(idx.shape)}")
    else:
        if weights.dim() != 2:
            raise ValueError(f"weights must be (S, N), got shape {tuple(weights.shape)}")
        rows, n = weights.shape
        if tuple(idx.shape) not in ((n,), (rows, n)):
            raise ValueError(f"indices of shape {tuple(idx.shape)} for weights of shape {(rows, n)}")
        weights = _weights_of(weights, idx)
    _on_kernel_device(idx)
    return _bincount_batched_op(idx, weights, num_bins)


def weighted_bincount(idx: torch.Tensor, weights: Optional[torch.Tensor] = None,
                      num_bins: int = 0) -> torch.Tensor:
    """Sum of weights per bin over int indices in ``[0, num_bins)``.

    Indices are flattened and cast to int32; negative and out-of-range
    indices contribute nothing. ``weights=None`` counts in int32 (exact);
    weights accumulate in float32. ``n == 0`` gives zeros and
    ``num_bins <= 0`` raises, as in the JAX package.

    CPU tensors take :func:`weighted_bincount_plain`; CUDA tensors launch the
    kernel (the batched one at S = 1), and ``weighted_bincount.launches``
    counts those launches, the batched entry's included. Under
    ``torch.func.vmap`` the vmapped calls are one batched launch.
    """
    if num_bins <= 0:
        raise ValueError(f"num_bins must be positive, got {num_bins}")
    idx = _as_int32_indices(idx.reshape(-1))
    if weights is not None:
        weights = _weights_of(weights, idx).reshape(-1)
        if weights.numel() != idx.numel():
            raise ValueError(f"{weights.numel()} weights for {idx.numel()} indices")
    _on_kernel_device(idx)
    return _bincount_op(idx, weights, num_bins)


weighted_bincount.launches = 0

# every kernel's wrapper whose ``launches`` a CUDA graph records and replays
# (ops.tdigest adds its own)
COUNTED_KERNELS = [weighted_bincount]


def note_launch(kernel: str, nbytes: int) -> None:
    """One launch of ``kernel`` moving ``nbytes`` by its bound, into every
    open :func:`recording_launches` record (the ledger's count of a graph's
    launches)."""
    for record in _RECORDING:
        record.bytes_each.append((kernel, int(nbytes)))


# the records of the captures in progress; each counted kernel's wrapper
# notes its launches into them
_RECORDING: list = []


class LaunchRecord:
    """The kernel launches a CUDA graph recorded at capture: each replay runs
    them. ``counts`` is per counted wrapper; ``count`` the bincount's;
    ``bytes_each`` every launch as ``(kernel, bound bytes)``."""

    __slots__ = ("counts", "bytes_each")

    def __init__(self) -> None:
        self.counts = {}
        self.bytes_each = []

    @property
    def count(self) -> int:
        return self.counts.get(weighted_bincount, 0)


@contextlib.contextmanager
def recording_launches():
    """Around a CUDA graph capture: the launches counted inside the block
    were recorded, not run, so the block leaves every counter of
    ``COUNTED_KERNELS`` as it found it and reports them in the yielded
    :class:`LaunchRecord`."""
    record = LaunchRecord()
    before = {fn: fn.launches for fn in COUNTED_KERNELS}
    _RECORDING.append(record)
    try:
        yield record
    finally:
        _RECORDING.remove(record)
        for fn, n in before.items():
            record.counts[fn] = fn.launches - n
            fn.launches = n


def count_replayed_launches(record: LaunchRecord) -> None:
    """One replay of a captured graph ran the launches it recorded."""
    for fn, n in record.counts.items():
        fn.launches += n
