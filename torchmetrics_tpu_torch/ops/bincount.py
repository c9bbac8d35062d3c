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
counter, bumped where ``_launch`` enqueues the kernel. Inside a graph
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

# shared memory one Hopper CTA may use (227 KB)
SMEM_BYTES = 232_448
# CTAs per cluster: clusters above 8 are non-portable, and 16 is the most Hopper launches
MAX_CLUSTER = 16
# up to this many index reads, with counters that fit one CTA, one CTA counts
# everything and writes the output directly: one launch, no merge
SINGLE_CTA_INPUTS = 16_384
# a CTA of a multi-CTA plan counts at least about this many inputs, so that
# zeroing and flushing its counters stays small against the counting
MIN_INPUTS_PER_CTA = 4096
# clusters larger than this are used only when the bins need them: every CTA
# of a cluster receives all of the cluster's inputs, and clusters of 8 and 16
# measured slower than clusters of 4 at the same or more CTAs
# (bincount_ablation.py, PERF.md)
PREFERRED_CLUSTER = 4
# 16-byte vectors of each input stream each CTA of a cluster brings in per
# stage (of two): at least 32 so a stage is worth its cluster barrier, at
# most 1024 (16 KB)
MIN_STAGE_VECTORS = 32
MAX_STAGE_VECTORS = 1024
# sparse plan: when the counters do not fit one CTA and each output row gets
# at most 1/SPARSE_BINS_PER_INPUT as many inputs as it has bins, every input
# is added straight into the zeroed output with a global atomic.
# bincount_ablation.py's sweep measured it faster than the cluster plans at
# every point, from 1,000 bins per input to 16 inputs per bin (PERF.md); 2
# is the lowest ratio that keeps every plan measured before it (the
# past-cluster case has ratio 1)
SPARSE_BINS_PER_INPUT = 2
# index reads per CTA of the sparse plan before its grid reaches one CTA per
# SM: one for each of the kernel's 512 threads
SPARSE_INPUTS_PER_CTA = 512


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
        ("clusters", ctypes.c_int),
        ("cluster", ctypes.c_int),
        ("tiles", ctypes.c_int),
        ("tile_bins", ctypes.c_int),
        ("bs", ctypes.c_int),
        ("chv", ctypes.c_int),
        ("magic", ctypes.c_ulonglong),
        ("device", ctypes.c_int),
        ("sparse", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.tm_bincount.argtypes = [
        ctypes.c_void_p,  # const Plan*
        ctypes.c_void_p,  # idx (int32)
        ctypes.c_void_p,  # weights (float32) or None
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tm_bincount.restype = ctypes.c_int
    lib.tm_bincount_error_string.argtypes = [ctypes.c_int]
    lib.tm_bincount_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class LaunchPlan(NamedTuple):
    """How one call is laid out: ``clusters`` clusters of ``cluster`` CTAs
    for each of ``tiles`` tiles of ``tile_bins`` bins; each CTA owns ``bs``
    bins of its tile in every output row and, in a cluster, brings in
    ``chv`` 16-byte vectors of each input stream per stage. More than one
    cluster per tile adds its counters into a zeroed output. A ``sparse``
    plan is ``clusters`` CTAs that add every input straight into the zeroed
    output with global atomics (``cluster`` 1, one tile of all bins)."""

    clusters: int
    cluster: int
    tiles: int
    tile_bins: int
    bs: int
    chv: int
    sparse: bool = False


class NoLaunchPlan(ValueError):
    """No layout of the kernel fits a call in shared memory (a shared index
    with more weight rows than a cluster can stage)."""


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align4(x: int) -> int:
    return _cdiv(x, 4) * 4


def smem_bytes(plan: LaunchPlan, out_rows: int, streams: int) -> int:
    """Shared memory of one CTA, as the kernel lays it out: two barriers,
    ``out_rows`` rows of counters padded to 16-byte phase and, in a cluster,
    two stages of ``cluster * chv`` vectors per input stream."""
    counters = _cdiv(out_rows * (_align4(plan.bs) + 4) * 4, 16) * 16
    stages = 2 * plan.cluster * plan.chv * 16 * streams if plan.cluster > 1 else 0
    return 16 + counters + stages


def launch_plan(n: int, rows: int, out_rows: int, num_bins: int, weighted: bool, sm_count: int) -> LaunchPlan:
    """Plan for ``rows`` index rows of ``n`` inputs into ``out_rows`` x
    ``num_bins`` counters.

    When every counter fits one CTA, each CTA holds them all: one CTA for
    small calls (at most ``SINGLE_CTA_INPUTS`` index reads), else a grid of
    such CTAs reading disjoint inputs. Otherwise the bins are split over a
    power-of-two cluster whose CTAs hold their share and two stages of at
    least ``MIN_STAGE_VECTORS`` vectors (tiled only past ``MAX_CLUSTER``
    CTAs). The number of clusters is at most one CTA per SM, at most what
    keeps the partial histograms added into the output (clusters x counters
    x 4 bytes) within the input bytes, and at most what gives each CTA
    ``MIN_INPUTS_PER_CTA`` inputs. Among the cluster sizes that fit, up to
    ``PREFERRED_CLUSTER`` or the smallest that fits, the plan takes the one
    with the most clusters, then the most CTAs.

    Counters that do not fit one CTA, for at most ``num_bins /
    SPARSE_BINS_PER_INPUT`` inputs per output row, take the sparse plan
    instead: a grid of up to one CTA per SM adding each input into the
    zeroed output with global atomics.
    """
    streams = 1 + (out_rows // rows if weighted else 0)
    hist = out_rows * num_bins
    inputs = rows * n
    in_bytes = 4 * inputs + (4 * out_rows * n if weighted else 0)
    merge_cap = max(1, in_bytes // (4 * hist))
    whole = LaunchPlan(1, 1, 1, num_bins, num_bins, 0)
    if smem_bytes(whole, out_rows, streams) <= SMEM_BYTES:
        if inputs <= SINGLE_CTA_INPUTS:
            return whole
        clusters = min(sm_count, merge_cap, _cdiv(inputs, MIN_INPUTS_PER_CTA))
        return whole._replace(clusters=max(1, clusters))
    if n * SPARSE_BINS_PER_INPUT <= num_bins:
        return whole._replace(clusters=max(1, min(sm_count, _cdiv(inputs, SPARSE_INPUTS_PER_CTA))), sparse=True)
    # a cluster stages every input stream (the index and each weight row of a
    # shared index): the smallest cluster plan, two CTAs of 4 bins each with
    # the least stages, must fit, or no number of tiles does
    if smem_bytes(LaunchPlan(1, 2, 1, 8, 4, MIN_STAGE_VECTORS), out_rows, streams) > SMEM_BYTES:
        raise NoLaunchPlan(f"no kernel plan for {out_rows} weight rows over one shared index of {n} inputs into "
                           f"{num_bins} bins: a cluster cannot stage {streams} input streams")
    tiles = 1
    while True:
        tile_bins = _align4(_cdiv(num_bins, tiles))
        best = None
        cluster = 2
        while cluster <= MAX_CLUSTER:
            plan = LaunchPlan(1, cluster, tiles, tile_bins, _align4(_cdiv(tile_bins, cluster)), 0)
            room = SMEM_BYTES - smem_bytes(plan, out_rows, streams)
            chv = min(MAX_STAGE_VECTORS, room // (2 * cluster * 16 * streams)) // 32 * 32
            if chv >= MIN_STAGE_VECTORS:
                clusters = max(1, min(sm_count // (cluster * tiles), merge_cap,
                                      _cdiv(inputs, MIN_INPUTS_PER_CTA * cluster)))
                if best is None or (clusters, cluster) > (best.clusters, best.cluster):
                    best = plan._replace(clusters=clusters, chv=chv)
                if cluster >= PREFERRED_CLUSTER:
                    return best
            cluster *= 2
        if best is not None:
            return best
        tiles += 1


@functools.lru_cache(maxsize=None)
def shared_rows_per_launch(n: int, out_rows: int, num_bins: int) -> int:
    """The most of ``out_rows`` weight rows over one shared index of ``n``
    inputs that one launch takes: all of them when the kernel has a plan for
    them, else the most whose counters fit one CTA (the plan without a
    cluster, which stages nothing), else the most a cluster can stage, at
    least 1. A call of more rows is this many rows per launch. Whether a
    plan exists does not depend on the SM count (it sets only how many
    clusters a plan has), so any count serves to ask."""
    try:
        launch_plan(n, 1, out_rows, num_bins, True, 1)
        return out_rows
    except NoLaunchPlan:
        pass
    rows = min(out_rows - 1, (SMEM_BYTES - 16) // ((_align4(num_bins) + 4) * 4))
    while rows > 1:
        try:
            launch_plan(n, 1, rows, num_bins, True, 1)
            return rows
        except NoLaunchPlan:
            rows //= 2
    return 1


def slice_magic(bs: int) -> int:
    """``ceil(2^40 / bs)``: the kernel finds the CTA that owns a bin as
    ``(b * magic) >> 40``, which equals ``b // bs`` while ``b * bs < 2^40``
    (true for every bin of a tile: both stay below 2^20)."""
    return (2**40 + bs - 1) // bs


@functools.lru_cache(maxsize=None)
def _kernel_plan(device_index: int, n: int, rows: int, out_rows: int, num_bins: int, weighted: bool) -> tuple:
    """(plan structure, its address), built once per shape; the cache keeps
    the structure alive for its address."""
    p = launch_plan(n, rows, out_rows, num_bins, weighted, _sm_count(device_index))
    st = _PlanStruct(n, rows, out_rows if rows == 1 else 1, num_bins, p.clusters, p.cluster, p.tiles, p.tile_bins,
                     p.bs, p.chv, slice_magic(p.bs), device_index, int(p.sparse))
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


def _launch(idx: torch.Tensor, weights: Optional[torch.Tensor], num_bins: int, out_rows: int) -> torch.Tensor:
    """One kernel launch for (out_rows, num_bins) counters; ``idx`` is (N,)
    or (out_rows, N) int32, ``weights`` (out_rows, N) float32 or None."""
    dtype = torch.int32 if weights is None else torch.float32
    n = idx.shape[-1]
    rows = idx.shape[0] if idx.dim() == 2 else 1
    out = torch.empty((out_rows, num_bins), dtype=dtype, device=idx.device)
    if n == 0:
        return out.zero_()
    idx = idx.contiguous()
    weights = None if weights is None else weights.contiguous()
    if rows * n >= 2**31 or out_rows * n >= 2**31 or out_rows * num_bins >= 2**31:
        raise ValueError(f"weighted_bincount kernel counts below 2^31 inputs and counters, got "
                         f"{rows} x {n} indices, {out_rows} x {num_bins} counters")
    _, plan = _kernel_plan(idx.device.index, n, rows, out_rows, num_bins, weights is not None)
    lib = _library()
    err = lib.tm_bincount(
        plan,
        idx.data_ptr(),
        None if weights is None else weights.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(idx.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"weighted_bincount kernel launch failed: cudaError {err} "
                           f"({lib.tm_bincount_error_string(err).decode()})")
    weighted_bincount.launches += 1
    return out


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
    rows = idx.shape[0] if weights is None else weights.shape[0]
    if weights is not None and idx.dim() == 1 and rows > 1:
        group = shared_rows_per_launch(idx.shape[0], rows, num_bins)
        if group < rows:  # more weight rows than one launch stages: one launch per group of rows
            return torch.cat([_launch(idx, weights[r:r + group], num_bins, min(group, rows - r))
                              for r in range(0, rows, group)])
    return _launch(idx, weights, num_bins, rows)


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
    """S weighted bincounts in one kernel launch (see below for a shared
    index with many weight rows): ``jax.vmap`` of ``weighted_bincount`` over
    a leading axis.

    ``weights`` is (S, N) or ``None`` for int32 counts; ``idx`` is (S, N),
    or (N,) shared by all S weight rows, whose indices the kernel then reads
    once for all of them. Returns (S, num_bins). A shared index with more
    weight rows than one launch stages (``shared_rows_per_launch``: 2,048
    rows over 1,000 bins take 36 launches of 57 rows) takes one launch per
    group of rows. The 1-D contract holds per
    row: indices cast to int32, out-of-range ones dropped, ``N == 0`` gives
    zeros, ``num_bins <= 0`` raises.

    CPU tensors take :func:`weighted_bincount_batched_plain`; CUDA tensors
    launch the kernel, and ``weighted_bincount.launches`` counts it. Under
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


class LaunchRecord:
    """The kernel launches a CUDA graph recorded at capture: each replay runs
    them. ``counts`` is per counted wrapper; ``count`` the bincount's."""

    __slots__ = ("counts",)

    def __init__(self) -> None:
        self.counts = {}

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
    try:
        yield record
    finally:
        for fn, n in before.items():
            record.counts[fn] = fn.launches - n
            fn.launches = n


def count_replayed_launches(record: LaunchRecord) -> None:
    """One replay of a captured graph ran the launches it recorded."""
    for fn, n in record.counts.items():
        fn.launches += n
