"""t-digest compression: a hand-written CUDA kernel and its plain PyTorch version.

``tdigest_compress_sorted(centroids, compression)`` compresses S digests'
sorted centroid lists, ``(S, M, 2)`` float32 ``[mean, weight]``, into
``(S, C, 2)``: the part of ``torchmetrics_tpu/sketches/tdigest.py``
``tdigest_compress`` (:65-96) after its lexsort, whose greedy slot
assignment is a sequential ``lax.scan`` (:78-88) that PyTorch cannot
compile. The CUDA source ``csrc/tdigest.cu`` gives the arithmetic, the
design and the bound; it is not a TPU kernel but the counterpart of an XLA
scan. The kernel is built at first use by ``nvcc`` for ``sm_90a`` into
``_build/`` (:func:`~torchmetrics_tpu_torch.ops.bincount.build_library`) and
loaded with ``ctypes``.

CPU tensors take :func:`tdigest_compress_sorted_plain`, the same float32
arithmetic in the same order; a CUDA tensor launches the kernel or raises.
The entry runs as a custom operator whose ``torch.func.vmap`` rule folds the
vmapped axis into S, so a vmapped update or merge (``TenantStack``,
``StackedMerge``, the windowed ring's merge) is one launch.
``tdigest_compress_sorted.launches`` counts launches; CUDA graphs record
and replay it as they do the bincount's (``bincount.COUNTED_KERNELS``).
"""
import ctypes
import functools
import math
from pathlib import Path

import torch

from . import bincount
from .bincount import COUNTED_KERNELS, build_library

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tdigest.cu"
# smallest positive divisor (float32 rounds it to a subnormal), as the JAX package clamps
TINY = 1e-38
# centroids each digest's walk tests per round in the plain version
PLAIN_WINDOW = 512
# the running sum's block: each block of BLOCK weights is one float64 chain in
# order, and the block totals are another (csrc/tdigest.cu kBlock)
BLOCK = 256
# CTAs (a thread-block cluster) that share one digest, at most (the kernel
# takes 8 where the card cannot place a cluster of 16), and the fewest
# centroids for which the kernel spreads a digest over more than one
CLUSTER_MAX = 16
CLUSTER_MIN_M = 8192


def build() -> Path:
    """Compile ``csrc/tdigest.cu`` unless a build of this exact source exists."""
    return build_library(SOURCE, "tm_tdigest")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.tm_tdigest_compress.argtypes = [
        ctypes.c_void_p,  # in (S, M, 2) float32
        ctypes.c_int,  # S
        ctypes.c_int,  # M
        ctypes.c_int,  # C
        ctypes.c_float,  # k1 scale
        ctypes.c_int,  # CTAs per digest
        ctypes.c_void_p,  # block offsets and total scratch (S, ceil(M / BLOCK) + 1) float64
        ctypes.c_void_p,  # k-value scratch (S, kv_floats(M)) float32
        ctypes.c_void_p,  # slot-start scratch (S, C + 1) int32
        ctypes.c_void_p,  # out (S, C, 2) float32
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.tm_tdigest_compress.restype = ctypes.c_int
    lib.tm_tdigest_prepare.argtypes = []
    lib.tm_tdigest_prepare.restype = ctypes.c_int
    lib.tm_tdigest_error_string.argtypes = [ctypes.c_int]
    lib.tm_tdigest_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _prepared(index: int) -> ctypes.CDLL:
    """The library, set up on card ``index`` (the kernel's shared-memory and
    cluster limits raised, the largest cluster the card can place found):
    once per card, at its first launch (a graph capture's warm-up launch
    comes before the capture)."""
    lib = _library()
    with torch.cuda.device(index):
        err = lib.tm_tdigest_prepare()
    if err != 0:
        raise RuntimeError(f"tdigest_compress kernel setup failed: cudaError {err} "
                           f"({lib.tm_tdigest_error_string(err).decode()})")
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kv_floats(m: int) -> int:
    """Floats of one digest's k-value scratch (csrc/tdigest.cu ``kv_stride``):
    M rounded up to whole strips of 32, twice, and the strip maxima rounded up
    to a multiple of 4."""
    mp = -(-m // 32) * 32
    return 2 * mp + -(-(mp // 32) // 4) * 4


def cluster_size(s: int, m: int, sms: int) -> int:
    """CTAs that share each digest: 1 for small digests or when S digests
    fill the card's ``sms`` multiprocessors, else the largest power of two
    up to ``CLUSTER_MAX`` that S clusters still fit."""
    if m < CLUSTER_MIN_M:
        return 1
    fit = max(1, min(CLUSTER_MAX, sms // s))
    return 1 << (fit.bit_length() - 1)


def delta_of(compression: int) -> float:
    """k1 scale ``δ = 2(C − 2)`` of a C-slot digest (JAX ``tdigest_delta``)."""
    return float(2 * (compression - 2))


@functools.lru_cache(maxsize=None)
def k_scale_factor(compression: int) -> float:
    """``float32(δ / 2π)``, the factor of ``k(q)``."""
    return float(torch.tensor(delta_of(compression) / (2.0 * math.pi), dtype=torch.float32))


def k_scale(q: Tensor, compression: int) -> Tensor:
    """``k(q) = asin(2·clamp(q, 0, 1) − 1)·float32(δ/2π)`` in float32."""
    return torch.asin(torch.clamp(q, 0.0, 1.0) * 2.0 - 1.0) * k_scale_factor(compression)


def blocked_running_sum(w: Tensor) -> Tensor:
    """The kernel's running weight of ``(S, M)`` float32 weights, in float32.

    Each block of ``BLOCK`` weights is summed in order in float64, the block
    totals are summed in order in float64 (the first block's offset is 0
    exactly), and each prefix is its block's offset plus the within-block
    prefix, one float64 add, rounded once to float32. M is padded to a
    multiple of ``BLOCK`` with zero weights (adding 0.0 is exact), and
    ``torch.cumsum`` is sequential along a row on the CPU. While the weights
    are integers below 2^24 every partial sum is exact, so this equals the
    sequential float64 sum, and JAX's float32 cumsum, bitwise.
    """
    s, m = w.shape
    nb = -(-m // BLOCK)
    padded = torch.zeros((s, nb * BLOCK), dtype=torch.float64, device=w.device)
    padded[:, :m] = w
    within = torch.cumsum(padded.view(s, nb, BLOCK), dim=-1)
    totals = torch.cumsum(within[..., -1], dim=-1)
    offset = torch.cat([torch.zeros((s, 1), dtype=torch.float64, device=w.device), totals[:, :-1]], dim=1)
    return (offset[..., None] + within).view(s, nb * BLOCK)[:, :m].to(torch.float32)


def tdigest_compress_sorted_plain(centroids: Tensor, compression: int) -> Tensor:
    """Plain PyTorch version of the kernel, on any device.

    The running weight is :func:`blocked_running_sum`, the kernel's order. The
    scan is walked for all S digests together: each round tests the next
    ``PLAIN_WINDOW`` centroids of every digest against its current
    ``k_start`` and stops each digest at its first opening, which is the
    sequential scan exactly. The per-slot sums are one ``index_add_`` in
    sorted order (sequential on the CPU; float32 atomics on a card, where
    integer weights still sum exactly).
    """
    s, m, _ = centroids.shape
    dev = centroids.device
    mean, w = centroids[..., 0], centroids[..., 1]
    cum = blocked_running_sum(w)
    safe = torch.clamp(cum[:, -1:], min=TINY)
    q_left = (cum - w) / safe
    k_right = k_scale(cum / safe, compression)
    k_left = k_scale(q_left, compression)
    may_open = (w > 0) & (q_left > 0)

    opens = torch.zeros((s, m), dtype=torch.int32, device=dev)
    pos = torch.zeros(s, dtype=torch.int64, device=dev)
    k_start = k_scale(torch.zeros(s, device=dev), compression)
    window = torch.arange(PLAIN_WINDOW, device=dev)
    while bool((pos < m).any()):
        at = pos[:, None] + window
        inside = at < m
        at = torch.clamp(at, max=m - 1)
        hit = inside & may_open.gather(1, at) & ((k_right.gather(1, at) - k_start[:, None]) > 1.0)
        found = hit.any(dim=1)
        first = torch.clamp(pos + hit.to(torch.int8).argmax(dim=1), max=m - 1)
        opens.scatter_add_(1, first[:, None], found[:, None].to(torch.int32))
        k_start = torch.where(found, k_left.gather(1, first[:, None])[:, 0], k_start)
        pos = torch.where(found, first + 1, pos + PLAIN_WINDOW)
    slots = torch.clamp(torch.cumsum(opens, dim=1), max=compression - 1)

    valid = w > 0
    w_masked = torch.where(valid, w, 0.0)
    mw = torch.where(valid, mean, 0.0) * w_masked
    flat = (slots + torch.arange(s, device=dev)[:, None] * compression).reshape(-1)
    sum_w = torch.zeros(s * compression, device=dev).index_add_(0, flat, w_masked.reshape(-1))
    sum_mw = torch.zeros(s * compression, device=dev).index_add_(0, flat, mw.reshape(-1))
    new_mean = torch.where(sum_w > 0, sum_mw / torch.clamp(sum_w, min=TINY), math.inf)
    return torch.stack([new_mean, sum_w], dim=-1).view(s, compression, 2)


def _launch(centroids: Tensor, compression: int) -> Tensor:
    s, m, _ = centroids.shape
    x = centroids.contiguous()
    if x.data_ptr() % 8:
        x = x.clone()
    if s * m >= 2**31 or s * compression >= 2**31:
        raise ValueError(f"tdigest_compress kernel takes fewer than 2^31 centroids, got {s} x {m}")
    index = x.device.index
    lib = _prepared(index)
    out = torch.empty((s, compression, 2), dtype=torch.float32, device=x.device)
    wsum = torch.empty((s, -(-m // BLOCK) + 1), dtype=torch.float64, device=x.device)
    kv = torch.empty((s, kv_floats(m)), dtype=torch.float32, device=x.device)
    starts = torch.empty((s, compression + 1), dtype=torch.int32, device=x.device)
    err = lib.tm_tdigest_compress(x.data_ptr(), s, m, compression, k_scale_factor(compression),
                                  cluster_size(s, m, _sm_count(index)), wsum.data_ptr(), kv.data_ptr(),
                                  starts.data_ptr(), out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tdigest_compress kernel launch failed: cudaError {err} "
                           f"({lib.tm_tdigest_error_string(err).decode()})")
    tdigest_compress_sorted.launches += 1
    if bincount._RECORDING:
        bincount.note_launch("tdigest_compress_sorted", bound_bytes(s, m, compression))
    return out


def bound_bytes(s: int, m: int, compression: int) -> int:
    """Least bytes one call moves: S·M centroids read once and S·C written
    once, float32 (mean, weight) pairs."""
    return (s * m + s * compression) * 8


@torch.library.custom_op("torchmetrics_tpu_torch::tdigest_compress_sorted", mutates_args=())
def _compress_op(centroids: Tensor, compression: int) -> Tensor:
    if centroids.device.type == "cpu":
        return tdigest_compress_sorted_plain(centroids, compression)
    return _launch(centroids, compression)


@_compress_op.register_fake
def _(centroids, compression):
    return centroids.new_empty((centroids.shape[0], compression, 2))


@_compress_op.register_vmap
def _(info, in_dims, centroids, compression):
    """B calls of S digests are one call of B * S digests."""
    x = centroids.movedim(in_dims[0], 0)
    b, s, m, _ = x.shape
    return _compress_op(x.reshape(b * s, m, 2), compression).view(b, s, compression, 2), 0


def tdigest_compress_sorted(centroids: Tensor, compression: int) -> Tensor:
    """Compress S sorted centroid lists ``(S, M, 2)`` into ``(S, C, 2)``.

    Rows are sorted by mean, ties by weight; empty centroids carry weight 0
    (and mean +inf, so they sort last). CPU tensors take the plain version;
    CUDA tensors launch the kernel (one cluster of CTAs per digest), counted in
    ``tdigest_compress_sorted.launches``.
    """
    if centroids.dim() != 3 or centroids.shape[-1] != 2:
        raise ValueError(f"centroids must be (S, M, 2), got shape {tuple(centroids.shape)}")
    if compression < 8 or centroids.shape[1] < 1:
        raise ValueError(f"compression must be >= 8 and M >= 1, got {compression} and {centroids.shape[1]}")
    if centroids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tdigest_compress runs on CUDA or CPU tensors, got {centroids.device}")
    return _compress_op(centroids.detach().to(torch.float32), compression)


tdigest_compress_sorted.launches = 0
COUNTED_KERNELS.append(tdigest_compress_sorted)
