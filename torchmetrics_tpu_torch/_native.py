"""The host C++ library: Levenshtein, assignment, RLE, box IoU and COCO matching.

Counterpart of ``torchmetrics_tpu/_native/__init__.py``. ``csrc/tm_native.cpp``
is a byte-identical copy of the JAX package's source, built by ``g++`` with
the JAX package's flags (``-O3 -march=native -shared -fPIC -std=c++17``), so
the same compiler gives the same machine code and every result here is
bitwise the JAX package's. The flags change the arithmetic: under
``-march=native`` the compiler may contract ``a_area + b_area - inter`` in
``tm_box_iou`` into an FMA, so a build with other flags can move an IoU by
its last bit and flip a match at a threshold.

The library is built at first use into ``_build/`` beside the package
(``.gitignore`` lists it), keyed by a hash of the source, the flags and the
target ``-march=native`` resolves to on this host, written to a temporary
file and renamed into place, so concurrent processes never load a
half-written file. A missing ``g++`` or a failed build raises with the
compiler's stderr; nothing falls back to numpy.

Every entry point takes and returns numpy arrays on the host, with the JAX
package's signature. The ``*_plain`` functions are the numpy versions the
JAX package falls back to: the tests hold the C++ code against them, and no
entry point calls them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "tm_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300


def _compiler() -> str:
    path = shutil.which(CXX)
    if path is None:
        raise RuntimeError(
            f"{CXX} not found: the host library {SOURCE} is built at first use and needs {CXX} on PATH"
        )
    return path


def _native_target(cxx: str) -> str:
    """The options ``-march=native`` resolves to on this host, as ``g++``
    hands them to its C++ front end: part of the build's key, so a library
    built for one CPU is never loaded on another."""
    proc = subprocess.run([cxx, "-march=native", "-E", "-v", "-x", "c++", os.devnull, "-o", os.devnull],
                          capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    lines = [line for line in proc.stderr.splitlines() if "-march=" in line and "cc1plus" in line]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{cxx} could not resolve -march=native (exit {proc.returncode}):\n{proc.stderr}")
    return lines[0][lines[0].index("-march="):]


def build() -> Path:
    """Compile ``csrc/tm_native.cpp`` into ``_build/libtm_native_{hash}.so``
    unless that build exists; a failed ``g++`` raises with its stderr."""
    cxx = _compiler()
    src = SOURCE.read_bytes()
    key = src + " ".join(CXX_FLAGS).encode() + _native_target(cxx).encode()
    lib = BUILD_DIR / f"libtm_native_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed to build {SOURCE} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_u32 = ctypes.POINTER(ctypes.c_uint32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_f64 = ctypes.POINTER(ctypes.c_double)

    lib.tm_edit_distance_batch.restype = None
    lib.tm_edit_distance_batch.argtypes = [p_i64, p_i64, p_i64, p_i64, i64, p_i64]
    lib.tm_edit_distance_counts_batch.restype = None
    lib.tm_edit_distance_counts_batch.argtypes = [p_i64, p_i64, p_i64, p_i64, i64, p_i64]
    lib.tm_linear_sum_assignment.restype = ctypes.c_int
    lib.tm_linear_sum_assignment.argtypes = [p_f64, i64, i64, p_i64]
    lib.tm_rle_encode.restype = i64
    lib.tm_rle_encode.argtypes = [p_u8, i64, i64, p_u32]
    lib.tm_rle_decode.restype = None
    lib.tm_rle_decode.argtypes = [p_u32, i64, i64, i64, p_u8]
    lib.tm_rle_area.restype = ctypes.c_uint64
    lib.tm_rle_area.argtypes = [p_u32, i64]
    lib.tm_rle_iou.restype = None
    lib.tm_rle_iou.argtypes = [p_u32, p_i64, i64, p_u32, p_i64, i64, p_u8, p_f64]
    lib.tm_box_iou.restype = None
    lib.tm_box_iou.argtypes = [p_f64, i64, p_f64, i64, p_u8, p_f64]
    lib.tm_box_iou_batch.restype = None
    lib.tm_box_iou_batch.argtypes = [p_f64, p_i64, p_f64, p_i64, p_u8, i64, p_f64, p_i64]
    lib.tm_coco_match.restype = None
    lib.tm_coco_match.argtypes = [p_f64, i64, i64, p_u8, p_u8, p_f64, i64, p_i64, p_i64, p_u8]
    lib.tm_coco_stage_match_batch.restype = None
    lib.tm_coco_stage_match_batch.argtypes = [
        p_f64, p_i64, p_f64, p_f64, p_i64, p_f64, p_u8, p_i64, i64,
        p_f64, p_f64, i64, p_f64, i64, i64, p_i64, p_i64, p_u8, p_u8, p_i64]
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------------------------------------------------------------------
# Token packing: text metrics deal in hashable tokens (str/int); the C++ DP
# needs int64 ids. Interning is per call: only equality matters.
# ---------------------------------------------------------------------------

def _intern(seqs: Sequence[Sequence]) -> List[np.ndarray]:
    table: dict = {}
    out = []
    for s in seqs:
        ids = np.empty(len(s), dtype=np.int64)
        for i, tok in enumerate(s):
            ids[i] = table.setdefault(tok, len(table))
        out.append(ids)
    return out


def _pack(arrs: List[np.ndarray], dtype=np.int64) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a list of 1D arrays into (flat, prefix_offsets)."""
    off = np.zeros(len(arrs) + 1, dtype=np.int64)
    for i, a in enumerate(arrs):
        off[i + 1] = off[i] + len(a)
    flat = np.concatenate(arrs) if arrs else np.zeros(0, dtype=dtype)
    return np.ascontiguousarray(flat, dtype=dtype), off


def _split_interned(preds: Sequence[Sequence], targets: Sequence[Sequence]):
    if len(preds) != len(targets):
        raise ValueError(f"Expected as many predictions as targets, got {len(preds)} and {len(targets)}")
    ids = _intern(list(preds) + list(targets))
    return ids[: len(preds)], ids[len(preds):]


# ---------------------------------------------------------------------------
# Levenshtein
# ---------------------------------------------------------------------------

def edit_distance_batch(preds: Sequence[Sequence], targets: Sequence[Sequence]) -> np.ndarray:
    """Unit-cost Levenshtein distance for each (pred, target) pair."""
    p_ids, t_ids = _split_interned(preds, targets)
    p_flat, p_off = _pack(p_ids)
    t_flat, t_off = _pack(t_ids)
    out = np.empty(len(preds), dtype=np.int64)
    if len(preds):
        _library().tm_edit_distance_batch(
            _ptr(p_flat, ctypes.c_int64), _ptr(p_off, ctypes.c_int64),
            _ptr(t_flat, ctypes.c_int64), _ptr(t_off, ctypes.c_int64),
            len(preds), _ptr(out, ctypes.c_int64))
    return out


def edit_distance_counts_batch(preds: Sequence[Sequence], targets: Sequence[Sequence]) -> np.ndarray:
    """(batch, 4) int64 array of [substitutions, deletions, insertions, hits]."""
    p_ids, t_ids = _split_interned(preds, targets)
    p_flat, p_off = _pack(p_ids)
    t_flat, t_off = _pack(t_ids)
    out = np.zeros((len(preds), 4), dtype=np.int64)
    if len(preds):
        _library().tm_edit_distance_counts_batch(
            _ptr(p_flat, ctypes.c_int64), _ptr(p_off, ctypes.c_int64),
            _ptr(t_flat, ctypes.c_int64), _ptr(t_off, ctypes.c_int64),
            len(preds), _ptr(out, ctypes.c_int64))
    return out


def _edit_distance_plain(a: np.ndarray, b: np.ndarray) -> int:
    """Two-row numpy Levenshtein."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return la + lb
    prev = np.arange(lb + 1, dtype=np.int64)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        best = np.minimum(prev[1:] + 1, sub)
        for j in range(1, lb + 1):  # insertion chain
            cur[j] = min(best[j - 1], cur[j - 1] + 1)
        prev = cur
    return int(prev[-1])


def _edit_distance_counts_plain(pred: np.ndarray, tgt: np.ndarray) -> Tuple[int, int, int, int]:
    """Full DP and backtrace."""
    m, n = len(pred), len(tgt)
    dp = np.zeros((m + 1, n + 1), dtype=np.int64)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if pred[i - 1] == tgt[j - 1] else 1
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1, dp[i - 1, j - 1] + cost)
    s = d = ins = hits = 0
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (pred[i - 1] != tgt[j - 1]):
            if pred[i - 1] == tgt[j - 1]:
                hits += 1
            else:
                s += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            d += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return s, d, ins, hits


def edit_distance_batch_plain(preds: Sequence[Sequence], targets: Sequence[Sequence]) -> np.ndarray:
    p_ids, t_ids = _split_interned(preds, targets)
    return np.array([_edit_distance_plain(p, t) for p, t in zip(p_ids, t_ids)], dtype=np.int64)


def edit_distance_counts_batch_plain(preds: Sequence[Sequence], targets: Sequence[Sequence]) -> np.ndarray:
    p_ids, t_ids = _split_interned(preds, targets)
    return np.array([_edit_distance_counts_plain(p, t) for p, t in zip(p_ids, t_ids)],
                    dtype=np.int64).reshape(len(preds), 4)


# ---------------------------------------------------------------------------
# Assignment
# ---------------------------------------------------------------------------

def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum-cost assignment; same contract as scipy's for n <= m."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    transposed = n > m
    if transposed:
        cost = np.ascontiguousarray(cost.T)
        n, m = m, n
    col4row = np.empty(n, dtype=np.int64)
    rc = _library().tm_linear_sum_assignment(_ptr(cost, ctypes.c_double), n, m, _ptr(col4row, ctypes.c_int64))
    if rc != 0:
        raise ValueError("infeasible assignment problem")
    rows = np.arange(n, dtype=np.int64)
    if transposed:
        order = np.argsort(col4row)
        return col4row[order], rows[order]
    return rows, col4row


def linear_sum_assignment_plain(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """scipy's solver, the JAX package's fallback."""
    from scipy.optimize import linear_sum_assignment as sp_lsa

    r, c = sp_lsa(cost)
    return np.asarray(r, np.int64), np.asarray(c, np.int64)


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------

def rle_from_coco_string(s, h: int = 0, w: int = 0) -> np.ndarray:
    """Decode COCO's compressed RLE string (the ``counts: bytes/str`` form
    produced by pycocotools) into plain uint32 run counts.

    Format: each count is a little-endian sequence of 6-bit chunks, char =
    chunk + 48 with bit 0x20 as continuation; counts from the 3rd on are
    delta-encoded against counts[i-2].
    """
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)  # sign-extend
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.uint32)


def rle_to_coco_string(counts: np.ndarray) -> bytes:
    """Encode plain run counts into COCO's compressed RLE string."""
    counts = np.asarray(counts, dtype=np.int64)
    out = []
    for i, x in enumerate(counts.tolist()):
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out).encode("ascii")


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """COCO column-major RLE counts (uint32) of a dense (h, w) binary mask."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    buf = np.empty(h * w + 1, dtype=np.uint32)
    n = _library().tm_rle_encode(_ptr(mask, ctypes.c_uint8), h, w, _ptr(buf, ctypes.c_uint32))
    return buf[:n].copy()


def rle_decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    out = np.zeros((h, w), dtype=np.uint8)
    _library().tm_rle_decode(_ptr(counts, ctypes.c_uint32), len(counts), h, w, _ptr(out, ctypes.c_uint8))
    return out


def rle_area(counts: np.ndarray) -> int:
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    return int(_library().tm_rle_area(_ptr(counts, ctypes.c_uint32), len(counts)))


def rle_iou(dt: List[np.ndarray], gt: List[np.ndarray], iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU between RLE masks of one image extent (crowd semantics)."""
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)), dtype=np.float64)
    crowd = np.ascontiguousarray(iscrowd, dtype=np.uint8)
    dt_flat, dt_off = _pack([np.asarray(c) for c in dt], dtype=np.uint32)
    gt_flat, gt_off = _pack([np.asarray(c) for c in gt], dtype=np.uint32)
    out = np.empty((len(dt), len(gt)), dtype=np.float64)
    _library().tm_rle_iou(_ptr(dt_flat, ctypes.c_uint32), _ptr(dt_off, ctypes.c_int64), len(dt),
                          _ptr(gt_flat, ctypes.c_uint32), _ptr(gt_off, ctypes.c_int64), len(gt),
                          _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double))
    return out


def rle_to_dense_cols_plain(counts: np.ndarray) -> np.ndarray:
    """Column-major flat 0/1 expansion of RLE counts."""
    counts = np.asarray(counts, dtype=np.int64)
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    return np.repeat(vals, counts)


def rle_encode_plain(mask: np.ndarray) -> np.ndarray:
    flat = (np.asarray(mask) != 0).T.reshape(-1)  # column-major scan
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate(([0], change, [flat.size]))
    runs = np.diff(bounds)
    if flat.size and flat[0]:
        runs = np.concatenate(([0], runs))
    return runs.astype(np.uint32)


def rle_decode_plain(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    return rle_to_dense_cols_plain(counts).reshape(w, h).T.copy()


def rle_area_plain(counts: np.ndarray) -> int:
    return int(np.asarray(counts, dtype=np.int64)[1::2].sum())


def _overlap_iou_plain(inter: np.ndarray, a_dt: np.ndarray, a_gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    union = np.where(np.asarray(crowd)[None, :].astype(bool), a_dt[:, None], a_dt[:, None] + a_gt[None, :] - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def rle_iou_plain(dt: List[np.ndarray], gt: List[np.ndarray], iscrowd: np.ndarray) -> np.ndarray:
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)), dtype=np.float64)
    dtm = np.stack([rle_to_dense_cols_plain(c) for c in dt]).astype(np.float64)
    gtm = np.stack([rle_to_dense_cols_plain(c) for c in gt]).astype(np.float64)
    return _overlap_iou_plain(dtm @ gtm.T, dtm.sum(1), gtm.sum(1), iscrowd)


# ---------------------------------------------------------------------------
# Box IoU
# ---------------------------------------------------------------------------

def box_iou(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise xyxy box IoU with COCO crowd semantics."""
    dt = np.ascontiguousarray(dt, dtype=np.float64).reshape(-1, 4)
    gt = np.ascontiguousarray(gt, dtype=np.float64).reshape(-1, 4)
    crowd = np.ascontiguousarray(iscrowd, dtype=np.uint8)
    out = np.empty((len(dt), len(gt)), dtype=np.float64)
    if len(dt) and len(gt):
        _library().tm_box_iou(_ptr(dt, ctypes.c_double), len(dt), _ptr(gt, ctypes.c_double), len(gt),
                              _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double))
    return out


def box_iou_batch(
    dts: List[np.ndarray], gts: List[np.ndarray], crowds: List[np.ndarray],
    return_flat: bool = False,
):
    """Pairwise box IoU for N (dt set, gt set, gt crowd flags) cells in one
    C++ call (one ctypes round trip per cell would dominate COCO evaluation).
    Semantics per cell those of :func:`box_iou`. With ``return_flat`` also
    returns the backing ``(flat, offsets)`` buffer, which
    :func:`coco_stage_match_batch` takes as ``ious_prebuilt``."""
    n_cells = len(dts)
    if n_cells == 0:
        return ([], None) if return_flat else []
    dt_arrs = [np.ascontiguousarray(d, np.float64).reshape(-1, 4) for d in dts]
    gt_arrs = [np.ascontiguousarray(g, np.float64).reshape(-1, 4) for g in gts]
    n_dt = np.asarray([len(d) for d in dt_arrs], dtype=np.int64)
    n_gt = np.asarray([len(g) for g in gt_arrs], dtype=np.int64)
    dt_off = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(n_dt, out=dt_off[1:])
    gt_off = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(n_gt, out=gt_off[1:])
    out_off = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(n_dt * n_gt, out=out_off[1:])
    dt_flat = np.concatenate(dt_arrs) if dt_off[-1] else np.zeros((0, 4), np.float64)
    gt_flat = np.concatenate(gt_arrs) if gt_off[-1] else np.zeros((0, 4), np.float64)
    crowd_flat = (np.concatenate([np.ascontiguousarray(c, np.uint8) for c in crowds])
                  if gt_off[-1] else np.zeros(0, np.uint8))
    out_flat = np.empty(int(out_off[-1]), dtype=np.float64)
    _library().tm_box_iou_batch(_ptr(dt_flat, ctypes.c_double), _ptr(dt_off, ctypes.c_int64),
                                _ptr(gt_flat, ctypes.c_double), _ptr(gt_off, ctypes.c_int64),
                                _ptr(crowd_flat, ctypes.c_uint8), n_cells,
                                _ptr(out_flat, ctypes.c_double), _ptr(out_off, ctypes.c_int64))
    cells = [out_flat[out_off[c]:out_off[c + 1]].reshape(n_dt[c], n_gt[c]) for c in range(n_cells)]
    if return_flat:
        return cells, (out_flat, out_off[:-1].copy())
    return cells


def box_iou_plain(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    dt = np.asarray(dt, dtype=np.float64).reshape(-1, 4)
    gt = np.asarray(gt, dtype=np.float64).reshape(-1, 4)
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    a_dt = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    a_gt = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    return _overlap_iou_plain(inter, a_dt, a_gt, iscrowd)


def box_iou_batch_plain(dts: List[np.ndarray], gts: List[np.ndarray], crowds: List[np.ndarray]) -> list:
    return [box_iou_plain(d, g, c) for d, g, c in zip(dts, gts, crowds)]


# ---------------------------------------------------------------------------
# COCO matching
# ---------------------------------------------------------------------------

def _match_inputs(ious, gt_ignore, gt_crowd, iou_thrs):
    ious = np.ascontiguousarray(ious, dtype=np.float64)
    return (ious, np.ascontiguousarray(gt_ignore, dtype=np.uint8), np.ascontiguousarray(gt_crowd, dtype=np.uint8),
            np.ascontiguousarray(iou_thrs, dtype=np.float64))


def coco_match(ious: np.ndarray, gt_ignore: np.ndarray, gt_crowd: np.ndarray,
               iou_thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy COCO matching across thresholds.

    Returns (dt_matches, gt_matches, dt_ignore): (T, n_dt)/(T, n_gt) 1-based
    match ids (0 = unmatched) and the ignore flags propagated to detections.
    """
    ious, gt_ignore, gt_crowd, iou_thrs = _match_inputs(ious, gt_ignore, gt_crowd, iou_thrs)
    n_dt, n_gt = ious.shape
    T = len(iou_thrs)
    dt_m = np.zeros((T, n_dt), dtype=np.int64)
    gt_m = np.zeros((T, n_gt), dtype=np.int64)
    dt_ig = np.zeros((T, n_dt), dtype=np.uint8)
    if n_dt and n_gt:
        _library().tm_coco_match(_ptr(ious, ctypes.c_double), n_dt, n_gt,
                                 _ptr(gt_ignore, ctypes.c_uint8), _ptr(gt_crowd, ctypes.c_uint8),
                                 _ptr(iou_thrs, ctypes.c_double), T,
                                 _ptr(dt_m, ctypes.c_int64), _ptr(gt_m, ctypes.c_int64),
                                 _ptr(dt_ig, ctypes.c_uint8))
    return dt_m, gt_m, dt_ig


def coco_match_plain(ious: np.ndarray, gt_ignore: np.ndarray, gt_crowd: np.ndarray,
                     iou_thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ious, gt_ignore, gt_crowd, iou_thrs = _match_inputs(ious, gt_ignore, gt_crowd, iou_thrs)
    n_dt, n_gt = ious.shape
    T = len(iou_thrs)
    dt_m = np.zeros((T, n_dt), dtype=np.int64)
    gt_m = np.zeros((T, n_gt), dtype=np.int64)
    dt_ig = np.zeros((T, n_dt), dtype=np.uint8)
    for t in range(T if n_dt and n_gt else 0):
        for d in range(n_dt):
            iou = min(iou_thrs[t], 1 - 1e-10)
            match = -1
            for g in range(n_gt):
                if gt_m[t, g] > 0 and not gt_crowd[g]:
                    continue
                if match > -1 and not gt_ignore[match] and gt_ignore[g]:
                    break
                if ious[d, g] < iou:
                    continue
                iou = ious[d, g]
                match = g
            if match == -1:
                continue
            dt_ig[t, d] = gt_ignore[match]
            dt_m[t, d] = match + 1
            gt_m[t, match] = d + 1
    return dt_m, gt_m, dt_ig


def coco_stage_match_batch(
    ious: List[np.ndarray],
    scores: List[np.ndarray],
    d_areas: List[np.ndarray],
    g_areas: List[np.ndarray],
    gt_crowd: List[np.ndarray],
    area_lo: np.ndarray,
    area_hi: np.ndarray,
    iou_thrs: np.ndarray,
    cap: int,
    ious_prebuilt: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """COCOeval staging and matching for an epoch of (image, class) cells in
    one C++ call.

    Per cell c, from the unordered full IoU matrix ``ious[c]`` (D, G) plus
    detection scores/areas and gt areas/crowd flags, evaluates all area
    ranges x thresholds and returns ``(order, matched, ignored, npos)``:
    ``order`` (D2,) descending-score dt indices (D2 = min(D, cap)),
    ``matched``/``ignored`` (A, T, D2) bool, and ``npos`` (A,) non-ignored
    gt counts. ``ious_prebuilt`` (flat, offsets) from
    ``box_iou_batch(..., return_flat=True)`` skips re-flattening the epoch's
    IoU data (its cells must be in-order views of that buffer).
    """
    n_cells = len(ious)
    area_lo = np.ascontiguousarray(area_lo, np.float64).reshape(-1)
    area_hi = np.ascontiguousarray(area_hi, np.float64).reshape(-1)
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    A, T = len(area_lo), len(iou_thrs)
    if n_cells == 0:
        return []
    n_dt = np.asarray([np.asarray(s).shape[0] for s in scores], dtype=np.int64)
    n_gt = np.asarray([np.asarray(g).shape[0] for g in g_areas], dtype=np.int64)
    n_d2 = np.minimum(n_dt, cap)
    iou_off = np.zeros(n_cells, dtype=np.int64)
    np.cumsum((n_dt * n_gt)[:-1], out=iou_off[1:])
    d_off = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(n_dt, out=d_off[1:])
    g_off = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(n_gt, out=g_off[1:])
    d2_off = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(n_d2, out=d2_off[1:])

    def _cat(arrs, dtype, total):
        return (np.concatenate([np.ascontiguousarray(a, dtype).ravel() for a in arrs])
                if total else np.zeros(0, dtype))

    if ious_prebuilt is not None:
        ious_flat, iou_off = ious_prebuilt
        ious_flat = np.ascontiguousarray(ious_flat, np.float64)
        iou_off = np.ascontiguousarray(iou_off, np.int64)
    else:
        ious_flat = _cat(ious, np.float64, int((n_dt * n_gt).sum()))
    scores_flat = _cat(scores, np.float64, int(n_dt.sum()))
    d_areas_flat = _cat(d_areas, np.float64, int(n_dt.sum()))
    g_areas_flat = _cat(g_areas, np.float64, int(n_gt.sum()))
    crowd_flat = _cat(gt_crowd, np.uint8, int(n_gt.sum()))

    total_d2 = int(d2_off[-1])
    order_flat = np.zeros(total_d2, dtype=np.int64)
    matched_flat = np.zeros(total_d2 * A * T, dtype=np.uint8)
    ignored_flat = np.zeros(total_d2 * A * T, dtype=np.uint8)
    npos_flat = np.zeros(n_cells * A, dtype=np.int64)
    _library().tm_coco_stage_match_batch(
        _ptr(ious_flat, ctypes.c_double), _ptr(iou_off, ctypes.c_int64),
        _ptr(scores_flat, ctypes.c_double), _ptr(d_areas_flat, ctypes.c_double),
        _ptr(d_off, ctypes.c_int64),
        _ptr(g_areas_flat, ctypes.c_double), _ptr(crowd_flat, ctypes.c_uint8),
        _ptr(g_off, ctypes.c_int64), n_cells,
        _ptr(area_lo, ctypes.c_double), _ptr(area_hi, ctypes.c_double), A,
        _ptr(iou_thrs, ctypes.c_double), T, int(cap),
        _ptr(d2_off, ctypes.c_int64),
        _ptr(order_flat, ctypes.c_int64), _ptr(matched_flat, ctypes.c_uint8),
        _ptr(ignored_flat, ctypes.c_uint8), _ptr(npos_flat, ctypes.c_int64),
    )
    out = []
    for c in range(n_cells):
        D2 = int(n_d2[c])
        base = int(d2_off[c]) * A * T
        shape = (A, T, D2)
        out.append((
            order_flat[d2_off[c]:d2_off[c] + D2],
            matched_flat[base: base + A * T * D2].reshape(shape).view(bool),
            ignored_flat[base: base + A * T * D2].reshape(shape).view(bool),
            npos_flat[c * A:(c + 1) * A],
        ))
    return out


def coco_stage_match_batch_plain(
    ious: List[np.ndarray],
    scores: List[np.ndarray],
    d_areas: List[np.ndarray],
    g_areas: List[np.ndarray],
    gt_crowd: List[np.ndarray],
    area_lo: np.ndarray,
    area_hi: np.ndarray,
    iou_thrs: np.ndarray,
    cap: int,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """The per-cell numpy staging over :func:`coco_match_plain`."""
    area_lo = np.asarray(area_lo, np.float64).reshape(-1)
    area_hi = np.asarray(area_hi, np.float64).reshape(-1)
    iou_thrs = np.asarray(iou_thrs, np.float64)
    A, T = len(area_lo), len(iou_thrs)
    out = []
    for c in range(len(ious)):
        sc = np.asarray(scores[c], np.float64)
        order = np.argsort(-sc, kind="stable")[:cap]
        D2 = len(order)
        ious_d = np.asarray(ious[c], np.float64)[order]
        crowd = np.asarray(gt_crowd[c], bool)
        ga = np.asarray(g_areas[c], np.float64)
        da = np.asarray(d_areas[c], np.float64)[order]
        matched = np.zeros((A, T, D2), bool)
        ignored = np.zeros((A, T, D2), bool)
        npos = np.zeros(A, np.int64)
        for a in range(A):
            g_ign = crowd | (ga < area_lo[a]) | (ga > area_hi[a])
            npos[a] = int((~g_ign).sum())
            g_order = np.argsort(g_ign, kind="stable")
            dt_m, _gt_m, dt_ig = coco_match_plain(
                np.ascontiguousarray(ious_d[:, g_order]),
                g_ign[g_order].astype(np.uint8),
                crowd[g_order].astype(np.uint8), iou_thrs)
            m = dt_m > 0
            d_ign = (da < area_lo[a]) | (da > area_hi[a])
            matched[a] = m
            ignored[a] = dt_ig.astype(bool) | (~m & d_ign[None, :])
        out.append((order, matched, ignored, npos))
    return out
