"""How state buckets move over the wire: the sync policy, the wire ledger and
the collectives that move one bucket over a ``torch.distributed`` group.

Counterpart of ``torchmetrics_tpu/parallel/strategies.py``. ``sync.py``
decides *what* to merge (bucketing by reduction and dtype); this module
decides *how* a bucket's bytes travel:

- elementwise buckets: one ``all_reduce`` (SUM, MAX, MIN; MEAN is a SUM
  divided by the world size, since ``ReduceOp.AVG`` is NCCL's alone), or,
  for large SUM/MEAN buckets, the reduce-scatter decomposition
  (:func:`reduce_scatter_sum`: ``reduce_scatter_tensor`` then
  ``all_gather_into_tensor``);
- cat/NONE/custom buckets: :func:`gather_bucket`, a gather of every rank's
  row, either ``all_gather_into_tensor`` (``gather="all_gather"``; ``"auto"``
  resolves to it) or zeros plus an ``all_reduce`` of a one-hot row
  (``gather="psum"``, the JAX package's replication-invariant gather).

Gathers carry raw bytes (a ``uint8`` view of the bucket), so every dtype
travels on every backend and comes back bitwise, bool and -0.0 included:
the psum gather adds the bytes of one rank to zeros as integers.

Every collective here takes CUDA tensors on NCCL and on gloo alike (gloo
moves them through host memory itself), so no route stages anything.

The quantized route (``quantize_bits``) is ROADMAP A13: a policy that asks
for it is accepted and validated, and a sync under it raises
:class:`NotImplementedError` rather than send full precision.

Every collective is counted in the process-wide wire ledger
(:func:`wire_stats`) with the JAX package's ring-bandwidth model.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

__all__ = [
    "SyncPolicy",
    "begin_sync",
    "default_policy",
    "gather_bucket",
    "group_size",
    "pad_cat_rows",
    "record_collective",
    "reduce_scatter_sum",
    "refuse_quantized",
    "reset_wire_stats",
    "stack_gather",
    "use_policy",
    "wire_stats",
]

def pad_cat_rows(value: Tensor, target_rows: int, trailing: Tuple[int, ...], dtype: torch.dtype) -> Tensor:
    """Adopt a cat shard to the group's row layout and zero-pad it to
    ``target_rows``: a rank with no rows takes the group's trailing shape
    and dtype, and every rank ships the same row count."""
    trailing = tuple(int(d) for d in trailing)
    if value.shape[0] == 0 and (tuple(value.shape[1:]) != trailing or value.dtype != dtype):
        value = torch.zeros((0, *trailing), dtype=dtype, device=value.device)
    else:
        value = value.to(dtype)
    pad = target_rows - value.shape[0]
    if pad <= 0:
        return value
    return torch.cat([value, torch.zeros((pad, *trailing), dtype=dtype, device=value.device)])


# ---------------------------------------------------------------------------
# wire-level counters
# ---------------------------------------------------------------------------

_COUNTERS = ("bytes_reduced", "bytes_gathered", "collectives_issued")
_WIRE: Dict[str, int] = {**dict.fromkeys(_COUNTERS, 0), "syncs": 0}
_LAST_SYNC: Dict[str, int] = dict.fromkeys(_COUNTERS, 0)


def record_collective(kind: str, nbytes: int, world: int) -> None:
    """Account one collective over ``nbytes`` of payload on a ``world`` ring.

    The JAX package's model (bytes per rank): ``psum``/``pmean``/``pmax``/
    ``pmin`` (an ``all_reduce``) move ``2(n-1)/n·S``, ``psum_scatter`` moves
    ``(n-1)/n·S``, ``all_gather`` of an ``S``-byte row ``(n-1)·S``, the
    zeros+psum gather ``2(n-1)·S``; the eager backends' ``eager_gather``
    and ``eager_reduce`` (a gather, reduced after) ``(n-1)·S``. Nothing is
    counted in a group of one.
    """
    n = max(int(world), 1)
    if n <= 1:
        return
    if kind in ("psum", "pmean", "pmax", "pmin"):
        key, moved = "bytes_reduced", 2 * (n - 1) * nbytes // n
    elif kind == "psum_scatter":
        key, moved = "bytes_reduced", (n - 1) * nbytes // n
    elif kind in ("all_gather", "eager_gather"):
        key, moved = "bytes_gathered", (n - 1) * nbytes
    elif kind == "zeros_psum_gather":
        key, moved = "bytes_gathered", 2 * (n - 1) * nbytes
    elif kind == "eager_reduce":
        key, moved = "bytes_reduced", (n - 1) * nbytes
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    for counters in (_WIRE, _LAST_SYNC):
        counters[key] += moved
        counters["collectives_issued"] += 1


def begin_sync() -> None:
    """Mark the start of one logical sync (resets the per-sync snapshot)."""
    _WIRE["syncs"] += 1
    for k in _COUNTERS:
        _LAST_SYNC[k] = 0


def wire_stats() -> Dict[str, Any]:
    """Totals since process start or :func:`reset_wire_stats`, plus the
    counters of the most recent sync under ``last_sync``."""
    return {**_WIRE, "last_sync": dict(_LAST_SYNC)}


def reset_wire_stats() -> None:
    for counters in (_WIRE, _LAST_SYNC):
        for k in counters:
            counters[k] = 0


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

_GATHER_MODES = ("auto", "all_gather", "psum")


@dataclass(frozen=True)
class SyncPolicy:
    """How collectives are issued for one sync; frozen and hashable.

    Args:
        exact: the dense full-precision path everywhere: no reduce-scatter
            decomposition, no quantization.
        gather: ``"auto"`` and ``"all_gather"`` gather cat/NONE buckets with
            ``all_gather_into_tensor``; ``"psum"`` with zeros plus an
            ``all_reduce`` (twice the bytes, the JAX package's
            replication-invariant form). Both are bitwise equal.
        quantize_bits: 8 or 16 asks for the quantized SUM/MEAN route, which
            is not ported (ROADMAP A13): a sync under it raises.
        quantize_threshold, quantize_chunk: that route's bucket floor and
            scale chunk; validated, unused until it is ported.
        reduce_scatter_threshold: SUM/MEAN buckets of at least this many
            elements use :func:`reduce_scatter_sum` (integers exactly,
            floats within summation order of an ``all_reduce``).
        gather_chunk_elems: gather cat/NONE buckets in chunks of at most
            this many elements (bounds the psum gather's zeros buffer);
            ``None`` gathers each bucket whole.
        retry_attempts, backoff_base_s, min_coverage: the elastic sync's
            knobs (ROADMAP A13), validated as in the JAX package.
    """

    exact: bool = False
    gather: str = "auto"
    quantize_bits: Optional[int] = None
    quantize_threshold: int = 4096
    quantize_chunk: int = 256
    reduce_scatter_threshold: int = 1 << 16
    gather_chunk_elems: Optional[int] = None
    retry_attempts: int = 0
    backoff_base_s: float = 0.5
    min_coverage: float = 0.0

    def __post_init__(self) -> None:
        if self.gather not in _GATHER_MODES:
            raise ValueError(f"`gather` must be one of {_GATHER_MODES}, got {self.gather!r}")
        if self.quantize_bits not in (None, 8, 16):
            raise ValueError(f"`quantize_bits` must be None, 8 or 16, got {self.quantize_bits!r}")
        if self.quantize_threshold < 1 or self.quantize_chunk < 1:
            raise ValueError("`quantize_threshold` and `quantize_chunk` must be >= 1")
        if self.reduce_scatter_threshold < 1:
            raise ValueError("`reduce_scatter_threshold` must be >= 1")
        if self.gather_chunk_elems is not None and self.gather_chunk_elems < 1:
            raise ValueError("`gather_chunk_elems` must be None or >= 1")
        if self.retry_attempts < 0:
            raise ValueError(f"`retry_attempts` must be >= 0, got {self.retry_attempts}")
        if self.backoff_base_s <= 0:
            raise ValueError(f"`backoff_base_s` must be > 0, got {self.backoff_base_s}")
        if not 0.0 <= self.min_coverage <= 1.0:
            raise ValueError(f"`min_coverage` must be in [0, 1], got {self.min_coverage}")

    def use_all_gather(self) -> bool:
        return self.gather != "psum"

    def wants_reduce_scatter(self, size: int) -> bool:
        return not self.exact and size >= self.reduce_scatter_threshold and self.use_all_gather()


_DEFAULT_POLICY = SyncPolicy()


def default_policy() -> SyncPolicy:
    return _DEFAULT_POLICY


@contextlib.contextmanager
def use_policy(policy: SyncPolicy) -> Iterator[SyncPolicy]:
    """Temporarily swap the process-default :class:`SyncPolicy`."""
    global _DEFAULT_POLICY
    prev = _DEFAULT_POLICY
    _DEFAULT_POLICY = policy
    try:
        yield policy
    finally:
        _DEFAULT_POLICY = prev


def refuse_quantized(policy: SyncPolicy) -> None:
    """Raise for a policy that asks for the quantized route: it is not
    ported, and sending full precision instead would hide that."""
    if policy.quantize_bits is not None and not policy.exact:
        raise NotImplementedError(
            f"SyncPolicy(quantize_bits={policy.quantize_bits}) asks for the quantized all-reduce, which "
            "torchmetrics_tpu_torch does not have yet (ROADMAP A13); use quantize_bits=None or exact=True"
        )


# ---------------------------------------------------------------------------
# collectives over a torch.distributed group
# ---------------------------------------------------------------------------

def group_size(group: Any = None) -> int:
    """Ranks in ``group`` (the default group when ``None``); 1 when no
    process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _as_bytes(value: Tensor) -> Tensor:
    return value.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(rows: Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> Tensor:
    """``(world, nbytes)`` uint8 rows back to ``(world, *shape)`` of ``dtype``."""
    return rows.view(dtype).reshape((rows.shape[0], *shape))


def _gather_bytes(flat: Tensor, group: Any, n: int, policy: SyncPolicy) -> Tensor:
    """``(n, flat.numel())`` uint8: every rank's bytes, in rank order."""
    if policy.use_all_gather():
        # a flat (world·n,) output: gloo refuses a (world, n) one
        out = torch.empty(n * flat.numel(), dtype=torch.uint8, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=group)
        return out.view(n, -1)
    rows = torch.zeros((n, flat.numel()), dtype=torch.uint8, device=flat.device)
    rows[dist.get_rank(group)] = flat
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    return rows


def stack_gather(value: Tensor, group: Any = None, policy: Optional[SyncPolicy] = None) -> Tensor:
    """``(world, *value.shape)``: every rank's ``value`` (equal shapes and
    dtypes), in rank order, bitwise. The caller accounts the collective."""
    policy = policy or default_policy()
    n = group_size(group)
    return _from_bytes(_gather_bytes(_as_bytes(value), group, n, policy), value.dtype, tuple(value.shape))


def gather_bucket(flat: Tensor, group: Any = None, policy: Optional[SyncPolicy] = None) -> Tensor:
    """Gather one flat ``(total,)`` cat/NONE bucket as ``(world, total)``,
    in column chunks of ``gather_chunk_elems`` when the policy sets it."""
    policy = policy or default_policy()
    n = group_size(group)
    chunk = policy.gather_chunk_elems
    if chunk is None or flat.numel() <= chunk:
        pieces = [flat]
    else:
        pieces = [flat[off : off + chunk] for off in range(0, flat.numel(), chunk)]
    kind = "all_gather" if policy.use_all_gather() else "zeros_psum_gather"
    gathered = []
    for piece in pieces:
        record_collective(kind, piece.numel() * piece.element_size(), n)
        gathered.append(stack_gather(piece, group, policy))
    return gathered[0] if len(gathered) == 1 else torch.cat(gathered, dim=1)


def reduce_scatter_sum(flat: Tensor, group: Any = None, mean: bool = False,
                       policy: Optional[SyncPolicy] = None) -> Tensor:
    """SUM (or MEAN) of a flat bucket as ``reduce_scatter_tensor`` then
    ``all_gather_into_tensor``: ``2(n-1)/n`` of the bucket on the wire, as a
    ring all-reduce, with the gather half as an op of its own. Integers are
    exact; floats may differ from an ``all_reduce`` in summation order."""
    policy = policy or default_policy()
    n = group_size(group)
    size = flat.numel()
    pad = (-size) % n
    padded = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat.contiguous()
    record_collective("psum_scatter", padded.numel() * padded.element_size(), n)
    shard = padded.new_empty(padded.numel() // n)
    dist.reduce_scatter_tensor(shard, padded, group=group)
    if mean:
        shard = shard / n if shard.is_floating_point() else shard // n
    record_collective("all_gather", shard.numel() * shard.element_size(), n)
    out = shard.new_empty(shard.numel() * n)
    dist.all_gather_into_tensor(out, shard, group=group)
    return out[:size]
