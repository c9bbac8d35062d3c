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

The quantized route (``quantize_bits``, :func:`quantized_allreduce`) sends
a float SUM/MEAN bucket as int8 or int16 with per-chunk shared scales: one
``all_reduce(MAX)`` of the chunks' absolute maxima, an integer
``reduce_scatter_tensor``, then ``all_gather`` of the requantized shards and
their scales. The integer reduce-scatter runs in int32 whatever the bit
width: neither NCCL nor gloo reduces int16, and the summed integers are the
same values the JAX package's int16 accumulator holds, so the result is
bitwise the same. The requantized payload travels through the raw-byte
gather, so int16 needs no reduction support either.

Every collective goes through :func:`_group_api`, which is
``torch.distributed`` except inside :func:`modelled_group`: a stand-in
group of ``world`` ranks that moves nothing, under which the sync's own
routes record the collectives they would issue (the autotuner's wire
model).

Every collective is counted in the process-wide wire ledger
(:func:`wire_stats`, a view of the registry's ``wire.*`` counters) with
the JAX package's ring-bandwidth model, its payload observed in the
``wire.collective_nbytes`` histogram, and, while tracing is armed, a
``collective`` span instant carries the model's numbers.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from ..observability import spans as _spans
from ..observability.registry import REGISTRY as _REGISTRY

Tensor = torch.Tensor

__all__ = [
    "SyncPolicy",
    "begin_sync",
    "default_policy",
    "dequantize_chunks",
    "gather_bucket",
    "group_size",
    "pad_cat_rows",
    "quantize_chunks",
    "quantized_allreduce",
    "record_collective",
    "reduce_scatter_sum",
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
# registry-backed (observability/registry.py), as the JAX package keeps them
_WIRE = _REGISTRY.group(
    "wire",
    {
        "bytes_reduced": 0,     # elementwise all-reduce traffic (model, per rank)
        "bytes_gathered": 0,    # cat/NONE gather traffic (model, per rank)
        "collectives_issued": 0,
        "syncs": 0,             # reduce_state_in_graph calls + eager Metric.sync calls
    },
    help="modelled ring-bandwidth wire traffic",
)
_LAST_SYNC = _REGISTRY.group(
    "wire.last_sync", dict(_WIRE), help="per-collective breakdown of the latest sync"
)
# per-collective payload size distribution, labelled by kind: the autotuner's
# observer reads it to size gather chunks and to decide whether quantization
# can pay for its scale overhead
_COLLECTIVE_NBYTES = _REGISTRY.histogram(
    "wire.collective_nbytes",
    "payload bytes per collective, by kind",
    buckets=(64, 256, 1024, 4096, 16384, 65536, 262144, 1 << 20, 1 << 22, 1 << 24),
)


def record_collective(kind: str, nbytes: int, world: int, dtype: Any = None) -> None:
    """Account one collective over ``nbytes`` of payload on a ``world`` ring.

    The JAX package's model (bytes per rank): ``psum``/``pmean``/``pmax``/
    ``pmin`` (an ``all_reduce``) move ``2(n-1)/n·S``, ``psum_scatter`` moves
    ``(n-1)/n·S``, ``all_gather`` of an ``S``-byte row ``(n-1)·S``, the
    zeros+psum gather ``2(n-1)·S``; the eager backends' ``eager_gather``
    and ``eager_reduce`` (a gather, reduced after) ``(n-1)·S``. Nothing is
    counted in a group of one. While tracing is armed a ``collective``
    instant carries the kind, the payload, the modelled wire bytes, the
    world and the dtype (JAX ``strategies.py:153``).
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
    _WIRE[key] += moved
    _WIRE["collectives_issued"] += 1
    _LAST_SYNC[key] += moved
    _LAST_SYNC["collectives_issued"] += 1
    _COLLECTIVE_NBYTES.observe(float(nbytes), kind=kind)
    if _spans.ENABLED:
        _spans.instant(
            "collective",
            kind=kind,
            bytes=int(nbytes),
            wire_bytes=int(moved),
            world=n,
            dtype=str(dtype) if dtype is not None else None,
        )


def begin_sync() -> None:
    """Mark the start of one logical sync (resets the per-sync snapshot)."""
    _WIRE["syncs"] += 1
    for k in _COUNTERS:
        _LAST_SYNC[k] = 0


def wire_stats() -> Dict[str, Any]:
    """Totals since process start or :func:`reset_wire_stats`, plus the
    counters of the most recent sync under ``last_sync``: a view of the
    registry's ``wire`` and ``wire.last_sync`` groups."""
    out: Dict[str, Any] = dict(_WIRE)
    out["last_sync"] = {k: _LAST_SYNC[k] for k in _COUNTERS}
    return out


def reset_wire_stats() -> None:
    _WIRE.reset()
    _LAST_SYNC.reset()
    _COLLECTIVE_NBYTES.reset()


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
        quantize_bits: 8 or 16 sends float SUM/MEAN buckets of at least
            ``quantize_threshold`` elements as int8/int16 with per-chunk
            scales (:func:`quantized_allreduce`; the eager class API
            quantizes each bucket before its gather). Integer buckets are
            never quantized.
        quantize_threshold, quantize_chunk: that route's bucket floor and
            the elements that share one scale.
        reduce_scatter_threshold: SUM/MEAN buckets of at least this many
            elements use :func:`reduce_scatter_sum` (integers exactly,
            floats within summation order of an ``all_reduce``).
        gather_chunk_elems: gather cat/NONE buckets in chunks of at most
            this many elements (bounds the psum gather's zeros buffer);
            ``None`` gathers each bucket whole.
        retry_attempts, backoff_base_s, min_coverage: the elastic sync's
            retries, its first backoff (doubled per retry) and the least
            coverage a degraded round may settle at
            (:class:`~torchmetrics_tpu_torch.parallel.elastic.ElasticSync`).
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

    def wants_quantize(self, dtype: torch.dtype, size: int) -> bool:
        return (not self.exact and self.quantize_bits is not None and size >= self.quantize_threshold
                and dtype.is_floating_point and self.use_all_gather())

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


# ---------------------------------------------------------------------------
# collectives over a torch.distributed group
# ---------------------------------------------------------------------------

class _ModelledGroup:
    """``torch.distributed``'s calls over ``world`` ranks that move nothing:
    a gather hands back ``world`` copies of this rank's tensor, a reduction
    leaves its tensor as it is, and a reduce-scatter keeps this rank's
    (rank 0's) slice. The tensors come back at the shapes a real group
    gives, so every route runs as it would, and ranks that all hold this
    rank's state exchange the same cat row counts."""

    def __init__(self, world: int) -> None:
        self.world = int(world)

    def is_available(self) -> bool:
        return True

    def is_initialized(self) -> bool:
        return True

    def get_world_size(self, group: Any = None) -> int:
        return self.world

    def get_rank(self, group: Any = None) -> int:
        return 0

    def get_backend(self, group: Any = None) -> str:
        return "gloo"  # its tensors may stay in host memory

    def all_reduce(self, tensor: Tensor, op: Any = None, group: Any = None) -> None:
        return None

    def all_gather_into_tensor(self, out: Tensor, tensor: Tensor, group: Any = None) -> None:
        out.copy_(tensor.reshape(-1).repeat(self.world))

    def reduce_scatter_tensor(self, out: Tensor, tensor: Tensor, group: Any = None) -> None:
        out.copy_(tensor.reshape(-1)[: out.numel()])


_GROUP_API: contextvars.ContextVar = contextvars.ContextVar("group_api", default=dist)


def _group_api() -> Any:
    """``torch.distributed``, or the :func:`modelled_group` in force in this
    thread's context."""
    return _GROUP_API.get()


@contextlib.contextmanager
def modelled_group(world: int) -> Iterator[None]:
    """Run the sync's collectives against a stand-in group of ``world``
    ranks that moves nothing (:class:`_ModelledGroup`): each still records
    itself in the wire ledger, so a sync run inside the block counts the
    bytes it would move over such a group. Other threads keep the real
    group."""
    token = _GROUP_API.set(_ModelledGroup(world))
    try:
        yield
    finally:
        _GROUP_API.reset(token)


def group_size(group: Any = None) -> int:
    """Ranks in ``group`` (the default group when ``None``); 1 when no
    process group is initialised."""
    api = _group_api()
    if not (api.is_available() and api.is_initialized()):
        return 1
    return api.get_world_size(group)


def group_rank(group: Any = None) -> int:
    """This process's rank in ``group`` (the default group when ``None``); 0
    when no process group is initialised."""
    api = _group_api()
    if not (api.is_available() and api.is_initialized()):
        return 0
    return api.get_rank(group)


def _as_bytes(value: Tensor) -> Tensor:
    return value.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(rows: Tensor, dtype: torch.dtype, shape: Tuple[int, ...]) -> Tensor:
    """``(world, nbytes)`` uint8 rows back to ``(world, *shape)`` of ``dtype``."""
    return rows.view(dtype).reshape((rows.shape[0], *shape))


def _gather_bytes(flat: Tensor, group: Any, n: int, policy: SyncPolicy) -> Tensor:
    """``(n, flat.numel())`` uint8: every rank's bytes, in rank order."""
    api = _group_api()
    if policy.use_all_gather():
        # a flat (world·n,) output: gloo refuses a (world, n) one
        out = torch.empty(n * flat.numel(), dtype=torch.uint8, device=flat.device)
        api.all_gather_into_tensor(out, flat, group=group)
        return out.view(n, -1)
    rows = torch.zeros((n, flat.numel()), dtype=torch.uint8, device=flat.device)
    rows[api.get_rank(group)] = flat
    api.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
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
        record_collective(kind, piece.numel() * piece.element_size(), n, dtype=piece.dtype)
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
    record_collective("psum_scatter", padded.numel() * padded.element_size(), n, dtype=padded.dtype)
    api = _group_api()
    shard = padded.new_empty(padded.numel() // n)
    api.reduce_scatter_tensor(shard, padded, group=group)
    if mean:
        shard = shard / n if shard.is_floating_point() else shard // n
    record_collective("all_gather", shard.numel() * shard.element_size(), n, dtype=shard.dtype)
    out = shard.new_empty(shard.numel() * n)
    api.all_gather_into_tensor(out, shard, group=group)
    return out[:size]


# ---------------------------------------------------------------------------
# quantized collective (float SUM/MEAN buckets)
# ---------------------------------------------------------------------------

def _q_info(bits: int) -> Tuple[torch.dtype, int]:
    return (torch.int8, 127) if bits == 8 else (torch.int16, 32767)


def _pad_to_multiple(flat: Tensor, multiple: int) -> Tuple[Tensor, int]:
    pad = (-flat.numel()) % multiple
    return (torch.cat([flat, flat.new_zeros(pad)]) if pad else flat), pad


def _quantize_blocks(blocks: Tensor, scales: Tensor, bits: int) -> Tensor:
    """``round(blocks / scale)`` clipped to the symmetric range; a chunk of
    scale 0 (all zeros) divides by 1. ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    qdtype, qmax = _q_info(bits)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    return torch.clamp(torch.round(blocks / safe[:, None]), -qmax, qmax).to(qdtype)


def quantize_chunks(x: Tensor, bits: int, chunk: int) -> Tuple[Tensor, Tensor, int]:
    """Per-chunk symmetric quantization of a flat float tensor.

    Returns ``(q, scales, pad)``: ``q`` the ``(C·chunk,)`` int8/int16
    payload, ``scales`` the ``(C,)`` per-chunk ``absmax / qmax`` (0 for an
    all-zero chunk), ``pad`` the zeros added to fill the last chunk. Bitwise
    the JAX package's ``quantize_chunks`` on the same float32 input.
    """
    _, qmax = _q_info(bits)
    padded, pad = _pad_to_multiple(x.reshape(-1), chunk)
    blocks = padded.reshape(-1, chunk)
    scales = torch.amax(torch.abs(blocks), dim=1) / qmax
    return _quantize_blocks(blocks, scales, bits).reshape(-1), scales.to(blocks.dtype), pad


def dequantize_chunks(q: Tensor, scales: Tensor, dtype: torch.dtype) -> Tensor:
    chunk = q.numel() // scales.numel()
    return (q.reshape(-1, chunk).to(dtype) * scales[:, None].to(dtype)).reshape(-1)


def quantized_allreduce(flat: Tensor, group: Any = None, mean: bool = False, policy: Optional[SyncPolicy] = None,
                        residual: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Quantized all-reduce of one flat float bucket over ``group``
    (JAX ``strategies.py:498-563``, after EQuARX).

    1. The chunks' absolute maxima meet in one ``all_reduce(MAX)``, so every
       rank quantizes with the same scales;
    2. the int8/int16 payload is summed by ``reduce_scatter_tensor`` in
       int32 (the JAX package accumulates in int16 at 8 bits and at most
       255 ranks; the sums are the same integers);
    3. each rank dequantizes its shard with its slice of the scales,
       requantizes it per chunk, and the shards and their scales come back
       through ``all_gather`` (the payload as raw bytes).

    ``residual`` is the error-feedback carry: the previous call's residual
    for the same bucket is added before quantizing. Returns ``(result,
    new_residual)``; with the same inputs on every rank, bitwise the JAX
    package's result and residual.
    """
    policy = policy or default_policy()
    bits = policy.quantize_bits or 8
    _, qmax = _q_info(bits)
    n = group_size(group)
    size = flat.numel()
    x = flat if residual is None else flat + residual
    chunk = policy.quantize_chunk
    padded, _ = _pad_to_multiple(x.reshape(-1), n * chunk)
    blocks = padded.reshape(-1, chunk)

    api = _group_api()
    absmax = torch.amax(torch.abs(blocks), dim=1)
    record_collective("pmax", absmax.numel() * absmax.element_size(), n, dtype=absmax.dtype)
    api.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scales = (absmax / qmax).to(blocks.dtype)
    q_in = _quantize_blocks(blocks, scales, bits)
    new_residual = (padded - (q_in.to(blocks.dtype) * scales[:, None]).reshape(-1))[:size]

    acc = q_in.to(torch.int32).reshape(-1)
    record_collective("psum_scatter", acc.numel() * acc.element_size(), n, dtype=acc.dtype)
    shard_acc = acc.new_empty(acc.numel() // n)
    api.reduce_scatter_tensor(shard_acc, acc, group=group)

    per_shard = scales.numel() // n
    rank = api.get_rank(group)
    shard_scales = scales[rank * per_shard:(rank + 1) * per_shard]
    shard = (shard_acc.reshape(-1, chunk).to(blocks.dtype) * shard_scales[:, None]).reshape(-1)
    if mean:
        shard = shard / n
    q_out, out_scales, _ = quantize_chunks(shard, bits, chunk)
    gather = SyncPolicy(gather="all_gather")
    record_collective("all_gather", q_out.numel() * q_out.element_size(), n, dtype=q_out.dtype)
    gathered_q = stack_gather(q_out, group, gather).reshape(-1)
    record_collective("all_gather", out_scales.numel() * out_scales.element_size(), n, dtype=out_scales.dtype)
    gathered_scales = stack_gather(out_scales, group, gather).reshape(-1)
    return dequantize_chunks(gathered_q, gathered_scales, flat.dtype)[:size], new_residual
