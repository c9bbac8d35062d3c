"""State sync over ``torch.distributed``.

Counterpart of ``torchmetrics_tpu/parallel/sync.py``:

- :func:`reduce_state_in_graph` / :func:`reduce_tensor_in_graph`: the pure
  route. PyTorch has no graph to trace into, so these are the collectives
  of the JAX functions issued eagerly over a process group (``group=``, the
  default group when ``None``, in place of ``axis_name``): elementwise
  leaves bucketed by ``(Reduction, dtype)``, one ``all_reduce`` per bucket;
  cat/NONE/custom leaves bucketed by dtype, one gather per bucket. They
  leave device tensors on the device and read nothing back to the host,
  except cat row counts when the group has more than one rank (the
  pad-to-max protocol needs them; a gloo group carries them in host
  memory, so nothing waits for the card there either).
- :class:`HostSync`: the eager class-API backend over ``torch.distributed``
  (the JAX package's ``HostSync`` runs over ``multihost_utils``): gather a
  ``(world, ...)`` stack, reduce over dim 0 in rank order.
- :class:`FakeSync`: an N-rank group emulated in one process, for tests.
- :class:`NoSync`: one process; everything is the identity.

Every process must issue the same collective sequence, so state names are
visited in sorted order: a divergent order hangs the group.
"""
import pickle
import threading
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..buffers import CatBuffer, _row_form
from .reduction import ELEMENTWISE_REDUCTIONS, Reduction
from .strategies import (  # noqa: F401  (re-exported: the JAX package's import surface)
    SyncPolicy,
    begin_sync,
    default_policy,
    gather_bucket,
    group_size,
    pad_cat_rows,
    quantized_allreduce,
    record_collective,
    reduce_scatter_sum,
    reset_wire_stats,
    stack_gather,
    use_policy,
    wire_stats,
)
from .strategies import _group_api

Tensor = torch.Tensor
StateDict = Dict[str, Any]

# HostSync instances poisoned by a gather timeout (weak: short-lived test
# backends do not accumulate); poison is per instance
_POISONED_BACKENDS: "weakref.WeakSet" = weakref.WeakSet()

_ALL_REDUCE = {
    Reduction.SUM: ("psum", dist.ReduceOp.SUM),
    Reduction.MEAN: ("pmean", dist.ReduceOp.SUM),
    Reduction.MAX: ("pmax", dist.ReduceOp.MAX),
    Reduction.MIN: ("pmin", dist.ReduceOp.MIN),
}

# cat metadata wire format: length, trailing shape (at most 6 dims, -1
# padded), and the dtype's name in 16 ascii bytes (4 int32 words)
_CAT_MAX_TRAILING = 6
_CAT_NAME_WORDS = 4


def _encode_dtype(dtype: torch.dtype) -> List[int]:
    name = str(dtype).removeprefix("torch.").encode("ascii")
    if len(name) > 4 * _CAT_NAME_WORDS:
        raise ValueError(f"dtype name too long for the cat-gather metadata: {name!r}")
    raw = name.ljust(4 * _CAT_NAME_WORDS, b"\0")
    return [int.from_bytes(raw[i : i + 4], "little", signed=True) for i in range(0, len(raw), 4)]


def _decode_dtype(words: List[int]) -> torch.dtype:
    raw = b"".join(int(w).to_bytes(4, "little", signed=True) for w in words).rstrip(b"\0")
    return getattr(torch, raw.decode("ascii"))


def _cat_meta(rows: int, trailing: Tuple[int, ...], dtype: Optional[torch.dtype]) -> List[int]:
    """One cat leaf's metadata words; an unknown dtype (a rank holding no
    increment at all) is sent as zeros and never read (its length is 0)."""
    if len(trailing) > _CAT_MAX_TRAILING:
        raise ValueError(f"cat state has {len(trailing)} trailing dims; at most {_CAT_MAX_TRAILING} are supported")
    words = [rows, *trailing, *([-1] * (_CAT_MAX_TRAILING - len(trailing)))]
    return words + (_encode_dtype(dtype) if dtype is not None else [0] * _CAT_NAME_WORDS)


def _group_layout(metas: List[List[int]]) -> Optional[Tuple[Tuple[int, ...], torch.dtype]]:
    """The group's (trailing, dtype) of one cat leaf from every rank's
    metadata words, taken from the ranks with rows (they must agree); None
    when no rank has any."""
    full = [m for m in metas if m[0] > 0]
    if not full:
        return None
    if any(m[1:] != full[0][1:] for m in full):
        raise ValueError(f"cat state shards disagree on trailing shape or dtype across ranks: {full}")
    trailing = tuple(d for d in full[0][1 : 1 + _CAT_MAX_TRAILING] if d >= 0)
    return trailing, _decode_dtype(full[0][1 + _CAT_MAX_TRAILING :])


def _reduce_stack(stack: Tensor, reduction: Union[Reduction, Callable]) -> Tensor:
    """Reduce a ``(world, ...)`` stack over dim 0 in rank order, so float
    results do not depend on a library's summation order. Integers keep
    their dtype; MEAN of integers is float32, as ``jnp.mean`` gives it."""
    if reduction == Reduction.NONE:
        return stack
    if reduction in (Reduction.SUM, Reduction.MEAN):
        if reduction == Reduction.MEAN and not stack.is_floating_point():
            stack = stack.to(torch.float32)
        acc = stack[0]
        for r in range(1, stack.shape[0]):
            acc = acc + stack[r]
        return acc / stack.shape[0] if reduction == Reduction.MEAN else acc
    if reduction == Reduction.MAX:
        return torch.amax(stack, dim=0)
    if reduction == Reduction.MIN:
        return torch.amin(stack, dim=0)
    if callable(reduction):
        return reduction(stack)
    raise ValueError(f"Unknown reduction {reduction}")


# ---------------------------------------------------------------------------
# the pure route
# ---------------------------------------------------------------------------

def _route_elementwise(value: Tensor, reduction: Reduction, group: Any, policy: SyncPolicy) -> Tensor:
    """One elementwise leaf or bucket: an ``all_reduce``; the quantized
    all-reduce for a large float SUM/MEAN bucket when the policy asks for
    it; or the reduce-scatter decomposition for a large SUM (or float
    MEAN) bucket (JAX ``sync.py:130-150``)."""
    n = group_size(group)
    if reduction in (Reduction.SUM, Reduction.MEAN) and policy.wants_quantize(value.dtype, value.numel()):
        out, _ = quantized_allreduce(value.reshape(-1), group, mean=reduction == Reduction.MEAN, policy=policy)
        return out.reshape(value.shape)
    if (reduction == Reduction.SUM or (reduction == Reduction.MEAN and value.is_floating_point())) \
            and policy.wants_reduce_scatter(value.numel()):
        out = reduce_scatter_sum(value.reshape(-1), group, mean=reduction == Reduction.MEAN, policy=policy)
        return out.reshape(value.shape)
    kind, op = _ALL_REDUCE[reduction]
    record_collective(kind, value.numel() * value.element_size(), n, dtype=value.dtype)
    out = value.clone()
    _group_api().all_reduce(out, op=op, group=group)
    if reduction == Reduction.MEAN:  # lax.pmean: psum / n, floats for integer input
        out = out / n
    return out


def _rows(value: Any) -> Optional[Tensor]:
    """A cat leaf's valid rows as one tensor; None for an empty tuple, whose
    dtype this rank cannot know."""
    if isinstance(value, CatBuffer):
        return value.materialize()
    if isinstance(value, (list, tuple)):
        if not value:
            return None
        parts = [_row_form(e) for e in value]
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    return _row_form(torch.as_tensor(value))


def _as_leaf_type(value: Any, rows: Tensor) -> Any:
    """Gathered rows in the form the cat leaf came in: a ``CatBuffer``, a
    tuple of one increment, or a tensor."""
    if isinstance(value, CatBuffer):
        return CatBuffer.from_rows(rows)
    return type(value)([rows]) if isinstance(value, (list, tuple)) else rows


class _Leaf:
    """One cat/NONE/custom leaf queued into a per-dtype gather bucket.

    A cat leaf (``counts`` set) ships its rows zero-padded to the group's
    longest and is cut back to each rank's count on receipt: every rank's
    rows, in rank order. A NONE/custom leaf (equal shapes on every rank)
    comes back as the ``(world, ...)`` stack, or the callable applied to it.
    """

    __slots__ = ("red", "wire", "counts", "value")

    def __init__(self, red: Any, wire: Tensor, counts: Optional[List[int]] = None, value: Any = None) -> None:
        self.red, self.wire, self.counts, self.value = red, wire, counts, value

    def finish(self, stack: Tensor) -> Any:
        if self.counts is None:
            return stack if self.red == Reduction.NONE else self.red(stack)
        return _as_leaf_type(self.value, torch.cat([stack[r, :c] for r, c in enumerate(self.counts)]))


def _default_device(group: Any) -> torch.device:
    """Where a rank puts tensors it makes for a collective (metadata, empty
    rows): host memory on a gloo group, so reading them waits for no card,
    and the current card otherwise (NCCL moves device memory only)."""
    api = _group_api()
    if api.is_initialized() and api.get_backend(group) != "gloo":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _plan_cat_leaves(cats: List[Tuple[str, Any]], group: Any, n: int, device: Optional[torch.device]) -> Dict[str, Any]:
    """Plan the cat leaves: exchange (rows, trailing, dtype) of all of them
    in one collective (none in a group of one), then pad each to the
    group's longest. Returns name -> a :class:`_Leaf`, or the leaf as it
    is when no rank has rows."""
    local = [_rows(v) for _, v in cats]
    device = device or next((r.device for r in local if r is not None), None) or _default_device(group)
    words = [_cat_meta(0, (), None) if r is None else _cat_meta(r.shape[0], tuple(r.shape[1:]), r.dtype)
             for r in local]
    if n == 1:
        metas = [words]
    else:
        mine = torch.tensor(words, dtype=torch.int32, device=_default_device(group))
        record_collective("all_gather", mine.numel() * mine.element_size(), n, dtype=mine.dtype)
        metas = stack_gather(mine, group, SyncPolicy()).tolist()
    out: Dict[str, Any] = {}
    for i, ((name, value), rows) in enumerate(zip(cats, local)):
        per_rank = [metas[r][i] for r in range(n)]
        layout = _group_layout(per_rank)
        if layout is None:
            out[name] = value
            continue
        trailing, dtype = layout
        counts = [m[0] for m in per_rank]
        if rows is None:
            rows = torch.zeros((0, *trailing), dtype=dtype, device=device)
        out[name] = _Leaf(Reduction.CAT, pad_cat_rows(rows, max(counts), trailing, dtype), counts, value)
    return out


def _reduce_leaves(state: Mapping[str, Any], reductions: Mapping[str, Any], group: Any,
                   policy: SyncPolicy) -> Dict[str, Any]:
    n = group_size(group)
    out: Dict[str, Any] = {}
    buckets: Dict[Tuple[Reduction, torch.dtype], List[Tuple[str, Tensor]]] = {}
    cats: List[Tuple[str, Any]] = []
    gathered: Dict[str, _Leaf] = {}
    device = None
    for name, value in sorted(state.items()):
        red = reductions.get(name, Reduction.NONE)
        if red == Reduction.CAT:
            cats.append((name, value))
            continue
        if isinstance(value, (list, tuple)):
            raise TypeError(f"state {name!r}: a list state syncs only under the cat reduction, got {red}")
        device = device or value.device
        if isinstance(red, Reduction) and red in ELEMENTWISE_REDUCTIONS:
            buckets.setdefault((red, value.dtype), []).append((name, value))
        else:
            gathered[name] = _Leaf(red, value)
    for (red, _), entries in buckets.items():
        flat = torch.cat([v.reshape(-1) for _, v in entries]) if len(entries) > 1 else entries[0][1].reshape(-1)
        reduced = _route_elementwise(flat, red, group, policy)
        offset = 0
        for name, v in entries:
            out[name] = reduced[offset : offset + v.numel()].reshape(v.shape)
            offset += v.numel()
    if cats:
        for name, planned in _plan_cat_leaves(cats, group, n, device).items():
            if isinstance(planned, _Leaf):
                gathered[name] = planned
            else:
                out[name] = planned
    by_dtype: Dict[torch.dtype, List[Tuple[str, _Leaf]]] = {}
    for name, leaf in gathered.items():
        by_dtype.setdefault(leaf.wire.dtype, []).append((name, leaf))
    for entries in by_dtype.values():
        wires = [leaf.wire for _, leaf in entries]
        flat = wires[0].reshape(-1) if len(wires) == 1 else torch.cat([w.reshape(-1) for w in wires])
        mat = gather_bucket(flat, group, policy)
        offset = 0
        for (name, leaf), w in zip(entries, wires):
            out[name] = leaf.finish(mat[:, offset : offset + w.numel()].reshape((n, *w.shape)))
            offset += w.numel()
    return {name: out[name] for name in state}  # the caller's key order


def reduce_tensor_in_graph(value: Tensor, reduction: Union[Reduction, Callable], group: Any = None,
                           policy: Optional[SyncPolicy] = None) -> Any:
    """Merge one state leaf across ``group`` (the default group when None)."""
    policy = policy or default_policy()
    return _reduce_leaves({"x": value}, {"x": reduction}, group, policy)["x"]


def reduce_state_in_graph(state: Mapping[str, Any],
                          reductions: Optional[Mapping[str, Union[Reduction, Callable]]] = None,
                          group: Any = None, policy: Optional[SyncPolicy] = None) -> Any:
    """Sync a whole state dict across ``group``; pure: the input is not changed.

    ``state`` is a plain dict with an explicit ``reductions`` mapping, or a
    :class:`~torchmetrics_tpu_torch.state.MetricState`, which carries its
    own (pass ``reductions=None``) and comes back as a MetricState.

    Elementwise leaves sharing a ``(Reduction, dtype)`` pair are flattened
    into one buffer and reduced by one collective, then split back: bitwise
    what per-leaf collectives give. Cat leaves (a tensor, a ``CatBuffer`` or
    a tuple of increments) and NONE/custom leaves are gathered in one
    collective per dtype, after one exchange of the cat leaves' row counts
    when the group has more than one rank. A cat leaf comes back as every
    rank's rows in rank order, in its own form (a ``CatBuffer``, a tuple of
    one increment, a tensor); ranks may hold different row counts, or none.
    A NONE leaf comes back as the ``(world, ...)`` stack.
    """
    if reductions is None:
        reductions = getattr(state, "reductions", None)
        if reductions is None:
            raise TypeError("reduce_state_in_graph: pass an explicit `reductions` mapping "
                            "or a MetricState that carries its own reduction metadata")
    policy = policy or default_policy()
    begin_sync()
    out = _reduce_leaves(state, reductions, group, policy)
    if hasattr(state, "with_leaves"):  # MetricState in, MetricState out
        return state.with_leaves(out)
    return out


# ---------------------------------------------------------------------------
# eager backends for the class API
# ---------------------------------------------------------------------------

class SyncBackend:
    """Protocol for eager state synchronization."""

    def is_available(self) -> bool:
        raise NotImplementedError

    def world_size(self) -> int:
        raise NotImplementedError

    def sync_tensor(self, value: Tensor, reduction: Union[Reduction, Callable]) -> Tensor:
        raise NotImplementedError

    def all_gather_object(self, obj: Any) -> list:
        raise NotImplementedError


class NoSync(SyncBackend):
    """Single-process backend: everything is identity."""

    def is_available(self) -> bool:
        return False

    def world_size(self) -> int:
        return 1

    def sync_tensor(self, value: Tensor, reduction) -> Tensor:
        return value

    def all_gather_object(self, obj: Any) -> list:
        return [obj]


class HostSync(SyncBackend):
    """The ``torch.distributed`` backend of the class API's eager sync.

    Gathers a ``(world, ...)`` stack over ``group`` (the default group when
    ``None``) and reduces it over dim 0 in rank order, as the JAX package's
    ``HostSync`` does over ``multihost_utils``, so float SUM/MEAN results
    are deterministic. ``cat`` states use the pad-to-max protocol: every
    rank sends its length, trailing shape and dtype first, so ranks may
    hold different row counts, or none (a rank with none takes the group's
    layout). Available when the group has more than one rank.

    Args:
        timeout_s: a wall-clock bound per gather. ``None`` blocks as
            ``torch.distributed`` does. With a bound, a gather that does not
            finish raises :class:`TimeoutError` and *poisons* the instance:
            its collective may still complete later and would pair with the
            next one, so every further gather through it raises until
            :meth:`recovery_barrier` succeeds or :meth:`clear_poison` is
            called after the process group was torn down and set up again.
        group: the process group; ``None`` is the default group.
    """

    def __init__(self, timeout_s: Optional[float] = None, group: Any = None) -> None:
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError(f"`timeout_s` must be positive or None, got {timeout_s}")
        self.timeout_s = timeout_s
        self.group = group
        self._poisoned = False

    def is_available(self) -> bool:
        return self.world_size() > 1

    def world_size(self) -> int:
        return group_size(self.group)

    @property
    def poisoned(self) -> bool:
        """True when an earlier gather on this instance timed out."""
        return self._poisoned

    def clear_poison(self) -> None:
        """Re-arm this instance after a gather timeout; call it only once the
        timed-out collective cannot complete any more (the process group
        was torn down and set up again)."""
        self._poisoned = False
        _POISONED_BACKENDS.discard(self)

    def _gather(self, value: Tensor, _bypass_poison: bool = False) -> Tensor:
        """``(world, *value.shape)`` in rank order, under the watchdog.

        A gather cannot be interrupted, so with ``timeout_s`` set it runs on
        a daemon thread that the caller joins with the deadline; on expiry
        the thread is left behind and the instance is poisoned.
        """
        if self._poisoned and not _bypass_poison:
            raise RuntimeError(
                "This HostSync instance is poisoned by an earlier gather timeout: the timed-out "
                "collective may still be in flight, and another would pair with it and silently "
                "corrupt every later collective. Run backend.recovery_barrier() (it clears the poison "
                "on success), or set the process group up again and call backend.clear_poison()."
            )
        if self.timeout_s is None:
            return stack_gather(value, self.group)
        result: list = []
        err: list = []
        device = torch.cuda.current_device() if value.is_cuda else None

        def run() -> None:
            try:
                if device is not None:
                    torch.cuda.set_device(device)
                result.append(stack_gather(value, self.group))
            except Exception as e:  # raised on the caller's thread below
                err.append(e)

        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        worker.join(self.timeout_s)
        if worker.is_alive():
            self._poisoned = True
            _POISONED_BACKENDS.add(self)
            raise TimeoutError(
                f"HostSync gather did not complete within {self.timeout_s}s: a peer process is likely "
                f"stalled or dead (world_size={self.world_size()}). Local metric state is intact; "
                "further gathers through this instance raise until the poison is cleared."
            )
        if err:
            raise err[0]
        return result[0]

    def recovery_barrier(self, timeout_s: Optional[float] = None) -> None:
        """One tiny gather that, when it completes, shows this process and
        its peers are sequenced on the same collectives again, and clears
        the poison. It keeps the watchdog: a barrier that times out leaves
        the instance poisoned and raises."""
        prev = self.timeout_s
        if timeout_s is not None:
            if timeout_s <= 0:
                raise ValueError(f"`timeout_s` must be positive or None, got {timeout_s}")
            self.timeout_s = timeout_s
        try:
            self._gather(torch.zeros((), dtype=torch.int32, device=_default_device(self.group)), _bypass_poison=True)
        finally:
            self.timeout_s = prev
        self.clear_poison()

    def sync_tensor(self, value: Tensor, reduction) -> Tensor:
        kind = "eager_reduce" if reduction in ELEMENTWISE_REDUCTIONS else "eager_gather"
        record_collective(kind, value.numel() * value.element_size(), self.world_size(), dtype=value.dtype)
        if reduction == Reduction.CAT:
            rows = value.reshape(1) if value.ndim == 0 else value
            return self._gather_cat(rows, rows.shape[0])
        return _reduce_stack(self._gather(value), reduction)

    def sync_cat_padded(self, buffer: Tensor, count: int) -> Tensor:
        """Gather a padded cat buffer with its valid row count: every rank
        ships its first ``max(counts)`` buffer rows (a view when its
        capacity holds them) and the receiver keeps each rank's ``count``
        rows. A rank that never appended takes part with a 0-row tensor."""
        record_collective("eager_gather", count * buffer[:1].numel() * buffer.element_size(), self.world_size())
        return self._gather_cat(buffer, count)

    def _gather_cat(self, rows: Tensor, count: int) -> Tensor:
        """The pad-to-max protocol: gather (count, trailing, dtype) first,
        ship ``max(count)`` rows each, cut every rank back to its count."""
        words = _cat_meta(count, tuple(rows.shape[1:]), rows.dtype)
        metas = self._gather(torch.tensor(words, dtype=torch.int32, device=_default_device(self.group))).tolist()
        layout = _group_layout(metas)
        if layout is None:  # every rank is empty
            return rows[:0]
        trailing, dtype = layout
        counts = [m[0] for m in metas]
        longest = max(counts)
        local = rows[:count] if count else rows[:0]
        if rows.shape[0] >= longest and tuple(rows.shape[1:]) == trailing and rows.dtype == dtype:
            shipped = rows[:longest]  # the buffer's own rows past count ride along, masked on receipt
        else:
            shipped = pad_cat_rows(local, longest, trailing, dtype)
        stack = self._gather(shipped)
        return torch.cat([stack[r, :c] for r, c in enumerate(counts)])

    def all_gather_object(self, obj: Any) -> list:
        """Every rank's picklable object, in rank order: lengths first, then
        the pickles padded to the longest, as bytes."""
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        device = _default_device(self.group)
        lens = self._gather(torch.tensor(payload.numel(), dtype=torch.int64, device=device)).tolist()
        padded = torch.zeros(max(lens), dtype=torch.uint8, device=device)
        padded[: payload.numel()] = payload.to(device)
        gathered = self._gather(padded).cpu()
        return [pickle.loads(gathered[r, :n].numpy().tobytes()) for r, n in enumerate(lens)]


class FakeSync(SyncBackend):
    """An N-rank group emulated in one process, for tests.

    ``group_states`` holds one state dict per emulated rank; ``sync_tensor``
    reduces the group's values of the addressed state, as a real group's
    gather would. Address each call with :meth:`set_current` first.
    """

    def __init__(self, group_states: list, rank: int) -> None:
        self._group = group_states
        self._rank = rank
        self._current_name: Union[str, tuple, None] = None

    def is_available(self) -> bool:
        return True

    def world_size(self) -> int:
        return len(self._group)

    def set_current(self, name: Union[str, tuple]) -> None:
        """Address the next call: a state name; a tuple of names for a
        bucketed call (each rank's leaves flattened and concatenated in that
        order, as ``Metric.sync`` buckets them); or a ``(name, start, stop)``
        range into a cat state (each rank gives rows ``[start, stop)`` of a
        ``CatBuffer``, or increments ``[start, stop)`` of a list)."""
        self._current_name = name

    @staticmethod
    def _is_range(name: Any) -> bool:
        return (isinstance(name, tuple) and len(name) == 3 and isinstance(name[0], str)
                and isinstance(name[1], int) and isinstance(name[2], int))

    def _rows_of(self, peer: Any, empty: Tensor) -> Tensor:
        if isinstance(peer, CatBuffer):
            return peer.materialize()
        if isinstance(peer, (list, tuple)):
            rows = [_row_form(torch.as_tensor(r)) for r in peer]
            return torch.cat(rows) if rows else empty
        return _row_form(torch.as_tensor(peer))

    def sync_tensor(self, value: Tensor, reduction) -> Tensor:
        name = self._current_name
        kind = "eager_reduce" if reduction in ELEMENTWISE_REDUCTIONS else "eager_gather"
        record_collective(kind, value.numel() * value.element_size(), self.world_size(), dtype=value.dtype)
        empty = torch.as_tensor(value).reshape(-1)[:0] if value.ndim == 0 else value[:0]
        if self._is_range(name):
            key, start, stop = name
            peers = []
            for s in self._group:
                peer = s[key]
                if isinstance(peer, CatBuffer):
                    rows = peer.rows(start, stop)
                    peers.append(rows if rows.shape[0] else empty)
                else:
                    peers.append(self._rows_of(list(peer)[start:stop], empty))
            return torch.cat(peers)
        if isinstance(name, tuple):
            peers = [torch.cat([torch.as_tensor(s[n]).reshape(-1) for n in name]) for s in self._group]
        elif reduction == Reduction.CAT:
            peers = [self._rows_of(s[name], empty) for s in self._group]
        else:
            peers = [torch.as_tensor(s[name]) for s in self._group]
        if reduction == Reduction.CAT:
            # a rank that never appended holds a (0,) float32 placeholder;
            # as on a real group, it takes no part in the group's layout
            nonempty = [p for p in peers if p.shape[0]]
            return torch.cat(nonempty) if nonempty else empty
        return _reduce_stack(torch.stack(peers), reduction)

    def sync_cat_padded(self, buffer: Tensor, count: int) -> Tensor:
        """Each emulated rank's valid rows of the addressed cat state,
        concatenated, as :meth:`HostSync.sync_cat_padded` gathers them."""
        record_collective("eager_gather", count * buffer[:1].numel() * buffer.element_size(), self.world_size())
        empty = torch.zeros((0, *buffer.shape[1:]), dtype=buffer.dtype, device=buffer.device)
        peers = [self._rows_of(s[self._current_name], empty) for s in self._group]
        nonempty = [p for p in peers if p.shape[0]]
        return torch.cat(nonempty) if nonempty else buffer[:0]

    def all_gather_object(self, obj: Any) -> list:
        if self._current_name is None:
            raise RuntimeError("FakeSync.all_gather_object requires set_current(name) first")
        return [s[self._current_name] for s in self._group]


def default_sync_backend() -> SyncBackend:
    """``HostSync`` over the default group when it has more than one rank,
    else ``NoSync``."""
    return HostSync() if group_size() > 1 else NoSync()
