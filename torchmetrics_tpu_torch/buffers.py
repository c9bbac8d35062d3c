"""Padded geometric cat-state buffers.

Counterpart of ``torchmetrics_tpu/buffers.py`` ``CatBuffer`` (:112),
``CatLayoutError`` (:50) and ``cat_rows`` (:637). A list (``cat``) state
that keeps one tensor per ``update`` is concatenated at compute, which holds
the whole state twice at that moment. ``CatBuffer`` keeps the rows in one
preallocated device tensor instead: its capacity is a power of two (at
least ``MIN_CAPACITY`` rows), an append is one ``copy_`` into the slice past
the valid rows, a full buffer doubles (one copy of the valid rows into the
new allocation), and readers take ``buffer[:count]``, a view: compute copies
nothing. Rows at or past ``count`` are garbage that no reader sees.

The device never reports a row count back: ``count`` is a host integer kept
from the increments' shapes, so appends and reads make no host sync.

Snapshots are copy-on-write: ``snapshot()`` aliases the tensor and marks
both sides unowned; the next append on either side copies first, so a
cached snapshot (a forward's full-state restore, a collection member that
left its group) never sees the other's later rows overwrite its garbage
region. A sync ships ``buffer`` and ``count`` (``HostSync.sync_cat_padded``)
and takes the gathered rows back with :meth:`CatBuffer.from_rows`.

:class:`ShardedCatBuffer` (JAX ``buffers.py:339-636``) partitions a cat
state over an eval mesh, a sequence of ``torch.device`` s of this process
(:func:`default_eval_mesh`): one ``(capacity,) + trailing`` tensor per
shard, on its own device. A device may be listed more than once, to stand
for several shards on one device. Sharding is across the devices of one
process; a sync across processes gathers the rows and re-shards them.
"""
import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

MIN_CAPACITY = 8


class CatLayoutError(TypeError):
    """An increment does not fit the padded buffer's row layout.

    Raised when an increment's trailing (non-concatenated) dimensions differ
    from the buffer's; the owning metric then keeps that state in the list
    layout, which takes ragged increments until they are concatenated.
    """


def _capacity_for(rows: int) -> int:
    """The least power of two >= ``rows``, and at least ``MIN_CAPACITY``."""
    return max(1 << max(rows - 1, 0).bit_length(), MIN_CAPACITY)


def _row_form(inc: Any) -> Tensor:
    """An increment as (rows,) + trailing: a scalar becomes one row, as
    ``dim_zero_cat`` reads it."""
    t = inc if isinstance(inc, torch.Tensor) else torch.as_tensor(inc)
    return t.reshape(1) if t.ndim == 0 else t


class CatBuffer:
    """Growable padded cat state: ``(buffer, count)`` with power-of-two capacity.

    Appends change ``buffer`` and ``count`` on the same object, so aliases a
    collection's compute group holds stay current. Equality compares the
    valid rows (a list or tuple compares as its concatenation); hashing is by
    identity, as for a list.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CatBuffer
        >>> buf = CatBuffer.allocate(torch.tensor([1.0, 2.0, 3.0]))
        >>> buf.append(torch.tensor([4.0, 5.0]))
        >>> len(buf), buf.capacity, buf.materialize().tolist()
        (5, 8, [1.0, 2.0, 3.0, 4.0, 5.0])
    """

    __slots__ = ("buffer", "count", "_owns")

    def __init__(self, buffer: Tensor, count: int, owns: bool = True) -> None:
        self.buffer = buffer
        self.count = int(count)
        self._owns = owns

    # ------------------------------------------------------------- creation

    @classmethod
    def allocate(cls, first_inc: Any) -> "CatBuffer":
        """A buffer holding one increment, its capacity fitted to it."""
        inc = _row_form(first_inc)
        buf = cls(torch.empty((_capacity_for(inc.shape[0]),) + tuple(inc.shape[1:]), dtype=inc.dtype,
                              device=inc.device), 0)
        buf.append(inc)
        return buf

    @classmethod
    def from_increments(cls, increments: Sequence[Any]) -> "CatBuffer":
        """A buffer holding the concatenation of ``increments``; raises
        :class:`CatLayoutError` when their trailing shapes differ."""
        rows = [_row_form(e) for e in increments]
        trailings = {tuple(r.shape[1:]) for r in rows}
        if len(trailings) > 1:
            raise CatLayoutError(f"ragged increment trailing shapes {sorted(trailings)}")
        buf = cls.allocate(rows[0])
        for r in rows[1:]:
            buf.append(r)
        return buf

    @classmethod
    def from_rows(cls, rows: Tensor) -> "CatBuffer":
        """A buffer over gathered rows (a sync's result), without a copy: its
        capacity is the row count, and the first append copies (the rows
        are not its own) into a power-of-two buffer."""
        rows = _row_form(rows)
        return cls(rows, rows.shape[0], owns=False)

    # ------------------------------------------------------------ properties

    @property
    def capacity(self) -> int:
        return self.buffer.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.buffer.dtype

    @property
    def device(self) -> torch.device:
        return self.buffer.device

    @property
    def trailing(self) -> Tuple[int, ...]:
        return tuple(self.buffer.shape[1:])

    # -------------------------------------------------------------- mutation

    def append(self, inc: Any) -> None:
        """Append one increment: one ``copy_`` into the buffer, and on
        overflow one copy of the valid rows into a buffer of twice (or more)
        the capacity."""
        inc = _row_form(inc)
        if tuple(inc.shape[1:]) != self.trailing:
            raise CatLayoutError(f"increment trailing shape {tuple(inc.shape[1:])} != buffer trailing {self.trailing}")
        if inc.device != self.device:
            raise ValueError(f"increment on {inc.device} but the buffer lives on {self.device}")
        if inc.dtype != self.dtype:
            promoted = torch.promote_types(self.dtype, inc.dtype)
            if promoted != self.dtype:  # rare widening: the whole buffer is cast once
                self.buffer = self.buffer.to(promoted)
                self._owns = True
            inc = inc.to(promoted)
        rows = inc.shape[0]
        if rows == 0:
            return
        needed = self.count + rows
        if needed > self.capacity:
            grown = torch.empty((_capacity_for(needed),) + self.trailing, dtype=self.dtype, device=self.device)
            grown[: self.count].copy_(self.buffer[: self.count])
            self.buffer = grown
        elif not self._owns:
            # copy-on-write: a snapshot aliases this tensor
            self.buffer = self.buffer.clone()
        self.buffer[self.count : needed].copy_(inc)
        self._owns = True
        self.count = needed

    # --------------------------------------------------------------- reading

    def materialize(self) -> Tensor:
        """The valid rows ``buffer[:count]``, a view (never the raw buffer)."""
        return self.buffer[: self.count]

    def rows(self, start: int, stop: int) -> Tensor:
        """Rows ``[start, stop)`` of the valid region; ``stop`` is clamped to
        ``count``, so no padding row reaches a sync."""
        return self.buffer[start : min(stop, self.count)]

    def snapshot(self) -> "CatBuffer":
        """An O(1) copy sharing the tensor; the next append on either side
        copies first."""
        self._owns = False
        return CatBuffer(self.buffer, self.count, owns=False)

    def apply(self, fn: Any) -> "CatBuffer":
        """A new buffer of ``fn(buffer)`` (a device or dtype move); a move
        that returns the same tensor gives a copy-on-write snapshot."""
        moved = fn(self.buffer)
        return self.snapshot() if moved is self.buffer else CatBuffer(moved, self.count)

    # ------------------------------------------------------------- protocols

    def __len__(self) -> int:
        return self.count

    def __eq__(self, other: Any) -> Any:
        if other is self:
            return True
        if isinstance(other, CatBuffer):
            if self.count != other.count or self.trailing != other.trailing:
                return False
            return self.count == 0 or bool(torch.equal(self.materialize(), other.materialize()))
        if isinstance(other, (list, tuple)):
            if len(other) == 0:
                return self.count == 0
            try:
                cat = torch.cat([_row_form(e) for e in other], dim=0)
            except (RuntimeError, TypeError):
                return NotImplemented
            if tuple(cat.shape) != (self.count,) + self.trailing:
                return False
            return bool(torch.equal(self.materialize(), cat.to(self.dtype)))
        return NotImplemented

    __hash__ = object.__hash__

    def __repr__(self) -> str:
        return (f"CatBuffer(count={self.count}, capacity={self.capacity}, trailing={self.trailing}, "
                f"dtype={self.dtype}, device={self.device})")

    # ------------------------------------------------- pickle / deepcopy

    def __getstate__(self) -> Tuple[Tensor, int]:
        # the valid rows only, not the capacity's garbage
        return self.materialize().clone(), self.count

    def __setstate__(self, state: Tuple[Tensor, int]) -> None:
        valid, count = state
        self.buffer = torch.empty((_capacity_for(max(count, 1)),) + tuple(valid.shape[1:]), dtype=valid.dtype,
                                  device=valid.device)
        self.buffer[:count].copy_(valid)
        self.count = int(count)
        self._owns = True

    def __deepcopy__(self, memo: dict) -> "CatBuffer":
        new = CatBuffer(self.buffer.clone(), self.count)
        memo[id(self)] = new
        return new


# ---------------------------------------------------------------------------
# the sharded layout
# ---------------------------------------------------------------------------

Mesh = Tuple[torch.device, ...]

_MESH_OVERRIDE: List[Optional[Mesh]] = [None]


def default_eval_mesh(devices: Optional[Sequence[Any]] = None, like: Any = None) -> Mesh:
    """The eval mesh sharded cat state lives on (JAX ``buffers.py:36-42``).

    ``devices`` builds the mesh from those devices (a sub-mesh of
    survivors, a reshard target; repeats allowed). Otherwise the mesh in
    force under :func:`use_eval_mesh`, else every visible CUDA device when
    ``like`` (the state's device) is a card, else ``like`` alone (the CPU
    when ``like`` is None and no card is visible).
    """
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if not mesh:
            raise ValueError("an eval mesh needs at least one device")
        return mesh
    if _MESH_OVERRIDE[0] is not None:
        return _MESH_OVERRIDE[0]
    like = torch.device(like) if like is not None else None
    if like is None:
        like = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if like.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (like,)


@contextlib.contextmanager
def use_eval_mesh(devices: Sequence[Any]) -> Iterator[Mesh]:
    """Make ``devices`` the default eval mesh inside the block: a metric
    built there (``cat_layout="sharded"``) shards its cat states over it,
    and unpickling rebalances onto it. ``[torch.device("cpu")] * 8`` gives
    eight shards in one process."""
    prev = _MESH_OVERRIDE[0]
    _MESH_OVERRIDE[0] = default_eval_mesh(devices)
    try:
        yield _MESH_OVERRIDE[0]
    finally:
        _MESH_OVERRIDE[0] = prev


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _split_counts(rows: int, n: int, chunk: int) -> np.ndarray:
    """Rows shard ``s`` takes of an increment of ``rows`` split into
    ``chunk``-row slabs: rows ``[s·chunk, (s+1)·chunk)``, clipped."""
    return np.clip(rows - np.arange(n) * chunk, 0, chunk).astype(np.int32)


class ShardedCatBuffer(CatBuffer):
    """A cat state partitioned over an eval mesh: shard ``s`` is a
    ``(capacity,) + trailing`` tensor on ``mesh[s]`` with ``counts[s]``
    valid rows (counts mirrored on the host, so an append reads nothing
    back from a device).

    An append of ``rows`` rows splits into ``ceil(rows / n)``-row slabs and
    shard ``s`` takes rows ``[s·chunk, (s+1)·chunk)`` at its own count, as
    the JAX package places them (``buffers.py:451-501``); every shard has
    one capacity, grown for all when the fullest would overflow. Where all
    shards share one device, an append is one ``copy_`` per shard and no
    host read, so the update that produced the rows may be captured.

    Reading: the valid rows in shard-major order (:meth:`materialize`), NOT
    append order. States appended in lockstep (``preds``/``target``) share
    counts, so their rows stay aligned, and every exact consumer of cat
    state is row-order-invariant. ``dim_zero_cat``/``padded_cat`` refuse
    this type outside :func:`~torchmetrics_tpu_torch.utils.data.sharded_oracle`;
    compute paths read it through
    :mod:`~torchmetrics_tpu_torch.parallel.sharded_compute`.

    Pickling stores the valid rows; unpickling rebuilds balanced shards on
    the current default mesh (a checkpoint taken on one mesh rejoins
    another resharded).
    """

    __slots__ = ("shards", "counts", "mesh", "owner")

    def __init__(self, shards: Sequence[Tensor], counts: Any, mesh: Optional[Sequence[Any]] = None,
                 owns: bool = True, owner: Optional[str] = None) -> None:
        self.shards = list(shards)
        self.counts = np.asarray(counts, np.int32).copy()
        self.count = int(self.counts.sum())
        self._owns = owns
        self.mesh = tuple(torch.device(d) for d in mesh) if mesh is not None else tuple(t.device for t in self.shards)
        self.owner = owner

    # ------------------------------------------------------------- creation

    @classmethod
    def allocate(cls, first_inc: Any, mesh: Optional[Sequence[Any]] = None,
                 owner: Optional[str] = None) -> "ShardedCatBuffer":
        inc = _row_form(first_inc)
        mesh = default_eval_mesh(mesh, like=inc.device)
        cap = _capacity_for(_ceil_div(max(inc.shape[0], 1), len(mesh)))
        shards = [torch.zeros((cap,) + tuple(inc.shape[1:]), dtype=inc.dtype, device=d) for d in mesh]
        out = cls(shards, np.zeros(len(mesh), np.int32), mesh=mesh, owner=owner)
        out.append(inc)
        return out

    @classmethod
    def from_increments(cls, increments: Sequence[Any], mesh: Optional[Sequence[Any]] = None,
                        owner: Optional[str] = None) -> "ShardedCatBuffer":
        rows = [_row_form(e) for e in increments]
        trailings = {tuple(r.shape[1:]) for r in rows}
        if len(trailings) > 1:
            raise CatLayoutError(f"ragged increment trailing shapes {sorted(trailings)}")
        first = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
        return cls.allocate(first, mesh=mesh, owner=owner)

    @classmethod
    def from_rows(cls, rows: Any, mesh: Optional[Sequence[Any]] = None,
                  owner: Optional[str] = None) -> "ShardedCatBuffer":
        """Balanced shards over dense rows (a sync's result, a restore)."""
        return cls.allocate(_row_form(rows), mesh=mesh, owner=owner)

    # ------------------------------------------------------------ properties

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def capacity(self) -> int:
        """Per-shard row capacity (the grow and garbage contract is per shard)."""
        return self.shards[0].shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device, where dense reads land."""
        return self.mesh[0]

    @property
    def trailing(self) -> Tuple[int, ...]:
        return tuple(self.shards[0].shape[1:])

    def valid_shards(self) -> List[Tensor]:
        """Each shard's valid rows, a view on its own device."""
        return [t[: int(c)] for t, c in zip(self.shards, self.counts)]

    def per_shard_nbytes(self) -> List[int]:
        """Resident bytes of each shard."""
        return [t.numel() * t.element_size() for t in self.shards]

    def per_device_nbytes(self) -> Dict[torch.device, int]:
        """Resident bytes per device (shards that share a device add up)."""
        out: Dict[torch.device, int] = {}
        for d, nbytes in zip(self.mesh, self.per_shard_nbytes()):
            out[d] = out.get(d, 0) + nbytes
        return out

    # -------------------------------------------------------------- mutation

    def append(self, inc: Any) -> None:
        inc = _row_form(inc)
        if tuple(inc.shape[1:]) != self.trailing:
            raise CatLayoutError(f"increment trailing shape {tuple(inc.shape[1:])} != buffer trailing {self.trailing}")
        if inc.dtype != self.dtype:
            promoted = torch.promote_types(self.dtype, inc.dtype)
            if promoted != self.dtype:
                self.shards = [t.to(promoted) for t in self.shards]
                self._owns = True
            inc = inc.to(promoted)
        rows = inc.shape[0]
        if rows == 0:
            return
        n = self.n_shards
        chunk = _ceil_div(rows, n)
        valid = _split_counts(rows, n, chunk)
        top = int(self.counts.max()) + chunk
        if top > self.capacity:
            cap = _capacity_for(top)
            grown = []
            for t, c in zip(self.shards, self.counts):
                g = torch.zeros((cap,) + self.trailing, dtype=self.dtype, device=t.device)
                g[: int(c)].copy_(t[: int(c)])
                grown.append(g)
            self.shards = grown
        elif not self._owns:
            self.shards = [t.clone() for t in self.shards]
        for s in range(n):
            v, c = int(valid[s]), int(self.counts[s])
            if v:
                self.shards[s][c : c + v].copy_(inc[s * chunk : s * chunk + v])
        self._owns = True
        self.counts = self.counts + valid
        self.count = int(self.counts.sum())

    # --------------------------------------------------------------- reading

    def materialize(self) -> Tensor:
        """The valid rows in shard-major order, on the first shard's device:
        the oracle and wire read (API-level densify refuses this type)."""
        parts = [t.to(self.device) for t in self.valid_shards() if t.shape[0]]
        if not parts:
            return torch.zeros((0,) + self.trailing, dtype=self.dtype, device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def rows(self, start: int, stop: int) -> Tensor:
        return self.materialize()[start : min(stop, self.count)]

    def padded_wire(self) -> Tuple[Tensor, int]:
        """A dense power-of-two padded ``(buffer, count)`` for the sync
        wire (``sync_cat_padded``): a gather across processes moves the
        bytes whatever the layout."""
        rows = self.materialize()
        pad = torch.zeros((_capacity_for(max(self.count, 1)) - rows.shape[0],) + self.trailing, dtype=self.dtype,
                          device=rows.device)
        return torch.cat([rows, pad], dim=0), self.count

    def snapshot(self) -> "ShardedCatBuffer":
        self._owns = False
        return ShardedCatBuffer(self.shards, self.counts, mesh=self.mesh, owns=False, owner=self.owner)

    def astype(self, dtype: torch.dtype) -> "ShardedCatBuffer":
        return ShardedCatBuffer([t.to(dtype) for t in self.shards], self.counts, mesh=self.mesh, owner=self.owner)

    def to_device(self, device: Any) -> "ShardedCatBuffer":
        """The mesh is the placement: moving to one device would un-shard the
        state, so this is the identity, as in the JAX package."""
        return self

    def apply(self, fn: Any) -> "ShardedCatBuffer":
        """``fn`` (a metric's device or dtype move) on every shard; the mesh
        follows the shards."""
        moved = [fn(t) for t in self.shards]
        if all(m is t for m, t in zip(moved, self.shards)):
            return self.snapshot()
        return ShardedCatBuffer(moved, self.counts, owner=self.owner)

    # ------------------------------------------------------------- protocols

    def __eq__(self, other: Any) -> Any:
        if other is self:
            return True
        if isinstance(other, ShardedCatBuffer):
            if self.count != other.count or self.trailing != other.trailing:
                return False
            # the two may live on different meshes (before and after a
            # reshard, which keeps the shard-major row stream): compare rows
            return self.count == 0 or bool(torch.equal(self.materialize().cpu(), other.materialize().cpu()))
        if isinstance(other, (CatBuffer, list, tuple)):
            # against another layout the comparison ignores row order:
            # shard-major rows permute the append order
            if isinstance(other, CatBuffer):
                cat = other.materialize()
            else:
                if len(other) == 0:
                    return self.count == 0
                try:
                    cat = torch.cat([_row_form(e) for e in other], dim=0)
                except (RuntimeError, TypeError):
                    return NotImplemented
            mine = self.materialize()
            if tuple(cat.shape) != tuple(mine.shape):
                return False
            if self.count == 0:
                return True
            flat_a = mine.cpu().numpy().reshape(self.count, -1)
            flat_b = cat.to(mine.dtype).cpu().numpy().reshape(self.count, -1)
            order_a = np.lexsort(flat_a.T[::-1])
            order_b = np.lexsort(flat_b.T[::-1])
            return bool(np.array_equal(flat_a[order_a], flat_b[order_b]))
        return NotImplemented

    __hash__ = object.__hash__

    def __repr__(self) -> str:
        return (f"ShardedCatBuffer(count={self.count}, shards={self.n_shards}, capacity/shard={self.capacity}, "
                f"trailing={self.trailing}, dtype={self.dtype})")

    # ------------------------------------------------- pickle / deepcopy

    def __getstate__(self) -> Tuple[Tensor, int, Optional[str]]:
        return self.materialize().clone(), self.count, self.owner

    def __setstate__(self, state: Tuple[Any, ...]) -> None:
        valid, count, owner = state
        count = int(count)
        mesh = default_eval_mesh(like=valid.device)
        n = len(mesh)
        chunk = _ceil_div(max(count, 1), n)
        counts = _split_counts(count, n, chunk)
        shards = []
        for s, d in enumerate(mesh):
            t = torch.zeros((_capacity_for(chunk),) + tuple(valid.shape[1:]), dtype=valid.dtype, device=d)
            t[: int(counts[s])].copy_(valid[s * chunk : s * chunk + int(counts[s])])
            shards.append(t)
        self.shards, self.counts, self.count = shards, counts, count
        self._owns, self.mesh, self.owner = True, mesh, owner

    def __deepcopy__(self, memo: dict) -> "ShardedCatBuffer":
        new = ShardedCatBuffer([t.clone() for t in self.shards], self.counts, mesh=self.mesh, owner=self.owner)
        memo[id(self)] = new
        return new


def cat_rows(value: Any, template: Optional[Tensor] = None) -> Tensor:
    """The concatenated valid rows of a cat state in any layout.

    Takes a :class:`CatBuffer` (its valid view), a list or tuple of
    increments (one increment is returned as it is, not copied), or a
    tensor. An empty list gives a 0-row tensor shaped like ``template``, or
    ``(0,)`` float32 without one.
    """
    if isinstance(value, CatBuffer):
        return value.materialize()
    if isinstance(value, (list, tuple)):
        if not value:
            if template is not None:
                return torch.zeros((0,) + tuple(template.shape[1:]), dtype=template.dtype, device=template.device)
            return torch.zeros((0,), dtype=torch.float32)
        rows = [_row_form(e) for e in value]
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
    return _row_form(value)
