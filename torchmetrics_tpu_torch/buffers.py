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
and takes the gathered rows back with :meth:`CatBuffer.from_rows`. Not
ported: ``ShardedCatBuffer`` and the mesh helpers (ROADMAP A13).
"""
from typing import Any, Optional, Sequence, Tuple

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
