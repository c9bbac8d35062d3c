"""Sequence and expert parallelism over ``torch.distributed``: ring attention
and the expert all-to-all.

Counterpart of ``torchmetrics_tpu/parallel/ring.py``. ``group=`` (the
default group when ``None``) takes the place of ``axis_name``, as in
:mod:`~torchmetrics_tpu_torch.parallel.sync`; the collectives are issued
eagerly, so every rank of the group must make the same calls in the same
order.

``ring_attention`` is exact: a blockwise softmax with a running max and
normaliser, folded in float32 whatever the input dtype, so its output
equals full attention up to the order of float additions. The sequence is
sharded over the group in rank order; each rank folds its own key/value
block, then passes the blocks one hop round the ring and folds what it
received, ``n - 1`` times.

``expert_all_to_all`` is the dispatch and combine of an expert-parallel
layer: the tiled all-to-all, whose second call with the same arguments
undoes the first.

Both move tensors with ``all_to_all_single`` only: one primitive that
NCCL and gloo take on CUDA tensors alike (gloo's ``send``/``recv`` take
host tensors only), so no block is staged through the host by this code.
Both are differentiable: the ring shift's backward shifts the cotangent
the other way round (the transpose of a permutation), the all-to-all's
backward is the all-to-all with the split and concat axes swapped.
"""
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from .strategies import group_rank, group_size

Tensor = torch.Tensor

__all__ = ["ring_attention", "expert_all_to_all"]


def _shift(x: Tensor, group: Any, hop: int) -> Tensor:
    """Send ``x`` to rank ``rank + hop`` of ``group`` and return what rank
    ``rank - hop`` sent: one ``all_to_all_single`` with every split but the
    peer's empty."""
    n, rank = group_size(group), group_rank(group)
    flat = x.contiguous().reshape(-1)
    send = [0] * n
    recv = [0] * n
    send[(rank + hop) % n] = flat.numel()
    recv[(rank - hop) % n] = flat.numel()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, output_split_sizes=recv, input_split_sizes=send, group=group)
    return out.reshape(x.shape)


class _RingShift(torch.autograd.Function):
    """``lax.ppermute`` to ``rank + 1``; the backward shifts to ``rank - 1``."""

    @staticmethod
    def forward(ctx, x: Tensor, group: Any) -> Tensor:
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tuple[Tensor, None]:
        return _shift(grad, ctx.group, -1), None


def ring_shift(x: Tensor, group: Any = None) -> Tensor:
    """``x`` of rank ``r - 1`` of ``group`` (the ring's predecessor), differentiably."""
    if group_size(group) == 1:
        return x
    return _RingShift.apply(x, group)


def _all_to_all(x: Tensor, group: Any, split_axis: int, concat_axis: int) -> Tensor:
    n = group_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"expert_all_to_all: axis {split_axis} of size {x.shape[split_axis]} does not split "
                         f"over {n} ranks")
    # chunk i of the split axis goes to rank i: lay the chunks out first
    chunks = x.movedim(split_axis, 0)
    chunks = chunks.reshape(n, chunks.shape[0] // n, *chunks.shape[1:]).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    # out[j] came from rank j: put each back in place and join in rank order
    return torch.cat([c.movedim(0, split_axis) for c in out.unbind(0)], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, group: Any, split_axis: int, concat_axis: int) -> Tensor:
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad: Tensor):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(grad, group, concat_axis, split_axis), None, None, None


def expert_all_to_all(tokens: Tensor, group: Any = None, split_axis: int = 0, concat_axis: int = 0) -> Tensor:
    """Dispatch token groups to the experts that own them (and back).

    ``split_axis`` of ``tokens`` holds one block per rank of ``group``
    (its size a multiple of the group's): block ``i`` goes to rank ``i``,
    and the blocks received are joined along ``concat_axis`` in rank order
    (``lax.all_to_all(..., tiled=True)``). A second call with the same
    arguments is the inverse for a symmetric layout.
    """
    split_axis %= tokens.dim()
    concat_axis %= tokens.dim()
    if group_size(group) == 1:
        return tokens
    return _AllToAll.apply(tokens, group, split_axis, concat_axis)


def _fold(stats, q: Tensor, k_blk: Tensor, v_blk: Tensor, q_pos: Optional[Tensor], src: int, scale: float):
    """Fold one key/value block into the running float32 ``(m, l, o)``
    softmax statistics (JAX ``ring.py:67-84``). ``q_pos`` is None when not
    causal. The ``-inf`` guards keep fully masked rows at zero; each guarded
    branch also sees finite inputs, so the backward never multiplies a
    zero by a NaN."""
    m, l, o = stats
    s = torch.matmul(q, k_blk.transpose(-1, -2)).float() * scale
    if q_pos is not None:
        t_loc = k_blk.shape[-2]
        k_pos = src * t_loc + torch.arange(t_loc, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    new_empty = torch.isneginf(m_new)
    m_safe = m_new.masked_fill(new_empty, 0.0)
    shift = torch.where(new_empty[..., None], 0.0, s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), 0.0, torch.exp(shift))
    either_empty = torch.isneginf(m) | new_empty
    corr = torch.where(either_empty, (m <= m_new).float(), torch.exp((m - m_new).masked_fill(either_empty, 0.0)))
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.matmul(p, v_blk.float())
    return m_new, l, o


def ring_attention(q: Tensor, k: Tensor, v: Tensor, group: Any = None, causal: bool = False,
                   scale: Optional[float] = None) -> Tensor:
    """Exact attention over a sequence sharded over ``group``.

    Args:
        q, k, v: this rank's blocks ``(..., T_local, D)``; the global
            sequence is the concatenation of the ranks' blocks in rank order.
        group: the process group the sequence is sharded over (the default
            group when None; one rank, or no process group, folds the local
            block alone).
        causal: mask on *global* positions.
        scale: logit scale; default ``D ** -0.5``.

    Returns:
        The attention output ``(..., T_local, D)`` of the local query block,
        in the dtype of ``q``.
    """
    n, rank = group_size(group), group_rank(group)
    t_loc, d = q.shape[-2], q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    q_pos = rank * t_loc + torch.arange(t_loc, device=q.device) if causal else None
    m0 = torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32, device=q.device)
    stats = (m0, torch.zeros_like(m0), torch.zeros(q.shape, dtype=torch.float32, device=q.device))
    # the local block first, then n - 1 (shift, fold) rounds: no exchange is
    # made whose block would go unused. After j hops this rank holds the
    # block of rank (rank - j) % n, so only K and V travel, in one message.
    stats = _fold(stats, q, k, v, q_pos, rank, scale)
    kv = torch.stack((k, v)) if n > 1 else None
    for j in range(1, n):
        kv = ring_shift(kv, group)
        stats = _fold(stats, q, kv[0], kv[1], q_pos, (rank - j) % n, scale)
    _, l, o = stats
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)
