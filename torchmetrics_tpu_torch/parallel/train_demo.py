"""A distributed train step, dp x pp x tp (+ep on tp), that metrics are
updated from: the template users copy.

Counterpart of ``torchmetrics_tpu/parallel/train_demo.py``. The model is
tiny and its sharding is real:

- **mesh**: a :class:`torch.distributed.device_mesh.DeviceMesh` with dims
  ``("pp", "dp", "tp")``; its sub-groups take the place of the JAX axes.
- **pp**: GPipe over microbatches. Each rank holds one stage; pp rank 0
  injects microbatch ``m`` at tick ``m``, activations hop one rank a tick
  through :func:`~torchmetrics_tpu_torch.parallel.ring.ring_shift`, the last
  rank keeps the finished microbatches, and an all-reduce over pp hands
  them to every pp rank: ``M + pp - 1`` ticks.
- **tp**: the MLP's hidden dim is sharded; the partial outputs are summed
  over tp.
- **ep**: one expert per tp rank, tokens routed round-robin by position
  through :func:`~torchmetrics_tpu_torch.parallel.ring.expert_all_to_all`.
- **dp**: each dp rank feeds its own rows of the global batch.

The loss is the global mean NLL and the step is SGD on every parameter,
with the gradient of that loss: the JAX step's (``value_and_grad`` through
its ``shard_map`` plus GSPMD) equals the single-device gradient of the
same model, and so does this one. Autograd on each rank gives each
parameter a local gradient; the reductions that turn those into the
global gradient (:func:`_reduce_grads`) follow from where each rank's
computation is a replica:

- the loss is computed on every pp and tp rank of a dp group alike, so
  the all-reduces that replicate a value (the tp sum of the MLP's partial
  outputs, the pp sum of the finished microbatches) pass the cotangent
  through unchanged, and the MLP's input, replicated over tp, sums its
  partial cotangents over tp (Megatron's conjugate pair);
- every dp rank saw other rows: every gradient is summed over dp;
- the embedding is used on pp rank 0 only: its gradient is summed over pp;
- each tp rank dispatches its own replica of the tokens, so every expert
  runs each of its tokens once per tp rank: its gradient is divided by tp.
"""
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .ring import expert_all_to_all, ring_shift
from .strategies import group_rank, group_size

Tensor = torch.Tensor

__all__ = ["init_demo_params", "demo_param_shardings", "make_demo_train_step"]

_STAGE_KEYS = ("w1", "w2", "we1", "we2")
# the dim of each stage parameter sharded over tp (dim 0 is the stage, over pp)
_TP_DIM = {"w1": 2, "w2": 1, "we1": 2, "we2": 1}


def init_demo_params(generator: torch.Generator, vocab: int, d_model: int, d_hidden: int, pp: int, tp: int,
                     device: Any = "cuda") -> Dict[str, Tensor]:
    """The global parameters, drawn from ``generator`` on ``device``: stage
    parameters carry a leading pp axis and a hidden dim that tp shards
    (JAX ``train_demo.py:52-64``; ``tp`` does not change the shapes)."""
    if d_hidden % tp:
        raise ValueError(f"init_demo_params: d_hidden={d_hidden} does not split over tp={tp}")
    se = d_model ** -0.5
    s = 0.5 * d_hidden ** -0.5

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device) * (se if len(shape) == 2 else s)

    return {
        "embed": normal(vocab, d_model),
        "w1": normal(pp, d_model, d_hidden),
        "w2": normal(pp, d_hidden, d_model),
        "we1": normal(pp, d_model, d_hidden),
        "we2": normal(pp, d_hidden, d_model),
        "out": normal(d_model, vocab),
    }


def params_from_jax(params: Dict[str, Any], device: Any = "cuda") -> Dict[str, Tensor]:
    """The JAX package's global parameter dict (numpy arrays, or anything
    ``np.asarray`` takes) as this module's: the layouts are the same."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device) for k, v in params.items()}


def demo_param_shardings(mesh) -> Dict[str, Tuple[Any, ...]]:
    """Each parameter's placements over ``mesh``'s dims ``("pp", "dp", "tp")``
    (JAX ``train_demo.py:67-76``): the stage axis sharded over pp, the
    hidden dim over tp, everything replicated over dp."""
    from torch.distributed.tensor import Replicate, Shard

    dims = mesh.mesh_dim_names
    if tuple(dims) != ("pp", "dp", "tp"):
        raise ValueError(f"demo_param_shardings: the mesh's dims must be ('pp', 'dp', 'tp'), not {dims}")
    out = {k: (Replicate(), Replicate(), Replicate()) for k in ("embed", "out")}
    for k, tp_dim in _TP_DIM.items():
        out[k] = (Shard(0), Replicate(), Shard(tp_dim))
    return out


def local_demo_params(params: Dict[str, Tensor], mesh) -> Dict[str, Tensor]:
    """This rank's slices of the global ``params`` under
    :func:`demo_param_shardings`, as contiguous leaf tensors."""
    out = {}
    for k, placements in demo_param_shardings(mesh).items():
        local = params[k]
        for dim_name, placement in zip(mesh.mesh_dim_names, placements):
            if placement.is_shard():
                n, i = mesh.size(mesh.mesh_dim_names.index(dim_name)), mesh.get_local_rank(dim_name)
                local = local.chunk(n, dim=placement.dim)[i]
        out[k] = local.detach().contiguous()
    return out


def local_batch(x: Tensor, mesh) -> Tensor:
    """This dp rank's rows of a global batch ``x`` (dim 0 split over dp)."""
    return x.chunk(mesh.size(mesh.mesh_dim_names.index("dp")), dim=0)[mesh.get_local_rank("dp")]


class _SumOver(torch.autograd.Function):
    """All-reduce over ``group`` whose result every rank of the group then
    uses alike: the cotangent passes through unchanged."""

    @staticmethod
    def forward(ctx, x: Tensor, group: Any) -> Tensor:
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: Tensor):
        return grad, None


class _SumGradOver(torch.autograd.Function):
    """The identity, whose cotangent is summed over ``group``: the input of a
    region whose ranks each use a part of the weights."""

    @staticmethod
    def forward(ctx, x: Tensor, group: Any) -> Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _sum_over(x: Tensor, group: Any) -> Tensor:
    return x if group_size(group) == 1 else _SumOver.apply(x, group)


def _sum_grad_over(x: Tensor, group: Any) -> Tensor:
    return x if group_size(group) == 1 else _SumGradOver.apply(x, group)


def _stage(stage: Dict[str, Tensor], x: Tensor, tp_group: Any) -> Tensor:
    """One pipeline stage (JAX ``train_demo.py:79-101``): the tp-sharded MLP
    and the expert block, one expert per tp rank. ``x`` is ``(mb, t, d)``
    and replicated over tp; ``stage`` holds this rank's tp slices."""
    h = F.gelu(_sum_grad_over(x, tp_group) @ stage["w1"], approximate="tanh")
    x = x + _sum_over(h @ stage["w2"], tp_group)
    ep = group_size(tp_group)
    mb, t, d = x.shape
    groups = x.reshape(mb, ep, t // ep, d).transpose(0, 1)  # (ep, mb, t/ep, d): group e to expert e
    dispatched = expert_all_to_all(groups, tp_group)  # the tokens of this rank's expert, from every rank
    eo = F.gelu(dispatched @ stage["we1"], approximate="tanh") @ stage["we2"]
    combined = expert_all_to_all(eo, tp_group)  # back to where they came from
    return x + combined.transpose(0, 1).reshape(mb, t, d)


def _pipeline(stage: Dict[str, Tensor], inputs: Tensor, pp_group: Any, tp_group: Any) -> Tensor:
    """GPipe (JAX ``train_demo.py:104-133``): ``inputs`` ``(M, mb, t, d)`` to
    outputs of the same shape, on every pp rank.

    Which rank injects and which keeps the outputs is a ``where`` on a
    flag, as in the JAX tick, not a branch: every rank then builds the
    same autograd graph, so each collective's backward runs on every rank
    of its group, in the same order (a branch would leave a shift's output
    unused on pp rank 0 and its backward would wait there forever)."""
    pp, idx = group_size(pp_group), group_rank(pp_group)
    m_count = inputs.shape[0]
    zeros = torch.zeros_like(inputs[0])
    first = torch.full((), idx == 0, dtype=torch.bool, device=inputs.device)
    last = torch.full((), idx == pp - 1, dtype=torch.bool, device=inputs.device)
    act, outs = zeros, [zeros] * m_count
    for t in range(m_count + pp - 1):
        recv = ring_shift(act, pp_group)
        act = _stage(stage, torch.where(first, inputs[t] if t < m_count else zeros, recv), tp_group)
        m = t - (pp - 1)
        if m >= 0:
            outs[m] = torch.where(last, act, outs[m])
    # the finished microbatches live on the last pp rank; replicate them
    return _sum_over(torch.stack(outs), pp_group)


def _reduce_grads(params: Dict[str, Tensor], mesh) -> None:
    """Turn each rank's local gradients into the global loss's gradient (the
    module docstring says why each reduction is what it is)."""
    groups = {name: mesh.get_group(name) for name in mesh.mesh_dim_names}
    tp = group_size(groups["tp"])
    for k, p in params.items():
        over = ("pp", "dp") if k == "embed" else ("dp",)
        for name in over:
            if group_size(groups[name]) > 1:
                dist.all_reduce(p.grad, group=groups[name])
        if k in ("we1", "we2") and tp > 1:
            p.grad.div_(tp)


def make_demo_train_step(mesh, *, microbatches: int = 2, lr: float = 0.1) -> Callable:
    """The train step ``(params, tokens, targets) -> (params, loss, logits)``
    over ``mesh`` (a ``DeviceMesh`` with dims ``("pp", "dp", "tp")``).

    ``params`` are this rank's slices (:func:`local_demo_params`), updated in
    place by SGD at ``lr`` and returned; ``tokens`` and ``targets`` are this
    dp rank's rows ``(B / dp, T)`` of the global batch
    (:func:`local_batch`), ``B / dp`` a multiple of ``microbatches`` and
    ``T`` of tp. ``loss`` is the global mean NLL, the same on every rank;
    ``logits`` ``(B / dp, T, vocab)`` are this dp rank's rows, detached.
    """
    if tuple(mesh.mesh_dim_names) != ("pp", "dp", "tp"):
        raise ValueError(f"make_demo_train_step: the mesh's dims must be ('pp', 'dp', 'tp'), "
                         f"not {mesh.mesh_dim_names}")
    pp_group, dp_group, tp_group = (mesh.get_group(name) for name in ("pp", "dp", "tp"))
    dp = group_size(dp_group)

    def train_step(params: Dict[str, Tensor], tokens: Tensor, targets: Tensor):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        x = params["embed"][tokens]  # (B / dp, T, d)
        b, t, d = x.shape
        stage = {k: params[k][0] for k in _STAGE_KEYS}  # the stage axis is 1 here
        y = _pipeline(stage, x.reshape(microbatches, b // microbatches, t, d), pp_group, tp_group)
        logits = y.reshape(b, t, d) @ params["out"]
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None]).squeeze(-1)
        # this dp rank's share of the global mean: the shares sum to it
        local = nll.sum() / (b * dp * t)
        local.backward()
        _reduce_grads(params, mesh)
        loss = local.detach().clone()
        if dp > 1:
            dist.all_reduce(loss, group=dp_group)
        with torch.no_grad():
            for p in params.values():
                p.sub_(lr * p.grad)
                p.grad = None
                p.requires_grad_(False)
        return params, loss, logits.detach()

    return train_step
