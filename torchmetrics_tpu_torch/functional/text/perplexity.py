"""Perplexity from logits or probabilities.

Counterpart of ``torchmetrics_tpu/functional/text/perplexity.py``: two
float32 sum states, the negative log-probabilities of the target tokens and
their count. Whether the input holds probabilities or logits is decided on
the device, as the JAX package's ``jnp.where`` over both branches decides
it: every row sums to 1 within 1e-3 and no entry is negative. The update
reads nothing back to the host, so it can be captured into a CUDA graph.
The log of the probabilities is taken at the target tokens only (the JAX
package takes it over the whole input and gathers after).
"""
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """preds: (..., vocab) logits or probabilities; target: (...) int tokens."""
    vocab = preds.shape[-1]
    preds = preds.reshape(-1, vocab).to(torch.float32)
    target = target.reshape(-1)
    is_probs = ((preds.sum(dim=-1) - 1.0).abs() < 1e-3).all() & (preds.amin() >= 0)
    if ignore_index is not None:
        mask = (target != ignore_index).to(torch.float32)
        target = target.clamp(0, vocab - 1)
    else:
        mask = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    index = target.long()[:, None]
    picked = preds.gather(1, index)[:, 0]
    token_log_probs = torch.where(is_probs, torch.log(picked.clamp(min=1e-20)),
                                  torch.log_softmax(preds, dim=-1).gather(1, index)[:, 0])
    total = -torch.sum(token_log_probs * mask)
    count = torch.sum(mask)
    return total, count


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """Perplexity of ``target`` under ``preds`` (on their device).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text import perplexity
        >>> logits = torch.log(torch.tensor([[[0.7, 0.2, 0.1], [0.2, 0.7, 0.1]]]))
        >>> print(f"{float(perplexity(logits, torch.tensor([[0, 1]]))):.4f}")
        1.4286
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
