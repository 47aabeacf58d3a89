"""Losses of the MLM step (the counterparts of
``perceiver_io_tpu/training/losses.py``: ``softmax_ce_integer``,
``cross_entropy_with_ignore``).

``softmax_ce_integer`` keeps the memory shape of the JAX package's custom
VJP: the forward saves the logits in their own dtype and the f32 row
log-sum-exp only, and the backward recomputes ``softmax - onehot`` and
returns it in the logits' dtype, so bf16 logits are never kept as f32.
"""

from __future__ import annotations

import torch

from perceiver_io_torch.ops.masking import IGNORE_LABEL


class SoftmaxCEInteger(torch.autograd.Function):
    """Per-position CE, ``lse - logits[label]``, with the memory-lean
    backward ``(softmax - onehot) * g`` in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        lse = torch.logsumexp(logits.float(), dim=-1)
        picked = torch.gather(logits, -1, labels[..., None])[..., 0].float()
        ctx.save_for_backward(logits, labels, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, labels, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])
        d.scatter_add_(-1, labels[..., None], torch.full_like(lse[..., None], -1.0))
        return (d * g[..., None]).to(logits.dtype), None


def softmax_ce_integer(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(...) f32 per-position CE of (..., C) logits against (...) int labels."""
    return SoftmaxCEInteger.apply(logits, labels.long())


def cross_entropy_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_label: int = IGNORE_LABEL) -> torch.Tensor:
    """Mean CE over the positions whose label is not ``ignore_label``, with
    the denominator floored at 1: an all-ignored batch gives 0 and zero
    gradients, where ``F.cross_entropy`` would give NaN."""
    valid = labels != ignore_label
    per_pos = softmax_ce_integer(logits, torch.where(valid, labels, 0))
    denom = valid.sum().clamp_min(1)
    return torch.where(valid, per_pos, 0.0).sum() / denom
