"""Losses of the MLM and classifier steps (the counterparts of
``perceiver_io_tpu/training/losses.py``: ``softmax_ce_integer``,
``cross_entropy_with_ignore``, ``classification_loss_and_accuracy``,
``fused_linear_ce_integer``, ``fused_linear_cross_entropy_with_ignore``,
``pallas_linear_cross_entropy_with_ignore``).

``softmax_ce_integer`` keeps the memory shape of the JAX package's custom
VJP: the forward saves the logits in their own dtype and the f32 row
log-sum-exp only, and the backward recomputes ``softmax - onehot`` and
returns it in the logits' dtype, so bf16 logits are never kept as f32.

The fused heads take the decoder's features and the head's (kernel, bias)
instead of logits: ``pallas_linear_cross_entropy_with_ignore`` through the
CE kernels (``ops/ce_kernel.py``), ``fused_linear_cross_entropy_with_ignore``
through plain PyTorch over vocab chunks (the JAX ``fused_head=True``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from perceiver_io_torch.ops.ce_kernel import linear_ce_integer
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


def _mean_over_valid(per_position: Callable[[torch.Tensor], torch.Tensor],
                     labels: torch.Tensor, ignore_label: int) -> torch.Tensor:
    """``per_position(safe_labels)`` averaged over the positions whose label
    is not ``ignore_label`` (ignored labels enter as 0), the denominator
    floored at 1."""
    valid = labels != ignore_label
    per_pos = per_position(torch.where(valid, labels, 0))
    denom = valid.sum().clamp_min(1)
    return torch.where(valid, per_pos, 0.0).sum() / denom


def cross_entropy_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_label: int = IGNORE_LABEL) -> torch.Tensor:
    """Mean CE over the positions whose label is not ``ignore_label``, with
    the denominator floored at 1: an all-ignored batch gives 0 and zero
    gradients, where ``F.cross_entropy`` would give NaN."""
    return _mean_over_valid(lambda safe: softmax_ce_integer(logits, safe), labels,
                            ignore_label)


# the chunked head pads the vocab with this bias: exp of it against any live
# logit is exactly 0, and it is finite in every dtype (no inf arithmetic)
_CHUNK_PAD_BIAS = -1e9


def classification_loss_and_accuracy(logits: torch.Tensor, labels: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE, top-1 accuracy) of (B, C) logits against (B,) int labels,
    both f32 scalars; argmax ties go to the first class, as ``jnp.argmax``'s."""
    labels = labels.long()
    loss = softmax_ce_integer(logits, labels).mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, acc


def _pad_vocab(kernel: torch.Tensor, bias: torch.Tensor, chunk: int):
    pad = -kernel.shape[-1] % chunk
    if pad:
        kernel = torch.nn.functional.pad(kernel, (0, pad))
        bias = torch.nn.functional.pad(bias, (0, pad), value=_CHUNK_PAD_BIAS)
    return kernel, bias


def _chunk_logits(features, kernel, bias, start: int, chunk: int) -> torch.Tensor:
    """f32 logits of one vocab chunk, the product and the bias in the
    features' dtype (the unfused head's order)."""
    dtype = features.dtype
    w = kernel[:, start:start + chunk].to(dtype)
    return (features @ w + bias[start:start + chunk].to(dtype)).float()


class ChunkedLinearCE(torch.autograd.Function):
    """Per-position CE of ``features @ kernel + bias`` over vocab chunks with
    an online log-sum-exp; the backward recomputes each chunk's logits from
    the saved lse. The (..., V) logits never exist whole."""

    @staticmethod
    def forward(ctx, features, kernel, bias, labels, chunk: int):
        kern_p, bias_p = _pad_vocab(kernel, bias, chunk)
        m = torch.full(labels.shape, float("-inf"), device=features.device)
        s = torch.zeros(labels.shape, device=features.device)
        picked = torch.zeros(labels.shape, device=features.device)
        for start in range(0, kern_p.shape[-1], chunk):
            logits = _chunk_logits(features, kern_p, bias_p, start, chunk)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(dim=-1)
            m = m_new
            in_chunk = (labels >= start) & (labels < start + chunk)
            idx = (labels - start).clamp(0, chunk - 1)
            pick = logits.gather(-1, idx[..., None])[..., 0]
            picked = picked + torch.where(in_chunk, pick, 0.0)
        lse = m + torch.log(s)
        ctx.chunk = chunk
        ctx.save_for_backward(features, kernel, bias, labels, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        features, kernel, bias, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        kern_p, bias_p = _pad_vocab(kernel, bias, chunk)
        dtype = features.dtype
        dx = torch.zeros(features.shape, dtype=torch.float32, device=features.device)
        dw = torch.zeros(kern_p.shape, dtype=torch.float32, device=features.device)
        db = torch.zeros(bias_p.shape, dtype=torch.float32, device=features.device)
        rows = features.reshape(-1, features.shape[-1]).float()
        for start in range(0, kern_p.shape[-1], chunk):
            logits = _chunk_logits(features, kern_p, bias_p, start, chunk)
            d = torch.exp(logits - lse[..., None])
            in_chunk = (labels >= start) & (labels < start + chunk)
            idx = (labels - start).clamp(0, chunk - 1)
            d.scatter_add_(-1, idx[..., None], -in_chunk[..., None].to(d.dtype))
            d = (d * g[..., None]).to(dtype)
            w = kern_p[:, start:start + chunk].to(dtype)
            dx += d.float() @ w.float().t()
            flat = d.reshape(-1, chunk).float()
            dw[:, start:start + chunk] = rows.t() @ flat
            db[start:start + chunk] = flat.sum(dim=0)
        v = kernel.shape[-1]
        return (dx.to(dtype), dw[:, :v].to(kernel.dtype), db[:v].to(bias.dtype), None, None)


def fused_linear_ce_integer(features: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor, labels: torch.Tensor,
                            chunk: int = 512) -> torch.Tensor:
    """(...) f32 per-position CE of ``features @ kernel + bias`` against
    (...) int labels, over ``chunk``-wide vocab slices: plain PyTorch, the
    logits of one chunk at a time. The vocab is padded to a chunk multiple
    with bias -1e9."""
    return ChunkedLinearCE.apply(features, kernel, bias, labels.long(), chunk)


def fused_linear_cross_entropy_with_ignore(features, kernel, bias, labels,
                                           ignore_label: int = IGNORE_LABEL,
                                           chunk: int = 512) -> torch.Tensor:
    """:func:`cross_entropy_with_ignore` of a linear head applied to
    ``features``, the head fused into the chunked loss."""
    return _mean_over_valid(
        lambda safe: fused_linear_ce_integer(features, kernel, bias, safe, chunk), labels,
        ignore_label)


def pallas_linear_cross_entropy_with_ignore(
        features, kernel, bias, labels, ignore_label: int = IGNORE_LABEL,
        linear_ce: Callable = linear_ce_integer) -> torch.Tensor:
    """:func:`cross_entropy_with_ignore` of a linear head applied to
    ``features`` through the CE kernels (``linear_ce``: the kernels'
    ``linear_ce_integer``; a parity run passes the plain versions)."""
    return _mean_over_valid(lambda safe: linear_ce(features, kernel, bias, safe), labels,
                            ignore_label)
