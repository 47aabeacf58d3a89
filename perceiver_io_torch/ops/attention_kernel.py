"""Fused attention forward: the CUDA kernel's wrapper and its plain version.

The counterpart of ``perceiver_io_tpu/ops/pallas_attention.py::fused_attention``
(forward only, no ``causal_offset``): (B, T, H, D) queries against (B, S, H, D)
keys/values with an optional (B, S) key padding mask (True = masked out).
The mask enters as the TPU kernel's finite additive bias (``-1e30``), so a
fully masked row attends uniformly over all S keys instead of producing NaN.

On CUDA tensors :func:`fused_attention` launches ``csrc/attention_fwd.cu``;
on CPU tensors it runs :func:`attention_reference`, the same function written
as a plain einsum softmax. There is no fallback between the two.
"""

from __future__ import annotations

from typing import Optional

import torch

from perceiver_io_torch.ops import build

MASK_VALUE = -1e30
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()


def pad_bias(pad_mask: Optional[torch.Tensor], batch: int, keys: int,
             device) -> torch.Tensor:
    """The (B, S) f32 additive bias: ``where(pad, -1e30, 0)``."""
    bias = torch.zeros((batch, keys), dtype=torch.float32, device=device)
    if pad_mask is None:
        return bias
    if tuple(pad_mask.shape) != (batch, keys):
        raise ValueError(
            f"pad_mask shape {tuple(pad_mask.shape)} != {(batch, keys)}")
    return bias.masked_fill(pad_mask.to(device=device, dtype=torch.bool),
                            MASK_VALUE)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"expected (B, T/S, H, D) tensors, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 logits scaled by D**-0.5
    plus the pad bias, softmax in f32, probabilities rounded to v's dtype,
    P.V accumulated in f32, output in q's dtype."""
    _check(q, k, v)
    b, _, _, d = q.shape
    bias = pad_bias(pad_mask, b, k.shape[1], q.device)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * d**-0.5
    probs = torch.softmax(logits + bias[:, None, None, :], dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype).contiguous()


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (B, T, H, D) q and (B, S, H, D) k/v; returns
    (B, T, H, D) contiguous in q's dtype. CUDA tensors launch the kernel
    (f32 or bf16, D in ``SUPPORTED_HEAD_DIMS``, unit stride along D; other
    strides are passed through, so head-split views need no copy); CPU
    tensors run :func:`attention_reference`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        counter.plain_calls += 1
        return attention_reference(q, k, v, pad_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, t, h, d = q.shape
    s = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head dim {d} unsupported by the kernel; expected one of "
            f"{SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    if (q.stride(3), k.stride(3), v.stride(3)) != (1, 1, 1):
        raise ValueError("q, k and v need unit stride along the head dim")
    bias = pad_bias(pad_mask, b, s, q.device).contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if t == 0 or b == 0:
        return out
    if s == 0:
        raise ValueError("attention over zero keys")
    err = build.library().attention_fwd(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, t, s, h,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("attention_fwd", err)
    counter.launches += 1
    return out
