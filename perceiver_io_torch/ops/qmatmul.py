"""Dequantizing matmul: the CUDA kernel's wrapper, its plain version, and the
linear apply every projection of the model goes through.

The counterpart of ``perceiver_io_tpu/ops/pallas_matmul.py`` (``dequant_matmul``,
``quantized_matmul``, ``linear_apply``). On CUDA tensors :func:`dequant_matmul`
launches ``csrc/dequant_matmul.cu``; on CPU tensors it runs
:func:`dequant_matmul_reference` (dequantize, then matmul). There is no
fallback between the two. Unquantized projections are a plain
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from perceiver_io_torch.ops import build
from perceiver_io_torch.quant.int8 import QKernel, dequantize_array, unpack_int4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bits: int,
           group_size: Optional[int]) -> int:
    """Validate the operands; returns N."""
    if x.ndim != 2 or q.ndim != 2:
        raise ValueError(f"expected 2-D x and q, got {tuple(x.shape)}, {tuple(q.shape)}")
    k = x.shape[1]
    if bits == 8:
        if q.dtype != torch.int8 or q.shape[0] != k:
            raise ValueError(f"int8 q must be int8 ({k}, N), got {q.dtype} {tuple(q.shape)}")
    elif bits == 4:
        if q.dtype != torch.uint8 or 2 * q.shape[0] != k:
            raise ValueError(
                f"int4 q must be packed uint8 ({k // 2}, N), got {q.dtype} "
                f"{tuple(q.shape)}")
    else:
        raise ValueError(f"unsupported bits={bits}; expected 8 or 4")
    n = q.shape[1]
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if group_size is None:
        if tuple(scale.shape) != (n,):
            raise ValueError(f"per-channel scale shape {tuple(scale.shape)} != ({n},)")
    else:
        if group_size <= 0 or k % group_size:
            raise ValueError(f"group_size {group_size} does not divide K={k}")
        if tuple(scale.shape) != (k // group_size, n):
            raise ValueError(
                f"grouped scale shape {tuple(scale.shape)} != {(k // group_size, n)}")
    if not (x.device == q.device == scale.device):
        raise ValueError("x, q and scale must lie on one device")
    return n


def dequant_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                             bits: int = 8,
                             group_size: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dequantize to f32, round the
    weight to x's dtype, multiply with f32 accumulation, return x's dtype."""
    _check(x, q, scale, bits, group_size)
    values = unpack_int4(q) if bits == 4 else q
    w = dequantize_array(values, scale, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   bits: int = 8, group_size: Optional[int] = None) -> torch.Tensor:
    """``x (M, K) @ dequant(q, scale)`` → (M, N) in x's dtype. CUDA tensors
    launch the kernel (f32 or bf16 x, all operands contiguous); CPU tensors
    run :func:`dequant_matmul_reference`."""
    n = _check(x, q, scale, bits, group_size)
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return dequant_matmul_reference(x, q, scale, bits, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"no dequant-matmul kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dequant-matmul kernel takes float32 or bfloat16, got {x.dtype}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequant-matmul kernel needs contiguous operands")
    m, k = x.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    err = build.library().dequant_matmul(
        _DTYPE_CODES[x.dtype], bits, group_size or 0, x.data_ptr(), q.data_ptr(),
        scale.data_ptr(), out.data_ptr(), m, k, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("dequant_matmul", err)
    counter.launches += 1
    return out


def quantized_matmul(x: torch.Tensor, w: QKernel,
                     matmul: Callable = dequant_matmul) -> torch.Tensor:
    """``x (..., K) @ w`` for a :class:`QKernel`, in its compute dtype."""
    k, n = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(w.compute_dtype).contiguous()
    return matmul(x2, w.q, w.scale, w.bits, w.group_size).reshape(*lead, n)


def linear_apply(x: torch.Tensor, w, b: Optional[torch.Tensor], dtype,
                 matmul: Callable = dequant_matmul) -> torch.Tensor:
    """``x @ w + b`` at ``dtype`` — except a :class:`QKernel` weight, which
    goes through the dequantizing ``matmul`` in its compute dtype."""
    if isinstance(w, QKernel):
        y = quantized_matmul(x, w, matmul)
        return y if b is None else y + b.to(y.dtype)
    y = x.to(dtype) @ w.to(dtype)
    return y if b is None else y + b.to(dtype)
