"""Packed-heads attention, forward and backward: the CUDA kernels' wrappers,
their plain versions, and the autograd function that joins them.

The counterpart of ``perceiver_io_tpu/ops/pallas_attention.py::
packed_latent_attention`` (``attn_impl='packed'``): (B, T, E) queries against
(B, S, E) keys/values with the H heads packed along E (head h owns channels
[h*d, (h+1)*d), d = E/H), an optional (B, S) key padding mask (True = masked
out) entering as the finite additive bias ``-1e30``, and a (B, T, E) output
with the heads already merged. The head-split layout never exists in memory.

- forward: ``csrc/packed_attention.cu`` (``_packed_fwd_kernel``): per head,
  f32 logits ``q_h . k_h * d**-0.5 + bias``, the row max (not clamped),
  probabilities normalised in f32 and rounded to v's dtype before P.V, an f32
  accumulator written in q's dtype.
- backward: the same source (``_packed_bwd_kernel``), a dq kernel and a dk/dv
  kernel. Unlike :mod:`attention_kernel`'s backward it saves no statistics:
  it recomputes p, takes ``delta = sum_s p * dp`` in f32 (not ``sum_d g *
  out``), applies the scale before rounding ``ds`` to q's dtype, zeroes ds on
  rows whose max sits at the mask value, and rounds p to q's dtype for dv.
  The two orders round at different points, and in bf16 they differ by more
  than the port's 1e-3 parity bar.
- two designs of all three kernels, chosen by dtype (:func:`packed_design`,
  :func:`packed_backward_design`): float32 the exact scalar-FMA kernels,
  bfloat16 the tensor-core kernels (``wgmma`` fed by TMA, key tiles that are
  all padding skipped), which need 16-byte aligned bases and (batch, row)
  strides that are multiples of 8 elements; a bf16 input they cannot take
  raises ``ValueError``.
- :class:`PackedAttention`: the ``torch.autograd.Function`` twin of the
  ``_packed_attention`` custom VJP; it saves (q, k, v, bias) and nothing else.

CUDA tensors launch the kernels; CPU tensors run the plain versions
(:func:`packed_attention_reference`, :func:`packed_attention_bwd_reference`).
There is no fallback between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from perceiver_io_torch.ops import build
from perceiver_io_torch.ops.attention_kernel import (MASK_VALUE, _kernel_grad, _tma_refusal,
                                                     pad_bias)

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

fwd_counter = build.LaunchCounter()   # packed_attention_fwd, either design
dq_counter = build.LaunchCounter()    # packed_attention_bwd_dq, either design
dkv_counter = build.LaunchCounter()   # packed_attention_bwd_dkv, either design
fwd_wgmma_counter = build.LaunchCounter()  # packed_attention_fwd, the bf16 wgmma design
dq_wgmma_counter = build.LaunchCounter()   # packed_attention_bwd_dq, the bf16 wgmma design
dkv_wgmma_counter = build.LaunchCounter()  # packed_attention_bwd_dkv, the bf16 wgmma design

# The JAX package's admission rule for attn_impl='packed', copied as it is
# (pallas_attention.PACKED_VMEM_BUDGET, packed_vmem_bytes, packed_fits_vmem):
# the TPU kernel holds one example's backward in VMEM, so the JAX package
# refuses shapes past this budget, and the port refuses the same ones. The
# CUDA kernels stream S and T in tiles and would take larger shapes.
PACKED_VMEM_BUDGET = 8 * 1024 * 1024


def packed_vmem_bytes(t: int, s: int, e: int, itemsize: int = 2) -> int:
    """Estimated live VMEM of one backward grid step of the TPU kernel."""
    tiles = 3 * t * s * 4                      # logits/p, dp, ds (f32)
    accs = (t + 2 * s) * e * 4                 # dq, dk, dv accumulators (f32)
    operands = (2 * t + 2 * s) * e * itemsize  # q, g, k, v blocks
    return tiles + accs + operands


def packed_fits_vmem(t: int, s: int, e: int, itemsize: int = 2) -> bool:
    return packed_vmem_bytes(t, s, e, itemsize) <= PACKED_VMEM_BUDGET


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"expected packed (B, T/S, E) tensors, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[-1] % num_heads != 0:
        raise ValueError(f"E {q.shape[-1]} not divisible by num_heads {num_heads}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"packed k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 math, as the kernels; f64 inputs keep f64 (gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _split(x: torch.Tensor, num_heads: int, acc: torch.dtype) -> torch.Tensor:
    """(B, N, E) -> (B, N, H, d) in the accumulation dtype."""
    b, n, e = x.shape
    return x.to(acc).reshape(b, n, num_heads, e // num_heads)


def _probs(qh, kh, bias, scale):
    """(p, m): p normalised in the accumulation dtype, m the row max."""
    logits = torch.einsum("bthd,bshd->bhts", qh, kh) * scale + bias[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    return p / p.sum(dim=-1, keepdim=True), m


def _plain_fwd(q, k, v, bias, num_heads: int) -> torch.Tensor:
    acc = _acc_dtype(q)
    b, t, e = q.shape
    scale = (e // num_heads) ** -0.5
    p, _ = _probs(_split(q, num_heads, acc), _split(k, num_heads, acc), bias.to(acc), scale)
    out = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).to(acc), _split(v, num_heads, acc))
    return out.reshape(b, t, e).to(q.dtype)


def _plain_bwd(q, k, v, bias, g, num_heads: int):
    """#5's math in #5's order (``_packed_bwd_kernel``): p recomputed and
    normalised; dp = g_h . v_h with g rounded to v's dtype; delta = sum_s
    p * dp; ds = p * (dp - delta) * scale, zeroed where the row max sits at
    the mask value, then rounded to q's dtype; dv = p^T . g_h with p rounded
    to q's dtype, dq = ds . k_h, dk = ds^T . q_h. Not autograd of the
    forward: that gives a fully masked row nonzero dq and dk through the
    finite bias, and rounds elsewhere."""
    acc = _acc_dtype(q)
    b, t, e = q.shape
    s = k.shape[1]
    scale = (e // num_heads) ** -0.5
    qh, kh, vh = (_split(x, num_heads, acc) for x in (q, k, v))
    p, m = _probs(qh, kh, bias.to(acc), scale)
    dp = torch.einsum("bthd,bshd->bhts", _split(g.to(v.dtype), num_heads, acc), vh)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = torch.where(m <= 0.5 * MASK_VALUE, 0.0, p * (dp - delta) * scale)
    ds = ds.to(q.dtype).to(acc)
    gh = _split(g, num_heads, acc)
    dv = torch.einsum("bhts,bthd->bshd", p.to(q.dtype).to(acc), gh)
    dq = torch.einsum("bhts,bshd->bthd", ds, kh)
    dk = torch.einsum("bhts,bthd->bshd", ds, qh)
    return (dq.reshape(b, t, e).to(q.dtype), dk.reshape(b, s, e).to(k.dtype),
            dv.reshape(b, s, e).to(v.dtype))


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               num_heads: int,
                               pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (#4's math)."""
    _check(q, k, v, num_heads)
    return _plain_fwd(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device),
                      num_heads)


def packed_attention_bwd_reference(q, k, v, bias, g, num_heads: int):
    """Plain version of the two backward kernels (#5's math): ``(dq, dk,
    dv)`` from the (B, S) f32 ``bias`` and the cotangent ``g``."""
    _check(q, k, v, num_heads)
    return _plain_bwd(q, k, v, bias, g, num_heads)


# -- the kernels ---------------------------------------------------------------


def packed_design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> str:
    """The design of the forward kernel for these packed tensors:
    ``'scalar_f32'`` for float32 (exact f32 FMAs: the f32 parity bar, packed
    = pallas, needs exact products), ``'wgmma'`` for bfloat16 (TMA needs
    16-byte aligned bases and (batch, row) strides that are multiples of 8
    elements). Raises ``ValueError`` on what neither takes: a head dim E/H
    outside ``SUPPORTED_HEAD_DIMS``, another dtype, a stride along E that
    is not 1. Checks layout only, not the device, so it answers for CPU
    tensors too."""
    _check(q, k, v, num_heads)
    d = q.shape[-1] // num_heads
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported by the packed kernels; expected one "
                         f"of {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"packed attention kernel takes float32 or bfloat16, got {q.dtype}")
    if (q.stride(2), k.stride(2), v.stride(2)) != (1, 1, 1):
        raise ValueError("q, k and v need unit stride along E")
    if q.dtype == torch.float32:
        return "scalar_f32"
    for name, x in (("q", q), ("k", k), ("v", v)):
        why = _tma_refusal(name, x)
        if why:
            raise ValueError(f"bf16 packed attention kernel: {why}")
    return "wgmma"


def packed_backward_design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor, num_heads: int) -> str:
    """The design of the dq and dk/dv kernels, by the forward's rule
    (:func:`packed_design`). The cotangent ``g`` must match q's shape and
    dtype but not TMA's rules: autograd may hand over a layout TMA refuses
    (``.sum().backward()`` a stride-0 broadcast), and the launch then makes
    ``g`` contiguous first (``_kernel_grad``). Checks layout only, so it
    answers for CPU tensors too."""
    design = packed_design(q, k, v, num_heads)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    return design


def _kernel_args(q, k, v, num_heads: int) -> Tuple[int, str]:
    """Checks what the kernels take; returns the head dim and the design."""
    if q.device.type != "cuda":
        raise ValueError(f"no packed attention kernel for device {q.device}")
    design = packed_design(q, k, v, num_heads)
    if k.shape[1] == 0:
        raise ValueError("attention over zero keys")
    return q.shape[-1] // num_heads, design


def _strides(*tensors) -> list:
    return [s for x in tensors for s in (x.stride(0), x.stride(1))]


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_fwd(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """The forward kernel: out (B, T, E) contiguous in q's dtype."""
    d, design = _kernel_args(q, k, v, num_heads)
    b, t, e = q.shape
    out = torch.empty((b, t, e), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    build.check_launch("packed_attention_fwd", build.library().packed_attention_fwd(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, t, k.shape[1], num_heads, *_strides(q, k, v), _stream(q)))
    fwd_counter.launches += 1
    if design == "wgmma":
        fwd_wgmma_counter.launches += 1
    return out


def _bwd_args(q, k, v, g, num_heads: int):
    """(head dim, design, g as the kernels read it)."""
    d, design = _kernel_args(q, k, v, num_heads)
    packed_backward_design(q, k, v, g, num_heads)
    return d, design, _kernel_grad(g, design)


def launch_bwd_dq(q, k, v, bias, g, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel: dq (B, T, E) in q's dtype, and each (row, head)'s
    (m, l, delta) as a (B, T, H, 3) f32 tensor, which the dk/dv kernel reads
    (a scratch of the backward, not a saved residual)."""
    d, design, g = _bwd_args(q, k, v, g, num_heads)
    b, t, e = q.shape
    dq = torch.empty((b, t, e), dtype=q.dtype, device=q.device)
    stats = torch.empty((b, t, num_heads, 3), dtype=torch.float32, device=q.device)
    build.check_launch("packed_attention_bwd_dq", build.library().packed_attention_bwd_dq(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        bias.data_ptr(), dq.data_ptr(), stats.data_ptr(), b, t, k.shape[1], num_heads,
        *_strides(q, k, v, g), _stream(q)))
    dq_counter.launches += 1
    if design == "wgmma":
        dq_wgmma_counter.launches += 1
    return dq, stats


def launch_bwd_dkv(q, k, v, bias, g, stats, num_heads: int):
    """The dk/dv kernel from the dq kernel's ``stats``: dk, dv (B, S, E)."""
    d, design, g = _bwd_args(q, k, v, g, num_heads)
    b, t, e = q.shape
    s = k.shape[1]
    if tuple(stats.shape) != (b, t, num_heads, 3) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError(f"stats must be {(b, t, num_heads, 3)} f32 contiguous")
    dk = torch.empty((b, s, e), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    build.check_launch("packed_attention_bwd_dkv", build.library().packed_attention_bwd_dkv(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        bias.data_ptr(), stats.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, s, num_heads,
        *_strides(q, k, v, g), _stream(q)))
    dkv_counter.launches += 1
    if design == "wgmma":
        dkv_wgmma_counter.launches += 1
    return dk, dv


def _launch_bwd(q, k, v, bias, g, num_heads: int):
    """The dq kernel, then the dk/dv kernel."""
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    g = _bwd_args(q, k, v, g, num_heads)[2]  # one copy for both kernels, if any
    dq, stats = launch_bwd_dq(q, k, v, bias, g, num_heads)
    return (dq, *launch_bwd_dkv(q, k, v, bias, g, stats, num_heads))


def _forward(q, k, v, bias, num_heads: int) -> torch.Tensor:
    if q.device.type == "cpu":
        fwd_counter.plain_calls += 1
        return _plain_fwd(q, k, v, bias, num_heads)
    return launch_fwd(q, k, v, bias, num_heads)


def _backward(q, k, v, bias, g, num_heads: int):
    if q.device.type == "cpu":
        dq_counter.plain_calls += 1
        dkv_counter.plain_calls += 1
        return _plain_bwd(q, k, v, bias, g, num_heads)
    return _launch_bwd(q, k, v, bias, g, num_heads)


def packed_attention_fwd(q, k, v, num_heads: int, pad_mask=None) -> torch.Tensor:
    """The forward kernel on CUDA tensors, :func:`packed_attention_reference`
    on CPU tensors."""
    _check(q, k, v, num_heads)
    return _forward(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device),
                    num_heads)


def packed_attention_bwd(q, k, v, num_heads: int, pad_mask, g):
    """``(dq, dk, dv)``: the dq and dk/dv kernels on CUDA tensors,
    :func:`packed_attention_bwd_reference` on CPU tensors."""
    _check(q, k, v, num_heads)
    return _backward(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device), g,
                     num_heads)


class PackedAttention(torch.autograd.Function):
    """Packed attention with #5's backward: the forward saves q, k, v and the
    pad bias and nothing else; the backward returns dq, dk, dv (the pad mask
    gets no gradient). ``plain=True`` runs the plain versions on any device
    (the kernels' stand-in in parity runs on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, num_heads: int, plain: bool = False):
        bias = pad_bias(pad_mask, q.shape[0], k.shape[1], q.device)
        out = (_plain_fwd if plain else _forward)(q, k, v, bias, num_heads)
        ctx.plain = plain
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, bias)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        bwd = _plain_bwd if ctx.plain else _backward
        dq, dk, dv = bwd(q, k, v, bias, g, ctx.num_heads)
        return dq, dk, dv, None, None, None


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def packed_latent_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int,
                            pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention over PACKED (B, T, E) q and (B, S, E) k/v;
    returns (B, T, E) in q's dtype, heads merged. CUDA tensors launch the
    kernels (f32 or bf16, E/num_heads in ``SUPPORTED_HEAD_DIMS``, unit stride
    along E; the designs follow the dtype, :func:`packed_design`); CPU
    tensors run the plain versions. When autograd records, the
    call goes through :class:`PackedAttention`."""
    _check(q, k, v, num_heads)
    if _records_grad(q, k, v):
        return PackedAttention.apply(q, k, v, pad_mask, num_heads)
    return _forward(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device),
                    num_heads)


def plain_packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int,
                           pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain forward and backward on any device, differentiable the same
    way: what a parity run puts in the kernels' place. Counts no launch and
    no plain call."""
    _check(q, k, v, num_heads)
    if _records_grad(q, k, v):
        return PackedAttention.apply(q, k, v, pad_mask, num_heads, True)
    return packed_attention_reference(q, k, v, num_heads, pad_mask)
