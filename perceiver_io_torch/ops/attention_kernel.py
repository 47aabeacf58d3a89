"""Fused attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd function that joins them.

The counterpart of ``perceiver_io_tpu/ops/pallas_attention.py::fused_attention``:
(B, T, H, D) queries against (B, S, H, D) keys/values with an optional (B, S)
key padding mask (True = masked out) and an optional ``causal_offset`` (query
row i attends key j only if j <= i + offset). Both enter as the TPU kernel's
finite additive biases (``-1e30`` each, the causal one added after the pad
one), so a fully masked row attends uniformly over the keys masked exactly
once instead of producing NaN: over all S keys with the pad mask alone.
The forward and both backward kernels take the causal offset (the
Perceiver-AR serving and training paths), each compiling it in only for a
causal call.

- forward: ``csrc/attention_fwd.cu``; with statistics it also returns each
  row's running max ``m`` and denominator ``l`` as (B, H, T) f32, the
  residuals of the backward (``_fused_attention_fwd_impl(with_lse=True)``);
  with ``causal_offset`` it adds the causal bias by index in both designs.
  Two designs, chosen by dtype (:func:`forward_design`): float32 runs the
  exact scalar-FMA kernel (``wgmma`` has no full-f32 mode), bfloat16 the
  tensor-core kernel (``wgmma`` fed by TMA), which needs 16-byte aligned
  bases and strides; a bf16 input it cannot take raises ``ValueError``.
- backward: ``csrc/attention_bwd.cu``, one kernel for dq and one for dk/dv
  (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``), recomputing the probabilities
  from ``m`` and ``l``; ``delta = sum_d g * out`` is a plain reduction, as the
  JAX package computes it outside its kernels; with ``causal_offset`` both
  add the forward's causal bias by index. Two designs, chosen by dtype
  (:func:`backward_design`) as the forward's: float32 the exact scalar-FMA
  kernels, bfloat16 the tensor-core kernels (``wgmma`` fed by TMA, key
  tiles that are all padding skipped); a bf16 input they cannot take
  raises ``ValueError``.
- deep heads: at D = 256, 512 and 1024 (``DEEP_HEAD_DIMS``; the
  optical-flow model's one-head crosses are D = 512, ImageNet's D = 1024)
  the same entry points run the designs of ``csrc/attention_deep.cu``, both
  dtypes, with and without the causal offset, whose tiles fit such a head.
  In bf16 each holds 256 head columns a block (a cluster of D / 256 blocks
  at D = 512 and 1024 that adds its shares of each logit tile, at D = 1024
  in a fixed order, so all four blocks hold the same bits) and computes
  every logit tile once (in f32 at D = 1024 every dot product sums in
  float64 and the sums over the keys are compensated): the forward 128
  query rows a block, 64-key tiles streamed through rings a loading warp
  refills, the next tile's product issued under this tile's softmax; the
  backward one launch each of dq and dk/dv, 64-row tiles, S and dP once.
  They skip no padded tile and use no atomics (two calls give the same
  bits). Their launches also count on ``deep_counter``,
  ``dq_deep_counter`` and ``dkv_deep_counter``.
- :class:`FusedAttention`: the ``torch.autograd.Function`` twin of the
  ``_fused_attention`` custom VJP. :func:`fused_attention` applies it when
  autograd records; serving calls launch the forward without statistics.

CUDA tensors launch the kernels; CPU tensors run the plain versions
(:func:`attention_reference_with_stats`, :func:`attention_bwd_reference`),
the same functions written as plain einsum math. There is no fallback
between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from perceiver_io_torch.ops import build
from perceiver_io_torch.ops.masking import causal_mask

MASK_VALUE = -1e30
# the mask value as the f32 bias holds it (the kernels' running-max floor)
_MASK_F32 = float(torch.tensor(MASK_VALUE, dtype=torch.float32))
SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128, 256, 512, 1024)
# the head dims of the deep designs (csrc/attention_deep.cu), reached through
# the same entry points; the TPU kernel takes any D (LONG_KV_MAX_D = 512 only
# caps its long-KV query block), and ImageNet's one-head crosses are D = 1024
DEEP_HEAD_DIMS = (256, 512, 1024)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()          # attention_fwd, either design
wgmma_counter = build.LaunchCounter()    # attention_fwd, the bf16 wgmma design
causal_counter = build.LaunchCounter()   # attention_fwd with the causal bias, either design
dq_counter = build.LaunchCounter()       # attention_bwd_dq, either design
dkv_counter = build.LaunchCounter()      # attention_bwd_dkv, either design
dq_wgmma_counter = build.LaunchCounter()   # attention_bwd_dq, the bf16 wgmma design
dkv_wgmma_counter = build.LaunchCounter()  # attention_bwd_dkv, the bf16 wgmma design
dq_causal_counter = build.LaunchCounter()   # attention_bwd_dq with the causal bias, either design
dkv_causal_counter = build.LaunchCounter()  # attention_bwd_dkv with the causal bias, either design
deep_counter = build.LaunchCounter()       # attention_fwd at a DEEP_HEAD_DIMS depth, either design
dq_deep_counter = build.LaunchCounter()    # attention_bwd_dq at a DEEP_HEAD_DIMS depth
dkv_deep_counter = build.LaunchCounter()   # attention_bwd_dkv at a DEEP_HEAD_DIMS depth


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


def causal_bias(num_queries: int, num_keys: int, offset: int, device) -> torch.Tensor:
    """The (T, S) f32 additive causal bias of the TPU kernel
    (``_causal_bias``): ``-1e30`` where key j > row i + offset."""
    return torch.zeros((num_queries, num_keys), dtype=torch.float32,
                       device=device).masked_fill(
        causal_mask(num_queries, num_keys, offset, device), MASK_VALUE)


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


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 math, as the kernels; f64 inputs keep f64 (gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _plain_fwd(q, k, v, bias, causal_offset: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, l): logits scaled by D**-0.5 plus the pad bias, then plus the
    causal bias when ``causal_offset`` is given, ``m`` the row max
    floored at the mask value (the kernel's running max starts there),
    ``l = sum exp(logits - m)``, probabilities rounded to v's dtype before
    P.V, output in q's dtype; m and l are (B, H, T) f32 (f64 for f64
    inputs)."""
    acc = _acc_dtype(q)
    d = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc)) * d**-0.5
    logits = logits + bias.to(acc)[:, None, None, :]
    if causal_offset is not None:
        logits = logits + causal_bias(q.shape[1], k.shape[1], causal_offset,
                                      q.device).to(acc)
    m = logits.amax(dim=-1).clamp_min(_MASK_F32)
    e = torch.exp(logits - m[..., None])
    l = e.sum(dim=-1)
    probs = (e / l[..., None]).to(v.dtype).to(acc)
    out = torch.einsum("bhts,bshd->bthd", probs, v.to(acc))
    return out.to(q.dtype).contiguous(), m, l


def _plain_bwd(q, k, v, bias, out, m, l, g, causal_offset: Optional[int] = None):
    """(dq, dk, dv) from the saved (m, l), written as the TPU kernels'
    math (``_recompute_probs_and_ds``): p recomputed as exp(logits - m)/l,
    the logits plus the pad bias, then plus the causal bias when
    ``causal_offset`` is given (as :func:`_plain_fwd` adds them),
    ds = p (g.v - delta) zeroed on rows whose m is pinned at the mask value,
    ds rounded to k's / q's dtype and p to g's before each product, the scale
    applied at the end. Not autograd of :func:`attention_reference`: that
    would give a fully masked row nonzero dq and dk through the finite bias."""
    acc = _acc_dtype(q)
    d = q.shape[-1]
    scale = d**-0.5
    m, l = m.to(acc)[..., None], l.to(acc)[..., None]
    logits = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc)) * scale
    logits = logits + bias.to(acc)[:, None, None, :]
    if causal_offset is not None:
        logits = logits + causal_bias(q.shape[1], k.shape[1], causal_offset,
                                      q.device).to(acc)
    p = torch.exp(logits - m) / l
    dp = torch.einsum("bthd,bshd->bhts", g.to(acc), v.to(acc))
    delta = (g.to(acc) * out.to(acc)).sum(dim=-1).transpose(1, 2)[..., None]
    ds = torch.where(m <= 0.5 * MASK_VALUE, 0.0, p * (dp - delta))
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).to(acc), k.to(acc)) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).to(acc), q.to(acc)) * scale
    dv = torch.einsum("bhts,bthd->bshd", p.to(g.dtype).to(acc), g.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pad_mask: Optional[torch.Tensor] = None,
                        causal_offset: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: f32 logits scaled by
    D**-0.5 plus the pad bias (plus the causal bias with ``causal_offset``),
    softmax in f32, probabilities rounded to v's dtype, P.V accumulated in
    f32, output in q's dtype."""
    return attention_reference_with_stats(q, k, v, pad_mask, causal_offset)[0]


def attention_reference_with_stats(q, k, v, pad_mask=None, causal_offset=None):
    """Plain version of the forward with statistics: ``(out, m, l)``, m and
    l (B, H, T) f32."""
    _check(q, k, v)
    return _plain_fwd(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device),
                      causal_offset)


def attention_bwd_reference(q, k, v, pad_mask, out, m, l, g, causal_offset=None):
    """Plain version of the two backward kernels: ``(dq, dk, dv)``."""
    _check(q, k, v)
    return _plain_bwd(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device),
                      out, m, l, g, causal_offset)


def _kernel_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    _head_dims(q, k, v)


def _head_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head dim {d} unsupported by the kernel; expected one of "
            f"{SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    if (q.stride(3), k.stride(3), v.stride(3)) != (1, 1, 1):
        raise ValueError("q, k and v need unit stride along the head dim")


def _tma_refusal(name: str, x: torch.Tensor) -> Optional[str]:
    """Why TMA cannot load the bf16 view ``x`` (16-byte aligned base, strides
    of every dim but the last that are multiples of 8 elements: (batch, row,
    head) here, (batch, row) for a packed (B, T, E) tensor), or None."""
    if x.data_ptr() % 16:
        return f"{name} is not 16-byte aligned, as its TMA loads need"
    if any(st % 8 for st in x.stride()[:-1]):
        return (f"{name} strides {tuple(x.stride())} are not multiples of 8 "
                f"elements (16 bytes), as its TMA loads need")
    return None


def forward_design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The design of the forward kernel a call with these tensors takes:
    ``'scalar_f32'`` for float32 (exact f32 FMAs; TF32 would break the f32
    parity bar, as the TPU kernel asks for HIGHEST precision there),
    ``'wgmma'`` for bfloat16 (TMA needs 16-byte aligned bases and (batch,
    row, head) strides that are multiples of 8 elements). Raises
    ``ValueError`` on what neither takes. Checks layout only, not the
    device, so it answers for CPU tensors too."""
    _head_dims(q, k, v)
    if q.dtype == torch.float32:
        return "scalar_f32"
    for name, x in (("q", q), ("k", k), ("v", v)):
        why = _tma_refusal(name, x)
        if why:
            raise ValueError(f"bf16 attention kernel: {why}")
    return "wgmma"


def backward_design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor) -> str:
    """The design of the two backward kernels for these tensors, by the
    forward's rule (:func:`forward_design`): ``'scalar_f32'`` for float32,
    ``'wgmma'`` for bfloat16, whose q, k and v must meet TMA's rules or the
    call raises ``ValueError``. The cotangent ``g`` is not held to them:
    autograd may hand over a layout TMA refuses (a broadcast zero has
    stride 0), and the launch then makes ``g`` contiguous first
    (:func:`_kernel_grad`), one copy of a tensor the kernels read anyway.
    ``g`` must match q's shape and dtype. Checks layout only, so it answers
    for CPU tensors too."""
    design = forward_design(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    return design


def _kernel_grad(g: torch.Tensor, design: str) -> torch.Tensor:
    """g as the backward kernels read it: as it is where its layout serves
    the design (unit stride along the last dim; for ``'wgmma'`` TMA's rules
    and no broadcast stride too), else a contiguous copy in fresh (aligned)
    memory. Serves the packed kernels' (B, T, E) cotangent too."""
    tma_ready = _tma_refusal("g", g) is None and 0 not in g.stride()[:-1]
    if g.stride(-1) == 1 and (design != "wgmma" or tma_ready):
        return g
    return g.clone(memory_format=torch.contiguous_format)


def _strides(*tensors) -> list:
    return [s for x in tensors for s in (x.stride(0), x.stride(1), x.stride(2))]


def _launch_fwd(q, k, v, bias, stats: bool, causal_offset: Optional[int] = None):
    """The forward kernel: out, plus (m, l) when ``stats``; the causal bias
    with ``causal_offset``."""
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    design = forward_design(q, k, v)
    b, t, h, d = q.shape
    s = k.shape[1]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    m = l = None
    if stats:
        m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if t == 0 or b == 0:
        return out, m, l
    if s == 0:
        raise ValueError("attention over zero keys")
    err = build.library().attention_fwd(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(), m.data_ptr() if stats else None,
        l.data_ptr() if stats else None, b, t, s, h, int(causal_offset is not None),
        causal_offset or 0, *_strides(q, k, v),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("attention_fwd", err)
    counter.launches += 1
    if design == "wgmma":
        wgmma_counter.launches += 1
    if causal_offset is not None:
        causal_counter.launches += 1
    if d in DEEP_HEAD_DIMS:
        deep_counter.launches += 1
    return out, m, l


def bwd_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = sum_d g * out, (B, H, T) f32 contiguous: summed in float64
    for f32 inputs (ds = p (dp - delta) cancels against it, and the f32
    designs at D=1024 sum dp in float64), in f32 for bf16."""
    acc = torch.float64 if g.dtype == torch.float32 else torch.float32
    return (g.to(acc) * out.to(acc)).sum(dim=-1).transpose(1, 2).float().contiguous()


def _bwd_args(q, k, v, bias, m, l, delta, g, causal_offset: Optional[int]):
    _kernel_dims(q, k, v)
    design = backward_design(q, k, v, g)
    g = _kernel_grad(g, design)
    b, t, h, d = q.shape
    stats = (b, h, t)
    for name, x in (("m", m), ("l", l), ("delta", delta)):
        if tuple(x.shape) != stats or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be {stats} f32 contiguous")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), bias.data_ptr(),
            m.data_ptr(), l.data_ptr(), delta.data_ptr())
    dims = (b, t, k.shape[1], h, int(causal_offset is not None), causal_offset or 0,
            *_strides(q, k, v, g), torch.cuda.current_stream(q.device).cuda_stream)
    return design, d, ptrs, dims


def launch_bwd_dq(q, k, v, bias, m, l, delta, g,
                  causal_offset: Optional[int] = None) -> torch.Tensor:
    """The dq kernel alone: dq (B, T, H, D) in q's dtype."""
    design, d, ptrs, dims = _bwd_args(q, k, v, bias, m, l, delta, g, causal_offset)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    build.check_launch("attention_bwd_dq", build.library().attention_bwd_dq(
        _DTYPE_CODES[q.dtype], d, *ptrs, dq.data_ptr(), *dims))
    dq_counter.launches += 1
    if design == "wgmma":
        dq_wgmma_counter.launches += 1
    if causal_offset is not None:
        dq_causal_counter.launches += 1
    if d in DEEP_HEAD_DIMS:
        dq_deep_counter.launches += 1
    return dq


def launch_bwd_dkv(q, k, v, bias, m, l, delta, g, causal_offset: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel alone: dk, dv (B, S, H, D) in k's dtype."""
    design, d, ptrs, dims = _bwd_args(q, k, v, bias, m, l, delta, g, causal_offset)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    build.check_launch("attention_bwd_dkv", build.library().attention_bwd_dkv(
        _DTYPE_CODES[q.dtype], d, *ptrs, dk.data_ptr(), dv.data_ptr(), *dims))
    dkv_counter.launches += 1
    if design == "wgmma":
        dkv_wgmma_counter.launches += 1
    if causal_offset is not None:
        dkv_causal_counter.launches += 1
    if d in DEEP_HEAD_DIMS:
        dkv_deep_counter.launches += 1
    return dk, dv


def _launch_bwd(q, k, v, bias, out, m, l, g, causal_offset: Optional[int] = None):
    """delta, then the dq kernel and the dk/dv kernel."""
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = bwd_delta(g, out)
    g = _kernel_grad(g, backward_design(q, k, v, g))  # one copy for both kernels, if any
    m, l = m.contiguous(), l.contiguous()
    return (launch_bwd_dq(q, k, v, bias, m, l, delta, g, causal_offset),
            *launch_bwd_dkv(q, k, v, bias, m, l, delta, g, causal_offset))


def _forward(q, k, v, bias, stats: bool, causal_offset: Optional[int] = None):
    if q.device.type == "cpu":
        counter.plain_calls += 1
        if causal_offset is not None:
            causal_counter.plain_calls += 1
        return _plain_fwd(q, k, v, bias, causal_offset)
    return _launch_fwd(q, k, v, bias, stats, causal_offset)


def _backward(q, k, v, bias, out, m, l, g, causal_offset: Optional[int] = None):
    if q.device.type == "cpu":
        dq_counter.plain_calls += 1
        dkv_counter.plain_calls += 1
        if causal_offset is not None:
            dq_causal_counter.plain_calls += 1
            dkv_causal_counter.plain_calls += 1
        return _plain_bwd(q, k, v, bias, out, m, l, g, causal_offset)
    return _launch_bwd(q, k, v, bias, out, m, l, g, causal_offset)


def attention_fwd_with_stats(q, k, v, pad_mask=None, causal_offset=None):
    """``(out, m, l)``: the forward kernel with statistics on CUDA tensors,
    :func:`attention_reference_with_stats` on CPU tensors."""
    _check(q, k, v)
    return _forward(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device), True,
                    causal_offset)


def attention_bwd(q, k, v, pad_mask, out, m, l, g, causal_offset=None):
    """``(dq, dk, dv)``: the dq and dk/dv kernels on CUDA tensors,
    :func:`attention_bwd_reference` on CPU tensors."""
    _check(q, k, v)
    return _backward(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device),
                     out, m, l, g, causal_offset)


class FusedAttention(torch.autograd.Function):
    """Attention with the kernels' backward, the twin of the JAX custom VJP
    ``_fused_attention``: the forward (with statistics and, given
    ``causal_offset``, the causal bias) saves q, k, v, the pad bias, out, m
    and l and keeps the offset; the backward returns dq, dk, dv with the same
    causal bias (the pad mask gets no gradient). ``plain=True`` runs the
    plain versions on any device (the kernels' stand-in in parity runs on
    the card)."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, causal_offset: Optional[int] = None,
                plain: bool = False):
        bias = pad_bias(pad_mask, q.shape[0], k.shape[1], q.device)
        out, m, l = (_plain_fwd(q, k, v, bias, causal_offset) if plain
                     else _forward(q, k, v, bias, True, causal_offset))
        ctx.plain = plain
        ctx.causal_offset = causal_offset
        ctx.save_for_backward(q, k, v, bias, out, m, l)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, m, l = ctx.saved_tensors
        bwd = _plain_bwd if ctx.plain else _backward
        dq, dk, dv = bwd(q, k, v, bias, out, m, l, g, ctx.causal_offset)
        return dq, dk, dv, None, None, None


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    causal_offset: Optional[int] = None) -> torch.Tensor:
    """Attention over (B, T, H, D) q and (B, S, H, D) k/v; returns
    (B, T, H, D) contiguous in q's dtype. CUDA tensors launch the kernels
    (f32 or bf16, D in ``SUPPORTED_HEAD_DIMS``, unit stride along D; other
    strides are passed through, so head-split views need no copy; the
    designs follow the dtype, :func:`forward_design` and
    :func:`backward_design`); CPU
    tensors run the plain versions. When autograd records, the call goes
    through :class:`FusedAttention` (forward with statistics, backward
    kernels); otherwise the forward runs without statistics.
    ``causal_offset``: query row i attends key j only if j <= i + offset,
    added by index in the forward and in both backward kernels."""
    _check(q, k, v)
    if _records_grad(q, k, v):
        return FusedAttention.apply(q, k, v, pad_mask, causal_offset)
    return _forward(q, k, v, pad_bias(pad_mask, q.shape[0], k.shape[1], q.device),
                    False, causal_offset)[0]


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None,
                    causal_offset: Optional[int] = None) -> torch.Tensor:
    """The plain versions of the forward and of the backward on any device,
    differentiable the same way: what a parity run puts in the kernels'
    place. Counts no launch and no plain call."""
    _check(q, k, v)
    if _records_grad(q, k, v):
        return FusedAttention.apply(q, k, v, pad_mask, causal_offset, True)
    return attention_reference(q, k, v, pad_mask, causal_offset)
