"""Attention layers of the Perceiver core, as PyTorch modules.

The counterparts of ``perceiver_io_tpu/ops/attention.py`` without dropout:

- :class:`MultiHeadAttention`: separate q/k/v projections with bias,
  ``D**-0.5`` scaling, a key padding mask (True = ignore), an output
  projection. ``attn_impl`` picks the attention: ``'pallas'`` (the
  default) goes through :func:`fused_attention` on head-split views,
  ``'packed'`` through :func:`packed_latent_attention` on the packed
  (B, T, E) tensors; each launches its CUDA kernels (forward, and the
  backward under autograd) on a CUDA tensor. The JAX package's ``'auto'``,
  ``'xla'`` and ``'pallas_sp'`` are not ported and raise.
- :class:`CrossAttention`: pre-LN on both query and kv streams.
- :class:`SelfAttention`: single pre-LN, q = kv.
- :class:`MLP`: LayerNorm → Linear → GELU (exact) → Linear, constant width.
- the layers add their residual to the FIRST argument.

The causal and cache surface of the Perceiver-AR decode path follows the
JAX package's: ``causal_offset`` (query row i attends key j only if
j <= i + offset; ``'pallas'`` adds it in the kernel, ``'packed'`` raises),
``kv`` (projections of an earlier call reused) and ``kv_only`` (project
this call's k/v and nothing else: what a decode step appends to a cache
ring; ``MultiHeadAttention.project_kv``); the self-attention modules
return their (k, v) beside their output; :class:`SelfAttentionLayer` and
:class:`SelfAttentionBlock` take per-layer ``cache`` rings that a decode
step writes IN PLACE at a host-int ``cache_index`` (the port's counterpart
of the JAX package's donated ``dynamic_update_slice``) before attending
the new row over them under ``cache_pad``.

Parameters keep the flax names and layouts (``q_proj.kernel`` is ``(in,
out)``; LayerNorm has ``scale``/``bias``), so a flax tree carries over by
path (``perceiver_io_torch.interop``). Each module has a compute ``dtype``:
inputs and weights are cast to it at apply, as flax's ``promote_dtype``
does, and LayerNorm statistics are taken in f32. Dropout is not ported
(the JAX package's default rate is 0).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_torch.ops.attention_kernel import fused_attention
from perceiver_io_torch.ops.packed_attention_kernel import (
    packed_fits_vmem,
    packed_latent_attention,
)
from perceiver_io_torch.ops.qmatmul import dequant_matmul, linear_apply
from perceiver_io_torch.quant.int8 import QKernel

LN_EPS = 1e-5  # torch nn.LayerNorm's epsilon (flax defaults to 1e-6)
ATTN_IMPLS = ("pallas", "packed")
NOT_PORTED_ATTN_IMPLS = ("auto", "xla", "pallas_sp")


def check_attn_impl(attn_impl: str) -> None:
    """Raise on an ``attn_impl`` the port does not run: the JAX package's
    names that have no counterpart yet, and unknown names."""
    if attn_impl in NOT_PORTED_ATTN_IMPLS:
        raise ValueError(
            f"attn_impl {attn_impl!r} is not ported yet (ROADMAP Queue 1): the port "
            f"runs {ATTN_IMPLS}")
    if attn_impl not in ATTN_IMPLS:
        # a typo'd impl must not fall through to another path
        raise ValueError(
            f"unknown attn_impl {attn_impl!r}; expected one of "
            f"{ATTN_IMPLS + NOT_PORTED_ATTN_IMPLS}")


class Linear(nn.Module):
    """A projection with a flax-layout ``kernel`` (in, out) and ``bias``.

    ``init`` picks the initialization of the JAX twin: ``'xavier'``
    (xavier-uniform kernel, zero bias — the q/k/v projections) or
    ``'torch'`` (torch's ``nn.Linear`` default ``U(±1/sqrt(in))`` kernel);
    ``bias_bound`` draws the bias from ``U(±bias_bound)`` instead of zeros.
    :meth:`set_qkernel` swaps the kernel for a :class:`QKernel`, after which
    the projection runs through ``qmatmul`` (the dequant kernel; the plain
    version can be put in its place)."""

    qmatmul = staticmethod(dequant_matmul)

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 init: str = "xavier", bias_bound: Optional[float] = None):
        super().__init__()
        if init not in ("xavier", "torch"):
            raise ValueError(f"unknown init {init!r}")
        self.dtype = dtype
        self.init = init
        self.bias_bound = bias_bound
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))
        self.qkernel: Optional[QKernel] = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in, fan_out = self.kernel.shape
        if self.init == "xavier":
            bound = math.sqrt(6.0 / (fan_in + fan_out))
        else:
            bound = 1.0 / math.sqrt(fan_in)
        self.kernel.uniform_(-bound, bound, generator=generator)
        if self.bias_bound is None:
            self.bias.zero_()
        else:
            self.bias.uniform_(-self.bias_bound, self.bias_bound, generator=generator)

    def set_qkernel(self, qkernel: QKernel) -> None:
        if tuple(qkernel.shape) != tuple(self.kernel.shape):
            raise ValueError(
                f"quantized kernel {qkernel.shape} != {tuple(self.kernel.shape)}")
        self.kernel = None
        self.qkernel = qkernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel if self.qkernel is None else self.qkernel
        return linear_apply(x, w, self.bias, self.dtype, self.qmatmul)


class LayerNorm(nn.Module):
    """LayerNorm with flax's ``scale``/``bias`` names, eps 1e-5; statistics
    in f32, output in the compute dtype."""

    def __init__(self, num_channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                         self.bias.float(), LN_EPS)
        return y.to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with distinct query / key-value channel counts
    (torch ``nn.MultiheadAttention(embed_dim=num_q_channels,
    kdim=vdim=num_kv_channels, batch_first=True)`` semantics).

    ``attention`` is :func:`fused_attention` (``attn_impl='pallas'``) and
    ``packed_attention`` :func:`packed_latent_attention` (``'packed'``), the
    CUDA kernels on a CUDA tensor; the plain versions can be put in their
    place on an instance."""

    attention = staticmethod(fused_attention)
    packed_attention = staticmethod(packed_latent_attention)

    def __init__(self, num_q_channels: int, num_kv_channels: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "pallas"):
        super().__init__()
        if num_q_channels % num_heads:
            raise ValueError(
                f"num_q_channels {num_q_channels} not divisible by num_heads {num_heads}")
        check_attn_impl(attn_impl)
        e = num_q_channels
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.q_proj = Linear(num_q_channels, e, dtype)
        self.k_proj = Linear(num_kv_channels, e, dtype)
        self.v_proj = Linear(num_kv_channels, e, dtype)
        self.out_proj = Linear(e, e, dtype, init="torch")

    def project_kv(self, x_kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (k, v) projections of ``x_kv`` alone, no query side and no
        attention (the JAX module's ``kv_only`` call)."""
        return self.k_proj(x_kv), self.v_proj(x_kv)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                causal_offset: Optional[int] = None):
        """Returns ``(out, (k, v))``. ``kv``: the (k, v) projections of a
        previous call over the same ``x_kv`` with the same weights — the
        shared encoder layer's reuse, or a decode step's cache rings; the
        k/v projections are skipped. ``causal_offset``: query row i attends
        key j only if j <= i + offset."""
        q = self.q_proj(x_q)
        if kv is None:
            kv = self.project_kv(x_kv)
        k, v = kv
        b, t, e = q.shape
        s = k.shape[1]
        h = self.num_heads
        if self.attn_impl == "packed":
            if causal_offset is not None:
                raise ValueError(
                    "attn_impl='packed' does not implement causal_offset: use "
                    "'pallas' (the kernel's causal offset)")
            if not packed_fits_vmem(t, s, e, q.element_size()):
                raise ValueError(
                    f"attn_impl='packed' shapes T={t} S={s} E={e} exceed the packed "
                    "kernel's admission rule, the TPU kernel's per-example VMEM budget "
                    "(packed_attention_kernel.packed_vmem_bytes)")
            return self.out_proj(self.packed_attention(q, k, v, h, pad_mask)), kv
        d = e // h
        out = self.attention(q.view(b, t, h, d), k.view(b, s, h, d),
                             v.view(b, s, h, d), pad_mask, causal_offset=causal_offset)
        return self.out_proj(out.reshape(b, t, e)), kv


class CrossAttention(nn.Module):
    """Pre-LN cross-attention; embedding dim = query channels."""

    def __init__(self, num_q_channels: int, num_kv_channels: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "pallas"):
        super().__init__()
        self.q_norm = LayerNorm(num_q_channels, dtype)
        self.kv_norm = LayerNorm(num_kv_channels, dtype)
        self.attention = MultiHeadAttention(num_q_channels, num_kv_channels,
                                            num_heads, dtype, attn_impl)

    def forward(self, x_q, x_kv, pad_mask=None, kv=None, causal_offset=None,
                kv_only=False):
        """Returns ``(out, (k, v))``; with ``kv`` given, kv_norm and the k/v
        projections are skipped (the cached tensors include them). With
        ``kv_only``, returns only the (k, v) of ``x_kv`` after kv_norm: what
        a decode step appends to its ring, the rows a dense forward
        projects."""
        if kv_only:
            return self.attention.project_kv(self.kv_norm(x_kv))
        x_q = self.q_norm(x_q)
        if kv is None:
            x_kv = self.kv_norm(x_kv)
        return self.attention(x_q, x_kv, pad_mask, kv, causal_offset)


class SelfAttention(nn.Module):
    """Pre-LN self-attention, q = kv."""

    def __init__(self, num_channels: int, num_heads: int, dtype=torch.float32,
                 attn_impl: str = "pallas"):
        super().__init__()
        self.norm = LayerNorm(num_channels, dtype)
        self.attention = MultiHeadAttention(num_channels, num_channels, num_heads,
                                            dtype, attn_impl)

    def forward(self, x, pad_mask=None, causal_offset=None, cache=None,
                cache_index=None):
        """Returns ``(out, (k, v))``, the stream's post-norm k/v. With
        ``cache`` ((k, v) rings (B, S_cap, E)), ``x`` is the (B, 1, C) new
        row: its k/v are written into the rings at ``cache_index`` (a host
        int) in place, the row attends over the rings under ``pad_mask``,
        and the rings return as the (k, v)."""
        x = self.norm(x)
        if cache is not None:
            k_ring, v_ring = cache
            k_new, v_new = self.attention.project_kv(x)
            k_ring[:, cache_index: cache_index + 1] = k_new
            v_ring[:, cache_index: cache_index + 1] = v_new
        return self.attention(x, x, pad_mask, cache, causal_offset)


class MLP(nn.Module):
    """LayerNorm → Linear → GELU(exact) → Linear at constant width, torch's
    default Linear initialization."""

    def __init__(self, num_channels: int, dtype=torch.float32):
        super().__init__()
        c = num_channels
        self.norm = LayerNorm(c, dtype)
        self.dense_1 = Linear(c, c, dtype, init="torch", bias_bound=c**-0.5)
        self.dense_2 = Linear(c, c, dtype, init="torch", bias_bound=c**-0.5)

    def forward(self, x):
        return self.dense_2(F.gelu(self.dense_1(self.norm(x))))


class CrossAttentionLayer(nn.Module):
    """Residual(CrossAttention) → Residual(MLP) on the query stream."""

    def __init__(self, num_q_channels: int, num_kv_channels: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "pallas"):
        super().__init__()
        self.cross_attention = CrossAttention(num_q_channels, num_kv_channels,
                                              num_heads, dtype, attn_impl)
        self.mlp = MLP(num_q_channels, dtype)

    def forward(self, x_q, x_kv, pad_mask=None, kv=None, causal_offset=None,
                kv_only=False):
        """Returns ``(out, (k, v))`` — see :class:`CrossAttention`; with
        ``kv_only`` only the (k, v) of ``x_kv``, no query, residual or MLP
        work."""
        if kv_only:
            return self.cross_attention(x_q, x_kv, kv_only=True)
        attn_out, kv = self.cross_attention(x_q, x_kv, pad_mask, kv, causal_offset)
        x = attn_out + x_q
        return self.mlp(x) + x, kv


class SelfAttentionLayer(nn.Module):
    """Residual(SelfAttention) → Residual(MLP)."""

    def __init__(self, num_channels: int, num_heads: int, dtype=torch.float32,
                 attn_impl: str = "pallas"):
        super().__init__()
        self.self_attention = SelfAttention(num_channels, num_heads, dtype, attn_impl)
        self.mlp = MLP(num_channels, dtype)

    def forward(self, x, causal_offset=None, cache=None, cache_index=None,
                cache_pad=None):
        """Returns ``(out, (k, v))``. Three modes on one weight set, as the
        JAX layer's: plain (the MLM path); dense causal (``causal_offset``),
        the (k, v) the post-norm rows of the whole stream, what a decode
        ring holds; incremental (``cache``): ``x`` is the (B, 1, C) new row,
        written into the rings at ``cache_index`` and attended over them
        under ``cache_pad`` (B, S_cap; True = empty slot), the (k, v) the
        rings."""
        attn_out, kv = self.self_attention(x, cache_pad, causal_offset, cache, cache_index)
        x = attn_out + x
        return self.mlp(x) + x, kv


class SelfAttentionBlock(nn.Module):
    """N stacked self-attention layers (``layer_0`` …), each with its own
    weights; returns ``(x, kvs)``, with the causal and cache surface of
    :class:`SelfAttentionLayer`: ``cache`` and ``kvs`` are lists of
    per-layer (k, v) (rings in the incremental mode)."""

    def __init__(self, num_layers: int, num_channels: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "pallas"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}",
                            SelfAttentionLayer(num_channels, num_heads, dtype, attn_impl))

    def forward(self, x, causal_offset=None, cache=None, cache_index=None, cache_pad=None):
        kvs = []
        for i in range(self.num_layers):
            x, kv = getattr(self, f"layer_{i}")(
                x, causal_offset, None if cache is None else cache[i], cache_index, cache_pad)
            kvs.append(kv)
        return x, kvs
