"""Attention layers of the Perceiver core, as PyTorch modules.

The counterparts of ``perceiver_io_tpu/ops/attention.py`` at inference:

- :class:`MultiHeadAttention`: separate q/k/v projections with bias,
  ``D**-0.5`` scaling, a key padding mask (True = ignore), an output
  projection. Every call goes through :func:`fused_attention`, which
  launches the CUDA kernel on a CUDA tensor.
- :class:`CrossAttention`: pre-LN on both query and kv streams.
- :class:`SelfAttention`: single pre-LN, q = kv.
- :class:`MLP`: LayerNorm → Linear → GELU (exact) → Linear, constant width.
- the layers add their residual to the FIRST argument.

Parameters keep the flax names and layouts (``q_proj.kernel`` is ``(in,
out)``; LayerNorm has ``scale``/``bias``), so a flax tree carries over by
path (``perceiver_io_torch.interop``). Each module has a compute ``dtype``:
inputs and weights are cast to it at apply, as flax's ``promote_dtype``
does, and LayerNorm statistics are taken in f32. Dropout is not ported:
these modules serve.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_torch.ops.attention_kernel import fused_attention
from perceiver_io_torch.ops.qmatmul import dequant_matmul, linear_apply
from perceiver_io_torch.quant.int8 import QKernel

LN_EPS = 1e-5  # torch nn.LayerNorm's epsilon (flax defaults to 1e-6)


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

    ``attention`` is :func:`fused_attention` (the CUDA kernel on a CUDA
    tensor); the plain version can be put in its place on an instance."""

    attention = staticmethod(fused_attention)

    def __init__(self, num_q_channels: int, num_kv_channels: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        if num_q_channels % num_heads:
            raise ValueError(
                f"num_q_channels {num_q_channels} not divisible by num_heads {num_heads}")
        e = num_q_channels
        self.num_heads = num_heads
        self.q_proj = Linear(num_q_channels, e, dtype)
        self.k_proj = Linear(num_kv_channels, e, dtype)
        self.v_proj = Linear(num_kv_channels, e, dtype)
        self.out_proj = Linear(e, e, dtype, init="torch")

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Returns ``(out, (k, v))``. ``kv``: the (k, v) projections of a
        previous call over the same ``x_kv`` with the same weights — the
        shared encoder layer's reuse; the k/v projections are skipped."""
        q = self.q_proj(x_q)
        if kv is None:
            kv = (self.k_proj(x_kv), self.v_proj(x_kv))
        k, v = kv
        b, t, e = q.shape
        s = k.shape[1]
        h = self.num_heads
        d = e // h
        out = self.attention(q.view(b, t, h, d), k.view(b, s, h, d),
                             v.view(b, s, h, d), pad_mask)
        return self.out_proj(out.reshape(b, t, e)), kv


class CrossAttention(nn.Module):
    """Pre-LN cross-attention; embedding dim = query channels."""

    def __init__(self, num_q_channels: int, num_kv_channels: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.q_norm = LayerNorm(num_q_channels, dtype)
        self.kv_norm = LayerNorm(num_kv_channels, dtype)
        self.attention = MultiHeadAttention(num_q_channels, num_kv_channels,
                                            num_heads, dtype)

    def forward(self, x_q, x_kv, pad_mask=None, kv=None):
        """Returns ``(out, (k, v))``; with ``kv`` given, kv_norm and the k/v
        projections are skipped (the cached tensors include them)."""
        x_q = self.q_norm(x_q)
        if kv is None:
            x_kv = self.kv_norm(x_kv)
        return self.attention(x_q, x_kv, pad_mask, kv)


class SelfAttention(nn.Module):
    """Pre-LN self-attention, q = kv."""

    def __init__(self, num_channels: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(num_channels, dtype)
        self.attention = MultiHeadAttention(num_channels, num_channels, num_heads,
                                            dtype)

    def forward(self, x, pad_mask=None):
        x = self.norm(x)
        out, _ = self.attention(x, x, pad_mask)
        return out


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
                 dtype=torch.float32):
        super().__init__()
        self.cross_attention = CrossAttention(num_q_channels, num_kv_channels,
                                              num_heads, dtype)
        self.mlp = MLP(num_q_channels, dtype)

    def forward(self, x_q, x_kv, pad_mask=None, kv=None):
        """Returns ``(out, (k, v))`` — see :class:`CrossAttention`."""
        attn_out, kv = self.cross_attention(x_q, x_kv, pad_mask, kv)
        x = attn_out + x_q
        return self.mlp(x) + x, kv


class SelfAttentionLayer(nn.Module):
    """Residual(SelfAttention) → Residual(MLP)."""

    def __init__(self, num_channels: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.self_attention = SelfAttention(num_channels, num_heads, dtype)
        self.mlp = MLP(num_channels, dtype)

    def forward(self, x):
        x = self.self_attention(x) + x
        return self.mlp(x) + x


class SelfAttentionBlock(nn.Module):
    """N stacked self-attention layers (``layer_0`` …), each with its own
    weights."""

    def __init__(self, num_layers: int, num_channels: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}",
                            SelfAttentionLayer(num_channels, num_heads, dtype))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        return x
