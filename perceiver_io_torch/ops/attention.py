"""Attention layers of the Perceiver core, as PyTorch modules.

The counterparts of ``perceiver_io_tpu/ops/attention.py``:

- :class:`MultiHeadAttention`: separate q/k/v projections with bias (one
  stacked product for self-attention), ``D**-0.5`` scaling, a key padding
  mask (True = ignore), an optional structural ``attn_mask``, dropout on
  the attention probabilities, an output projection. ``attn_impl`` picks
  the attention: ``'pallas'`` goes through :func:`fused_attention` on
  head-split views, ``'packed'`` through :func:`packed_latent_attention`
  on the packed (B, T, E) tensors (each launches its CUDA kernels, forward
  and backward, on a CUDA tensor), ``'xla'`` through
  :func:`dot_product_attention`, the plain einsum attention, and
  ``'auto'`` resolves per call (:func:`auto_attention_impl`). As in the
  JAX package, a call with an ``attn_mask`` or with active probability
  dropout goes to the einsum path whatever the name. ``'pallas_sp'`` is
  not ported and raises.
- :class:`CrossAttention`: pre-LN on both query and kv streams.
- :class:`SelfAttention`: single pre-LN, q = kv.
- :class:`MLP`: LayerNorm → Linear → GELU (exact) → Linear, constant width.
- the layers add their residual to the FIRST argument, after dropout.

The causal and cache surface of the Perceiver-AR decode path follows the
JAX package's: ``causal_offset`` (query row i attends key j only if
j <= i + offset; ``'pallas'`` adds it in the kernel, ``'xla'`` ORs
``causal_mask`` into ``attn_mask``, ``'auto'`` sends every causal call to
``'xla'``, ``'packed'`` raises), ``kv`` (projections of an earlier call
reused) and ``kv_only`` (project this call's k/v and nothing else: what a
decode step appends to a cache ring; ``MultiHeadAttention.project_kv``);
the self-attention modules return their (k, v) beside their output;
:class:`SelfAttentionLayer` and :class:`SelfAttentionBlock` take per-layer
``cache`` rings that a decode step writes IN PLACE (:func:`write_ring`, the
port's counterpart of the JAX package's donated ``dynamic_update_slice``)
at ``cache_index``, a :class:`RingIndex` of per-row slots on the device,
before attending the new row over them under ``cache_pad``.

Dropout follows the JAX modules: each module has a ``dropout`` rate and
each call an explicit ``deterministic`` flag (True: no dropout) and, when
it is False, a ``dropout_key`` (``ops/dropout.py``) that each module folds
into one key per draw.

Parameters keep the flax names and layouts (``q_proj.kernel`` is ``(in,
out)``; LayerNorm has ``scale``/``bias``), so a flax tree carries over by
path (``perceiver_io_torch.interop``). Each module has a compute ``dtype``:
inputs and weights are cast to it at apply, as flax's ``promote_dtype``
does, and LayerNorm statistics are taken in f32.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_torch.ops import dropout as drop
from perceiver_io_torch.ops.attention_kernel import (
    SUPPORTED_HEAD_DIMS,
    fused_attention,
)
from perceiver_io_torch.ops.masking import causal_mask
from perceiver_io_torch.ops.packed_attention_kernel import (
    packed_fits_vmem,
    packed_latent_attention,
)
from perceiver_io_torch.ops.qmatmul import dequant_matmul, linear_apply
from perceiver_io_torch.quant.int8 import QKernel

LN_EPS = 1e-5  # torch nn.LayerNorm's epsilon (flax defaults to 1e-6)
ATTN_IMPLS = ("auto", "xla", "pallas", "packed")
NOT_PORTED_ATTN_IMPLS = ("pallas_sp",)

# 'auto' on the H100 (chip_smoke.py phase 24's sweep, bf16 device ms of the
# forward + backward, PERF.md §6): the shape of the JAX rule
# (perceiver_io_tpu/ops/attention.py:96) — the kernel for a long KV stream,
# or for a large enough logits area with a head that is not too shallow —
# with the card's constants in place of its v5e ones, the kernel's own head
# depths (a D the kernel refuses never routes to it), and one term the TPU
# rule has no need of: the kernel runs one block per (batch, head, 128 query
# rows) and does not split the keys, so a call of fewer than
# AUTO_PALLAS_MIN_BLOCKS blocks leaves most of the card's 132 SMs idle and
# the einsum path wins, however long its KV stream.
AUTO_PALLAS_MIN_KV = 4096                # in-8h (64 blocks, S=50176): 5.97 vs 13.28 ms
AUTO_PALLAS_MIN_LOGITS = 128 * 1024      # B·H·T·S; tiny-self-b8 (131072): 0.026 vs 0.039
AUTO_PALLAS_AREA_MIN_HEAD_DIM = 8        # d8-self (D=8): 0.046 vs 0.070
AUTO_PALLAS_MIN_BLOCKS = 32              # 32 blocks win (tiny-self-b8, ar-step-cross);
# at 16 mlm-cross-b2 loses (0.059 vs 0.051) and mlm-32k wins (1.88 vs 2.01),
# at 8 every row loses (mlm-131k 8.44 vs 4.11)
# the rule counts a call's work in tiles of 128 query rows: one block of the
# bf16 #1 design at D <= 256 (csrc/attention_fwd.cu, and attention_deep.cu at
# D = 256), a two-block cluster of the D = 512 design (each block half the
# head's columns)
AUTO_KERNEL_ROWS = 128
# At D = 512 (AUTO_EINSUM_HEAD_DIMS) the einsum path is the faster wherever
# it fits (phase 24, fwd + bwd ms, einsum vs kernels: flow-cross at batch 1
# 12.3 vs 19.0, flow-dec-cross at batch 1 11.0 vs 15.6 and at batch 2 21.9 vs
# 22.3; at batch 8, where a step does not fit it, flow-cross-b8 98.0 vs 81.7,
# flow-dec-cross-b8 87.7 vs 90.0), so 'auto' sends such a head to the kernels
# only where the einsum path's (B, H, T, S) logits take too much memory. The line is drawn from whole bf16 train_flow
# steps with every call on the einsum path (phase 36, one 80 GB H100):
# batch 4 (1.5e9 logits a cross) peaks at 63.3 GB, batch 8 (3.0e9) runs out
# of memory; on the kernels batch 8 peaks at 33.9 GB. A model with other
# calls beside its deep ones may cross it elsewhere: the rule sees one call.
# As the JAX rule's D=512 note has it: the kernel's O(S) memory breaks the
# tie. At D = 256 the kernels win (d256-cross 1.57 vs 2.08, d256-self-b8
# 0.56 vs 1.10), and the rule of the shallower heads routes them.
AUTO_EINSUM_HEAD_DIMS = (512,)
# Past D = 512 (ImageNet's one-head crosses, D = 1024) the JAX rule's line
# holds: d > 512 takes the einsum path at any size (its deep contraction is
# compute-bound, where the einsum's matmuls win), and the D = 1024 designs
# run under attn_impl='pallas'. ImageNet's encoder cross at the CLI's batch
# 64 has 1.6e9 logits, under AUTO_DEEP_MIN_LOGITS as well.
AUTO_MAX_HEAD_DIM = 512
AUTO_DEEP_MIN_LOGITS = 1 << 31


def auto_attention_impl(b: int, t: int, s: int, h: int, d: int) -> str:
    """Resolve ``attn_impl='auto'`` for a non-causal (B, T, S, H, D) call:
    ``'pallas'`` iff the kernel takes D (``SUPPORTED_HEAD_DIMS``) and D <=
    ``AUTO_MAX_HEAD_DIM`` (the JAX rule's line), the call
    fills at least ``AUTO_PALLAS_MIN_BLOCKS`` tiles of 128 query rows
    (B·H·⌈T/128⌉), and either, at D = 512 (``AUTO_EINSUM_HEAD_DIMS``),
    B·H·T·S >= ``AUTO_DEEP_MIN_LOGITS``, or, at D <= 256, S >=
    ``AUTO_PALLAS_MIN_KV`` or B·H·T·S >= ``AUTO_PALLAS_MIN_LOGITS`` with D >=
    ``AUTO_PALLAS_AREA_MIN_HEAD_DIM``; else ``'xla'``. The same rule on every
    device (a CPU tensor runs the chosen path's plain version), so the CPU
    tests check the routing."""
    if d not in SUPPORTED_HEAD_DIMS or d > AUTO_MAX_HEAD_DIM:
        return "xla"
    if b * h * -(-t // AUTO_KERNEL_ROWS) < AUTO_PALLAS_MIN_BLOCKS:
        return "xla"
    if d in AUTO_EINSUM_HEAD_DIMS:
        return "pallas" if b * h * t * s >= AUTO_DEEP_MIN_LOGITS else "xla"
    long_kv = s >= AUTO_PALLAS_MIN_KV
    big_logits = b * h * t * s >= AUTO_PALLAS_MIN_LOGITS and d >= AUTO_PALLAS_AREA_MIN_HEAD_DIM
    return "pallas" if (long_kv or big_logits) else "xla"


def check_attn_impl(attn_impl: str) -> None:
    """Raise on an ``attn_impl`` the port does not run: ``'pallas_sp'``,
    which comes with the distribution slice, and unknown names."""
    if attn_impl in NOT_PORTED_ATTN_IMPLS:
        raise ValueError(
            f"attn_impl {attn_impl!r} is not ported yet (ROADMAP Queue 1 item 8, "
            f"with the distribution slice): the port runs {ATTN_IMPLS}")
    if attn_impl not in ATTN_IMPLS:
        # a typo'd impl must not fall through to another path
        raise ValueError(
            f"unknown attn_impl {attn_impl!r}; expected one of "
            f"{ATTN_IMPLS + NOT_PORTED_ATTN_IMPLS}")


class CallCounter:
    """Counts the calls of a plain-PyTorch path (it launches no kernel of
    its own)."""

    def __init__(self):
        self.calls = 0

    def reset(self) -> None:
        self.calls = 0


xla_counter = CallCounter()  # calls of dot_product_attention, either device


@functools.lru_cache(maxsize=None)
def _scale(d: int, dtype: torch.dtype) -> float:
    """``d**-0.5`` rounded to ``dtype``, as JAX's weakly typed scalar."""
    return float(torch.tensor(d ** -0.5, dtype=dtype))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pad_mask: Optional[torch.Tensor] = None,
                          attn_mask: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0,
                          dropout_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The einsum attention over (B, T, H, D) q and (B, S, H, D) k/v, with
    the rounding points of the JAX ``_dot_product_attention``: q is scaled
    by ``D**-0.5`` (rounded to q's dtype) in q's dtype before the first
    product; the (B, H, T, S) logits are f32 for f32 operands (full f32:
    the caller keeps TF32 off) and stored in bf16 for bf16 operands; masked
    logits are set to ``finfo(logits.dtype).min`` by ``where``, the pad mask
    (B, S) first, then ``attn_mask`` ((T, S), broadcast over the batch, or
    (B, T, S)), True = masked out; softmax in f32; ``dropout_keep`` (the
    (B, H, T, S) keep mask, given when dropout is active) applies as
    ``where(keep, p / (1 - rate), 0)`` on the f32 probabilities; the
    probabilities are cast to v's dtype for the second product. Returns
    (B, T, H, D) in v's dtype."""
    xla_counter.calls += 1
    logits = torch.einsum("bthd,bshd->bhts", q * _scale(q.shape[-1], q.dtype), k)
    neg = torch.finfo(logits.dtype).min
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask.to(torch.bool)[:, None, None, :], neg)
    if attn_mask is not None:
        if attn_mask.ndim == 2:
            attn_mask = attn_mask[None]
        logits = logits.masked_fill(attn_mask.to(torch.bool)[:, None, :, :], neg)
    probs = torch.softmax(logits.float(), dim=-1)
    if dropout_keep is not None:
        probs = drop.apply_keep(probs, dropout_keep, dropout_rate)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


class RingIndex(NamedTuple):
    """Per-row ring slots of a decode step, on the rings' device: ``slots``
    (B,) long, each inside its ring; ``rows`` ``arange(B)``, or None for a
    one-row step that every row takes; and ``active`` (B,) bool, or None
    when every row writes. A row whose ``active`` is False keeps its ring
    bit for bit, as the JAX arena's ``where`` select keeps an idle slot's."""

    slots: torch.Tensor
    rows: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None


def write_ring(ring: torch.Tensor, index: RingIndex, new: torch.Tensor) -> None:
    """Write the (B, 1, E) rows ``new`` into the (B, S, E) ``ring`` in place,
    each at its row's slot of ``index``; an inactive row writes its old
    value back. Reads nothing back from the device. One row (``rows``
    None) writes by ``index_copy_`` along the slot axis, the least host
    work a write takes (one stream's decode is host-bound)."""
    new = new.to(ring.dtype)
    if index.rows is None:
        ring.index_copy_(1, index.slots, new)
        return
    new = new[:, 0]
    if index.active is not None:
        new = torch.where(index.active[:, None], new, ring[index.rows, index.slots])
    ring[index.rows, index.slots] = new


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
    kdim=vdim=num_kv_channels, batch_first=True)`` semantics), dropout
    ``dropout`` on the attention probabilities.

    ``attention`` is :func:`fused_attention` (``'pallas'``),
    ``packed_attention`` :func:`packed_latent_attention` (``'packed'``), the
    CUDA kernels on a CUDA tensor; the plain versions can be put in their
    place on an instance."""

    attention = staticmethod(fused_attention)
    packed_attention = staticmethod(packed_latent_attention)

    def __init__(self, num_q_channels: int, num_kv_channels: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        if num_q_channels % num_heads:
            raise ValueError(
                f"num_q_channels {num_q_channels} not divisible by num_heads {num_heads}")
        check_attn_impl(attn_impl)
        e = num_q_channels
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dropout = dropout
        self.dtype = dtype
        self.q_proj = Linear(num_q_channels, e, dtype)
        self.k_proj = Linear(num_kv_channels, e, dtype)
        self.v_proj = Linear(num_kv_channels, e, dtype)
        self.out_proj = Linear(e, e, dtype, init="torch")

    def project_kv(self, x_kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (k, v) projections of ``x_kv`` alone, no query side and no
        attention (the JAX module's ``kv_only`` call)."""
        return self.k_proj(x_kv), self.v_proj(x_kv)

    def _project_qkv(self, x: torch.Tensor):
        """Self-attention's q, k, v as ONE product over the three kernels
        side by side (the JAX module's stacked einsum): each output column is
        the same dot product as in its own projection, and the input is read
        once."""
        projs = (self.q_proj, self.k_proj, self.v_proj)
        w = torch.cat([p.kernel for p in projs], dim=1).to(self.dtype)
        bias = torch.cat([p.bias for p in projs]).to(self.dtype)
        return (x.to(self.dtype) @ w + bias).chunk(3, dim=-1)

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                causal_offset: Optional[int] = None,
                attn_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, dropout_key: Optional[int] = None):
        """Returns ``(out, (k, v))``. ``kv``: the (k, v) projections of a
        previous call over the same ``x_kv`` with the same weights — the
        shared encoder layer's reuse, or a decode step's cache rings; the
        k/v projections are skipped. With neither ``kv`` nor quantized
        kernels and ``x_q is x_kv``, q, k and v come from one stacked
        product. ``causal_offset``: query row i attends key j only if
        j <= i + offset. ``attn_mask``: (T, S) or (B, T, S), True = masked
        out. ``deterministic`` False with a ``dropout`` rate drops
        probabilities by a mask drawn from ``dropout_key``."""
        quantized = self.q_proj.qkernel is not None
        if kv is None and x_q is x_kv and not quantized:
            q, k, v = self._project_qkv(x_q)
            kv = (k, v)
        else:
            q = self.q_proj(x_q)
            if kv is None:
                kv = self.project_kv(x_kv)
            k, v = kv
        b, t, e = q.shape
        s = k.shape[1]
        h = self.num_heads
        d = e // h
        dropout_active = drop.check_key(self.dropout, deterministic, dropout_key)
        impl = self.attn_impl
        if impl == "auto":
            # causal calls stay on the einsum path, as the JAX rule keeps
            # them: a row whose keys are all masked differs between the two
            # paths, so a switch must settle those rows first
            impl = "xla" if causal_offset is not None else auto_attention_impl(b, t, s, h, d)
        if impl == "packed" and causal_offset is not None:
            raise ValueError(
                "attn_impl='packed' does not implement causal_offset: use "
                "'auto'/'xla' (masked einsum) or 'pallas' (the kernel's causal offset)")
        # the kernels cover pad-masked attention without probability
        # dropout; an attn_mask or active dropout takes the einsum path
        fusable = attn_mask is None and not dropout_active
        if impl == "packed" and fusable:
            if not packed_fits_vmem(t, s, e, q.element_size()):
                raise ValueError(
                    f"attn_impl='packed' shapes T={t} S={s} E={e} exceed the packed "
                    "kernel's admission rule, the TPU kernel's per-example VMEM budget "
                    "(packed_attention_kernel.packed_vmem_bytes)")
            out = self.packed_attention(q, k, v, h, pad_mask)
        elif impl == "pallas" and fusable:
            out = self.attention(q.view(b, t, h, d), k.view(b, s, h, d),
                                 v.view(b, s, h, d), pad_mask,
                                 causal_offset=causal_offset).reshape(b, t, e)
        else:
            if causal_offset is not None:
                cmask = causal_mask(t, s, causal_offset, q.device)
                attn_mask = cmask if attn_mask is None else attn_mask | cmask
            keep = (drop.keep_mask(dropout_key, self.dropout, (b, h, t, s), q.device)
                    if dropout_active else None)
            out = dot_product_attention(q.view(b, t, h, d), k.view(b, s, h, d),
                                        v.view(b, s, h, d), pad_mask, attn_mask,
                                        self.dropout, keep).reshape(b, t, e)
        return self.out_proj(out), kv


class CrossAttention(nn.Module):
    """Pre-LN cross-attention; embedding dim = query channels."""

    def __init__(self, num_q_channels: int, num_kv_channels: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.q_norm = LayerNorm(num_q_channels, dtype)
        self.kv_norm = LayerNorm(num_kv_channels, dtype)
        self.attention = MultiHeadAttention(num_q_channels, num_kv_channels,
                                            num_heads, dtype, attn_impl, dropout)

    def forward(self, x_q, x_kv, pad_mask=None, kv=None, causal_offset=None,
                kv_only=False, attn_mask=None, deterministic=True, dropout_key=None):
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
        return self.attention(x_q, x_kv, pad_mask, kv, causal_offset, attn_mask,
                              deterministic, dropout_key)


class SelfAttention(nn.Module):
    """Pre-LN self-attention, q = kv."""

    def __init__(self, num_channels: int, num_heads: int, dtype=torch.float32,
                 attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.norm = LayerNorm(num_channels, dtype)
        self.attention = MultiHeadAttention(num_channels, num_channels, num_heads,
                                            dtype, attn_impl, dropout)

    def forward(self, x, pad_mask=None, causal_offset=None, cache=None,
                cache_index=None, attn_mask=None, deterministic=True, dropout_key=None,
                return_kv=False):
        """Returns ``(out, (k, v))``, the stream's post-norm k/v. With
        ``cache`` ((k, v) rings (B, S_cap, E)), ``x`` is the (B, 1, C) new
        row: its k/v are written into the rings at ``cache_index`` (a
        :class:`RingIndex`, :func:`write_ring`) in place, the row attends
        over the rings under ``pad_mask``, and the rings return as the
        (k, v). ``return_kv``: the (k, v) are projected on their own
        (contiguous, what a prefill keeps as its rings), as the JAX layer's
        ``return_kv`` call does; otherwise q, k and v come from one stacked
        product."""
        x = self.norm(x)
        kv = None
        if cache is not None:
            k_ring, v_ring = cache
            k_new, v_new = self.attention.project_kv(x)
            write_ring(k_ring, cache_index, k_new)
            write_ring(v_ring, cache_index, v_new)
            kv = cache
        elif return_kv:
            kv = self.attention.project_kv(x)
        return self.attention(x, x, pad_mask, kv, causal_offset, attn_mask, deterministic,
                              dropout_key)


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
    """Residual(CrossAttention) → Residual(MLP) on the query stream, each
    branch through dropout before its residual (``drop(attn) + x_q``, then
    ``drop(mlp) + x``)."""

    def __init__(self, num_q_channels: int, num_kv_channels: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.cross_attention = CrossAttention(num_q_channels, num_kv_channels,
                                              num_heads, dtype, attn_impl, dropout)
        self.mlp = MLP(num_q_channels, dtype)

    def forward(self, x_q, x_kv, pad_mask=None, kv=None, causal_offset=None,
                kv_only=False, deterministic=True, dropout_key=None):
        """Returns ``(out, (k, v))`` — see :class:`CrossAttention`; with
        ``kv_only`` only the (k, v) of ``x_kv``, no query, residual or MLP
        work. ``dropout_key`` folds into one key for the attention's
        probabilities and one for each residual branch."""
        if kv_only:
            return self.cross_attention(x_q, x_kv, kv_only=True)
        attn_out, kv = self.cross_attention(x_q, x_kv, pad_mask, kv, causal_offset,
                                            deterministic=deterministic,
                                            dropout_key=drop.fold_in(dropout_key, 0))
        x = drop.dropout(attn_out, self.dropout, drop.fold_in(dropout_key, 1),
                         deterministic) + x_q
        return drop.dropout(self.mlp(x), self.dropout, drop.fold_in(dropout_key, 2),
                            deterministic) + x, kv


class SelfAttentionLayer(nn.Module):
    """Residual(SelfAttention) → Residual(MLP), each branch through dropout
    before its residual."""

    def __init__(self, num_channels: int, num_heads: int, dtype=torch.float32,
                 attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attention = SelfAttention(num_channels, num_heads, dtype, attn_impl,
                                            dropout)
        self.mlp = MLP(num_channels, dtype)

    def forward(self, x, causal_offset=None, cache=None, cache_index=None,
                cache_pad=None, attn_mask=None, deterministic=True, dropout_key=None,
                return_kv=False):
        """Returns ``(out, (k, v))``. Three modes on one weight set, as the
        JAX layer's: plain (the MLM path); dense causal (``causal_offset``,
        ``attn_mask``), the (k, v) the post-norm rows of the whole stream, what a
        decode ring holds (projected on their own with ``return_kv``);
        incremental (``cache``): ``x`` is the (B, 1, C) new row,
        written into the rings at ``cache_index`` and attended over them
        under ``cache_pad`` (B, S_cap; True = empty slot), the (k, v) the
        rings."""
        attn_out, kv = self.self_attention(x, cache_pad, causal_offset, cache, cache_index,
                                           attn_mask, deterministic,
                                           drop.fold_in(dropout_key, 0), return_kv)
        x = drop.dropout(attn_out, self.dropout, drop.fold_in(dropout_key, 1),
                         deterministic) + x
        return drop.dropout(self.mlp(x), self.dropout, drop.fold_in(dropout_key, 2),
                            deterministic) + x, kv


class SelfAttentionBlock(nn.Module):
    """N stacked self-attention layers (``layer_0`` …), each with its own
    weights; returns ``(x, kvs)``, with the causal and cache surface of
    :class:`SelfAttentionLayer`: ``cache`` and ``kvs`` are lists of
    per-layer (k, v) (rings in the incremental mode). Layer i draws its
    dropout from ``fold_in(dropout_key, i)``."""

    def __init__(self, num_layers: int, num_channels: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", SelfAttentionLayer(num_channels, num_heads, dtype,
                                                             attn_impl, dropout))

    def forward(self, x, causal_offset=None, cache=None, cache_index=None, cache_pad=None,
                attn_mask=None, deterministic=True, dropout_key=None, return_kv=False):
        kvs = []
        for i in range(self.num_layers):
            x, kv = getattr(self, f"layer_{i}")(
                x, causal_offset, None if cache is None else cache[i], cache_index, cache_pad,
                attn_mask, deterministic, drop.fold_in(dropout_key, i), return_kv)
            kvs.append(kv)
        return x, kvs
