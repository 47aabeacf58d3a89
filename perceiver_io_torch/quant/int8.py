"""Weight-only int8 / grouped-int4 quantization for the serving path.

The port's copy of ``perceiver_io_tpu/quant/int8.py``: the same scheme, bit
for bit, so a tree quantized here equals the JAX package's.

- **int8**: per-channel symmetric. Each output column ``j`` of an
  ``(in, out)`` kernel gets ``scale[j] = max|w[:, j]| / 127`` (f32) and
  ``q = round(w / scale)`` clipped to [-127, 127].
- **int4**: symmetric, values in [-7, 7], scales per ``(group_size x
  column)`` block, ``(in // group_size, out)``; a kernel whose fan-in
  ``group_size`` does not divide keeps per-channel scales. Torch has no
  int4 dtype, so storage packs two nibbles per uint8 along the fan-in
  axis: ``(in // 2, out)``, the low nibble holding the even row.

Policy: quantize the streamed matmul weights, the 2-D floating leaves whose
path ends in ``kernel``; gathered tables (embeddings, learned latent and
query arrays, position encodings) stay floating, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

QUANT_RULE = re.compile(r"kernel$")

_QMAX = 127.0  # symmetric int8: [-127, 127]
_QMAX4 = 7.0   # symmetric int4: [-7, 7]
DEFAULT_GROUP_SIZE = 128


def quantize_array(w, bits: int = 8,
                   group_size: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric quantization over the last axis: ``(q int8, scale f32)``
    (numpy, one-time load work). ``bits=4`` keeps its values in [-7, 7],
    still as int8; :func:`pack_int4` makes the storage form."""
    w = np.asarray(w, np.float32)
    if w.ndim < 1:
        raise ValueError("quantize_array needs at least one axis")
    if bits not in (8, 4):
        raise ValueError(f"unsupported bits={bits}; expected 8 or 4")
    qmax = _QMAX if bits == 8 else _QMAX4
    if group_size and w.ndim == 2 and w.shape[0] % group_size == 0:
        g = w.shape[0] // group_size
        wg = w.reshape(g, group_size, w.shape[1])
        amax = np.max(np.abs(wg), axis=1)  # (g, out)
        scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
        q = np.clip(np.rint(wg / scale[:, None, :]), -qmax, qmax)
        return q.reshape(w.shape).astype(np.int8), scale
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    # an all-zero channel quantizes to zeros under any scale; 1.0 avoids /0
    scale = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -qmax, qmax).astype(np.int8)
    return q, scale


def pack_int4(q: np.ndarray) -> np.ndarray:
    """(K, N) int8 values in [-8, 7] → (K/2, N) uint8, two nibbles per byte
    along K: the low nibble holds row 2i, the high nibble row 2i+1."""
    q = np.asarray(q, np.int8)
    if q.ndim != 2 or q.shape[0] % 2:
        raise ValueError(f"int4 packing needs a 2-D array with even rows, got {q.shape}")
    nib = q.astype(np.uint8) & 0xF
    return (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (K/2, N) uint8 → (K, N) int8."""
    low = (packed & 0xF).to(torch.int8)
    high = (packed >> 4).to(torch.int8)
    low = torch.where(low > 7, low - 16, low)
    high = torch.where(high > 7, high - 16, high)
    return torch.stack([low, high], dim=1).reshape(-1, packed.shape[-1])


def dequantize_array(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype``; a 2-D ``scale`` on a 2-D
    ``q`` means grouped scales (row block ``g`` of column ``j`` by
    ``scale[g, j]``). ``q`` is the unpacked int8 form."""
    wf = q.to(torch.float32)
    if scale.ndim == 2 and q.ndim == 2:
        g = scale.shape[0]
        wf = wf.reshape(g, q.shape[0] // g, q.shape[1]) * scale[:, None, :]
        return wf.reshape(q.shape).to(dtype)
    return (wf * scale).to(dtype)


class QKernel(nn.Module):
    """A quantized ``(K, N)`` kernel in place of a floating one: the int
    bytes (``q``: int8 ``(K, N)``, or int4 packed as uint8 ``(K/2, N)``) and
    the f32 ``scale`` (``(N,)`` or grouped ``(K/group_size, N)``), as
    buffers so ``.to(device)`` moves them. ``compute_dtype`` is the dtype
    the product runs and returns in."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        if bits not in (8, 4):
            raise ValueError(f"unsupported bits={bits}; expected 8 or 4")
        self.bits = bits
        self.compute_dtype = compute_dtype
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> Tuple[int, int]:
        rows = self.q.shape[0] * (2 if self.bits == 4 else 1)
        return rows, self.q.shape[1]

    @property
    def group_size(self) -> Optional[int]:
        """Rows per scale group, or None for per-channel scales."""
        if self.scale.ndim == 2:
            return self.shape[0] // self.scale.shape[0]
        return None

    def int_values(self) -> torch.Tensor:
        """The quantized values as (K, N) int8."""
        return unpack_int4(self.q) if self.bits == 4 else self.q

    def dequantize(self) -> torch.Tensor:
        return dequantize_array(self.int_values(), self.scale, self.compute_dtype)

    def extra_repr(self) -> str:
        return f"shape={self.shape}, bits={self.bits}, group_size={self.group_size}"


def is_quantized(tree: Mapping[str, object]) -> bool:
    """True for a tree already prepared by :func:`quantize_tree`."""
    return any(isinstance(v, QKernel) for v in tree.values())


def quantize_tree(params: Mapping[str, object], compute_dtype=torch.float32,
                  bits: int = 8, group_size: Optional[int] = None) -> Dict[str, object]:
    """Quantize a flat ``{path: array}`` param tree (``/``-joined flax
    paths) for int8w/int4w serving. Leaves matching ``QUANT_RULE`` that are 2-D
    floating become :class:`QKernel` with scales computed from the f32
    source; every other floating leaf is cast to ``compute_dtype``. The key
    set is unchanged. ``bits=4`` defaults to ``group_size=128``."""
    if bits == 4 and group_size is None:
        group_size = DEFAULT_GROUP_SIZE
    out: Dict[str, object] = {}
    for name, leaf in params.items():
        arr = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf))
        if arr.is_floating_point() and arr.ndim == 2 and QUANT_RULE.search(name):
            q, scale = quantize_array(arr.float().numpy(), bits=bits,
                                      group_size=group_size)
            stored = pack_int4(q) if bits == 4 else q
            out[name] = QKernel(torch.from_numpy(stored), torch.from_numpy(scale),
                                bits, compute_dtype)
        elif arr.is_floating_point():
            out[name] = arr.to(compute_dtype)
        else:
            out[name] = arr
    if not any(isinstance(v, QKernel) for v in out.values()):
        raise ValueError(
            "quantize_tree found no quantizable leaves — expected at least "
            f"one 2-D floating leaf matching {QUANT_RULE.pattern!r}")
    return out
