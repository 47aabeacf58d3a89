"""Content digests of a param tree (the port's copy of ``tree_digest`` and
``digest_named`` from ``perceiver_io_tpu/utils/treepath.py``).

A digest is sha256 over the sorted ``/``-joined paths and, for each leaf,
its dtype name, its shape and its raw little-endian bytes, so the same
weights give the same hex digest in both packages. A bf16 tensor hashes as
the JAX side hashes an ``ml_dtypes.bfloat16`` array: the dtype name
``bfloat16`` and its 2-byte words.
"""

from __future__ import annotations

import hashlib
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from perceiver_io_torch.interop import flatten_tree


def _leaf_bytes(leaf: Any) -> Tuple[str, tuple, bytes]:
    """(dtype name, shape, little-endian bytes) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        leaf = t.numpy()
    a = np.ascontiguousarray(leaf)
    if a.dtype.byteorder == ">":  # hash a platform-stable byte order
        a = a.astype(a.dtype.newbyteorder("<"))
    return str(a.dtype), a.shape, a.tobytes()


def digest_named(named: Mapping[str, Any]) -> str:
    """sha256 over a flat ``{path: tensor or array}`` tree."""
    h = hashlib.sha256()
    for name in sorted(named):
        dtype, shape, data = _leaf_bytes(named[name])
        h.update(name.encode())
        h.update(dtype.encode())
        h.update(str(tuple(shape)).encode())
        h.update(data)
    return h.hexdigest()


def tree_digest(tree: Mapping[str, Any]) -> str:
    """sha256 over a tree's content (nested or flat, as ``interop`` takes
    trees): equal iff the trees hold the same values at the same paths."""
    return digest_named(flatten_tree(tree))
