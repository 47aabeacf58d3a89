"""Batched inference with power-of-two batch padding (the port's
``perceiver_io_tpu/inference/predictor.py``).

Requests are padded up to the next power-of-two batch bucket (padding rows
repeat row 0 and are sliced off every output) and requests larger than
``max_batch`` are chunked, so the kernels see the same few batch shapes the
JAX package compiles for.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from perceiver_io_torch.device import resolve_device


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two ≥ n, capped at ``max_batch``."""
    if n <= 0:
        raise ValueError(f"batch size must be positive, got {n}")
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
    """Pad the leading axis to ``bucket`` rows by repeating row 0."""
    n = x.shape[0]
    if bucket <= n:
        return x
    return torch.cat([x, x[:1].expand(bucket - n, *x.shape[1:])], dim=0)


def to_numpy(out: torch.Tensor) -> np.ndarray:
    """A result on the host; bf16 comes back as f32 (numpy has no bf16)."""
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()


class Predictor:
    """Wrap ``apply_fn(*batched_tensors) → tensor`` for serving: inputs
    (numpy or tensors) go to ``device``, are padded to a batch bucket and
    chunked at ``max_batch``; the output returns to the host as numpy.
    ``apply_fn`` must treat examples independently along the leading axis."""

    def __init__(self, apply_fn: Callable[..., Any], max_batch: int = 64,
                 device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.apply_fn = apply_fn
        self.max_batch = max_batch
        self.device = resolve_device(device)

    def _dispatch(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        n = inputs[0].shape[0]
        bucket = bucket_size(n, self.max_batch)
        with torch.inference_mode():
            return self.apply_fn(*[pad_rows(x, bucket) for x in inputs])[:n]

    def __call__(self, *inputs) -> np.ndarray:
        tensors = [torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                                   else x).to(self.device) for x in inputs]
        n = tensors[0].shape[0]
        if any(x.shape[0] != n for x in tensors):
            raise ValueError("all inputs must share the leading batch axis")
        if n == 0:
            raise ValueError("empty request")
        chunks = [to_numpy(self._dispatch([x[s: s + self.max_batch] for x in tensors]))
                  for s in range(0, n, self.max_batch)]
        return np.concatenate(chunks, axis=0)
