"""Fourier position encodings of an image's pixels (the port's copy of
``perceiver_io_tpu/ops/fourier.py``; the arithmetic is the same numpy f32,
so the encodings are bit for bit the JAX package's).

- positions: per spatial dim, evenly spaced coordinates in [-1, 1]
  (``linspace``), combined with an 'ij'-indexed meshgrid and stacked
  channel-last;
- encodings: per dim *i*, ``num_bands`` frequencies linearly spaced from 1.0
  to ``max_freq_i / 2`` (``max_freq_i`` defaults to the size of dim *i*);
  features are the raw positions, then ``sin(pi f p)``, then
  ``cos(pi f p)`` for every (dim, band) pair.

Total channels: ``ndim * (2 * num_bands + include_positions)``. The
encodings are a constant of the image shape: the adapter makes them once
and holds them on the device (``models.adapters.ImageInputAdapter``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def spatial_positions(spatial_shape: Sequence[int], v_min: float = -1.0,
                      v_max: float = 1.0) -> np.ndarray:
    """Evenly spaced coordinates for each point of ``spatial_shape``:
    ``(*spatial_shape, len(spatial_shape))`` f32 in ``[v_min, v_max]``."""
    coords = [np.linspace(v_min, v_max, num=s, dtype=np.float32) for s in spatial_shape]
    return np.stack(np.meshgrid(*coords, indexing="ij"), axis=-1)


def fourier_position_encodings(p: np.ndarray, num_frequency_bands: int,
                               max_frequencies: Optional[Tuple[int, ...]] = None,
                               include_positions: bool = True) -> np.ndarray:
    """Fourier-encode positions ``p`` of shape ``(*d, c)``, c = len(d):
    ``(*d, c * (2 * num_bands + include_positions))`` f32, the features
    ordered positions, every sine, every cosine."""
    p = np.asarray(p, dtype=np.float32)
    if max_frequencies is None:
        max_frequencies = p.shape[:-1]
    if len(max_frequencies) != p.shape[-1]:
        raise ValueError(f"need one max frequency per position dim: got "
                         f"{len(max_frequencies)} for {p.shape[-1]} dims")
    grids = [p[..., i: i + 1] * np.linspace(1.0, max_freq / 2.0, num=num_frequency_bands,
                                            dtype=np.float32)
             for i, max_freq in enumerate(max_frequencies)]
    encodings = [p] if include_positions else []
    encodings.extend(np.sin(np.float32(np.pi) * g) for g in grids)
    encodings.extend(np.cos(np.float32(np.pi) * g) for g in grids)
    return np.concatenate(encodings, axis=-1)


def num_position_encoding_channels(num_spatial_dims: int, num_frequency_bands: int,
                                   include_positions: bool = True) -> int:
    """The channel count :func:`fourier_position_encodings` gives."""
    return num_spatial_dims * (2 * num_frequency_bands + int(include_positions))
