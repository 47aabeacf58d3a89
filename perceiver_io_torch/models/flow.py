"""Optical flow (the counterpart of ``perceiver_io_tpu/models/flow.py``): a
frame pair in, a dense flow field out, through the unchanged
``PerceiverEncoder`` / ``PerceiverDecoder``.

- :class:`OpticalFlowInputAdapter`: a frame pair (B, 2, H, W, C) becomes one
  token per pixel: both frames' k×k patches (zero-padded at the borders;
  shift-major within a frame, frame-major across the pair, as the JAX
  adapter orders them) and the pixel's Fourier position encodings
  (``ops/fourier.py``), in the compute dtype.
- :class:`DenseSpatialOutputAdapter`: one decoder query per output pixel
  (``output_shape = (H·W, C)``), a linear head to ``num_output_features``
  per pixel, reshaped to (B, H, W, F); F = 2 (dx, dy) for flow.
- :func:`build_optical_flow_model`: the Perceiver IO paper's flow
  configuration at its defaults (a 368 × 496 Sintel frame: 182,528 input
  tokens and as many output queries; 2048 × 512 latents; one
  cross-attention head of depth 512; 24 self-attention layers of 8 heads of
  depth 64). The decoder's learned queries are one (H·W, C) parameter,
  expanded over the batch without a copy.
- :func:`end_point_error`: the mean Euclidean end-point error, the loss.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_torch.models.perceiver import PerceiverDecoder, PerceiverEncoder, PerceiverIO
from perceiver_io_torch.ops.attention import Linear
from perceiver_io_torch.ops.fourier import (
    fourier_position_encodings,
    num_position_encoding_channels,
    spatial_positions,
)


def extract_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Per-pixel k×k neighbourhoods: (..., H, W, C) → (..., H, W, k·k·C),
    zero-padded at the borders; the channels of shift (i, j) come i-major,
    then j, each shift's C channels together."""
    if patch_size % 2 != 1:
        raise ValueError(f"patch_size must be odd, got {patch_size}")
    r = patch_size // 2
    *_, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, r, r, r, r))
    shifts = [xp[..., i: i + h, j: j + w, :]
              for i in range(patch_size) for j in range(patch_size)]
    return torch.cat(shifts, dim=-1)


class OpticalFlowInputAdapter(nn.Module):
    """Frame pair → per-pixel patch features + Fourier position encodings:
    (B, 2, H, W, C) → (B, H·W, 2·k²·C + pos_channels). The encodings are a
    constant of the image shape, held as a buffer in the compute dtype."""

    def __init__(self, image_shape: Tuple[int, int, int] = (368, 496, 3),
                 patch_size: int = 3, num_frequency_bands: int = 64, dtype=torch.float32):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.patch_size = patch_size
        self.num_frequency_bands = num_frequency_bands
        self.dtype = dtype
        enc = fourier_position_encodings(spatial_positions(self.spatial_shape),
                                         num_frequency_bands)
        self.register_buffer("position_encoding",
                             torch.from_numpy(enc.reshape(-1, enc.shape[-1])).to(dtype),
                             persistent=False)

    @property
    def spatial_shape(self) -> Tuple[int, int]:
        return self.image_shape[:2]

    @property
    def num_patch_channels(self) -> int:
        return 2 * self.patch_size**2 * self.image_shape[-1]

    @property
    def num_input_channels(self) -> int:
        return self.num_patch_channels + num_position_encoding_channels(
            2, self.num_frequency_bands)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, *rest = x.shape
        if tuple(rest) != (2, *self.image_shape):
            raise ValueError(
                f"Input shape {tuple(rest)} != required (2, *{self.image_shape})")
        h, w, _ = self.image_shape
        patches = extract_patches(x.to(self.dtype), self.patch_size)  # (B, 2, H, W, k²C)
        # both frames' patches side by side per pixel, frame 0's first
        patches = patches.movedim(1, -2).reshape(b, h * w, self.num_patch_channels)
        enc = self.position_encoding.expand(b, *self.position_encoding.shape)
        return torch.cat([patches, enc], dim=-1)


class DenseSpatialOutputAdapter(nn.Module):
    """One decoder query per output pixel; a linear head to F features a
    pixel, (B, H·W, C) → (B, H, W, F)."""

    def __init__(self, spatial_shape: Tuple[int, int] = (368, 496),
                 num_output_features: int = 2, num_output_channels: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.spatial_shape = tuple(spatial_shape)
        self.num_output_features = num_output_features
        self.num_output_channels = num_output_channels
        self.dtype = dtype
        self.linear = Linear(num_output_channels, num_output_features, dtype, init="torch",
                             bias_bound=num_output_channels**-0.5)

    @property
    def output_shape(self) -> Tuple[int, int]:
        h, w = self.spatial_shape
        return (h * w, self.num_output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.spatial_shape
        return self.linear(x).reshape(x.shape[0], h, w, self.num_output_features)


def build_optical_flow_model(image_shape: Tuple[int, int, int] = (368, 496, 3),
                             latent_shape: Tuple[int, int] = (2048, 512),
                             num_layers: int = 1,
                             num_self_attention_layers_per_block: int = 24,
                             num_cross_attention_heads: int = 1,
                             num_self_attention_heads: int = 8, patch_size: int = 3,
                             num_frequency_bands: int = 64, dropout: float = 0.0,
                             dtype=torch.float32, attn_impl: str = "auto",
                             remat: bool = False, reuse_kv: bool = True) -> PerceiverIO:
    """``PerceiverIO`` for optical flow, uninitialised (``models.perceiver.
    init_params`` draws its weights); the defaults are the Perceiver IO
    paper's flow configuration."""
    h, w, _ = image_shape
    encoder = PerceiverEncoder(
        OpticalFlowInputAdapter(image_shape, patch_size, num_frequency_bands, dtype),
        latent_shape=latent_shape, num_layers=num_layers,
        num_cross_attention_heads=num_cross_attention_heads,
        num_self_attention_heads=num_self_attention_heads,
        num_self_attention_layers_per_block=num_self_attention_layers_per_block,
        dtype=dtype, attn_impl=attn_impl, dropout=dropout, remat=remat, reuse_kv=reuse_kv)
    decoder = PerceiverDecoder(
        DenseSpatialOutputAdapter((h, w), num_output_features=2,
                                  num_output_channels=latent_shape[1], dtype=dtype),
        latent_shape=latent_shape, num_cross_attention_heads=num_cross_attention_heads,
        dtype=dtype, attn_impl=attn_impl, dropout=dropout)
    return PerceiverIO(encoder, decoder)


def end_point_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean Euclidean end-point error, the standard optical-flow metric. Its
    gradient at a pixel whose error is exactly 0 is 0 here and NaN in the
    JAX package (``jnp.linalg.norm``); they agree wherever the JAX one is
    finite."""
    return torch.linalg.vector_norm(pred - target, dim=-1).mean()
