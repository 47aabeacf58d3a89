"""Input and output adapters (the counterparts of
``perceiver_io_tpu/models/adapters.py``): text in, image in, classes out.

- input adapters map task input to ``(B, M, C_in)`` and expose
  ``num_input_channels``;
- output adapters map the decoder output ``(B, K, C_out)`` to task output
  and expose ``output_shape == (K, C_out)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_torch.ops.attention import Linear
from perceiver_io_torch.ops.ce_kernel import linear_ce_integer
from perceiver_io_torch.ops.fourier import (
    fourier_position_encodings,
    num_position_encoding_channels,
    spatial_positions,
)


class TextEmbedding(nn.Module):
    """The token table under flax's ``embedding`` name, scaled by ``scale``
    BEFORE the gather (as the JAX package's ``_ScaledEmbed``)."""

    def __init__(self, vocab_size: int, num_channels: int, scale: float,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = scale
        self.embedding = nn.Parameter(torch.empty(vocab_size, num_channels))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if ids.is_floating_point():
            raise ValueError("Input type must be an integer or unsigned integer.")
        # F.embedding, not table[ids]: its backward sorts the ids and sums
        # each row's gradient in f32, where indexing's backward adds the
        # duplicates of a row one by one (the pad id fills most positions)
        return F.embedding(ids.long(), self.embedding.to(self.dtype) * self.scale)


class TextInputAdapter(nn.Module):
    """Token embedding · √C + learned position encodings."""

    def __init__(self, vocab_size: int = 10003, max_seq_len: int = 512,
                 num_channels: int = 64, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.max_seq_len = max_seq_len
        self.num_channels = num_channels
        self.text_embedding = TextEmbedding(vocab_size, num_channels,
                                            math.sqrt(num_channels), dtype)
        self.pos_encoding = nn.Parameter(torch.empty(max_seq_len, num_channels))

    @property
    def num_input_channels(self) -> int:
        return self.num_channels

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.text_embedding.embedding.uniform_(-0.1, 0.1, generator=generator)
        self.pos_encoding.uniform_(-0.5, 0.5, generator=generator)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``positions``: optional (B, L) int, the absolute position of each
        token, for rows that do not start at position 0 (the AR decode step
        embeds one token at its position); None takes ``[0, L)``."""
        _, l = x.shape
        if l > self.max_seq_len:
            raise ValueError(f"sequence length {l} exceeds max_seq_len {self.max_seq_len}")
        emb = self.text_embedding(x)
        if positions is not None:
            return emb + F.embedding(positions.long(), self.pos_encoding).to(self.dtype)
        return emb + self.pos_encoding[:l].to(self.dtype)


class ImageInputAdapter(nn.Module):
    """Flatten a channels-last image to (B, H·W, C) and concatenate the
    pixels' Fourier position encodings (``ops/fourier.py``), both in the
    compute dtype. The encodings are a constant of ``image_shape``: made
    once, in numpy f32 as the JAX adapter makes them, and held as a buffer
    in the compute dtype (it moves with the module; it is not a
    parameter)."""

    def __init__(self, image_shape: Tuple[int, ...] = (28, 28, 1),
                 num_frequency_bands: int = 32, dtype=torch.float32):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_frequency_bands = num_frequency_bands
        self.dtype = dtype
        enc = fourier_position_encodings(spatial_positions(self.spatial_shape),
                                         num_frequency_bands)
        self.register_buffer("position_encoding",
                             torch.from_numpy(enc.reshape(-1, enc.shape[-1])).to(dtype),
                             persistent=False)

    @property
    def spatial_shape(self) -> Tuple[int, ...]:
        return self.image_shape[:-1]

    @property
    def num_image_channels(self) -> int:
        return self.image_shape[-1]

    @property
    def num_input_channels(self) -> int:
        return self.num_image_channels + num_position_encoding_channels(
            len(self.spatial_shape), self.num_frequency_bands)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, *d = x.shape
        if tuple(d) != self.image_shape:
            raise ValueError(f"Input image shape {tuple(d)} different from required shape "
                             f"{self.image_shape}")
        x = x.reshape(b, -1, self.num_image_channels).to(self.dtype)
        enc = self.position_encoding.expand(b, *self.position_encoding.shape)
        return torch.cat([x, enc], dim=-1)


class ClassificationOutputAdapter(nn.Module):
    """Linear head over the decoder output; squeezes the query dim when the
    configured query count is 1.

    ``pad_classes_to`` rounds the projection width up to a multiple, with
    the extra logits pinned to ``-1e30`` so no softmax, argmax or top-k
    picks them.

    ``linear_ce`` is the fused head's per-position CE (the CE kernels on a
    CUDA tensor); the plain version can be put in its place on an instance."""

    linear_ce = staticmethod(linear_ce_integer)

    def __init__(self, num_classes: int = 2, num_outputs: int = 1,
                 num_output_channels: Optional[int] = None, dtype=torch.float32,
                 pad_classes_to: Optional[int] = None):
        super().__init__()
        self.num_classes = num_classes
        self.num_outputs = num_outputs
        self.num_output_channels = num_output_channels
        self.dtype = dtype
        self.pad_classes_to = pad_classes_to
        c_in = self.output_shape[-1]
        self.linear = Linear(c_in, self.padded_num_classes, dtype, init="torch",
                             bias_bound=c_in**-0.5)

    @property
    def output_shape(self) -> Tuple[int, int]:
        c = (self.num_output_channels if self.num_output_channels is not None
             else self.num_classes)
        return (self.num_outputs, c)

    @property
    def padded_num_classes(self) -> int:
        if self.pad_classes_to is None:
            return self.num_classes
        m = self.pad_classes_to
        if m < 1:
            raise ValueError(f"pad_classes_to must be >= 1, got {m}")
        return -(-self.num_classes // m) * m

    def masked_head(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel, bias) of the linear head with the padded classes masked
        out of the bias (``-1e9``, as the JAX package's ``masked_head``): what
        a caller that fuses the head into the loss uses instead of applying
        this adapter. The padded columns vanish from any softmax and get zero
        gradient."""
        if self.linear.kernel is None:
            raise ValueError("the fused head needs the float kernel, not a quantized one")
        kernel, bias = self.linear.kernel, self.linear.bias
        if self.padded_num_classes != self.num_classes:
            col = torch.arange(bias.shape[-1], device=bias.device)
            bias = torch.where(col < self.num_classes, bias,
                               torch.tensor(-1e9, dtype=bias.dtype, device=bias.device))
        return kernel, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        if x.shape[-1] != self.num_classes:
            col = torch.arange(x.shape[-1], device=x.device)
            x = x.masked_fill(col >= self.num_classes, -1e30)
        if self.num_outputs == 1 and x.shape[1] == 1:
            x = x.squeeze(1)
        return x


def TextOutputAdapter(vocab_size: int, max_seq_len: int,
                      num_output_channels: Optional[int] = None, dtype=torch.float32,
                      pad_classes_to: Optional[int] = None) -> ClassificationOutputAdapter:
    """Per-position vocab logits: one output query per sequence position."""
    return ClassificationOutputAdapter(
        num_classes=vocab_size, num_outputs=max_seq_len,
        num_output_channels=num_output_channels, dtype=dtype,
        pad_classes_to=pad_classes_to)
