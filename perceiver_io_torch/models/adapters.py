"""Text input/output adapters (the counterparts of
``perceiver_io_tpu/models/adapters.py``).

- input adapters map task input to ``(B, M, C_in)`` and expose
  ``num_input_channels``;
- output adapters map the decoder output ``(B, K, C_out)`` to task output
  and expose ``output_shape == (K, C_out)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_torch.ops.attention import Linear


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
        return (self.embedding.to(self.dtype) * self.scale)[ids.long()]


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, l = x.shape
        if l > self.max_seq_len:
            raise ValueError(f"sequence length {l} exceeds max_seq_len {self.max_seq_len}")
        return self.text_embedding(x) + self.pos_encoding[:l].to(self.dtype)


class ClassificationOutputAdapter(nn.Module):
    """Linear head over the decoder output; squeezes the query dim when the
    configured query count is 1.

    ``pad_classes_to`` rounds the projection width up to a multiple, with
    the extra logits pinned to ``-1e30`` so no softmax, argmax or top-k
    picks them."""

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
