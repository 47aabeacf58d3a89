"""The Perceiver IO core at inference: encoder, decoder, and the MLM model
(the counterparts of ``perceiver_io_tpu/models/perceiver.py``).

- encoder layer 1 has its own weights; layers 2..num_layers share ONE
  weight set (``layer_n``) applied recurrently, and its cross-attention K/V
  projection of the unchanging input is computed once and reused — so the
  second and later applications run no k/v projection.
- learned latent / output-query arrays init ~N(0, 0.02) clamped to ±2.
- the decoder decodes either every output query or only the rows at
  ``positions``; queries never interact, so a subset is exactly those rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from perceiver_io_torch.models.adapters import TextInputAdapter
from perceiver_io_torch.ops.attention import (
    CrossAttentionLayer,
    LayerNorm,
    Linear,
    SelfAttentionBlock,
)


class PerceiverLayer(nn.Module):
    """One encoder layer: cross-attention (latent ← input) + self-attention
    block."""

    def __init__(self, num_latent_channels: int, num_input_channels: int,
                 num_cross_attention_heads: int, num_self_attention_heads: int,
                 num_self_attention_layers_per_block: int, dtype=torch.float32):
        super().__init__()
        self.cross_attention_layer = CrossAttentionLayer(
            num_latent_channels, num_input_channels, num_cross_attention_heads, dtype)
        self.self_attention_block = SelfAttentionBlock(
            num_self_attention_layers_per_block, num_latent_channels,
            num_self_attention_heads, dtype)

    def forward(self, x_latent, x_input, pad_mask=None, kv=None):
        """Returns ``(x_latent, kv)``: the cross-attention's (k, v) of
        ``x_input`` (computed here when ``kv`` is None, else passed through)."""
        x_latent, kv = self.cross_attention_layer(x_latent, x_input, pad_mask, kv)
        return self.self_attention_block(x_latent), kv


class PerceiverEncoder(nn.Module):
    """Generic Perceiver IO encoder over an injected input adapter."""

    def __init__(self, input_adapter: nn.Module, latent_shape: Tuple[int, int],
                 num_layers: int, num_cross_attention_heads: int = 4,
                 num_self_attention_heads: int = 4,
                 num_self_attention_layers_per_block: int = 2,
                 dtype=torch.float32):
        super().__init__()
        self.input_adapter = input_adapter
        self.latent_shape = tuple(latent_shape)
        self.num_layers = num_layers
        self.dtype = dtype
        self.latent = nn.Parameter(torch.empty(self.latent_shape))
        layer = dict(
            num_latent_channels=latent_shape[1],
            num_input_channels=input_adapter.num_input_channels,
            num_cross_attention_heads=num_cross_attention_heads,
            num_self_attention_heads=num_self_attention_heads,
            num_self_attention_layers_per_block=num_self_attention_layers_per_block,
            dtype=dtype,
        )
        self.layer_1 = PerceiverLayer(**layer)
        if num_layers > 1:
            self.layer_n = PerceiverLayer(**layer)

    def forward(self, x, pad_mask=None):
        x = self.input_adapter(x)
        b = x.shape[0]
        x_latent = self.latent.to(self.dtype).expand(b, *self.latent_shape)
        x_latent, _ = self.layer_1(x_latent, x, pad_mask)
        kv = None
        for _ in range(self.num_layers - 1):
            x_latent, kv = self.layer_n(x_latent, x, pad_mask, kv)
        return x_latent


class PerceiverDecoder(nn.Module):
    """Generic Perceiver IO decoder: a learned output-query array
    cross-attends the latents, then the output adapter."""

    def __init__(self, output_adapter: nn.Module, latent_shape: Tuple[int, int],
                 num_cross_attention_heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.output_adapter = output_adapter
        self.latent_shape = tuple(latent_shape)
        self.dtype = dtype
        output_shape = output_adapter.output_shape
        self.output = nn.Parameter(torch.empty(tuple(output_shape)))
        self.cross_attention_layer = CrossAttentionLayer(
            output_shape[-1], latent_shape[1], num_cross_attention_heads, dtype)

    def forward(self, x, positions: Optional[torch.Tensor] = None):
        """``positions``: optional (B, K) int — decode only these rows of
        the output-query array."""
        b, *d = x.shape
        if tuple(d) != self.latent_shape:
            raise ValueError(
                f"Latent shape {tuple(d)} different from required shape "
                f"{self.latent_shape}")
        if positions is not None:
            x_output = self.output[positions.long()].to(self.dtype)
        else:
            x_output = self.output.to(self.dtype).expand(b, *self.output.shape)
        x_output, _ = self.cross_attention_layer(x_output, x)
        return self.output_adapter(x_output)


class PerceiverMLM(nn.Module):
    """encoder → decoder, logits truncated to the input length — the
    inference surface of the JAX package's ``PerceiverMLM`` (masking is
    training's and not ported)."""

    def __init__(self, encoder: PerceiverEncoder, decoder: PerceiverDecoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, x_input: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                masking: bool = False, positions: Optional[torch.Tensor] = None):
        """``(logits, None)``: (B, L, vocab), or (B, K, vocab) at the (B, K)
        ``positions``."""
        if masking:
            raise ValueError(
                "masking=True is the training path, which the port does not "
                "have yet; serve with masking=False")
        x_latent = self.encoder(x_input, pad_mask)
        if positions is not None:
            return self.decoder(x_latent, positions), None
        return self.decoder(x_latent)[:, : x_input.shape[1], :], None

    def encode(self, x_input: torch.Tensor,
               pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder half: token ids → (B, N, C) latents."""
        return self.encoder(x_input, pad_mask)

    def decode(self, x_latent: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decoder half over cached latents: (B, K) ``positions`` → (B, K,
        vocab) logits (None = the full max_seq_len decode)."""
        return self.decoder(x_latent, positions)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight of ``model`` from ``generator`` with the JAX twin's
    initializers (the learned latent/output arrays N(0, 0.02) clamped to
    ±2; adapters and projections by their own ``reset_parameters``)."""
    for module in model.modules():
        if isinstance(module, (Linear, TextInputAdapter)):
            module.reset_parameters(generator)
        elif isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, PerceiverEncoder):
            module.latent.normal_(0.0, 0.02, generator=generator).clamp_(-2.0, 2.0)
        elif isinstance(module, PerceiverDecoder):
            module.output.normal_(0.0, 0.02, generator=generator).clamp_(-2.0, 2.0)
    return model
