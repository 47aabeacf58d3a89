"""The Perceiver IO core: encoder, decoder, and the MLM model (the
counterparts of ``perceiver_io_tpu/models/perceiver.py``).

- encoder layer 1 has its own weights; layers 2..num_layers share ONE
  weight set (``layer_n``) applied recurrently, and its cross-attention K/V
  projection of the unchanging input is computed once and reused — so the
  second and later applications run no k/v projection.
- learned latent / output-query arrays init ~N(0, 0.02) clamped to ±2.
- the decoder decodes either every output query or only the rows at
  ``positions``; queries never interact, so a subset is exactly those rows.
- the MLM's training forward masks its input (``masking=True``) and, with
  ``loss_gather_capacity``, decodes only the masked positions.
- ``attn_impl`` (``'pallas'`` or ``'packed'``, see ``ops/attention.py``)
  picks the attention kernels of every layer below; the weights do not
  depend on it.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiver_io_torch.models.adapters import TextInputAdapter
from perceiver_io_torch.ops.attention import (
    CrossAttentionLayer,
    LayerNorm,
    Linear,
    SelfAttentionBlock,
)
from perceiver_io_torch.ops.masking import IGNORE_LABEL, TextMasking


class PerceiverLayer(nn.Module):
    """One encoder layer: cross-attention (latent ← input) + self-attention
    block."""

    def __init__(self, num_latent_channels: int, num_input_channels: int,
                 num_cross_attention_heads: int, num_self_attention_heads: int,
                 num_self_attention_layers_per_block: int, dtype=torch.float32,
                 attn_impl: str = "pallas"):
        super().__init__()
        self.cross_attention_layer = CrossAttentionLayer(
            num_latent_channels, num_input_channels, num_cross_attention_heads, dtype,
            attn_impl)
        self.self_attention_block = SelfAttentionBlock(
            num_self_attention_layers_per_block, num_latent_channels,
            num_self_attention_heads, dtype, attn_impl)

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
                 dtype=torch.float32, attn_impl: str = "pallas"):
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
            attn_impl=attn_impl,
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
                 num_cross_attention_heads: int = 4, dtype=torch.float32,
                 attn_impl: str = "pallas"):
        super().__init__()
        self.output_adapter = output_adapter
        self.latent_shape = tuple(latent_shape)
        self.dtype = dtype
        output_shape = output_adapter.output_shape
        self.output = nn.Parameter(torch.empty(tuple(output_shape)))
        self.cross_attention_layer = CrossAttentionLayer(
            output_shape[-1], latent_shape[1], num_cross_attention_heads, dtype, attn_impl)

    def forward(self, x, positions: Optional[torch.Tensor] = None,
                return_features: bool = False):
        """``positions``: optional (B, K) int — decode only these rows of
        the output-query array. ``return_features`` skips the output adapter
        and returns the (B, K, C) decoder stream, for a caller that fuses the
        head into the loss."""
        b, *d = x.shape
        if tuple(d) != self.latent_shape:
            raise ValueError(
                f"Latent shape {tuple(d)} different from required shape "
                f"{self.latent_shape}")
        if positions is not None:
            x_output = F.embedding(positions.long(), self.output).to(self.dtype)
        else:
            x_output = self.output.to(self.dtype).expand(b, *self.output.shape)
        x_output, _ = self.cross_attention_layer(x_output, x)
        if return_features:
            return x_output
        return self.output_adapter(x_output)


class PerceiverMLM(nn.Module):
    """masking → encoder → decoder, logits truncated to the input length."""

    def __init__(self, encoder: PerceiverEncoder, decoder: PerceiverDecoder,
                 masking: Optional[TextMasking] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.masking = masking

    def forward(self, x_input: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                masking: bool = False, positions: Optional[torch.Tensor] = None,
                loss_gather_capacity: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                return_features: bool = False):
        """``(logits, labels)``; with ``return_features`` the decoder's
        (B, K, C) features in the logits' place (the fused head's input).

        Serving (``masking=False``): (B, L, vocab) logits, or (B, K, vocab)
        at the (B, K) ``positions``; labels None.

        Training (``masking=True``): the input is masked with draws from
        ``generator`` and the labels come back with the logits. With
        ``loss_gather_capacity`` only K = min(capacity, L) positions per row
        are decoded: the first K masked ones, then the earliest unmasked ones
        (whose labels are already ``IGNORE_LABEL``), and the labels are
        gathered at the same positions — loss and gradients equal the full
        decode's while no row has more than K masked positions."""
        _, l = x_input.shape
        if masking:
            if positions is not None:
                raise ValueError(
                    "positions= is an inference-path argument (masking=False); "
                    "training's masked-position gather is loss_gather_capacity=")
            if self.masking is None or generator is None:
                raise ValueError("masking=True needs the model's TextMasking and a "
                                 "torch.Generator on the batch's device")
            x_masked, labels = self.masking(generator, x_input, pad_mask)
        else:
            x_masked, labels = x_input, None
        x_latent = self.encoder(x_masked, pad_mask)
        decode = (functools.partial(self.decoder, return_features=True) if return_features
                  else self.decoder)
        if positions is not None:
            return decode(x_latent, positions), None
        if masking and loss_gather_capacity is not None:
            capacity = min(loss_gather_capacity, l)
            # stable, so ties keep index order: jax.lax.top_k's order on the
            # 0/1 vector (torch.topk promises no order between ties)
            valid = (labels != IGNORE_LABEL).to(torch.int32)
            order = torch.sort(valid, dim=1, descending=True, stable=True).indices
            gather = order[:, :capacity]
            return decode(x_latent, gather), torch.gather(labels, 1, gather)
        return decode(x_latent)[:, :l, :], labels

    def encode(self, x_input: torch.Tensor,
               pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder half: token ids → (B, N, C) latents."""
        return self.encoder(x_input, pad_mask)

    def decode(self, x_latent: torch.Tensor, positions: Optional[torch.Tensor] = None,
               return_features: bool = False) -> torch.Tensor:
        """Decoder half over cached latents: (B, K) ``positions`` → (B, K,
        vocab) logits (None = the full max_seq_len decode), or the (B, K, C)
        features with ``return_features``."""
        return self.decoder(x_latent, positions, return_features)


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
