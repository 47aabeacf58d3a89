"""Named MLM and Perceiver-AR presets (the counterparts of
``perceiver_io_tpu/models/presets.py``).

Each preset draws its weights from a seeded ``torch.Generator`` on the CPU
(the same weights on every device) and moves the model to ``device``; with
no ``device`` it goes to the CUDA card and raises when there is none.
"""

from __future__ import annotations

from typing import Optional

import torch

from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.models.adapters import TextInputAdapter, TextOutputAdapter
from perceiver_io_torch.models.perceiver import (
    PerceiverARLM,
    PerceiverDecoder,
    PerceiverEncoder,
    PerceiverMLM,
    init_params,
)
from perceiver_io_torch.ops.masking import TextMasking


def flagship_mlm(vocab_size: int = 10003, max_seq_len: int = 512,
                 num_latents: int = 256, num_channels: int = 64, num_layers: int = 3,
                 num_self_attention_layers_per_block: int = 6,
                 dtype=torch.float32, device=None, seed: int = 0,
                 pad_classes_to: Optional[int] = None, attn_impl: str = "pallas",
                 decoder_attn_impl: Optional[str] = None, dropout: float = 0.0,
                 remat: bool = False, reuse_kv: bool = True) -> PerceiverMLM:
    """The reference train_mlm shapes: 512-token sequences, 256 latents,
    3 encoder layers × (cross-attention + 6-layer self-attention block),
    text in/out adapters, C=64 (4 heads of depth 16); masking with [UNK] 1,
    [MASK] 2 and 3 special tokens, as the tokenizer lays them out.
    ``pad_classes_to`` rounds the vocab head's width up to a multiple.
    ``attn_impl`` picks the attention (``'pallas'``, the default, and
    ``'packed'`` the kernels; ``'xla'`` the einsum path; ``'auto'`` by
    ``ops.attention.auto_attention_impl``); ``decoder_attn_impl`` overrides
    the decoder's (None = the same). The weights do not depend on either.
    ``dropout``: every layer's rate; ``remat``: recompute each encoder layer
    in the backward; ``reuse_kv``: the shared layer's cross (k, v) computed
    once (``PerceiverEncoder``)."""
    device = resolve_device(device)
    latent_shape = (num_latents, num_channels)
    model = mlm_model(
        encoder=PerceiverEncoder(
            input_adapter=TextInputAdapter(vocab_size, max_seq_len, num_channels, dtype),
            latent_shape=latent_shape, num_layers=num_layers,
            num_self_attention_layers_per_block=num_self_attention_layers_per_block,
            dtype=dtype, attn_impl=attn_impl, dropout=dropout, remat=remat,
            reuse_kv=reuse_kv),
        decoder=PerceiverDecoder(
            output_adapter=TextOutputAdapter(
                vocab_size, max_seq_len, num_output_channels=num_channels,
                dtype=dtype, pad_classes_to=pad_classes_to),
            latent_shape=latent_shape, dtype=dtype,
            attn_impl=decoder_attn_impl or attn_impl, dropout=dropout))
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def mlm_model(encoder: PerceiverEncoder, decoder: PerceiverDecoder) -> PerceiverMLM:
    """The MLM over a text encoder and decoder (weights not drawn): masking
    with [UNK] 1, [MASK] 2 and 3 special tokens, as the tokenizer lays them
    out, over the encoder's vocab."""
    vocab_size = encoder.input_adapter.text_embedding.embedding.shape[0]
    return PerceiverMLM(encoder=encoder, decoder=decoder,
                        masking=TextMasking(vocab_size, unk_token_id=1, mask_token_id=2,
                                            num_special_tokens=3))


def flagship_tpu_mlm(vocab_size: int = 10003, max_seq_len: int = 512,
                     num_latents: int = 256, num_channels: int = 512,
                     num_layers: int = 3, num_self_attention_layers_per_block: int = 6,
                     dtype=torch.bfloat16, device=None, seed: int = 0,
                     attn_impl: str = "pallas", dropout: float = 0.0,
                     remat: bool = False) -> PerceiverMLM:
    """The MLM recipe at C=512 (4 heads of depth 128) with bf16 compute —
    the flagship serving configuration."""
    return flagship_mlm(
        vocab_size=vocab_size, max_seq_len=max_seq_len, num_latents=num_latents,
        num_channels=num_channels, num_layers=num_layers,
        num_self_attention_layers_per_block=num_self_attention_layers_per_block,
        dtype=dtype, device=device, seed=seed, attn_impl=attn_impl, dropout=dropout,
        remat=remat)


def tiny_mlm(vocab_size: int = 503, max_seq_len: int = 64, num_latents: int = 16,
             num_channels: int = 32, num_layers: int = 2,
             num_self_attention_layers_per_block: int = 1, dtype=torch.float32,
             device=None, seed: int = 0, attn_impl: str = "pallas", dropout: float = 0.0,
             remat: bool = False) -> PerceiverMLM:
    """The CPU-scale twin of the flagship recipe (the tests' model)."""
    return flagship_mlm(
        vocab_size=vocab_size, max_seq_len=max_seq_len, num_latents=num_latents,
        num_channels=num_channels, num_layers=num_layers,
        num_self_attention_layers_per_block=num_self_attention_layers_per_block,
        dtype=dtype, device=device, seed=seed, attn_impl=attn_impl, dropout=dropout,
        remat=remat)


def flagship_ar(vocab_size: int = 10003, max_seq_len: int = 512, num_latents: int = 256,
                num_channels: int = 512, num_layers: int = 3,
                num_self_attention_layers_per_block: int = 6, dtype=torch.bfloat16,
                device=None, seed: int = 0, attn_impl: str = "pallas",
                pad_classes_to: Optional[int] = None, dropout: float = 0.0,
                num_cross_attention_heads: int = 4,
                num_self_attention_heads: int = 4) -> PerceiverARLM:
    """The generative (Perceiver-AR causal decode) task at the flagship
    widths: the encoder recipe of ``flagship_tpu_mlm`` (3 layers × (cross
    + 6-layer self block), C=512 / 4 heads of depth 128, bf16 compute),
    with the causal latent window over the last ``num_latents`` positions
    and a causal query decode predicting each successor token.

    ``attn_impl`` defaults to ``'pallas'``, the port's convention: every
    causal call goes through the attention kernel's causal offset. The JAX
    preset's default ``'auto'`` resolves every causal call to the einsum
    path (``'xla'``, which the port has too); the two compute the same
    function. ``pad_classes_to`` rounds the vocab head's width up to a
    multiple; ``dropout`` is every layer's rate. The AR model has no remat,
    as the JAX one has none."""
    return _build_ar(vocab_size, max_seq_len, num_latents, num_channels, num_layers,
                     num_self_attention_layers_per_block, dtype, device, seed, attn_impl,
                     pad_classes_to, dropout, num_cross_attention_heads,
                     num_self_attention_heads)


def tiny_ar(vocab_size: int = 503, max_seq_len: int = 64, num_latents: int = 16,
            num_channels: int = 32, num_layers: int = 2,
            num_self_attention_layers_per_block: int = 1, dtype=torch.float32,
            device=None, seed: int = 0, attn_impl: str = "pallas",
            dropout: float = 0.0) -> PerceiverARLM:
    """The CPU-scale twin of :func:`flagship_ar` (the tests' model)."""
    return _build_ar(vocab_size, max_seq_len, num_latents, num_channels, num_layers,
                     num_self_attention_layers_per_block, dtype, device, seed, attn_impl,
                     dropout=dropout)


def _build_ar(vocab_size, max_seq_len, num_latents, num_channels, num_layers,
              num_self_attention_layers_per_block, dtype, device, seed, attn_impl,
              pad_classes_to=None, dropout=0.0, num_cross_attention_heads=4,
              num_self_attention_heads=4) -> PerceiverARLM:
    device = resolve_device(device)
    model = PerceiverARLM(
        input_adapter=TextInputAdapter(vocab_size, max_seq_len, num_channels, dtype),
        output_adapter=TextOutputAdapter(vocab_size, max_seq_len,
                                         num_output_channels=num_channels, dtype=dtype,
                                         pad_classes_to=pad_classes_to),
        num_latents=num_latents, num_layers=num_layers,
        num_cross_attention_heads=num_cross_attention_heads,
        num_self_attention_heads=num_self_attention_heads,
        num_self_attention_layers_per_block=num_self_attention_layers_per_block,
        dtype=dtype, attn_impl=attn_impl, dropout=dropout)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device)


PRESETS = {
    "flagship_tpu_mlm": flagship_tpu_mlm,
    "flagship_mlm": flagship_mlm,
    "tiny": tiny_mlm,
    "flagship_ar": flagship_ar,
    "tiny_ar": tiny_ar,
}
# the presets of the Perceiver-AR generation task (the others are MLMs)
AR_PRESETS = ("flagship_ar", "tiny_ar")
