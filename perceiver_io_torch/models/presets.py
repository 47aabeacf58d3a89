"""Named MLM presets (the counterparts of ``perceiver_io_tpu/models/presets.py``).

Each preset draws its weights from a seeded ``torch.Generator`` on the CPU
(the same weights on every device) and moves the model to ``device``; with
no ``device`` it goes to the CUDA card and raises when there is none.
"""

from __future__ import annotations

import torch

from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.models.adapters import TextInputAdapter, TextOutputAdapter
from perceiver_io_torch.models.perceiver import (
    PerceiverDecoder,
    PerceiverEncoder,
    PerceiverMLM,
    init_params,
)


def flagship_mlm(vocab_size: int = 10003, max_seq_len: int = 512,
                 num_latents: int = 256, num_channels: int = 64, num_layers: int = 3,
                 num_self_attention_layers_per_block: int = 6,
                 dtype=torch.float32, device=None, seed: int = 0) -> PerceiverMLM:
    """The reference train_mlm shapes: 512-token sequences, 256 latents,
    3 encoder layers × (cross-attention + 6-layer self-attention block),
    text in/out adapters, C=64 (4 heads of depth 16)."""
    device = resolve_device(device)
    latent_shape = (num_latents, num_channels)
    model = PerceiverMLM(
        encoder=PerceiverEncoder(
            input_adapter=TextInputAdapter(vocab_size, max_seq_len, num_channels, dtype),
            latent_shape=latent_shape, num_layers=num_layers,
            num_self_attention_layers_per_block=num_self_attention_layers_per_block,
            dtype=dtype),
        decoder=PerceiverDecoder(
            output_adapter=TextOutputAdapter(
                vocab_size, max_seq_len, num_output_channels=num_channels,
                dtype=dtype),
            latent_shape=latent_shape, dtype=dtype),
    )
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def flagship_tpu_mlm(vocab_size: int = 10003, max_seq_len: int = 512,
                     num_latents: int = 256, num_channels: int = 512,
                     num_layers: int = 3, num_self_attention_layers_per_block: int = 6,
                     dtype=torch.bfloat16, device=None, seed: int = 0) -> PerceiverMLM:
    """The MLM recipe at C=512 (4 heads of depth 128) with bf16 compute —
    the flagship serving configuration."""
    return flagship_mlm(
        vocab_size=vocab_size, max_seq_len=max_seq_len, num_latents=num_latents,
        num_channels=num_channels, num_layers=num_layers,
        num_self_attention_layers_per_block=num_self_attention_layers_per_block,
        dtype=dtype, device=device, seed=seed)


def tiny_mlm(vocab_size: int = 503, max_seq_len: int = 64, num_latents: int = 16,
             num_channels: int = 32, num_layers: int = 2,
             num_self_attention_layers_per_block: int = 1, dtype=torch.float32,
             device=None, seed: int = 0) -> PerceiverMLM:
    """The CPU-scale twin of the flagship recipe (the tests' model)."""
    return flagship_mlm(
        vocab_size=vocab_size, max_seq_len=max_seq_len, num_latents=num_latents,
        num_channels=num_channels, num_layers=num_layers,
        num_self_attention_layers_per_block=num_self_attention_layers_per_block,
        dtype=dtype, device=device, seed=seed)


PRESETS = {
    "flagship_tpu_mlm": flagship_tpu_mlm,
    "flagship_mlm": flagship_mlm,
    "tiny": tiny_mlm,
}
