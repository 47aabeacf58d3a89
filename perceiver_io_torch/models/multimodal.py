"""Multimodal audio-video autoencoding (the counterpart of
``perceiver_io_tpu/models/multimodal.py``): the Perceiver IO paper's
Kinetics-700 task, video and audio fused into one token stream, both
reconstructed, and the clip classified from one extra query, through the
unchanged ``PerceiverEncoder`` / ``PerceiverDecoder``.

Input side:

- :class:`AudioInputAdapter`: a waveform (B, S, C_a) cut into patches of
  ``samples_per_patch`` samples a token, with 1-D Fourier encodings of the
  patch positions.
- :class:`VideoInputAdapter`: (B, T, H, W, C) cut into (pt, ph, pw)
  space-time patches by a reshape and a permute (no convolution), with 3-D
  Fourier encodings over the patch grid.
- :class:`MultimodalInputAdapter`: each stream padded to the widest
  stream's width by a trainable padding vector, tagged with a learned
  modality embedding, and the streams concatenated along M in the order the
  adapters are given.

The Fourier encodings are constants of the shapes, held as non-persistent
buffers in the compute dtype, as ``models/flow.py`` holds flow's.

Output side: :class:`AudioOutputAdapter` and :class:`VideoOutputAdapter`
(a linear head a decoder query to one patch of samples or voxels, put back
in the input's layout; ``as_patches`` keeps the video in patch space for
the loss), and :class:`MultimodalOutputAdapter`, which routes contiguous
spans of query rows to named sub-adapters and returns a dict.

Two traps for a weight carry from the JAX package:

- **Parameter names** are flax's. A sub-adapter held in the tuple of
  ``(name, adapter)`` pairs is named by its place in it: the output side's
  heads are ``decoder/output_adapter/adapters_0_1`` (video),
  ``adapters_1_1`` (audio) and ``adapters_2_1`` (label), each holding
  ``linear/{kernel,bias}``. The input side's vectors sit on the fusing
  adapter itself: ``encoder/input_adapter/audio_padding``,
  ``video_modality`` and ``audio_modality``; the widest stream (video at
  the paper's width) has no padding vector.
- **Initializers.** The padding and modality vectors are flax's
  ``truncated_normal(0.02)``: a standard normal truncated to [-2, 2], then
  scaled by 0.02, so every value lies within ±0.04. That is not the rule of
  the learned latent and query arrays, N(0, 0.02) clamped at ±2
  (``models.perceiver.init_params``). The three heads draw as torch's
  ``nn.Linear``: ``Linear(init="torch", bias_bound=C**-0.5)``.

:func:`build_multimodal_autoencoder` assembles video + audio → latents →
video + audio + label at the paper's Kinetics width by default;
:func:`multimodal_autoencoding_loss` is the weighted MSE + MSE + CE.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from perceiver_io_torch.models.adapters import ClassificationOutputAdapter
from perceiver_io_torch.ops.attention import Linear
from perceiver_io_torch.ops.fourier import (
    fourier_position_encodings,
    num_position_encoding_channels,
    spatial_positions,
)
from perceiver_io_torch.training.losses import classification_loss_and_accuracy


def _check_divisible(size: int, patch: int, what: str) -> int:
    if size % patch != 0:
        raise ValueError(f"{what}: size {size} not divisible by patch {patch}")
    return size // patch


def _encoding_buffer(module: nn.Module, grid_shape: Sequence[int], bands: int, dtype) -> None:
    """The (M, channels) Fourier encodings of ``grid_shape``'s points, in
    numpy f32 as the JAX adapters make them, as a buffer in ``dtype``."""
    enc = fourier_position_encodings(spatial_positions(tuple(grid_shape)), bands)
    module.register_buffer("position_encoding",
                           torch.from_numpy(enc.reshape(-1, enc.shape[-1])).to(dtype),
                           persistent=False)


def _video_grid(video_shape, patch_shape) -> Tuple[int, int, int]:
    t, h, w, _ = video_shape
    pt, ph, pw = patch_shape
    return (_check_divisible(t, pt, "video time"), _check_divisible(h, ph, "video height"),
            _check_divisible(w, pw, "video width"))


class AudioInputAdapter(nn.Module):
    """Waveform (B, num_samples, C_a) → (B, num_samples/p, p·C_a + pos): one
    token a patch of ``samples_per_patch`` consecutive samples (their
    channels interleaved), then the patch position's 1-D Fourier
    encodings."""

    def __init__(self, num_samples: int = 48000, samples_per_patch: int = 16,
                 num_audio_channels: int = 1, num_frequency_bands: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.num_samples = num_samples
        self.samples_per_patch = samples_per_patch
        self.num_audio_channels = num_audio_channels
        self.num_frequency_bands = num_frequency_bands
        self.dtype = dtype
        _encoding_buffer(self, (self.num_tokens,), num_frequency_bands, dtype)

    @property
    def num_tokens(self) -> int:
        return _check_divisible(self.num_samples, self.samples_per_patch, "audio")

    @property
    def num_input_channels(self) -> int:
        return (self.samples_per_patch * self.num_audio_channels
                + num_position_encoding_channels(1, self.num_frequency_bands))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, *rest = x.shape
        if tuple(rest) != (self.num_samples, self.num_audio_channels):
            raise ValueError(f"Input audio shape {tuple(rest)} != required "
                             f"({self.num_samples}, {self.num_audio_channels})")
        x = x.to(self.dtype).reshape(b, self.num_tokens,
                                     self.samples_per_patch * self.num_audio_channels)
        enc = self.position_encoding.expand(b, *self.position_encoding.shape)
        return torch.cat([x, enc], dim=-1)


class VideoInputAdapter(nn.Module):
    """Video (B, T, H, W, C) → (B, grid_size, pt·ph·pw·C + pos): one token a
    space-time patch of ``patch_shape`` voxels (in (t, h, w, c) order), then
    the 3-D Fourier encodings of its place on the (T/pt, H/ph, W/pw) grid.
    The cast to the compute dtype comes before the permute (the same values
    as the JAX adapter's cast after it, in half the bytes in bf16)."""

    def __init__(self, video_shape: Tuple[int, int, int, int] = (16, 224, 224, 3),
                 patch_shape: Tuple[int, int, int] = (1, 4, 4), num_frequency_bands: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.video_shape = tuple(video_shape)
        self.patch_shape = tuple(patch_shape)
        self.num_frequency_bands = num_frequency_bands
        self.dtype = dtype
        _encoding_buffer(self, self.grid_shape, num_frequency_bands, dtype)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return _video_grid(self.video_shape, self.patch_shape)

    @property
    def num_tokens(self) -> int:
        return math.prod(self.grid_shape)

    @property
    def num_patch_channels(self) -> int:
        return math.prod(self.patch_shape) * self.video_shape[-1]

    @property
    def num_input_channels(self) -> int:
        return self.num_patch_channels + num_position_encoding_channels(
            3, self.num_frequency_bands)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, *rest = x.shape
        if tuple(rest) != self.video_shape:
            raise ValueError(f"Input video shape {tuple(rest)} != required {self.video_shape}")
        x = patchify_video(x.to(self.dtype), self.grid_shape, self.patch_shape)
        enc = self.position_encoding.expand(b, *self.position_encoding.shape)
        return torch.cat([x, enc], dim=-1)


def _truncated_normal_(tensor: torch.Tensor, stddev: float,
                       generator: torch.Generator) -> torch.Tensor:
    """flax's ``truncated_normal(stddev)``: a standard normal truncated to
    [-2, 2], scaled by ``stddev`` (no variance correction)."""
    nn.init.trunc_normal_(tensor, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return tensor.mul_(stddev)


class MultimodalInputAdapter(nn.Module):
    """Fuse named sub-adapters into one (B, ΣM_i, common + E) token stream.

    Each stream of C_i < ``common_channels`` channels is right-padded by its
    trainable ``<name>_padding`` vector, then tagged by its learned
    ``<name>_modality`` embedding of ``num_modality_channels`` (the paper's
    modality alignment); the streams are concatenated along M in the order
    of ``adapters``, a sequence of (name, adapter) pairs. The sub-adapters
    are held as ``adapters_<i>_1``, flax's names (they have no parameters);
    ``x`` is a dict by name. :meth:`reset_parameters` draws the vectors as
    flax's ``truncated_normal(0.02)`` (the module docstring's trap b)."""

    def __init__(self, adapters: Sequence[Tuple[str, nn.Module]] = (),
                 num_modality_channels: int = 8, dtype=torch.float32):
        super().__init__()
        if not adapters:
            raise ValueError("MultimodalInputAdapter needs at least one adapter")
        self.adapters = tuple(adapters)
        self.num_modality_channels = num_modality_channels
        self.dtype = dtype
        common = self.common_channels
        for i, (name, adapter) in enumerate(self.adapters):
            self.add_module(f"adapters_{i}_1", adapter)
            if adapter.num_input_channels < common:
                self.register_parameter(f"{name}_padding", nn.Parameter(
                    torch.empty(common - adapter.num_input_channels)))
            if num_modality_channels:
                self.register_parameter(f"{name}_modality", nn.Parameter(
                    torch.empty(num_modality_channels)))

    @property
    def common_channels(self) -> int:
        return max(a.num_input_channels for _, a in self.adapters)

    @property
    def num_input_channels(self) -> int:
        return self.common_channels + self.num_modality_channels

    @property
    def num_tokens(self) -> int:
        return sum(a.num_tokens for _, a in self.adapters)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in self.parameters(recurse=False):
            _truncated_normal_(p, 0.02, generator)

    def forward(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        streams = []
        for name, adapter in self.adapters:
            tokens = adapter(x[name])  # (B, M_i, C_i)
            b, m, _ = tokens.shape
            parts = [tokens]
            for vector in (getattr(self, f"{name}_padding", None),
                           getattr(self, f"{name}_modality", None)):
                if vector is not None:
                    parts.append(vector.to(self.dtype).expand(b, m, vector.shape[0]))
            streams.append(torch.cat(parts, dim=-1))
        return torch.cat(streams, dim=1)


def _head(num_output_channels: int, features: int, dtype) -> Linear:
    """A decoder query's linear head, drawn as torch's ``nn.Linear``."""
    return Linear(num_output_channels, features, dtype, init="torch",
                  bias_bound=num_output_channels**-0.5)


class AudioOutputAdapter(nn.Module):
    """One decoder query an audio patch; a linear head to its samples,
    (B, S/p, C) → (B, S, C_a)."""

    def __init__(self, num_samples: int = 48000, samples_per_patch: int = 16,
                 num_audio_channels: int = 1, num_output_channels: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.num_samples = num_samples
        self.samples_per_patch = samples_per_patch
        self.num_audio_channels = num_audio_channels
        self.num_output_channels = num_output_channels
        self.linear = _head(num_output_channels, samples_per_patch * num_audio_channels, dtype)

    @property
    def output_shape(self) -> Tuple[int, int]:
        return (_check_divisible(self.num_samples, self.samples_per_patch, "audio"),
                self.num_output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x).reshape(x.shape[0], self.num_samples, self.num_audio_channels)


class VideoOutputAdapter(nn.Module):
    """One decoder query a space-time patch; a linear head to its voxels,
    un-patchified to (B, T, H, W, C) (the exact inverse of
    :func:`patchify_video`).

    ``as_patches=True`` returns the head's (B, N_patches, pt·ph·pw·C)
    output as it is: the loss is an elementwise MSE, so it can run in patch
    space against a patchified target (the same elements, so the same loss
    up to the order of the sum), and the (B, T, H, W, C) permute pair never
    runs. The parameters are the same either way."""

    def __init__(self, video_shape: Tuple[int, int, int, int] = (16, 224, 224, 3),
                 patch_shape: Tuple[int, int, int] = (1, 4, 4), num_output_channels: int = 512,
                 dtype=torch.float32, as_patches: bool = False):
        super().__init__()
        self.video_shape = tuple(video_shape)
        self.patch_shape = tuple(patch_shape)
        self.num_output_channels = num_output_channels
        self.as_patches = as_patches
        self.linear = _head(num_output_channels,
                            math.prod(self.patch_shape) * self.video_shape[-1], dtype)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return _video_grid(self.video_shape, self.patch_shape)

    @property
    def output_shape(self) -> Tuple[int, int]:
        return (math.prod(self.grid_shape), self.num_output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        if self.as_patches:
            return x
        (gt, gh, gw), (pt, ph, pw) = self.grid_shape, self.patch_shape
        x = x.reshape(x.shape[0], gt, gh, gw, pt, ph, pw, self.video_shape[-1])
        return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(x.shape[0], *self.video_shape)


def patchify_video(video: torch.Tensor, grid_shape, patch_shape) -> torch.Tensor:
    """(B, T, H, W, C) → (B, N_patches, pt·ph·pw·C), each patch's voxels in
    (t, h, w, c) order: the video input adapter's tokens, and the target of
    a patch-space loss against ``VideoOutputAdapter(as_patches=True)``."""
    b, c = video.shape[0], video.shape[-1]
    (gt, gh, gw), (pt, ph, pw) = grid_shape, patch_shape
    x = video.reshape(b, gt, pt, gh, ph, gw, pw, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, gt * gh * gw, pt * ph * pw * c)


class MultimodalOutputAdapter(nn.Module):
    """Route contiguous spans of decoder query rows to named sub-adapters,
    in the order of ``adapters`` ((name, adapter) pairs, held as
    ``adapters_<i>_1``, flax's names); returns ``{name: sub_adapter(rows)}``.
    ``output_shape = (Σ K_i, C)``: every sub-adapter must take queries of one
    width C, else :attr:`output_shape` raises (the decoder reads it when it
    is built)."""

    def __init__(self, adapters: Sequence[Tuple[str, nn.Module]] = ()):
        super().__init__()
        self.adapters = tuple(adapters)
        for i, (_, adapter) in enumerate(self.adapters):
            self.add_module(f"adapters_{i}_1", adapter)

    @property
    def output_shape(self) -> Tuple[int, int]:
        if not self.adapters:
            raise ValueError("MultimodalOutputAdapter needs at least one adapter")
        shapes = [a.output_shape for _, a in self.adapters]
        widths = {s[1] for s in shapes}
        if len(widths) != 1:
            raise ValueError("all sub-adapters must share one query channel width, got "
                             + ", ".join(f"{n}:{s[1]}" for (n, _), s in zip(self.adapters,
                                                                            shapes)))
        return (sum(s[0] for s in shapes), widths.pop())

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, start = {}, 0
        for name, adapter in self.adapters:
            k = adapter.output_shape[0]
            out[name] = adapter(x[:, start: start + k, :])
            start += k
        return out


def build_multimodal_autoencoder(
        video_shape: Tuple[int, int, int, int] = (16, 224, 224, 3),
        num_audio_samples: int = 30720, samples_per_patch: int = 16,
        num_audio_channels: int = 1, num_classes: int = 700,
        latent_shape: Tuple[int, int] = (784, 512),
        video_patch_shape: Tuple[int, int, int] = (1, 4, 4), num_layers: int = 1,
        num_self_attention_layers_per_block: int = 8, num_cross_attention_heads: int = 1,
        num_self_attention_heads: int = 8, num_modality_channels: int = 8,
        video_frequency_bands: int = 32, audio_frequency_bands: int = 64,
        dropout: float = 0.0, dtype=torch.float32, attn_impl: str = "auto",
        remat: bool = False, reuse_kv: bool = True, video_patch_loss: bool = False):
    """``PerceiverIO`` mapping ``{'video', 'audio'}`` to ``{'video',
    'audio', 'label'}``, uninitialised (``models.perceiver.init_params``
    draws its weights); the defaults are the Perceiver IO paper's Kinetics
    configuration. ``video_patch_loss`` keeps the video head in patch space
    (``VideoOutputAdapter.as_patches``): ``training.steps.
    make_multimodal_steps`` then patchifies the target instead."""
    from perceiver_io_torch.models.perceiver import (
        PerceiverDecoder,
        PerceiverEncoder,
        PerceiverIO,
    )

    c = latent_shape[1]
    audio = dict(num_samples=num_audio_samples, samples_per_patch=samples_per_patch,
                 num_audio_channels=num_audio_channels)
    input_adapter = MultimodalInputAdapter(
        (("video", VideoInputAdapter(video_shape, video_patch_shape, video_frequency_bands,
                                     dtype)),
         ("audio", AudioInputAdapter(**audio, num_frequency_bands=audio_frequency_bands,
                                     dtype=dtype))),
        num_modality_channels=num_modality_channels, dtype=dtype)
    output_adapter = MultimodalOutputAdapter(
        (("video", VideoOutputAdapter(video_shape, video_patch_shape, c, dtype,
                                      as_patches=video_patch_loss)),
         ("audio", AudioOutputAdapter(**audio, num_output_channels=c, dtype=dtype)),
         ("label", ClassificationOutputAdapter(num_classes=num_classes, num_outputs=1,
                                               num_output_channels=c, dtype=dtype))))
    encoder = PerceiverEncoder(
        input_adapter, latent_shape=latent_shape, num_layers=num_layers,
        num_cross_attention_heads=num_cross_attention_heads,
        num_self_attention_heads=num_self_attention_heads,
        num_self_attention_layers_per_block=num_self_attention_layers_per_block,
        dtype=dtype, attn_impl=attn_impl, dropout=dropout, remat=remat, reuse_kv=reuse_kv)
    decoder = PerceiverDecoder(output_adapter, latent_shape=latent_shape,
                               num_cross_attention_heads=num_cross_attention_heads,
                               dtype=dtype, attn_impl=attn_impl, dropout=dropout)
    return PerceiverIO(encoder, decoder)


def video_patch_info(model: nn.Module) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """``(grid_shape, patch_shape)`` of the model's video head when it runs
    in patch space (``as_patches``), read off the adapter; else None."""
    output_adapter = getattr(getattr(model, "decoder", None), "output_adapter", None)
    for name, adapter in getattr(output_adapter, "adapters", ()):
        if name == "video" and getattr(adapter, "as_patches", False):
            return adapter.grid_shape, adapter.patch_shape
    return None


def multimodal_autoencoding_loss(outputs: Dict[str, torch.Tensor],
                                 batch: Dict[str, torch.Tensor], video_weight: float = 1.0,
                                 audio_weight: float = 1.0, label_weight: float = 1.0,
                                 video_patch_info=None):
    """Weighted MSE(video) + MSE(audio) + CE(label): ``(loss, metrics)``,
    metrics ``video_loss``, ``audio_loss``, ``label_loss``, ``video_psnr``
    (over the [0, 1] video, from the MSE clamped at 1e-10) and ``acc``. Each
    MSE is taken in f32 on the prediction cast to f32, as the JAX loss takes
    it. A patch-space video prediction (3-D against a 5-D target) needs
    ``video_patch_info = (grid_shape, patch_shape)`` from the model's
    adapter (:func:`video_patch_info`): several factorisations can match
    the shapes, and a wrong one pairs predictions with the wrong voxels."""
    video_target, video_pred = batch["video"], outputs["video"]
    if video_pred.ndim == 3 and video_target.ndim == 5:
        if video_patch_info is None:
            raise ValueError("patch-space video output needs video_patch_info="
                             "(grid_shape, patch_shape)")
        video_target = patchify_video(video_target, *video_patch_info)
    video_loss = torch.mean(torch.square(video_pred.float() - video_target))
    audio_loss = torch.mean(torch.square(outputs["audio"].float() - batch["audio"]))
    label_loss, acc = classification_loss_and_accuracy(outputs["label"], batch["label"])
    loss = video_weight * video_loss + audio_weight * audio_loss + label_weight * label_loss
    video_psnr = -10.0 * torch.log10(torch.clamp_min(video_loss, 1e-10))
    return loss, {"video_loss": video_loss, "audio_loss": audio_loss,
                  "label_loss": label_loss, "video_psnr": video_psnr, "acc": acc}
