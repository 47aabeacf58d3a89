"""The Perceiver IO core: encoder, decoder, the encoder-decoder
``PerceiverIO`` (the classifiers), the MLM model and the Perceiver-AR
language model (the counterparts of ``perceiver_io_tpu/models/perceiver.py``).

- encoder layer 1 has its own weights; layers 2..num_layers share ONE
  weight set (``layer_n``) applied recurrently, and its cross-attention K/V
  projection of the unchanging input is computed once and reused — so the
  second and later applications run no k/v projection.
- learned latent / output-query arrays init ~N(0, 0.02) clamped to ±2.
- the decoder decodes either every output query or only the rows at
  ``positions``; queries never interact, so a subset is exactly those rows.
- the MLM's training forward masks its input (``masking=True``) and, with
  ``loss_gather_capacity``, decodes only the masked positions.
- ``attn_impl`` (``'auto'``, ``'xla'``, ``'pallas'`` or ``'packed'``, see
  ``ops/attention.py``) picks the attention of every layer below; the
  weights do not depend on it.
- ``dropout`` is the rate of every layer's dropout (attention
  probabilities and residual branches); a forward drops only with
  ``deterministic=False``, from the masks its ``dropout_key`` gives
  (``ops/dropout.py``): the encoder folds in each layer application's
  index, the MLM 0 for the encoder and 1 for the decoder.
- ``remat`` recomputes each encoder layer application's forward in the
  backward (``torch.utils.checkpoint``, the JAX ``nn.remat``), trading
  compute for activation memory; the recompute is handed the same dropout
  key, so it draws the same masks.
- :class:`PerceiverARLM` is causal: its dense forward, ``prefill`` and
  incremental ``step`` run every attention under the causal offset or a
  key padding mask over its cache rings.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from perceiver_io_torch.models.adapters import TextInputAdapter
from perceiver_io_torch.models.multimodal import MultimodalInputAdapter
from perceiver_io_torch.ops.attention import (
    CrossAttentionLayer,
    LayerNorm,
    Linear,
    RingIndex,
    SelfAttentionBlock,
    write_ring,
)
from perceiver_io_torch.ops.dropout import fold_in
from perceiver_io_torch.ops.masking import IGNORE_LABEL, TextMasking


class PerceiverLayer(nn.Module):
    """One encoder layer: cross-attention (latent ← input) + self-attention
    block."""

    def __init__(self, num_latent_channels: int, num_input_channels: int,
                 num_cross_attention_heads: int, num_self_attention_heads: int,
                 num_self_attention_layers_per_block: int, dtype=torch.float32,
                 attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.cross_attention_layer = CrossAttentionLayer(
            num_latent_channels, num_input_channels, num_cross_attention_heads, dtype,
            attn_impl, dropout)
        self.self_attention_block = SelfAttentionBlock(
            num_self_attention_layers_per_block, num_latent_channels,
            num_self_attention_heads, dtype, attn_impl, dropout)

    def forward(self, x_latent, x_input, pad_mask=None, kv=None, deterministic=True,
                dropout_key=None):
        """Returns ``(x_latent, kv)``: the cross-attention's (k, v) of
        ``x_input`` (computed here when ``kv`` is None, else passed through).
        The cross-attention draws its dropout from ``fold_in(dropout_key,
        0)``, the block from ``fold_in(dropout_key, 1)``."""
        x_latent, kv = self.cross_attention_layer(
            x_latent, x_input, pad_mask, kv, deterministic=deterministic,
            dropout_key=fold_in(dropout_key, 0))
        return self.self_attention_block(x_latent, deterministic=deterministic,
                                         dropout_key=fold_in(dropout_key, 1))[0], kv


class PerceiverEncoder(nn.Module):
    """Generic Perceiver IO encoder over an injected input adapter.

    ``remat``: each layer application's forward is recomputed in the
    backward. ``reuse_kv`` (the default): the shared ``layer_n``'s
    cross-attention (k, v) of the unchanging input are computed once and
    passed to its later applications (exact: the same tensors); False
    projects them again at each application (the JAX ``--no_reuse_kv``)."""

    def __init__(self, input_adapter: nn.Module, latent_shape: Tuple[int, int],
                 num_layers: int, num_cross_attention_heads: int = 4,
                 num_self_attention_heads: int = 4,
                 num_self_attention_layers_per_block: int = 2,
                 dtype=torch.float32, attn_impl: str = "pallas", dropout: float = 0.0,
                 remat: bool = False, reuse_kv: bool = True):
        super().__init__()
        self.input_adapter = input_adapter
        self.latent_shape = tuple(latent_shape)
        self.num_layers = num_layers
        self.dtype = dtype
        self.remat = remat
        self.reuse_kv = reuse_kv
        self.latent = nn.Parameter(torch.empty(self.latent_shape))
        layer = dict(
            num_latent_channels=latent_shape[1],
            num_input_channels=input_adapter.num_input_channels,
            num_cross_attention_heads=num_cross_attention_heads,
            num_self_attention_heads=num_self_attention_heads,
            num_self_attention_layers_per_block=num_self_attention_layers_per_block,
            dtype=dtype,
            attn_impl=attn_impl,
            dropout=dropout,
        )
        self.layer_1 = PerceiverLayer(**layer)
        if num_layers > 1:
            self.layer_n = PerceiverLayer(**layer)

    def _apply_layer(self, layer, x_latent, x, pad_mask, kv, deterministic, key):
        if self.remat and torch.is_grad_enabled():
            # the global generators hold no dropout state (ops/dropout.py):
            # nothing to stash, and the recompute sees the same key
            return checkpoint(layer, x_latent, x, pad_mask, kv, deterministic, key,
                              use_reentrant=False, preserve_rng_state=False)
        return layer(x_latent, x, pad_mask, kv, deterministic, key)

    def forward(self, x, pad_mask=None, deterministic=True, dropout_key=None):
        """Layer application a draws its dropout from ``fold_in(dropout_key,
        a)`` (layer_1 is application 0)."""
        x = self.input_adapter(x)
        b = x.shape[0]
        x_latent = self.latent.to(self.dtype).expand(b, *self.latent_shape)
        x_latent, _ = self._apply_layer(self.layer_1, x_latent, x, pad_mask, None,
                                        deterministic, fold_in(dropout_key, 0))
        kv = None
        for a in range(1, self.num_layers):
            x_latent, kv_out = self._apply_layer(self.layer_n, x_latent, x, pad_mask, kv,
                                                 deterministic, fold_in(dropout_key, a))
            if self.reuse_kv:
                kv = kv_out
        return x_latent


class PerceiverDecoder(nn.Module):
    """Generic Perceiver IO decoder: a learned output-query array
    cross-attends the latents, then the output adapter."""

    def __init__(self, output_adapter: nn.Module, latent_shape: Tuple[int, int],
                 num_cross_attention_heads: int = 4, dtype=torch.float32,
                 attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.output_adapter = output_adapter
        self.latent_shape = tuple(latent_shape)
        self.dtype = dtype
        output_shape = output_adapter.output_shape
        self.output = nn.Parameter(torch.empty(tuple(output_shape)))
        self.cross_attention_layer = CrossAttentionLayer(
            output_shape[-1], latent_shape[1], num_cross_attention_heads, dtype, attn_impl,
            dropout)

    def forward(self, x, positions: Optional[torch.Tensor] = None,
                return_features: bool = False, deterministic: bool = True,
                dropout_key: Optional[int] = None):
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
        x_output, _ = self.cross_attention_layer(x_output, x, deterministic=deterministic,
                                                 dropout_key=dropout_key)
        if return_features:
            return x_output
        return self.output_adapter(x_output)


class PerceiverIO(nn.Module):
    """encoder → decoder: the classifiers (a text or image input adapter, a
    ``ClassificationOutputAdapter``)."""

    def __init__(self, encoder: PerceiverEncoder, decoder: PerceiverDecoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, dropout_key: Optional[int] = None) -> torch.Tensor:
        """``deterministic=False`` drops out by the masks of ``dropout_key``:
        the encoder's from ``fold_in(dropout_key, 0)``, the decoder's from
        ``fold_in(dropout_key, 1)``."""
        return self.decode(self.encode(x, pad_mask, deterministic, dropout_key),
                           deterministic, dropout_key)

    def encode(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
               deterministic: bool = True, dropout_key: Optional[int] = None) -> torch.Tensor:
        """Encoder half: inputs → (B, N, C) latents."""
        return self.encoder(x, pad_mask, deterministic, fold_in(dropout_key, 0))

    def decode(self, x_latent: torch.Tensor, deterministic: bool = True,
               dropout_key: Optional[int] = None) -> torch.Tensor:
        """Decoder half over latents: the (B, classes) logits."""
        return self.decoder(x_latent, deterministic=deterministic,
                            dropout_key=fold_in(dropout_key, 1))


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
                return_features: bool = False, deterministic: bool = True,
                dropout_key: Optional[int] = None):
        """``(logits, labels)``; with ``return_features`` the decoder's
        (B, K, C) features in the logits' place (the fused head's input).
        ``deterministic=False`` drops out by the masks of ``dropout_key``
        (the encoder's from ``fold_in(dropout_key, 0)``, the decoder's from
        ``fold_in(dropout_key, 1)``).

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
        x_latent = self.encoder(x_masked, pad_mask, deterministic, fold_in(dropout_key, 0))
        decode_kwargs = {"return_features": True} if return_features else {}
        if not deterministic:
            decode_kwargs.update(deterministic=False, dropout_key=fold_in(dropout_key, 1))
        decode = (functools.partial(self.decoder, **decode_kwargs) if decode_kwargs
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


class PerceiverARLayer(nn.Module):
    """One causal encoder layer of the Perceiver-AR decode path: causal
    cross-attention (latent window ← input prefix) + causal latent
    self-attention block, with :class:`PerceiverLayer`'s submodule names.
    Three call modes share the weights, as the JAX layer's:

    - dense (``causal_offset``): the window query at absolute position
      offset + i sees input keys ``<= offset + i``; the block is square
      causal. Returns ``(x_latent, kv, self_kvs)``: the cross (k, v) and
      each self-attention sub-layer's (k, v), the tensors a decode caches.
    - ``kv_only``: the cross (k, v) of ``x_input`` alone, for the ring.
    - incremental (``latent_cache``): ``x_latent`` is the (B, 1, C) new
      latent row; the cross-attention runs over the caller's input rings
      (``kv`` under ``pad_mask``), the block writes and attends its rings at
      ``latent_index`` under ``latent_pad``; returns ``(x_latent, rings)``.
    """

    def __init__(self, num_latent_channels: int, num_input_channels: int,
                 num_cross_attention_heads: int, num_self_attention_heads: int,
                 num_self_attention_layers_per_block: int, dtype=torch.float32,
                 attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.cross_attention_layer = CrossAttentionLayer(
            num_latent_channels, num_input_channels, num_cross_attention_heads, dtype,
            attn_impl, dropout)
        self.self_attention_block = SelfAttentionBlock(
            num_self_attention_layers_per_block, num_latent_channels,
            num_self_attention_heads, dtype, attn_impl, dropout)

    def forward(self, x_latent, x_input, pad_mask=None, kv=None, causal_offset=None,
                kv_only=False, latent_cache=None, latent_index=None, latent_pad=None,
                deterministic=True, dropout_key=None, return_cache=False):
        """``return_cache``: the self-attention (k, v) are projected on
        their own, contiguous, as a prefill keeps them (the JAX layer's
        ``return_cache``); the dense training forward takes q, k and v from
        one stacked product."""
        if kv_only:
            return self.cross_attention_layer(x_latent, x_input, kv_only=True)
        x_latent, kv_out = self.cross_attention_layer(
            x_latent, x_input, pad_mask, kv, causal_offset, deterministic=deterministic,
            dropout_key=fold_in(dropout_key, 0))
        block = self.self_attention_block
        if latent_cache is not None:
            return block(x_latent, cache=latent_cache, cache_index=latent_index,
                         cache_pad=latent_pad)
        x_latent, self_kvs = block(x_latent, causal_offset=0, deterministic=deterministic,
                                   dropout_key=fold_in(dropout_key, 1),
                                   return_kv=return_cache)
        return x_latent, kv_out, self_kvs


class PerceiverARLM(nn.Module):
    """The Perceiver-AR causal language model: a token prefix cross-attends
    into a causal latent window over its LAST ``num_latents`` positions, a
    causal latent self-attention stack refines it, and learned
    per-position output queries decode it diagonally-causally (query i
    sees latents ``<= i``) into next-token logits.

    The flax layout, so a JAX ``PerceiverARLM`` tree loads by path:
    ``input_adapter`` (token embedding + learned positions), ``latent`` (ONE
    learned (1, C) row added to every window query), ``layer_1`` /
    ``layer_n`` (layer 1 unique, layers 2..num_layers one shared weight set
    whose cross (k, v) of the input is reused across applications),
    ``output`` + ``cross_attention_layer`` + ``output_adapter`` (the
    decode).

    Window rule: a length-L input with ``latent_offset`` o (default
    ``L - min(num_latents, L)``) computes the n = L - o latents of positions
    ``[o, L)``; logits row i predicts token o + i + 1.

    Incremental decode: :meth:`prefill` runs the dense forward once over the
    (right-padded) prefix and keeps every tensor it attends over as the
    cache rings, allocated there once; :meth:`step` writes the new token's
    rows into them IN PLACE and recomputes only its latent row, so its
    logits are the dense forward's to float rounding. The cache's ``len``
    (the next position) is a (B,) long tensor of per-row positions on the
    device (rows of one stream or of an arena's slots,
    ``inference/batching.py``), which a step advances there: it never reads
    the device to find where it writes. Run both
    under ``torch.inference_mode`` or ``torch.no_grad``: :meth:`step` writes
    the rings in place. The dense :meth:`forward` trains: its causal
    attention has a backward (``training.steps.make_ar_steps``).
    """

    def __init__(self, input_adapter: nn.Module, output_adapter: nn.Module,
                 num_latents: int, num_layers: int, num_cross_attention_heads: int = 4,
                 num_self_attention_heads: int = 4,
                 num_self_attention_layers_per_block: int = 2, dtype=torch.float32,
                 attn_impl: str = "pallas", dropout: float = 0.0):
        super().__init__()
        self.input_adapter = input_adapter
        self.output_adapter = output_adapter
        self.num_latents = num_latents
        self.num_layers = num_layers
        self.dtype = dtype
        c = input_adapter.num_input_channels
        self.latent = nn.Parameter(torch.empty(1, c))
        layer = dict(
            num_latent_channels=c, num_input_channels=c,
            num_cross_attention_heads=num_cross_attention_heads,
            num_self_attention_heads=num_self_attention_heads,
            num_self_attention_layers_per_block=num_self_attention_layers_per_block,
            dtype=dtype, attn_impl=attn_impl, dropout=dropout)
        self.layer_1 = PerceiverARLayer(**layer)
        if num_layers > 1:
            self.layer_n = PerceiverARLayer(**layer)
        output_shape = tuple(output_adapter.output_shape)
        self.output = nn.Parameter(torch.empty(output_shape))
        self.cross_attention_layer = CrossAttentionLayer(
            output_shape[-1], c, num_cross_attention_heads, dtype, attn_impl, dropout)
        # later[s, j]: latent ring slot j lies after slot s (not written yet),
        # so a step's latent pad mask is a view, made on no device
        slots = torch.arange(num_latents)
        self.register_buffer("later", slots[None, :] > slots[:, None], persistent=False)

    def _offset(self, l: int, latent_offset: Optional[int]) -> int:
        o = l - min(self.num_latents, l) if latent_offset is None else latent_offset
        if not 0 <= o < l:
            raise ValueError(f"latent_offset {o} outside [0, {l})")
        if l - o > self.num_latents:
            raise ValueError(f"latent window {l - o} exceeds num_latents {self.num_latents}")
        return o

    def _applications(self):
        """(weight set name, layer) per encoder application, in order."""
        return [("layer_1", self.layer_1)] + [("layer_n", self.layer_n)] * (
            self.num_layers - 1)

    def _encode_window(self, h, pad_mask, o: int, return_cache: bool = False,
                       deterministic: bool = True, dropout_key: Optional[int] = None):
        """The dense trunk: embedded input → causal latent window, with the
        cross (k, v) per weight set and the self-attention (k, v) per
        application (the prefill's rings with ``return_cache``). Application
        a draws its dropout from ``fold_in(dropout_key, a)``."""
        x = h[:, o:] + self.latent.to(self.dtype)
        cross, caches = {}, []
        for a, (name, layer) in enumerate(self._applications()):
            x, cross[name], self_kvs = layer(
                x, h, pad_mask, cross.get(name), causal_offset=o,
                deterministic=deterministic, dropout_key=fold_in(dropout_key, a),
                return_cache=return_cache)
            caches.append(self_kvs)
        return x, cross, caches

    def _decode_window(self, x, o: int, n: int, deterministic: bool = True,
                       dropout_key: Optional[int] = None):
        """Diagonally-causal decode of the window: ``(logits, final (k, v))``."""
        queries = self.output[o: o + n].to(self.dtype).expand(
            x.shape[0], n, self.output.shape[-1])
        out, final_kv = self.cross_attention_layer(queries, x, causal_offset=0,
                                                   deterministic=deterministic,
                                                   dropout_key=dropout_key)
        return self.output_adapter(out), final_kv

    def forward(self, token_ids: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                latent_offset: Optional[int] = None, deterministic: bool = True,
                dropout_key: Optional[int] = None) -> torch.Tensor:
        """Dense causal forward, the incremental path's oracle: (B, L) token
        ids → (B, L - offset, vocab) logits, row i predicting token
        offset + i + 1. ``deterministic=False`` drops out by the masks of
        ``dropout_key`` (encoder application a from ``fold_in(dropout_key,
        a)``, the decode from ``fold_in(dropout_key, num_layers)``)."""
        h = self.input_adapter(token_ids)
        l = h.shape[1]
        o = self._offset(l, latent_offset)
        x, _, _ = self._encode_window(h, pad_mask, o, False, deterministic, dropout_key)
        return self._decode_window(x, o, l - o, deterministic,
                                   fold_in(dropout_key, self.num_layers))[0]

    def prefill(self, token_ids: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                length=None, latent_offset: Optional[int] = None):
        """Dense forward over the (possibly right-padded) prefix and the
        cache: ``(logits, cache)``. ``length`` is the real token count: a
        host int for every row, or a (B,) long tensor, each row's own (an
        admission wave of prompts of several lengths, the JAX arena's
        ``prefill_rows_fn``); slots at positions ``>= length`` are masked
        and overwritten as decoding goes on. The cache, as the JAX model's:

        ``len``    (B,) long, ``length``: the position each row's next
                   token takes,
        ``cross``  per cross weight set, (k, v) rings (B, W, E),
        ``pad``    (B, W) bool, True where a ring slot is invalid (beyond
                   ``len``, or a prefix pad token),
        ``latent`` per encoder application, per self-attention sub-layer,
                   (k, v) rings (B, N, E),
        ``final``  (k, v) ring (B, N, E) of the decoded latent states.

        The rings are the dense forward's own k/v tensors: nothing is
        copied, and :meth:`step` writes them in place."""
        b, l = token_ids.shape
        h = self.input_adapter(token_ids)
        o = self._offset(l, latent_offset)
        if length is None:
            length = l
        x, cross, latent = self._encode_window(h, pad_mask, o, return_cache=True)
        logits, final_kv = self._decode_window(x, o, l - o)
        length = torch.as_tensor(length, dtype=torch.long).to(token_ids.device).expand(b).clone()
        invalid = torch.arange(l, device=token_ids.device)[None, :] >= length[:, None]
        if pad_mask is not None:
            invalid = invalid | pad_mask.to(torch.bool)
        cache = {"len": length, "cross": cross,
                 "pad": invalid.expand(b, l).clone(), "latent": latent,
                 "final": final_kv}
        return logits, cache

    def step(self, cache, token: torch.Tensor, active: Optional[torch.Tensor] = None):
        """One incremental decode step: row b's ``token`` (B, 1) takes its
        position ``cache['len'][b]``; its rows are written into the rings in
        place, ONLY its latent row is recomputed against them, and
        ``(next_logits (B, vocab), cache)`` returns (the same dict, ``len``
        advanced): the logits for position ``len + 1``.

        ``active`` ((B,) bool, default every row) names the rows that take
        the step: an inactive row's rings, pad mask and ``len`` stay bit for
        bit (its logits are computed and mean nothing). Positions outside
        the cache's window are clamped into it, as the JAX
        ``dynamic_update_slice`` clamps them, so a row that holds no stream
        (an arena's zero slot, ``len`` 0) reads finite values: the step
        keeps static shapes and reads nothing back from the device."""
        k1 = cache["cross"]["layer_1"][0]
        b, w, _ = k1.shape
        n_cap = cache["final"][0].shape[1]
        p = cache["len"].clamp(0, w - 1)             # the new token's positions
        s = (p - (w - n_cap)).clamp(0, n_cap - 1)    # their latent window slots
        # one stream's step writes with no row index (write_ring)
        rows = None if b == 1 and active is None else torch.arange(b, device=p.device)
        at_p, at_s = RingIndex(p, rows, active), RingIndex(s, rows, active)
        positions = p[:, None]
        lat_pad = self.later.index_select(0, s)[:, :n_cap]
        query = self.output.index_select(0, p)[:, None].to(self.dtype)
        h = self.input_adapter(token, positions=positions)

        # this token's cross k/v per weight set, into slot p of its ring
        layers = dict(self._applications())
        for name, layer in layers.items():
            k_new, v_new = layer(h, h, kv_only=True)
            k_ring, v_ring = cache["cross"][name]
            write_ring(k_ring, at_p, k_new)
            write_ring(v_ring, at_p, v_new)
        # the new slot becomes live; the slots past it stay masked
        if rows is None:
            cache["pad"].index_fill_(1, p, False)
        else:
            cache["pad"][rows, p] = False if active is None else cache["pad"][rows, p] & ~active

        x = h + self.latent.to(self.dtype)
        for a, (name, layer) in enumerate(self._applications()):
            x, _ = layer(x, h, cache["pad"], cache["cross"][name],
                         latent_cache=cache["latent"][a], latent_index=at_s,
                         latent_pad=lat_pad)

        # decode: the new final-latent k/v into its ring, query = output[p]
        fk, fv = self.cross_attention_layer(x, x, kv_only=True)
        final = cache["final"]
        write_ring(final[0], at_s, fk)
        write_ring(final[1], at_s, fv)
        dec, _ = self.cross_attention_layer(query, x, lat_pad, final)
        cache["len"] += 1 if active is None else active
        return self.output_adapter(dec)[:, 0, :], cache


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight of ``model`` from ``generator`` with the JAX twin's
    initializers (the learned latent/output arrays N(0, 0.02) clamped to
    ±2; adapters and projections by their own ``reset_parameters``: the
    multimodal padding and modality vectors flax's ``truncated_normal(0.02)``,
    within ±0.04)."""
    for module in model.modules():
        if isinstance(module, (Linear, TextInputAdapter, MultimodalInputAdapter)):
            module.reset_parameters(generator)
        elif isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, PerceiverEncoder):
            module.latent.normal_(0.0, 0.02, generator=generator).clamp_(-2.0, 2.0)
        elif isinstance(module, PerceiverDecoder):
            module.output.normal_(0.0, 0.02, generator=generator).clamp_(-2.0, 2.0)
        elif isinstance(module, PerceiverARLM):
            for array in (module.latent, module.output):
                array.normal_(0.0, 0.02, generator=generator).clamp_(-2.0, 2.0)
    return model
