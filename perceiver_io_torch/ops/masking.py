"""BERT-style MLM text masking, the causal attention mask and the
Perceiver-AR next-token labels (the port's copy of
``perceiver_io_tpu/ops/masking.py``: ``IGNORE_LABEL``, ``causal_mask``,
``combine_attention_masks``, ``shift_ar_labels``, ``apply_text_masking``,
``TextMasking``).

The same corruption scheme, nested draws included:

- special positions = ``(x == unk_id) | pad_mask``; only the others are
  candidates,
- ``selected``   = U < mask_p ∧ candidate                    (15% default),
- ``selected_1`` = selected ∧ U < 0.9                          (become [MASK]),
- ``selected_2`` = selected_1 ∧ U < 1/9                        (then a random
  token in ``[num_special_tokens, vocab_size)``: the 80/10/10 split),
- labels are ``IGNORE_LABEL`` everywhere except the selected positions.

The draws come from an explicit ``torch.Generator`` on the batch's device,
so masking is deterministic in (generator state, batch) and never touches
the global RNG. Torch's generators draw other bits than JAX's threefry: the
two packages agree in distribution, not bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

IGNORE_LABEL = -100


def causal_mask(num_queries: int, num_keys: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """(T, S) bool causal mask, True = masked out: query row ``i`` (absolute
    position ``offset + i``) may attend key positions ``<= offset + i``.
    offset 0 is the square causal self-attention; L - N the Perceiver-AR
    latent window's cross-attention. The attention kernel takes the same
    rule as ``causal_offset`` and applies it by index instead of reading
    this mask; the plain version and the tests use it."""
    rows = torch.arange(num_queries, device=device)[:, None]
    cols = torch.arange(num_keys, device=device)[None, :]
    return cols > rows + offset


def combine_attention_masks(pad_mask: Optional[torch.Tensor],
                            attn_mask: Optional[torch.Tensor],
                            num_queries: Optional[int] = None) -> Optional[torch.Tensor]:
    """The effective True = masked-out mask the attention paths apply: the
    (B, S) ``pad_mask`` OR'd with a (T, S) or (B, T, S) structural
    ``attn_mask``, as (B, T, S) (a 2-D ``attn_mask`` alone gives (1, T, S),
    a pad mask alone (B, 1, S), or (B, T, S) given ``num_queries``); None
    when neither masks anything."""
    if pad_mask is None and attn_mask is None:
        return None
    if attn_mask is not None and attn_mask.ndim == 2:
        attn_mask = attn_mask[None]
    if pad_mask is None:
        return attn_mask
    pad = pad_mask.to(torch.bool)[:, None, :]
    if num_queries is not None:
        pad = pad.expand(pad_mask.shape[0], num_queries, pad_mask.shape[-1])
    if attn_mask is None:
        return pad
    return pad | attn_mask


def shift_ar_labels(token_ids: torch.Tensor, pad_mask: Optional[torch.Tensor],
                    latent_offset: int = 0) -> torch.Tensor:
    """Next-token labels for the causal AR window: the query at absolute
    position ``latent_offset + i`` predicts ``token_ids[:, latent_offset + i
    + 1]``. Returns (B, L - latent_offset) int64 labels with
    :data:`IGNORE_LABEL` at the final position (it has no successor) and
    wherever the target token is padding, so ``cross_entropy_with_ignore``
    applies unchanged. The successors come from a roll, as the JAX
    function's: the wrapped-around element lands on the ignored last slot."""
    n = token_ids.shape[1] - latent_offset
    labels = torch.roll(token_ids, -1, dims=1)[:, latent_offset:].long()
    invalid = torch.arange(n, device=token_ids.device)[None, :] == n - 1
    if pad_mask is not None:
        pad = pad_mask.to(device=token_ids.device, dtype=torch.bool)
        invalid = invalid | torch.roll(pad, -1, dims=1)[:, latent_offset:]
    return labels.masked_fill(invalid, IGNORE_LABEL)


def apply_text_masking(
    generator: torch.Generator,
    x: torch.Tensor,
    pad_mask: Optional[torch.Tensor],
    *,
    vocab_size: int,
    unk_token_id: int,
    mask_token_id: int,
    num_special_tokens: int,
    mask_p: float = 0.15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corrupt token ids ``x`` (B, L) for MLM; returns ``(x_masked, labels)``,
    labels int64 with ``IGNORE_LABEL`` off the selection. ``pad_mask`` is
    True at padding positions."""
    shape, device = x.shape, x.device

    def uniform():
        return torch.rand(shape, generator=generator, device=device)

    is_special = x == unk_token_id
    if pad_mask is not None:
        is_special = is_special | pad_mask.to(device=device, dtype=torch.bool)
    is_selected = (uniform() < mask_p) & ~is_special
    is_selected_1 = is_selected & (uniform() < 0.9)
    is_selected_2 = is_selected_1 & (uniform() < 1.0 / 9.0)
    random_tokens = torch.randint(num_special_tokens, vocab_size, shape,
                                  generator=generator, device=device, dtype=x.dtype)
    x_masked = torch.where(is_selected_1, torch.full_like(x, mask_token_id), x)
    x_masked = torch.where(is_selected_2, random_tokens, x_masked)
    labels = torch.where(is_selected, x.long(), IGNORE_LABEL)
    return x_masked, labels


class TextMasking:
    """The masking configuration as a callable ``(generator, x, pad_mask) ->
    (x_masked, labels)``."""

    def __init__(self, vocab_size: int, unk_token_id: int, mask_token_id: int,
                 num_special_tokens: int, mask_p: float = 0.15):
        self.vocab_size = vocab_size
        self.unk_token_id = unk_token_id
        self.mask_token_id = mask_token_id
        self.num_special_tokens = num_special_tokens
        self.mask_p = mask_p

    def __call__(self, generator: torch.Generator, x: torch.Tensor,
                 pad_mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        return apply_text_masking(
            generator, x, pad_mask, vocab_size=self.vocab_size,
            unk_token_id=self.unk_token_id, mask_token_id=self.mask_token_id,
            num_special_tokens=self.num_special_tokens, mask_p=self.mask_p)
