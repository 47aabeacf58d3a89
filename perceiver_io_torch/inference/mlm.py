"""Fill-mask inference (the port's ``perceiver_io_tpu/inference/mlm.py``):
tokenize texts holding the ``[MASK]`` literal, decode only the mask
positions, and return the top-k tokens per mask."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from perceiver_io_torch.data.tokenizer import MASK_TOKEN, PAD_TOKEN, WordPieceTokenizer
from perceiver_io_torch.inference.predictor import Predictor, bucket_size


def masked_token_ids(tokenizer: WordPieceTokenizer, text: str) -> List[int]:
    """Token ids for one raw string containing the ``[MASK]`` literal,
    splicing in the mask token id. Natural length — no padding."""
    mask_id = tokenizer.token_to_id(MASK_TOKEN)
    ids: List[int] = []
    for i, piece in enumerate(text.split(MASK_TOKEN)):
        if i > 0:
            ids.append(mask_id)
        if piece.strip():
            ids.extend(tokenizer.encode_ids(piece))
    return ids


def pad_token_rows(rows: Sequence[Sequence[int]], width: int,
                   pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of ids → ``(token_ids, pad_mask)`` at fixed ``width`` (longer
    rows truncate)."""
    token_ids = np.full((len(rows), width), pad_id, dtype=np.int32)
    for i, ids in enumerate(rows):
        token_ids[i, : min(len(ids), width)] = ids[:width]
    return token_ids, token_ids == pad_id


def encode_masked_texts(tokenizer: WordPieceTokenizer, texts: Sequence[str],
                        max_seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Encode raw strings containing ``[MASK]``: ``(token_ids, pad_mask)``
    at width ``max_seq_len``."""
    pad_id = tokenizer.token_to_id(PAD_TOKEN)
    rows = [masked_token_ids(tokenizer, text) for text in texts]
    return pad_token_rows(rows, max_seq_len, pad_id)


def top_k_tokens(tokenizer: WordPieceTokenizer, logits: np.ndarray,
                 k: int) -> List[List[str]]:
    """Per row of (K, vocab) ``logits``, the ``k`` highest-scoring tokens."""
    return [[tokenizer.id_to_token(int(t)) for t in np.argsort(-row)[:k]]
            for row in np.asarray(logits, np.float32)]


class MLMPredictor:
    """Top-k fill-mask predictions from a ``PerceiverMLM`` + tokenizer; the
    model must already hold its weights on ``device``."""

    def __init__(self, model, tokenizer: WordPieceTokenizer, max_seq_len: int,
                 max_batch: int = 64, device=None):
        self.model = model
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.mask_id = tokenizer.token_to_id(MASK_TOKEN)

        def gathered(token_ids, pad_mask, positions):
            return model(token_ids, pad_mask, positions=positions)[0]

        self._gathered = Predictor(gathered, max_batch=max_batch, device=device)

    def fill_masks(self, texts: Sequence[str], k: int = 5) -> List[List[List[str]]]:
        """Per text, per ``[MASK]`` (in order), the top-k tokens — decoding
        only the mask positions (their count bucketed to a power of two)."""
        token_ids, pad_mask = encode_masked_texts(self.tokenizer, texts, self.max_seq_len)
        mask_pos = [np.nonzero(row == self.mask_id)[0] for row in token_ids]
        n_max = max((len(p) for p in mask_pos), default=0)
        if n_max == 0:
            return [[] for _ in texts]
        cap = bucket_size(n_max, self.max_seq_len)
        # filler slots repeat position 0; their logits are never read
        positions = np.zeros((len(texts), cap), np.int32)
        for row, pos in enumerate(mask_pos):
            positions[row, : len(pos)] = pos
        logits = self._gathered(token_ids, pad_mask, positions)
        return [top_k_tokens(self.tokenizer, logits[row, : len(pos)], k)
                for row, pos in enumerate(mask_pos)]
