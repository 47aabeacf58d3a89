"""IMDB text data (the port's subset of ``perceiver_io_tpu/data/imdb.py``).

- ``synthetic_reviews``: the offline corpus, a deterministic sentiment-
  labelled word soup, the same texts from the same seed;
- ``load_split``: the ``<root>/IMDB/aclImdb/{split}/{neg,pos}/*.txt`` tree,
  read where it exists (there is no download);
- ``Collator``: pad/truncate to ``max_seq_len``, or to the smallest of
  ``bucket_widths`` holding the batch; ids, pad mask, label;
- ``IMDBDataModule``: trains and caches the WordPiece tokenizer under
  ``root`` on first use and serves the train / validation loaders, with a
  ``synthetic`` mode and width buckets (``bucket_widths``, with
  ``length_sort_window`` for the train loader). Multi-host sharding is not
  part of the port.
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from perceiver_io_torch.data.pipeline import DataLoader, resolve_bucket_width
from perceiver_io_torch.data.tokenizer import (
    PAD_TOKEN,
    WordPieceTokenizer,
    create_tokenizer,
    load_tokenizer,
    save_tokenizer,
    train_tokenizer,
)

_POSITIVE_WORDS = (
    "awesome brilliant captivating delightful excellent fantastic great "
    "inspiring lovely masterful moving outstanding perfect powerful stunning "
    "superb touching wonderful gripping charming"
).split()
_NEGATIVE_WORDS = (
    "awful boring clumsy disappointing dreadful horrible lazy mediocre "
    "miserable painful pointless predictable shallow sloppy terrible tedious "
    "unwatchable weak wooden forgettable"
).split()
_NEUTRAL_WORDS = (
    "movie film story plot actor actress director scene script camera music "
    "ending character dialogue performance production audience screen watch "
    "time people year minute way thing life world night day man woman"
).split()


def synthetic_reviews(
    n: int, seed: int = 0, min_words: int = 20, max_words: int = 120
) -> Tuple[List[str], List[int]]:
    """Deterministic sentiment-labelled word-soup corpus (zero-egress stand-in
    for the IMDB download)."""
    texts, labels = _synthetic_corpus(n, seed, min_words, max_words)
    return list(texts), list(labels)


@functools.lru_cache(maxsize=8)
def _synthetic_corpus(n: int, seed: int, min_words: int,
                      max_words: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The corpus of :func:`synthetic_reviews`, made once for each argument
    set (a data module reads its train split twice). A word is drawn as
    ``rng.choice(words)`` draws it, by ``rng.integers(0, len(words))``,
    without the per-call conversion of the list to an array."""
    rng = np.random.default_rng(seed)
    integers, random = rng.integers, rng.random
    texts, labels = [], []
    for _ in range(n):
        label = int(integers(0, 2))
        length = int(integers(min_words, max_words))
        sentiment = _POSITIVE_WORDS if label else _NEGATIVE_WORDS
        words = [
            sentiment[integers(0, len(sentiment))] if random() < 0.3
            else _NEUTRAL_WORDS[integers(0, len(_NEUTRAL_WORDS))]
            for _ in range(length)
        ]
        texts.append(" ".join(words))
        labels.append(label)
    return tuple(texts), tuple(labels)


def load_split(root: str, split: str) -> Tuple[List[str], List[int]]:
    """Read the aclImdb directory tree under ``<root>/IMDB``."""
    if split not in ("train", "test"):
        raise ValueError(f"invalid split: {split}")
    texts: List[str] = []
    labels: List[int] = []
    for label, name in enumerate(("neg", "pos")):
        pattern = os.path.join(root, "IMDB", "aclImdb", split, name, "*.txt")
        for path in sorted(glob.glob(pattern)):
            with open(path, encoding="utf-8") as f:
                texts.append(f.read())
            labels.append(label)
    if not texts:
        raise FileNotFoundError(
            f"no IMDB data under {os.path.join(root, 'IMDB', 'aclImdb', split)} — "
            "place the aclImdb tree there, or use synthetic=True")
    return texts, labels


class IMDBDataset:
    def __init__(self, texts: Sequence[str], labels: Sequence[int]):
        if len(texts) != len(labels):
            raise ValueError(f"{len(texts)} texts but {len(labels)} labels")
        self.texts = list(texts)
        self.labels = list(labels)

    def __len__(self) -> int:
        return len(self.texts)

    def __getitem__(self, i: int) -> Tuple[int, str]:
        return self.labels[i], self.texts[i]


class Collator:
    """Pad/truncate to ``max_seq_len``: ``{'label', 'token_ids', 'pad_mask'}``
    numpy arrays, ``pad_mask = token_ids == pad_id``.

    ``bucket_widths``: each batch is padded to the smallest of these widths
    that holds its longest (truncated) sequence instead of to
    ``max_seq_len``, which is always the last bucket."""

    def __init__(self, tokenizer: WordPieceTokenizer, max_seq_len: int,
                 bucket_widths: Optional[Sequence[int]] = None):
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.pad_id = tokenizer.token_to_id(PAD_TOKEN)
        self.bucket_widths: Optional[List[int]] = None
        if bucket_widths:
            widths = sorted({int(w) for w in bucket_widths})
            if widths[0] <= 0 or widths[-1] > max_seq_len:
                raise ValueError(f"bucket_widths must lie in [1, max_seq_len={max_seq_len}], "
                                 f"got {widths}")
            if widths[-1] != max_seq_len:
                widths.append(max_seq_len)
            self.bucket_widths = widths
        tokenizer.enable_truncation(max_seq_len)

    def collate(self, batch: Sequence[Tuple[int, str]],
                width: Optional[int] = None) -> Dict[str, np.ndarray]:
        """``width``: the bucket width the loader decided for the batch; None
        decides it here from the encoded lengths (``max_seq_len`` without
        buckets)."""
        labels = np.asarray([y for y, _ in batch], dtype=np.int32)
        encoded = self.tokenizer.encode_batch([x for _, x in batch])
        if width is None:
            width = self.max_seq_len
            if self.bucket_widths is not None:
                longest = max((len(e) for e in encoded), default=1)
                width = resolve_bucket_width(longest, self.bucket_widths)
        ids = np.full((len(batch), width), self.pad_id, dtype=np.int32)
        for i, e in enumerate(encoded):
            ids[i, : min(len(e), width)] = e[:width]
        return {"label": labels, "token_ids": ids, "pad_mask": ids == self.pad_id}


class IMDBDataModule:
    """``prepare_data`` / ``setup`` / loaders, as the JAX package's module:
    the same tokenizer file name under ``root``, the same synthetic splits
    (``synthetic_size`` train texts from ``seed``, an eighth of that, at
    least 64, for validation from ``seed + 1``). With ``bucket_widths`` the
    train loader sorts by token length within windows of
    ``length_sort_window`` batches and both loaders collate each batch at its
    bucket width, decided from the split's token lengths."""

    def __init__(self, root: str = ".cache", max_seq_len: int = 512,
                 vocab_size: int = 10003, batch_size: int = 64, synthetic: bool = False,
                 synthetic_size: int = 2048, seed: int = 0,
                 bucket_widths: Optional[Sequence[int]] = None,
                 length_sort_window: int = 8):
        self.root = root
        self.max_seq_len = max_seq_len
        self.vocab_size = vocab_size
        self.batch_size = batch_size
        self.synthetic = synthetic
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.bucket_widths = bucket_widths
        self.length_sort_window = length_sort_window
        self._train_token_lengths: Optional[np.ndarray] = None
        self._valid_token_lengths: Optional[np.ndarray] = None
        suffix = "synthetic-" if synthetic else ""
        self.tokenizer_path = os.path.join(root, f"imdb-{suffix}tokenizer-{vocab_size}.json")
        self.tokenizer: Optional[WordPieceTokenizer] = None
        self.collator: Optional[Collator] = None
        self.ds_train: Optional[IMDBDataset] = None
        self.ds_valid: Optional[IMDBDataset] = None

    def _train_texts(self) -> Tuple[List[str], List[int]]:
        if self.synthetic:
            return synthetic_reviews(self.synthetic_size, seed=self.seed)
        return load_split(self.root, "train")

    def _valid_texts(self) -> Tuple[List[str], List[int]]:
        if self.synthetic:
            return synthetic_reviews(max(self.synthetic_size // 8, 64), seed=self.seed + 1)
        return load_split(self.root, "test")

    def prepare_data(self) -> None:
        """Train and cache the tokenizer on the train texts, once."""
        if not os.path.exists(self.tokenizer_path):
            os.makedirs(self.root, exist_ok=True)
            tokenizer = create_tokenizer(("<br />", " "))
            train_tokenizer(tokenizer, self._train_texts()[0], vocab_size=self.vocab_size)
            save_tokenizer(tokenizer, self.tokenizer_path)

    def setup(self) -> None:
        self.tokenizer = load_tokenizer(self.tokenizer_path)
        self.collator = Collator(self.tokenizer, self.max_seq_len,
                                 bucket_widths=self.bucket_widths)
        self.ds_train = IMDBDataset(*self._train_texts())
        self.ds_valid = IMDBDataset(*self._valid_texts())
        if self.bucket_widths:
            # the token lengths of the train split: the sort key and the
            # loader's width oracle
            self._train_token_lengths = np.asarray(
                [len(e) for e in self.tokenizer.encode_batch(self.ds_train.texts)],
                dtype=np.int64)

    def _valid_lengths(self) -> np.ndarray:
        """The validation split's token lengths, computed on first use."""
        if self._valid_token_lengths is None:
            self._valid_token_lengths = np.asarray(
                [len(e) for e in self.tokenizer.encode_batch(self.ds_valid.texts)],
                dtype=np.int64)
        return self._valid_token_lengths

    def train_dataloader(self) -> DataLoader:
        buckets = {}
        if self.bucket_widths:
            buckets = dict(sort_key=self._train_token_lengths,
                           sort_window=self.length_sort_window,
                           group_widths=self.collator.bucket_widths)
        return DataLoader(self.ds_train, self.batch_size, self.collator.collate,
                          shuffle=True, seed=self.seed, **buckets)

    def val_dataloader(self) -> DataLoader:
        buckets = {}
        if self.bucket_widths:
            buckets = dict(sort_key=self._valid_lengths(),
                           group_widths=self.collator.bucket_widths)
        return DataLoader(self.ds_valid, self.batch_size, self.collator.collate,
                          shuffle=False, drop_last=False, **buckets)
