"""The offline review corpus (the port's copy of
``perceiver_io_tpu/data/imdb.py::synthetic_reviews``): a deterministic,
sentiment-labelled word soup, the same texts from the same seed."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

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
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for i in range(n):
        label = int(rng.integers(0, 2))
        length = int(rng.integers(min_words, max_words))
        sentiment = _POSITIVE_WORDS if label else _NEGATIVE_WORDS
        words = [
            str(rng.choice(sentiment)) if rng.random() < 0.3 else str(rng.choice(_NEUTRAL_WORDS))
            for _ in range(length)
        ]
        texts.append(" ".join(words))
        labels.append(label)
    return texts, labels
