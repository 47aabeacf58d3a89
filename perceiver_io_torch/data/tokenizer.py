"""WordPiece tokenizer (host-side): the port's copy of
``perceiver_io_tpu/data/tokenizer.py``, pure-Python path only.

It reads and writes the same files (the native
``perceiver_io_tpu.wordpiece.v1`` JSON schema and the HuggingFace
``tokenizers`` schema) and gives the same ids.

Behavioral contract (matching the reference surface):

- special tokens ``[PAD]``, ``[UNK]``, ``[MASK]`` at ids 0, 1, 2 (the masking
  op assumes specials occupy the first ids, reference ``model.py:284-289``),
- normalization: optional literal replacements (e.g. ``'<br />' → ' '``, as the
  IMDB module adds at ``data/imdb.py:124``), then NFD → lowercase → strip
  accents (reference ``tokenizer.py:33``),
- pre-tokenization: contiguous word characters or contiguous
  non-word/non-space punctuation (the ``Whitespace`` pre-tokenizer's
  ``\\w+|[^\\w\\s]+`` rule),
- WordPiece: greedy longest-match-first with ``##`` continuation prefix,
  whole-word ``[UNK]`` fallback, likelihood-scored pair merges in training
  (score = freq(ab) / freq(a)·freq(b)),
- decoding joins tokens and strips ``##`` continuations.
"""

from __future__ import annotations

import json
import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
MASK_TOKEN = "[MASK]"

SPECIAL_TOKENS = [PAD_TOKEN, UNK_TOKEN, MASK_TOKEN]

_PRETOKENIZE_RE = re.compile(r"\w+|[^\w\s]+")

CONTINUATION_PREFIX = "##"
MAX_CHARS_PER_WORD = 100


def normalize(text: str, replacements: Sequence[Tuple[str, str]] = ()) -> str:
    """Literal replacements, then NFD → lowercase → strip combining marks."""
    for old, new in replacements:
        text = text.replace(old, new)
    text = unicodedata.normalize("NFD", text)
    text = text.lower()
    return "".join(c for c in text if unicodedata.category(c) != "Mn")


def pre_tokenize(text: str) -> List[str]:
    """Split normalized text into word / punctuation chunks."""
    return _PRETOKENIZE_RE.findall(text)


class WordPieceTokenizer:
    """Trainable WordPiece tokenizer with the reference pipeline's surface
    (create/train/save/load/encode/decode, reference ``tokenizer.py:18-36``)."""

    def __init__(
        self,
        vocab: Optional[Dict[str, int]] = None,
        replacements: Sequence[Tuple[str, str]] = (),
    ):
        self.vocab: Dict[str, int] = dict(vocab) if vocab else {}
        self.replacements: List[Tuple[str, str]] = [tuple(r) for r in replacements]
        self._ids_to_tokens: Dict[int, str] = {}
        self._word_cache: Dict[str, List[int]] = {}
        self._truncation: Optional[int] = None
        self._padding: bool = False
        if self.vocab:
            self._rebuild()

    # -- vocab bookkeeping -------------------------------------------------

    def _rebuild(self):
        self._ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self._word_cache.clear()

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token(self, idx: int) -> Optional[str]:
        return self._ids_to_tokens.get(idx)

    # -- reference-surface config (Collator uses these, imdb.py:55-57) ----

    def enable_truncation(self, max_length: int):
        self._truncation = max_length

    def enable_padding(self):
        self._padding = True

    # -- training ----------------------------------------------------------

    def train_from_iterator(self, data: Iterable[str], vocab_size: int):
        """Likelihood-scored WordPiece training (the algorithm behind the HF
        WordPieceTrainer the reference calls at ``tokenizer.py:26-28``).

        Incremental: symbol/pair frequencies and a pair→words index are
        maintained across merges (only words containing the merged pair are
        touched), with a lazily-revalidated max-heap over pair scores — a
        10k-vocab training over a real corpus runs in minutes, not hours.
        """
        import heapq

        word_freqs: Dict[str, int] = {}
        for text in data:
            for w in pre_tokenize(normalize(text, self.replacements)):
                if len(w) <= MAX_CHARS_PER_WORD:
                    word_freqs[w] = word_freqs.get(w, 0) + 1

        # split each word into symbols: first char bare, rest ## prefixed
        splits: Dict[str, List[str]] = {
            w: [w[0]] + [CONTINUATION_PREFIX + c for c in w[1:]] for w in word_freqs
        }

        vocab: Dict[str, int] = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
        alphabet = sorted({s for symbols in splits.values() for s in symbols})
        for sym in alphabet:
            if sym not in vocab and len(vocab) < vocab_size:
                vocab[sym] = len(vocab)

        sym_freq: Dict[str, int] = {}
        pair_freq: Dict[Tuple[str, str], int] = {}
        pair_words: Dict[Tuple[str, str], set] = {}
        for w, freq in word_freqs.items():
            symbols = splits[w]
            for s in symbols:
                sym_freq[s] = sym_freq.get(s, 0) + freq
            for p in zip(symbols, symbols[1:]):
                pair_freq[p] = pair_freq.get(p, 0) + freq
                pair_words.setdefault(p, set()).add(w)

        def score(p: Tuple[str, str]) -> float:
            f = pair_freq.get(p, 0)
            if f <= 0:
                return 0.0
            return f / (sym_freq[p[0]] * sym_freq[p[1]])

        # max-heap with lazy revalidation: entries carry the score at push
        # time; on pop, a stale score is recomputed and re-pushed.
        heap = [(-score(p), p) for p in pair_freq]
        heapq.heapify(heap)

        def add_word(w: str, freq: int):
            symbols = splits[w]
            for s in symbols:
                sym_freq[s] = sym_freq.get(s, 0) + freq
            for p in zip(symbols, symbols[1:]):
                was = pair_freq.get(p, 0)
                pair_freq[p] = was + freq
                pair_words.setdefault(p, set()).add(w)
                if was == 0:
                    heapq.heappush(heap, (-score(p), p))

        def remove_word(w: str, freq: int):
            symbols = splits[w]
            for s in symbols:
                sym_freq[s] -= freq
            for p in zip(symbols, symbols[1:]):
                pair_freq[p] -= freq
                pair_words.get(p, set()).discard(w)

        while len(vocab) < vocab_size and heap:
            neg, best = heapq.heappop(heap)
            current = score(best)
            if current <= 0.0:
                continue
            if -neg != current:  # stale — revalidate
                heapq.heappush(heap, (-current, best))
                continue
            a, b = best
            stripped = b[len(CONTINUATION_PREFIX):] if b.startswith(CONTINUATION_PREFIX) else b
            merged = a + stripped
            if merged in vocab:
                pair_freq[best] = 0  # degenerate duplicate — retire the pair
                continue
            vocab[merged] = len(vocab)

            affected = list(pair_words.get(best, ()))
            for w in affected:
                freq = word_freqs[w]
                remove_word(w, freq)
                symbols = splits[w]
                out: List[str] = []
                i = 0
                while i < len(symbols):
                    if i + 1 < len(symbols) and symbols[i] == a and symbols[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(symbols[i])
                        i += 1
                splits[w] = out
                add_word(w, freq)
            pair_words.pop(best, None)
            pair_freq.pop(best, None)
            if merged not in sym_freq:
                sym_freq[merged] = 0

        self.vocab = vocab
        self._rebuild()

    # -- encoding ----------------------------------------------------------

    def _encode_word_py(self, word: str) -> List[int]:
        """Greedy longest-match-first; whole-word [UNK] on failure."""
        ids: List[int] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            found = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = CONTINUATION_PREFIX + piece
                idx = self.vocab.get(piece)
                if idx is not None:
                    found = idx
                    break
                end -= 1
            if found is None:
                return [self.vocab[UNK_TOKEN]]
            ids.append(found)
            start = end
        return ids

    def _encode_word(self, word: str) -> List[int]:
        if len(word) > MAX_CHARS_PER_WORD:
            return [self.vocab[UNK_TOKEN]]
        cached = self._word_cache.get(word)
        if cached is None:
            cached = self._encode_word_py(word)
            self._word_cache[word] = cached
        return cached

    def encode_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for w in pre_tokenize(normalize(text, self.replacements)):
            ids.extend(self._encode_word(w))
        if self._truncation is not None:
            ids = ids[: self._truncation]
        return ids

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Encode many texts; pads to the longest (or truncation length) with
        PAD id when padding is enabled — the Collator contract
        (reference ``data/imdb.py:52-64``)."""
        encoded = [self.encode_ids(t) for t in texts]
        if self._padding:
            width = max((len(e) for e in encoded), default=0)
            if self._truncation is not None:
                width = min(max(width, 0), self._truncation)
            pad_id = self.vocab[PAD_TOKEN]
            encoded = [e + [pad_id] * (width - len(e)) for e in encoded]
        return encoded

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        special_ids = {self.vocab.get(t) for t in SPECIAL_TOKENS}
        parts: List[str] = []
        for i in ids:
            if skip_special_tokens and i in special_ids:
                continue
            tok = self._ids_to_tokens.get(int(i))
            if tok is None:
                continue
            if tok.startswith(CONTINUATION_PREFIX) and parts:
                parts[-1] += tok[len(CONTINUATION_PREFIX):]
            else:
                parts.append(tok)
        return " ".join(parts)

    # -- persistence -------------------------------------------------------

    def save(self, path: str, format: str = "native"):
        """Write the tokenizer as JSON.

        ``format='native'`` is this framework's compact schema;
        ``format='hf'`` emits the HuggingFace ``tokenizers`` schema the
        reference caches (reference ``tokenizer.py:26-36``), loadable by the
        HF Rust library and by :meth:`from_file` alike.
        """
        if format == "native":
            payload = {
                "format": "perceiver_io_tpu.wordpiece.v1",
                "vocab": self.vocab,
                "replacements": self.replacements,
            }
        elif format == "hf":
            payload = self.to_hf_dict()
        else:
            raise ValueError(f"format must be 'native' or 'hf', got {format!r}")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, ensure_ascii=False)

    def to_hf_dict(self) -> dict:
        """This tokenizer in the HF ``tokenizers`` JSON schema (the pipeline
        the reference builds at ``tokenizer.py:26-36``: Replace* → NFD →
        Lowercase → StripAccents, Whitespace pre-tokenizer, WordPiece model +
        decoder, specials registered as added tokens)."""
        normalizers = [
            {"type": "Replace", "pattern": {"String": old}, "content": new}
            for old, new in self.replacements
        ] + [{"type": "NFD"}, {"type": "Lowercase"}, {"type": "StripAccents"}]
        return {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": [
                {
                    "id": self.vocab[t], "special": True, "content": t,
                    "single_word": False, "lstrip": False, "rstrip": False,
                    "normalized": False,
                }
                for t in SPECIAL_TOKENS if t in self.vocab
            ],
            "normalizer": {"type": "Sequence", "normalizers": normalizers},
            "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None,
            "decoder": {
                "type": "WordPiece",
                "prefix": CONTINUATION_PREFIX,
                "cleanup": True,
            },
            "model": {
                "type": "WordPiece",
                "unk_token": UNK_TOKEN,
                "continuing_subword_prefix": CONTINUATION_PREFIX,
                "max_input_chars_per_word": MAX_CHARS_PER_WORD,
                "vocab": self.vocab,
            },
        }

    @classmethod
    def from_hf_dict(cls, payload: dict) -> "WordPieceTokenizer":
        """Build from the HF ``tokenizers`` JSON schema — the format of the
        reference's cached artifact (``.cache/imdb-tokenizer-10003.json``).
        Token ids index embedding rows, so loading the exact reference vocab
        is what makes an imported reference checkpoint usable.

        Raises on pipeline components this implementation does not reproduce
        (anything beyond Replace/NFD/Lowercase/StripAccents normalizers, the
        Whitespace pre-tokenizer, and a WordPiece model) — silently dropping
        one would change token ids.
        """
        model = payload.get("model") or {}
        if model.get("type") != "WordPiece":
            raise ValueError(
                f"unsupported tokenizer model {model.get('type')!r} (need WordPiece)"
            )
        prefix = model.get("continuing_subword_prefix", CONTINUATION_PREFIX)
        if prefix != CONTINUATION_PREFIX:
            raise ValueError(f"unsupported continuation prefix {prefix!r}")
        unk = model.get("unk_token", UNK_TOKEN)
        if unk != UNK_TOKEN:
            raise ValueError(f"unsupported unk_token {unk!r} (need {UNK_TOKEN!r})")
        max_chars = model.get("max_input_chars_per_word", MAX_CHARS_PER_WORD)
        if max_chars != MAX_CHARS_PER_WORD:
            raise ValueError(
                f"unsupported max_input_chars_per_word {max_chars} "
                f"(need {MAX_CHARS_PER_WORD})"
            )
        if payload.get("post_processor") is not None:
            raise ValueError(
                "post_processor pipelines are not supported (they add tokens "
                "this implementation would not reproduce)"
            )

        # encode() unconditionally applies Replace* → NFD → Lowercase →
        # StripAccents then Whitespace splitting, so the file must declare
        # EXACTLY that pipeline (leading Replaces + those three, in order) —
        # anything else (normalizer: null, cased vocab, different order)
        # would produce different ids than the HF library
        normalizer = payload.get("normalizer")
        entries = []
        if normalizer is not None:
            entries = (
                normalizer.get("normalizers", [])
                if normalizer.get("type") == "Sequence" else [normalizer]
            )
        replacements = []
        tail = []
        for entry in entries:
            kind = entry.get("type")
            if kind == "Replace":
                if tail:
                    # normalize() applies replacements FIRST; a Replace after
                    # case-folding would see different text than here
                    raise ValueError(
                        "Replace normalizers after NFD/Lowercase/StripAccents "
                        "are not supported"
                    )
                pattern = entry.get("pattern", {})
                if "String" not in pattern:
                    raise ValueError("only literal-string Replace is supported")
                replacements.append((pattern["String"], entry.get("content", "")))
            elif kind in ("NFD", "Lowercase", "StripAccents"):
                tail.append(kind)
            else:
                raise ValueError(f"unsupported normalizer {kind!r}")
        if tail != ["NFD", "Lowercase", "StripAccents"]:
            raise ValueError(
                f"normalizer pipeline must be Replace* -> NFD -> Lowercase -> "
                f"StripAccents (this implementation always applies all "
                f"three), got {tail or None}"
            )

        pre = payload.get("pre_tokenizer")
        if pre is None or pre.get("type") != "Whitespace":
            raise ValueError(
                f"pre-tokenizer must be Whitespace, got "
                f"{pre.get('type') if pre else None!r}"
            )

        extra_added = [
            t.get("content") for t in payload.get("added_tokens") or []
            if t.get("content") not in SPECIAL_TOKENS
        ]
        if extra_added:
            raise ValueError(
                f"added tokens beyond {SPECIAL_TOKENS} are not supported: "
                f"{extra_added}"
            )

        vocab = model["vocab"]
        for i, tok in enumerate(SPECIAL_TOKENS):
            if vocab.get(tok) != i:
                # the masking op assumes specials occupy the first ids
                # (reference model.py:284-289) — a vocab violating that would
                # silently corrupt MLM training
                raise ValueError(
                    f"special token {tok!r} must have id {i}, got {vocab.get(tok)}"
                )
        return cls(vocab=vocab, replacements=replacements)

    @classmethod
    def from_file(cls, path: str) -> "WordPieceTokenizer":
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        if payload.get("format") == "perceiver_io_tpu.wordpiece.v1":
            return cls(
                vocab=payload["vocab"],
                replacements=payload.get("replacements", ()),
            )
        if isinstance(payload.get("model"), dict):  # HF tokenizers schema
            return cls.from_hf_dict(payload)
        raise ValueError(f"unrecognized tokenizer file format in {path}")


# -- module-level API mirroring the reference surface (tokenizer.py:18-36) --

def create_tokenizer(*replacements: Tuple[str, str]) -> WordPieceTokenizer:
    return WordPieceTokenizer(replacements=replacements)


def train_tokenizer(tokenizer: WordPieceTokenizer, data: Iterable[str], vocab_size: int):
    tokenizer.train_from_iterator(data, vocab_size)


def save_tokenizer(tokenizer: WordPieceTokenizer, path: str):
    tokenizer.save(path)


def load_tokenizer(path: str) -> WordPieceTokenizer:
    return WordPieceTokenizer.from_file(path)
