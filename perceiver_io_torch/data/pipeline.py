"""Sequence-width bucketing (the port's copy of
``perceiver_io_tpu/data/pipeline.py::resolve_bucket_width``)."""

from __future__ import annotations

from typing import Sequence


def resolve_bucket_width(length: int, widths: Sequence[int]) -> int:
    """Smallest of the (sorted, ascending) ``widths`` holding ``length``;
    lengths beyond the final width (the cap) truncate to it."""
    cap = widths[-1]
    length = min(max(int(length), 1), cap)
    return next(w for w in widths if w >= length)
