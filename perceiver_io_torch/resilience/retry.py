"""Error taxonomy and a bounded retry (the parts of
``perceiver_io_tpu/resilience/retry.py`` the trainer uses).

The taxonomy answers one question for an exception escaping a train step:
is retrying sane? Rules, in order:

- an exception with a boolean ``transient`` attribute keeps that verdict
  (an error that crossed a process boundary carries its original class);
- connection-level errors (reset, aborted, broken pipe, timeout, or an
  ``OSError`` whose text says so) are transient;
- a CUDA error (``torch.cuda`` raises a ``RuntimeError`` or
  ``torch.AcceleratorError`` naming CUDA) and ``torch.OutOfMemoryError`` are
  fatal: after a device-side fault the CUDA context is unusable, and an OOM
  repeats on the same shapes;
- everything else (shape and type errors, ``FloatingPointError`` from the
  non-finite guards) is fatal.

The JAX package retries with capped exponential backoff and jitter. A
single-process train step of the port does no I/O, so none of its own errors
is transient; the retry is kept for the command line's parity, and waits a
fixed pause instead.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

TRANSIENT = "transient"
FATAL = "fatal"

_TRANSIENT_MESSAGE_MARKERS = (
    "connection reset", "connection aborted", "broken pipe", "socket closed",
    "failed to connect", "connection closed", "transient",
)


def _is_cuda_error(exc: BaseException) -> bool:
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    names = {c.__name__ for c in type(exc).__mro__}
    text = str(exc)
    return ("AcceleratorError" in names or isinstance(exc, RuntimeError)) and (
        "CUDA" in text or "cuda" in text or "cuBLAS" in text or "CUBLAS" in text)


def classify_error(exc: BaseException) -> str:
    """``'transient'`` (retry is sane) or ``'fatal'`` (it is not)."""
    declared = getattr(exc, "transient", None)
    if isinstance(declared, bool):
        return TRANSIENT if declared else FATAL
    if _is_cuda_error(exc):
        return FATAL
    if isinstance(exc, (ConnectionResetError, ConnectionAbortedError, BrokenPipeError,
                        TimeoutError)):
        return TRANSIENT
    if isinstance(exc, OSError) and any(m in str(exc).lower()
                                        for m in _TRANSIENT_MESSAGE_MARKERS):
        return TRANSIENT
    return FATAL


def is_transient(exc: BaseException) -> bool:
    return classify_error(exc) == TRANSIENT


RETRY_PAUSE_S = 0.05  # the wait before each retry


def call_with_retry(fn: Callable, retries: int,
                    on_retry: Optional[Callable[[int, BaseException], None]] = None):
    """``fn()``, retried after a transient exception up to ``retries`` times,
    RETRY_PAUSE_S apart; a fatal error, or a transient one with the retries
    spent, raises. ``on_retry(retry, error)`` (1-based) is called before each
    retry."""
    for retry in range(retries + 1):
        try:
            return fn()
        except Exception as e:
            if retry == retries or not is_transient(e):
                raise
            if on_retry is not None:
                on_retry(retry + 1, e)
            time.sleep(RETRY_PAUSE_S)
