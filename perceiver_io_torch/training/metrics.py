"""Run directories and metrics logging (the port's counterpart of
``perceiver_io_tpu/training/metrics.py``).

Runs go to ``<logdir>/<experiment>/version_n``. Every scalar row
(``{"step", ...}``) and text row (``{"step", "tag", "text"}``) is appended to
``metrics.jsonl`` in the run directory, one JSON object a line; TensorBoard
events are written too through ``torch.utils.tensorboard`` when it can be
imported and opened (fail-soft: without it the JSONL file is the log).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

METRICS_FILE = "metrics.jsonl"


def next_version_dir(logdir: str, experiment: str) -> str:
    """``<logdir>/<experiment>/version_n`` with the next unused n, created."""
    base = os.path.join(logdir, experiment)
    versions = [int(m.group(1)) for name in (os.listdir(base) if os.path.isdir(base) else [])
                if (m := re.fullmatch(r"version_(\d+)", name))]
    run_dir = os.path.join(base, f"version_{max(versions) + 1 if versions else 0}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


class MetricsLogger:
    """Scalar and text rows to ``metrics.jsonl`` (line-buffered, so a row
    can be read as soon as it is logged) and to TensorBoard."""

    def __init__(self, run_dir: str, use_tensorboard: bool = True):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, METRICS_FILE), "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=run_dir)
            except Exception:
                self._tb = None

    def log_scalars(self, step: int, metrics: Dict[str, float]) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": int(step), **values}) + "\n")
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, int(step))

    def log_text(self, tag: str, step: int, text: str) -> None:
        """Free text: the sample hooks' channel and the trainer's events."""
        self._jsonl.write(json.dumps({"step": int(step), "tag": tag, "text": text}) + "\n")
        if self._tb is not None:
            self._tb.add_text(tag, text, int(step))

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_metrics(run_dir: str) -> List[dict]:
    """The rows of ``<run_dir>/metrics.jsonl`` (none if it does not exist)."""
    path = os.path.join(run_dir, METRICS_FILE)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
