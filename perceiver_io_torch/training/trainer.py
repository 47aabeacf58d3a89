"""The training loop (the port's subset of ``perceiver_io_tpu/training/trainer.py``).

``Trainer.fit`` runs ``train_step`` over the train loader, epoch after epoch,
until ``max_steps``; every ``log_every_n_steps`` it writes one row to
``<logdir>/version_n/metrics.jsonl`` with the train loss, the
lr, the mean step seconds of the window and tokens per second. It evaluates
the validation loader and writes ``val_loss`` as the JAX ``Trainer.fit``
does: every ``eval_every_n_steps`` steps and once more at ``max_steps`` if
the last interval is partial; with ``eval_every_n_steps`` unset, at the end
of every epoch and at ``max_steps`` if that falls inside an epoch; never
twice at one step. A non-finite train loss at a log point stops the run.
Checkpoints, recovery and profiling are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
from typing import Dict, Optional

import torch

EVAL_SEED = 4242  # the JAX trainer's eval key


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_steps: int
    log_every_n_steps: int = 50
    eval_every_n_steps: Optional[int] = None
    logdir: str = "logs"


def next_version_dir(logdir: str) -> str:
    """``<logdir>/version_n`` with the next unused n."""
    versions = [int(m.group(1)) for name in (os.listdir(logdir) if os.path.isdir(logdir) else [])
                if (m := re.fullmatch(r"version_(\d+)", name))]
    run_dir = os.path.join(logdir, f"version_{max(versions) + 1 if versions else 0}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """``train_step(state, batch) -> (state, metrics)`` and
    ``eval_step(state, batch, generator) -> metrics`` driven over loaders of
    dict batches; ``tokens_per_example`` turns steps into tokens."""

    def __init__(self, train_step, eval_step, state, config: TrainerConfig,
                 tokens_per_example: int):
        self.train_step = train_step
        self.eval_step = eval_step
        self.state = state
        self.config = config
        self.tokens_per_example = tokens_per_example
        self.device = next(state.model.parameters()).device
        self.run_dir = next_version_dir(config.logdir)
        self._eval_generator = torch.Generator(device=self.device).manual_seed(EVAL_SEED)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        with open(os.path.join(self.run_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")

    def evaluate(self, val_loader) -> Dict[str, float]:
        """Batch-size-weighted mean of the eval metrics, as ``val_*``."""
        totals: Dict[str, float] = {}
        weight = 0
        for batch in val_loader:
            n = len(batch["token_ids"])
            for k, v in self.eval_step(self.state, batch, self._eval_generator).items():
                totals[k] = totals.get(k, 0.0) + float(v) * n
            weight += n
        return {f"val_{k}": v / weight for k, v in totals.items()} if weight else {}

    def _validate(self, step: int, val_loader) -> float:
        """Evaluate and log at ``step``; returns the seconds it took."""
        if val_loader is None:
            return 0.0
        t_eval = time.perf_counter()
        self.log(step, self.evaluate(val_loader))
        _sync(self.device)
        return time.perf_counter() - t_eval

    def fit(self, train_loader, val_loader=None):
        cfg = self.config
        every = cfg.eval_every_n_steps
        step = last_validated = self.state.step
        _sync(self.device)
        window_start, window_steps, window_examples = time.perf_counter(), 0, 0
        metrics: Dict[str, object] = {}
        while step < cfg.max_steps:
            batches = 0
            for batch in train_loader:
                batches += 1
                self.state, metrics = self.train_step(self.state, batch)
                step += 1
                window_steps += 1
                window_examples += len(batch["token_ids"])
                if step % cfg.log_every_n_steps == 0 or step == cfg.max_steps:
                    _sync(self.device)
                    elapsed = time.perf_counter() - window_start
                    row = {("train_loss" if k == "loss" else k): float(v)
                           for k, v in metrics.items()}
                    row["step_s"] = elapsed / window_steps
                    row["tokens_per_sec"] = window_examples * self.tokens_per_example / elapsed
                    self.log(step, row)
                    if not math.isfinite(row["train_loss"]):
                        raise FloatingPointError(
                            f"non-finite train loss {row['train_loss']} at step {step}")
                    window_start, window_steps, window_examples = time.perf_counter(), 0, 0
                if every and step % every == 0:
                    window_start += self._validate(step, val_loader)  # steps only
                    last_validated = step
                if step >= cfg.max_steps:
                    break
            if batches == 0:
                raise ValueError("the train loader yields no batch")
            if not every:  # the epoch's end, or max_steps inside it
                window_start += self._validate(step, val_loader)
                last_validated = step
        if step > last_validated:  # the final partial interval
            self._validate(step, val_loader)
        return self.state
