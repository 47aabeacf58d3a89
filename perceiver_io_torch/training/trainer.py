"""The training loop (the port's counterpart of
``perceiver_io_tpu/training/trainer.py``, single process).

``Trainer.fit`` runs ``train_step`` over the train loader, epoch after epoch,
until ``max_steps`` or ``max_epochs``; every ``log_every_n_steps`` (and at
``max_steps``) it writes one row to ``<logdir>/<experiment>/version_n/
metrics.jsonl`` with the train loss (and a classifier's ``train_acc``), the
lr, the mean step seconds of the window, examples and tokens per second. It validates as the JAX ``Trainer.fit`` does:
every ``eval_every_n_steps`` steps and once more at the end if the last
interval is partial; with ``eval_every_n_steps`` unset, at the end of every
epoch and at ``max_steps`` if that falls inside an epoch; never twice at one
step. Each validation logs ``val_*``, saves a checkpoint ranked by the
lowest ``val_loss`` (the train loss stands in when there is no validation
loader; the write runs on a background thread) and calls the
``predict_hook``. A non-finite train loss at a log point stops the run.

Resume: a state restored at step s > 0 starts at the epoch and the offset in
it that s falls on (the loader's ``epoch`` and ``skip_next``), so it sees
the batches the uninterrupted run would have; a restored run that is already
complete does nothing. SIGTERM (on the main thread) saves the current state
to the checkpoints' ``last/`` slot at the next step boundary and returns;
a notice that comes in an epoch's or the run's last step saves it after
that step.

Recovery (``skip_nonfinite_steps``, ``dispatch_error_retries``,
``fit_attempts``): each step's loss is read on the host (one sync a step); a
step whose loss or gradients are not finite is skipped with the state as it
was before it (``training.steps.make_guarded_step``), and after
``rollback_after_bad_steps`` bad steps in a row the newest checkpoint is
restored; a step that raises a transient error (``resilience.retry``) before
its update is retried on the same batch (the step zeroes the gradients
first, so it runs again from the same state); ``fit_with_recovery`` restarts
``fit`` from the newest checkpoint after a transient failure. Each of these
writes an ``events`` text row.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from perceiver_io_torch.resilience.retry import call_with_retry, is_transient
from perceiver_io_torch.training.checkpoint import CheckpointManager, restore_train_state
from perceiver_io_torch.training.metrics import MetricsLogger, next_version_dir
from perceiver_io_torch.training.steps import make_guarded_step

EVAL_SEED = 4242  # the JAX trainer's eval key
MONITOR = "val_loss"  # the checkpoints keep the lowest


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The loop's flags, the JAX ``TrainerConfig``'s single-process subset."""

    max_epochs: Optional[int] = None
    max_steps: Optional[int] = None
    log_every_n_steps: int = 50
    eval_every_n_steps: Optional[int] = None  # None: validate per epoch
    logdir: str = "logs"
    experiment: str = "default"
    max_to_keep: int = 1
    use_tensorboard: bool = True
    # recovery: read each step's loss on the host and skip a non-finite
    # step with the pre-step state kept; after rollback_after_bad_steps bad
    # steps in a row, restore the newest checkpoint (0: never)
    skip_nonfinite_steps: bool = False
    rollback_after_bad_steps: int = 3
    # retry a step that raises a transient error, up to this many times
    dispatch_error_retries: int = 0
    # fit_with_recovery: total attempts, each resuming from the newest
    # checkpoint after a transient failure
    fit_attempts: int = 1

    def __post_init__(self):
        if self.max_epochs is None and self.max_steps is None:
            raise ValueError("set max_epochs and/or max_steps")
        if self.dispatch_error_retries < 0:
            raise ValueError(f"dispatch_error_retries must be >= 0, got "
                             f"{self.dispatch_error_retries}")
        if self.fit_attempts < 1:
            raise ValueError(f"fit_attempts must be >= 1, got {self.fit_attempts}")

    @property
    def recovery_active(self) -> bool:
        """True when each step's loss is read on the host (recovery mode)."""
        return self.skip_nonfinite_steps or self.dispatch_error_retries > 0


def batch_size(batch) -> int:
    """The example count of a dict batch: its ``label`` column's length, or
    its first column's (a text, image or MLM batch alike)."""
    return len(batch["label"] if "label" in batch else next(iter(batch.values())))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Drives ``train_step(state, batch) -> (state, metrics)`` and
    ``eval_step(state, batch, generator) -> metrics`` over loaders of dict
    batches; owns the logs and the checkpoints of one run directory.

    ``tokens_per_example`` turns steps into tokens per second; ``hparams``
    (JSON-able) are embedded in the checkpoints; ``predict_hook(state,
    logger, step)`` runs after each validation; ``run_dir`` continues a run
    in place (resume) instead of starting ``version_n + 1``."""

    def __init__(self, train_step: Callable, eval_step: Optional[Callable], state,
                 config: TrainerConfig, tokens_per_example: Optional[int] = None,
                 hparams: Optional[Dict[str, Any]] = None,
                 predict_hook: Optional[Callable] = None, run_dir: Optional[str] = None):
        self.train_step = train_step
        self.eval_step = eval_step
        self.state = state
        self.config = config
        self.tokens_per_example = tokens_per_example
        self.predict_hook = predict_hook
        self.device = next(state.model.parameters()).device
        self.run_dir = run_dir or next_version_dir(config.logdir, config.experiment)
        self.logger = MetricsLogger(self.run_dir, use_tensorboard=config.use_tensorboard)
        self.checkpoints = CheckpointManager(
            os.path.join(self.run_dir, "checkpoints"), max_to_keep=config.max_to_keep,
            monitor=MONITOR, mode="min", hparams=hparams)
        self._eval_generator = torch.Generator(device=self.device).manual_seed(EVAL_SEED)
        self._bad_streak = 0
        self._sigterm = False
        self._last_train_loss = float("nan")
        # what recovery did in this trainer's life (the events rows say when)
        self.bad_steps = self.rollbacks = self.step_retries = self.fit_restarts = 0

    # -- evaluation ----------------------------------------------------------

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self.logger.log_scalars(step, metrics)

    def evaluate(self, val_loader) -> Dict[str, float]:
        """Batch-size-weighted mean of the eval metrics, as ``val_*``."""
        totals: Dict[str, float] = {}
        weight = 0
        for batch in val_loader:
            n = batch_size(batch)
            for k, v in self.eval_step(self.state, batch, self._eval_generator).items():
                totals[k] = totals.get(k, 0.0) + float(v) * n
            weight += n
        return {f"val_{k}": v / weight for k, v in totals.items()} if weight else {}

    def _validate_and_checkpoint(self, step: int, val_loader) -> float:
        """Validate, checkpoint and run the hook at ``step``; returns the
        seconds it took (the step-time window leaves them out)."""
        t0 = time.perf_counter()
        val_metrics = self.evaluate(val_loader) if val_loader is not None else {}
        if val_metrics:
            self.log(step, val_metrics)
        if val_loader is None:
            if math.isfinite(self._last_train_loss):
                self.checkpoints.save(step, self.state, {MONITOR: self._last_train_loss})
        elif MONITOR in val_metrics:
            self.checkpoints.save(step, self.state, val_metrics)
        if self.predict_hook is not None:
            self.predict_hook(self.state, self.logger, step)
        self.logger.flush()
        _sync(self.device)
        return time.perf_counter() - t0

    def test(self, test_loader) -> Dict[str, float]:
        """One evaluation pass over a held-out split, logged as ``test_*``."""
        if self.eval_step is None:
            raise ValueError("Trainer.test() needs an eval_step; this trainer was "
                             "constructed with eval_step=None")
        metrics = {k.replace("val_", "test_", 1): v
                   for k, v in self.evaluate(test_loader).items()}
        if metrics:
            self.log(self.state.step, metrics)
            self.logger.flush()
        return metrics

    # -- preemption and recovery --------------------------------------------

    def _preempt_save(self, step: int) -> None:
        self.checkpoints.save_last(step, self.state)
        self.logger.log_text("events", step, f"SIGTERM: saved last/ checkpoint at step {step}")
        self.logger.flush()

    def _ensure_rollback_target(self, step: int) -> None:
        """With no checkpoint yet, save the current state to ``last/`` so a
        rollback has somewhere to land."""
        if self.checkpoints.latest_step is None:
            self.checkpoints.save_last(step, self.state)

    def _rollback(self, step: int) -> None:
        """Bad steps in a row: restore the newest checkpoint and go on."""
        self.checkpoints.wait()
        restore_train_state(self.checkpoints.directory, self.state, prefer_latest=True)
        self._bad_streak = 0
        self.rollbacks += 1
        self.logger.log_text("events", step,
                             f"{self.config.rollback_after_bad_steps} consecutive non-finite "
                             f"steps: rolled back to checkpoint step {self.state.step}")
        self.logger.flush()

    def _recovering_step(self, step_fn, batch, step: int):
        """One step under the recovery config: a transient error raised before
        the update retried on the same batch, the loss read on the host, a
        bad step skipped or rolled back. Returns ``(status, metrics)``:
        ``'ok'``, ``'skipped'`` (the pre-step state kept) or
        ``'rolled_back'``."""
        cfg = self.config

        def attempt():
            before = self.state.step
            try:
                state, metrics = step_fn(self.state, batch)
                return state, metrics, float(metrics["loss"])  # the step's host sync
            except Exception as e:
                if self.state.step != before:  # updated in place: a rerun would update twice
                    raise RuntimeError(f"step {step} failed after its update "
                                       f"({type(e).__name__}); not retried") from e
                raise

        def on_retry(retry: int, error: BaseException) -> None:
            self.step_retries += 1
            self.logger.log_text(
                "events", step, f"transient dispatch error ({type(error).__name__}: {error}); "
                f"retry {retry}/{cfg.dispatch_error_retries}")

        self.state, metrics, loss = call_with_retry(attempt, cfg.dispatch_error_retries,
                                                    on_retry=on_retry)
        if cfg.skip_nonfinite_steps and int(metrics.get("bad_step", 0)):
            self._bad_streak += 1
            self.bad_steps += 1
            self.logger.log_text("events", step,
                                 f"non-finite loss or gradients (loss {loss}) at step "
                                 f"{step}: step skipped, pre-step state kept (streak "
                                 f"{self._bad_streak})")
            if 0 < cfg.rollback_after_bad_steps <= self._bad_streak:
                self._rollback(step)
                return "rolled_back", None
            return "skipped", None
        self._bad_streak = 0
        return "ok", metrics

    def fit_with_recovery(self, train_loader, val_loader=None):
        """:meth:`fit` under a supervisor: an attempt that dies with a
        transient error (``resilience.retry.is_transient``) resumes from the
        newest checkpoint (``prefer_latest``; the in-memory state when there
        is none yet), up to ``fit_attempts`` attempts in all."""
        attempts = self.config.fit_attempts
        for attempt in range(1, attempts + 1):
            try:
                return self.fit(train_loader, val_loader)
            except Exception as e:
                if attempt >= attempts or not is_transient(e):
                    raise
                self.fit_restarts += 1
                try:
                    self.checkpoints.wait()
                    restore_train_state(self.checkpoints.directory, self.state,
                                        prefer_latest=True)
                except FileNotFoundError:
                    pass  # nothing saved yet: resume from the in-memory state
                self.logger.log_text(
                    "events", self.state.step,
                    f"fit attempt {attempt} failed with transient {type(e).__name__}: {e}; "
                    f"auto-resuming from step {self.state.step} ({attempts - attempt} "
                    f"attempts left)")
                self.logger.flush()

    # -- the loop ------------------------------------------------------------

    def _fast_forward(self, train_loader, step: int) -> int:
        """The epoch a restored ``step`` falls in; the loader set to its epoch
        and offset. Returns the epoch."""
        try:
            per_epoch = len(train_loader)
        except TypeError:
            return 0
        if step <= 0 or per_epoch <= 0 or not hasattr(train_loader, "epoch"):
            return 0
        train_loader.epoch = step // per_epoch
        if step % per_epoch and hasattr(train_loader, "skip_next"):
            train_loader.skip_next(step % per_epoch)
        return step // per_epoch

    def fit(self, train_loader, val_loader=None):
        """Run the loop; returns the state."""
        cfg = self.config
        step = last_validated = self.state.step
        self._last_train_loss = float("nan")
        if cfg.max_steps is not None and step >= cfg.max_steps:
            return self.state  # a restored run that is complete
        epoch = self._fast_forward(train_loader, step)
        every = cfg.eval_every_n_steps
        self._bad_streak = 0
        if cfg.skip_nonfinite_steps and cfg.rollback_after_bad_steps > 0:
            self._ensure_rollback_target(step)
        step_fn = make_guarded_step(self.train_step) if cfg.skip_nonfinite_steps \
            else self.train_step

        self._sigterm = False
        prev_handler, installed = None, False
        if threading.current_thread() is threading.main_thread():
            def on_sigterm(signum, frame):
                self._sigterm = True

            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
            installed = True

        _sync(self.device)
        window_start, window_steps, window_examples = time.perf_counter(), 0, 0
        metrics: Dict[str, Any] = {}
        done = preempted = False
        try:
            while not done:
                if cfg.max_epochs is not None and epoch >= cfg.max_epochs:
                    break
                batches = steps_this_epoch = 0
                for batch in train_loader:
                    batches += 1
                    if self._sigterm:
                        self._preempt_save(step)
                        done = preempted = True
                        break
                    if cfg.recovery_active:
                        status, stepped = self._recovering_step(step_fn, batch, step)
                        if status != "ok":
                            step = self.state.step  # skipped: unchanged; rolled back: restored
                            if status == "rolled_back":
                                window_start, window_steps, window_examples = \
                                    time.perf_counter(), 0, 0
                            continue
                        metrics = stepped
                    else:
                        self.state, metrics = step_fn(self.state, batch)
                    prev = step
                    step += 1
                    steps_this_epoch += 1
                    window_steps += 1
                    window_examples += batch_size(batch)
                    if step % cfg.log_every_n_steps == 0 or step == cfg.max_steps:
                        _sync(self.device)
                        elapsed = time.perf_counter() - window_start
                        row = {(f"train_{k}" if k in ("loss", "acc") else k): float(v)
                               for k, v in metrics.items()}
                        row["step_s"] = elapsed / window_steps
                        row["examples_per_sec"] = window_examples / elapsed
                        if self.tokens_per_example:
                            row["tokens_per_sec"] = (window_examples * self.tokens_per_example
                                                     / elapsed)
                        self._last_train_loss = row.get("train_loss", self._last_train_loss)
                        self.log(step, row)
                        if not math.isfinite(row.get("train_loss", 0.0)):
                            self.logger.flush()
                            raise FloatingPointError(
                                f"non-finite train loss {row['train_loss']} at step {step}: "
                                f"training diverged (--skip_nonfinite_steps skips such "
                                f"steps)")
                        window_start, window_steps, window_examples = time.perf_counter(), 0, 0
                    if every and step // every > prev // every:
                        window_start += self._validate_and_checkpoint(step, val_loader)
                        last_validated = step
                    if cfg.max_steps is not None and step >= cfg.max_steps:
                        done = True
                        break
                if self._sigterm:
                    break
                if batches == 0:
                    raise ValueError("the train loader yields no batch")
                if steps_this_epoch == 0:
                    raise FloatingPointError(
                        f"every train step of epoch {epoch} was skipped as non-finite "
                        f"({batches} batches): the run cannot make progress")
                epoch += 1
                if not every:  # the epoch's end, or max_steps inside it
                    if not math.isfinite(self._last_train_loss) and "loss" in metrics:
                        self._last_train_loss = float(metrics["loss"])
                    window_start += self._validate_and_checkpoint(step, val_loader)
                    last_validated = step
        finally:
            if installed:
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
        # a notice in an epoch's or the run's last step: save unless that step's
        # validation did
        if self._sigterm and not preempted and (self.checkpoints.latest_step or -1) < step:
            self._preempt_save(step)
        if step > last_validated and not self._sigterm:  # the final partial interval
            if not math.isfinite(self._last_train_loss) and "loss" in metrics:
                self._last_train_loss = float(metrics["loss"])
            self._validate_and_checkpoint(step, val_loader)
        self.checkpoints.wait()
        self.logger.flush()
        return self.state

    def close(self) -> None:
        self.checkpoints.close()
        self.logger.close()

    def __enter__(self) -> "Trainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
