"""Resume, preemption and recovery of the port's trainer on the CPU.

- Resume against the JAX CLI: both ``train_mlm`` CLIs (f32, the rule
  masking both packages draw alike, the JAX run's initial weights) run 2
  steps, then ``--resume`` to 4: ``val_loss`` at step 4 within 1e-4
  relative of the JAX CLI's.
- The port against itself: a run stopped at step 2 (mid-epoch, dropout on)
  and resumed gives the uninterrupted run's train losses bit for bit.
- The fast-forward: a mid-epoch resume positions the loader on the JAX
  loader's batches.
- SIGTERM raised inside a step saves ``last/`` at the next step boundary and
  ``fit`` returns; raised inside the run's last step, it saves ``last/``
  after it.
- Recovery: a step with NaN gradients is skipped with the pre-step state
  kept; two in a row roll back to the newest checkpoint; a transient error
  is retried on the same batch (the clean run's losses), but not after the
  step's update, and ``fit_with_recovery`` resumes after one;
  ``classify_error``'s verdicts.
- ``--max_epochs`` alone against the JAX CLI, and ``Trainer.test``.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import common as jax_common
from perceiver_io_tpu.cli import train_mlm as jax_train_mlm
from perceiver_io_tpu.data.pipeline import DataLoader as JaxDataLoader
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics as jax_read_metrics
from perceiver_io_torch.cli import common, train_mlm
from perceiver_io_torch.data.pipeline import DataLoader
from perceiver_io_torch.interop import from_jax_params, param_tree
from perceiver_io_torch.models import presets
from perceiver_io_torch.resilience.retry import FATAL, TRANSIENT, classify_error
from perceiver_io_torch.training.checkpoint import LAST_SUBDIR
from perceiver_io_torch.training.metrics import read_metrics
from perceiver_io_torch.training.optim import OptimizerConfig, make_optimizer
from perceiver_io_torch.training.steps import make_mlm_steps
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.training.trainer import Trainer, TrainerConfig

# flags both CLIs take: 64 synthetic texts in batches of 32 are two steps an
# epoch
BOTH = ["--preset", "reference", "--synthetic", "--synthetic_size", "64", "--batch_size", "32",
        "--max_seq_len", "48", "--vocab_size", "1000", "--num_latents", "8",
        "--num_latent_channels", "16", "--num_encoder_layers", "2",
        "--num_self_attention_layers_per_block", "1", "--log_every_n_steps", "1",
        "--dtype", "float32", "--no_tensorboard", "--predict_samples"]


class _JaxRuleMasking:
    """Masks every non-pad position p with p % 5 == 2 (label: its token)."""

    def __init__(self, **_):
        pass

    def __call__(self, key, x, pad):
        import jax.numpy as jnp

        sel = (jnp.arange(x.shape[1])[None, :] % 5 == 2) & ~pad
        return jnp.where(sel, 2, x), jnp.where(sel, x, -100)


class _RuleMasking:
    """The port's twin of :class:`_JaxRuleMasking`."""

    def __init__(self, *_, **__):
        pass

    def __call__(self, generator, x, pad):
        sel = (torch.arange(x.shape[1])[None, :] % 5 == 2) & ~pad
        return torch.where(sel, 2, x), torch.where(sel, x.long(), -100)


def _carry_jax_init(monkeypatch) -> None:
    """The port's CLI starts from the weights the JAX CLI's run drew."""
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = common.build_mlm
    monkeypatch.setattr(common, "build_mlm",
                        lambda *a, **k: from_jax_params(build(*a, **k), seen["params"]))


def _rows(run_dir: str, key: str) -> list:
    return [(r["step"], r[key]) for r in read_metrics(run_dir) if key in r]


def test_resumed_val_loss_matches_the_jax_cli(tmp_path, monkeypatch):
    """Two steps, then ``--resume RUN --max_steps 4``, in both CLIs:
    validation at step 4 within 1e-4 relative; the resumed runs log into
    the first runs' directories."""
    monkeypatch.setattr(jax_common, "TextMasking", _JaxRuleMasking)
    monkeypatch.setattr(presets, "TextMasking", _RuleMasking)
    _carry_jax_init(monkeypatch)
    run = BOTH + ["--optimizer", "AdamW", "--weight_decay", "0.01", "--learning_rate", "0.01",
                  "--eval_every_n_steps", "2"]
    jax_args = ["--root", str(tmp_path / "jax"), "--logdir", str(tmp_path / "jax_logs")]
    port_args = ["--cpu", "--root", str(tmp_path / "port"), "--logdir", str(tmp_path / "port_logs")]
    jax_dir = jax_train_mlm.main(run + jax_args + ["--max_steps", "2"])
    port_dir = train_mlm.main(run + port_args + ["--max_steps", "2"])
    assert jax_train_mlm.main(run + jax_args + ["--resume", jax_dir, "--max_steps", "4"]) \
        == jax_dir
    assert train_mlm.main(run + port_args + ["--resume", port_dir, "--max_steps", "4"]) \
        == os.path.abspath(port_dir)
    jax_val = [r for r in jax_read_metrics(jax_dir) if "val_loss" in r]
    port_val = _rows(port_dir, "val_loss")
    assert [s for s, _ in port_val] == [r["step"] for r in jax_val] == [2, 4]
    np.testing.assert_allclose([v for _, v in port_val], [r["val_loss"] for r in jax_val],
                               rtol=1e-4)
    assert [s for s, _ in _rows(port_dir, "train_loss")] == [1, 2, 3, 4]


def test_resume_repeats_the_uninterrupted_run(tmp_path):
    """96 texts in batches of 32 are 3 steps an epoch: a run stopped at step
    2 and resumed to 5 (dropout 0.1, Adam, the seeded masking) logs the
    uninterrupted run's train losses and lr exactly."""
    run = [a for a in BOTH if a != "--predict_samples"] + [
        "--synthetic_size", "96", "--dropout", "0.1", "--eval_every_n_steps", "2", "--cpu",
        "--root", str(tmp_path)]
    full = train_mlm.main(run + ["--max_steps", "5", "--logdir", str(tmp_path / "full")])
    cut = train_mlm.main(run + ["--max_steps", "2", "--logdir", str(tmp_path / "cut")])
    train_mlm.main(run + ["--max_steps", "5", "--logdir", str(tmp_path / "cut"),
                          "--resume", cut])
    want = [(r["step"], r["train_loss"], r["lr"]) for r in read_metrics(full)
            if "train_loss" in r]
    got = [(r["step"], r["train_loss"], r["lr"]) for r in read_metrics(cut)
           if "train_loss" in r]
    assert [s for s, *_ in got] == [1, 2, 3, 4, 5]
    assert got == want
    # the hooks' rows and the checkpoints live in the one run directory
    assert any(r.get("tag") == "predictions" for r in read_metrics(cut))
    saved = sorted(os.listdir(os.path.join(cut, "checkpoints")))
    assert len(saved) == 3 and saved[1:] == ["digests.json", "hparams.json"]


@pytest.mark.parametrize("step", [4, 7])
def test_fast_forward_matches_the_jax_loader(step):
    """A resume at ``step`` (mid-epoch, 3 batches an epoch) positions the
    port's loader where the JAX trainer positions the JAX loader: the same
    batches, with the length-sorted windows on."""
    data = np.arange(10 * 2).reshape(10, 2)
    lengths = np.random.default_rng(0).integers(1, 50, 10)

    def collate(examples):
        return {"token_ids": np.stack(examples)}

    kwargs = dict(shuffle=True, seed=3, sort_key=lengths, sort_window=2)
    port = DataLoader(data, 3, collate, **kwargs)
    theirs = JaxDataLoader(data, 3, collate, prefetch=0, **kwargs)
    trainer = Trainer.__new__(Trainer)  # the arithmetic alone
    epoch = trainer._fast_forward(port, step)
    theirs.epoch = step // len(theirs)
    theirs.skip_next(step % len(theirs))
    assert epoch == step // 3
    got = [b["token_ids"] for b in port] + [b["token_ids"] for b in port]
    want = [b["token_ids"] for b in theirs] + [b["token_ids"] for b in theirs]
    assert len(got) == len(want) == 3 - step % 3 + 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


VOCAB, SEQ = 97, 24


def _setup(tmp_path, **config):
    """A tiny MLM trainer (Adam 1e-2) over 6 fixed examples in batches of 2
    (3 steps an epoch), the same batches as validation."""
    model = presets.tiny_mlm(vocab_size=VOCAB, max_seq_len=SEQ, num_latents=8, num_channels=16,
                             device="cpu", seed=0)
    optimizer, schedule = make_optimizer(OptimizerConfig(learning_rate=1e-2), model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=5)
    train_step, eval_step, _ = make_mlm_steps(model, schedule)
    ids = np.random.default_rng(1).integers(3, VOCAB, (6, SEQ)).astype(np.int32)

    def collate(rows):
        x = np.stack(rows)
        return {"token_ids": x, "pad_mask": x == 0}

    loader = DataLoader(ids, 2, collate, shuffle=True, seed=0)
    val = DataLoader(ids, 2, collate)
    cfg = TrainerConfig(**{"max_steps": 6, "log_every_n_steps": 1, "logdir": str(tmp_path),
                           "use_tensorboard": False, **config})
    return Trainer(train_step, eval_step, state, cfg, tokens_per_example=SEQ), loader, val


def _snapshot(state):
    opt = state.optimizer.state_dict()
    opt = opt.get("optimizer", opt)["state"]  # MultiSteps wraps the inner optimizer's
    return ({k: v.clone() for k, v in param_tree(state.model).items()},
            {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
             for i, s in opt.items()})


def _same(a, b) -> bool:
    params_a, opt_a = a
    params_b, opt_b = b
    return all(torch.equal(params_a[k], params_b[k]) for k in params_a) and opt_a.keys() \
        == opt_b.keys() and all(torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a
                                for k in opt_a[i])


def test_sigterm_saves_last_and_returns(tmp_path):
    """SIGTERM raised from inside step 3: the step finishes, ``last/3`` holds
    the state, an events row says so, ``fit`` returns without validating,
    and the previous SIGTERM handler is back."""
    trainer, loader, val = _setup(tmp_path)
    inner = trainer.train_step

    def step(state, batch, **kwargs):
        out = inner(state, batch, **kwargs)
        if state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = step
    before = signal.getsignal(signal.SIGTERM)
    with trainer:
        state = trainer.fit(loader, val)
    assert signal.getsignal(signal.SIGTERM) is before
    assert state.step == 3
    last = os.path.join(trainer.run_dir, "checkpoints", LAST_SUBDIR)
    assert sorted(os.listdir(last)) == ["3", "digests.json"]
    rows = read_metrics(trainer.run_dir)
    assert {"step": 3, "tag": "events",
            "text": "SIGTERM: saved last/ checkpoint at step 3"} in rows
    assert not any("val_loss" in r for r in rows)


def test_sigterm_in_the_last_step_saves_last(tmp_path):
    """SIGTERM raised from inside step 6, the run's last and no validation
    step (validation every 4): ``last/6`` holds the final state, so a resume
    repeats nothing, and the partial interval's validation is skipped."""
    trainer, loader, val = _setup(tmp_path, eval_every_n_steps=4)
    inner = trainer.train_step

    def step(state, batch, **kwargs):
        out = inner(state, batch, **kwargs)
        if state.step == 6:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = step
    with trainer:
        state = trainer.fit(loader, val)
    assert state.step == 6
    checkpoints = os.path.join(trainer.run_dir, "checkpoints")
    assert sorted(os.listdir(os.path.join(checkpoints, LAST_SUBDIR))) == ["6", "digests.json"]
    assert trainer.checkpoints.all_steps == [4]
    rows = read_metrics(trainer.run_dir)
    assert {"step": 6, "tag": "events",
            "text": "SIGTERM: saved last/ checkpoint at step 6"} in rows
    assert [r["step"] for r in rows if "val_loss" in r] == [4]


def _poisoned(trainer, calls):
    """The trainer's step with NaN gradients on the listed (1-based) calls;
    returns the snapshots taken before each call."""
    inner, seen = trainer.train_step, []
    param = next(trainer.state.model.parameters())

    def step(state, batch, **kwargs):
        seen.append(_snapshot(state))
        handle = None
        if len(seen) in calls:
            handle = param.register_hook(lambda g: torch.full_like(g, float("nan")))
        try:
            return inner(state, batch, **kwargs)
        finally:
            if handle is not None:
                handle.remove()

    trainer.train_step = step
    return seen


def test_nan_step_is_skipped_with_the_pre_step_state(tmp_path):
    trainer, loader, val = _setup(tmp_path, skip_nonfinite_steps=True,
                                  rollback_after_bad_steps=0)
    seen = _poisoned(trainer, {3})
    with trainer:
        state = trainer.fit(loader, val)
    # the bad call left the state as it found it: the next call saw it
    assert _same(seen[2], seen[3]) and not _same(seen[1], seen[2])
    assert trainer.bad_steps == 1 and state.step == 6 and len(seen) == 7
    rows = read_metrics(trainer.run_dir)
    assert any(r.get("tag") == "events" and r["step"] == 2 and "step skipped" in r["text"]
               for r in rows)
    train = [r for r in rows if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["train_loss"]) and r["bad_step"] == 0 for r in train)


def test_bad_steps_in_a_row_roll_back(tmp_path):
    """Validation (and a checkpoint) every 2 steps; calls 4 and 5 poisoned
    with ``rollback_after_bad_steps 2``: the second restores step 2's
    checkpoint, the run goes on to step 6 with finite losses."""
    trainer, loader, val = _setup(tmp_path, skip_nonfinite_steps=True,
                                  rollback_after_bad_steps=2, eval_every_n_steps=2,
                                  max_to_keep=3)
    seen = _poisoned(trainer, {4, 5})
    with trainer:
        state = trainer.fit(loader, val)
    assert trainer.bad_steps == 2 and trainer.rollbacks == 1 and state.step == 6
    # the state after the rollback is the step-2 checkpoint's
    assert _same(seen[5], seen[2]) and not _same(seen[5], seen[4])
    events = [r["text"] for r in read_metrics(trainer.run_dir) if r.get("tag") == "events"]
    assert events[-1] == "2 consecutive non-finite steps: rolled back to checkpoint step 2"
    train = [r for r in read_metrics(trainer.run_dir) if "train_loss" in r]
    assert all(np.isfinite(r["train_loss"]) for r in train)


def _flaky(trainer, calls):
    """The trainer's step raising ``ConnectionResetError`` before the listed
    (1-based) calls."""
    inner, count = trainer.train_step, [0]

    def step(state, batch, **kwargs):
        count[0] += 1
        if count[0] in calls:
            raise ConnectionResetError("connection reset by peer")
        return inner(state, batch, **kwargs)

    trainer.train_step = step


def test_transient_errors_retry_and_resume(tmp_path):
    """One ``ConnectionResetError`` with ``dispatch_error_retries 1``: the
    retry reruns the batch and the losses are the clean run's. Without
    retries, ``fit_with_recovery`` (2 attempts) resumes from the newest
    checkpoint and finishes the run."""
    clean, loader, val = _setup(tmp_path / "clean")
    with clean:
        clean.fit(loader, val)
    want = [r["train_loss"] for r in read_metrics(clean.run_dir) if "train_loss" in r]

    retried, loader, val = _setup(tmp_path / "retry", dispatch_error_retries=1)
    _flaky(retried, {3})
    with retried:
        retried.fit(loader, val)
    rows = read_metrics(retried.run_dir)
    assert [r["train_loss"] for r in rows if "train_loss" in r] == want
    assert retried.step_retries == 1 and any(
        r.get("tag") == "events" and "transient dispatch error" in r["text"] for r in rows)

    resumed, loader, val = _setup(tmp_path / "resume", fit_attempts=2, eval_every_n_steps=2,
                                  max_to_keep=3)
    _flaky(resumed, {5})
    with resumed:
        state = resumed.fit_with_recovery(loader, val)
    assert state.step == 6 and resumed.fit_restarts == 1
    events = [r for r in read_metrics(resumed.run_dir) if r.get("tag") == "events"]
    assert events[0]["step"] == 4 and "auto-resuming from step 4" in events[0]["text"]
    with pytest.raises(ConnectionResetError):
        again, loader, val = _setup(tmp_path / "again", fit_attempts=1)
        _flaky(again, {2})
        again.fit_with_recovery(loader, val)


def test_transient_error_after_the_update_is_not_retried(tmp_path):
    """A ``ConnectionResetError`` raised after step 3's in-place update: a
    rerun would update twice, so the trainer raises instead of retrying."""
    trainer, loader, val = _setup(tmp_path, dispatch_error_retries=2)
    inner = trainer.train_step

    def step(state, batch, **kwargs):
        out = inner(state, batch, **kwargs)
        if state.step == 3:
            raise ConnectionResetError("connection reset by peer")
        return out

    trainer.train_step = step
    with trainer, pytest.raises(RuntimeError, match="failed after its update") as raised:
        trainer.fit(loader, val)
    assert isinstance(raised.value.__cause__, ConnectionResetError)
    assert trainer.step_retries == 0 and trainer.state.step == 3


@pytest.mark.parametrize("poison", ["loss", "gradients"])
def test_guarded_step_keeps_the_pre_step_state(poison):
    """``make_guarded_step`` inside an accumulation window (k=2, after its
    first micro-step): a NaN loss or NaN gradients leave the parameters, the
    optimizer's state, the ``MultiSteps`` running mean and count and
    ``state.step`` as they were; ``bad_step`` is 1, and 0 on a clean step."""
    from perceiver_io_torch.training.steps import make_guarded_step

    model = presets.tiny_mlm(vocab_size=VOCAB, max_seq_len=SEQ, num_latents=8, num_channels=16,
                             device="cpu", seed=0)
    optimizer, schedule = make_optimizer(OptimizerConfig(learning_rate=1e-2, accumulate_steps=2),
                                         model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=5)
    step = make_guarded_step(make_mlm_steps(model, schedule)[0])
    ids = np.random.default_rng(1).integers(3, VOCAB, (2, SEQ)).astype(np.int32)
    batch = {"token_ids": ids, "pad_mask": ids == 0}
    state, metrics = step(state, batch)
    assert metrics["bad_step"] == 0 and state.step == 1 and optimizer.mini_step == 1
    before = (_snapshot(state), [a.clone() for a in optimizer.acc])
    if poison == "loss":
        handle = model.encoder.register_forward_hook(lambda m, i, out: out * float("nan"))
    else:
        handle = next(model.parameters()).register_hook(lambda g: torch.full_like(g, float("nan")))
    state, metrics = step(state, batch)
    handle.remove()
    assert metrics["bad_step"] == 1 and state.step == 1 and optimizer.mini_step == 1
    assert np.isfinite(float(metrics["loss"])) == (poison == "gradients")
    assert _same(_snapshot(state), before[0])
    assert all(torch.equal(a, b) for a, b in zip(optimizer.acc, before[1]))


def test_classify_error():
    assert classify_error(RuntimeError("CUDA error: an illegal memory access was "
                                       "encountered")) == FATAL
    assert classify_error(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                                 "2.00 GiB")) == FATAL
    assert classify_error(ConnectionResetError("reset")) == TRANSIENT
    assert classify_error(OSError("connection reset by peer")) == TRANSIENT
    assert classify_error(TimeoutError()) == TRANSIENT
    assert classify_error(ValueError("shape")) == FATAL
    assert classify_error(FloatingPointError("non-finite")) == FATAL
    declared = RuntimeError("CUDA error")
    declared.transient = True
    assert classify_error(declared) == TRANSIENT


def test_max_epochs_matches_the_jax_cli_and_test_rows(tmp_path):
    """``--max_epochs 2`` with no ``--max_steps``: 4 steps, validation at each
    epoch's end (steps 2 and 4) in both CLIs; ``Trainer.test`` logs
    ``test_loss`` at the state's step."""
    run = BOTH + ["--max_epochs", "2"]
    jax_dir = jax_train_mlm.main(run + ["--root", str(tmp_path / "jax"),
                                        "--logdir", str(tmp_path / "jax_logs")])
    trainer, data = train_mlm.prepare(run + ["--cpu", "--root", str(tmp_path / "port"),
                                             "--logdir", str(tmp_path / "port_logs")])
    with trainer:
        common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
        metrics = trainer.test(data.val_dataloader())
    jax_val = [r["step"] for r in jax_read_metrics(jax_dir) if "val_loss" in r]
    assert [s for s, _ in _rows(trainer.run_dir, "val_loss")] == jax_val == [2, 4]
    assert [s for s, _ in _rows(trainer.run_dir, "train_loss")] == [1, 2, 3, 4]
    assert list(metrics) == ["test_loss"] and np.isfinite(metrics["test_loss"])
    assert _rows(trainer.run_dir, "test_loss") == [(4, metrics["test_loss"])]
    assert json.load(open(os.path.join(trainer.run_dir, "checkpoints", "hparams.json")))[
        "max_epochs"] == 2


def test_resume_takes_the_hparams_and_keeps_the_flags_given(tmp_path):
    """``--resume`` fills the flags not given from the run's hparams (here
    the widths and the optimizer); the flags given win; ``--cpu`` and
    ``--resume`` never come from the hparams."""
    run_dir = train_mlm.main(BOTH + ["--max_steps", "1", "--optimizer", "SGD", "--cpu",
                                     "--root", str(tmp_path), "--logdir", str(tmp_path / "l")])
    args = common.parse_with_resume(train_mlm.build_parser(),
                                    ["--resume", run_dir, "--max_steps", "3"])
    assert (args.num_latents, args.num_latent_channels, args.optimizer) == (8, 16, "SGD")
    assert args.max_steps == 3 and args.cpu is False
    assert args.resume == os.path.abspath(run_dir)
    with pytest.raises(SystemExit, match="no usable checkpoint"):
        common.parse_with_resume(train_mlm.build_parser(),
                                 ["--resume", str(tmp_path / "nothing")])
