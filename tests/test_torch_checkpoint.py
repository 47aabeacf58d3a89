"""The port's checkpoints (``training/checkpoint.py``) on the CPU: a save in
the middle of a run and a restore into a fresh model continue the run bit
for bit, for each of the eight optimizers and for ``accumulate_steps 2``
saved inside an accumulation window; best-k retention under ``min`` and
``max``; the ``last/`` slot under ``prefer_latest`` (and winning a tie);
a truncated newest step, and one whose params were altered after their
digest was recorded, are skipped with a warning, and with every candidate
bad the error is raised; the module-level readers; the async save copies
the state before it returns. Against the JAX package: ``tree_digest`` of
the same tiny-MLM weights, f32 and bf16, and the ``next_version_dir``
layout."""

import glob
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.models.presets import tiny_mlm as jax_tiny_mlm
from perceiver_io_tpu.training.metrics import next_version_dir as jax_next_version_dir
from perceiver_io_tpu.utils.treepath import tree_digest as jax_tree_digest
from perceiver_io_torch.interop import from_jax_params, param_tree
from perceiver_io_torch.models import presets
from perceiver_io_torch.training.checkpoint import (
    LAST_SUBDIR,
    PARAMS_FILE,
    CheckpointManager,
    load_hparams,
    resolve_checkpoint_step,
    restore_encoder_params,
    restore_params,
    restore_raw_params,
    restore_train_state,
)
from perceiver_io_torch.training.metrics import next_version_dir
from perceiver_io_torch.training.optim import (
    SUPPORTED_OPTIMIZERS,
    OptimizerConfig,
    make_optimizer,
)
from perceiver_io_torch.training.steps import make_mlm_steps
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.utils.treepath import tree_digest

VOCAB, SEQ, BATCH = 97, 24, 4


def _state(name: str = "Adam", k: int = 1, seed: int = 0):
    """A tiny MLM (weights from ``seed``) with ``name`` at lr 1e-2, weight
    decay 0.01 (SGD: momentum 0.9), ``accumulate_steps`` k, OneCycle over 12
    steps; masking and dropout draws from seed 7."""
    model = presets.tiny_mlm(vocab_size=VOCAB, max_seq_len=SEQ, num_latents=8, num_channels=16,
                             device="cpu", seed=seed, dropout=0.1)
    optimizer, schedule = make_optimizer(OptimizerConfig(
        optimizer=name, learning_rate=1e-2, weight_decay=0.01, one_cycle_lr=True,
        max_steps=12, momentum=0.9 if name == "SGD" else 0.0, accumulate_steps=k),
        model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=7)
    return state, make_mlm_steps(model, schedule)[0]


def _batches(n: int):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(3, VOCAB, (BATCH, SEQ)).astype(np.int32)
        ids[:, SEQ - rng.integers(0, 6):] = 0
        out.append({"token_ids": ids, "pad_mask": ids == 0})
    return out


def _run(state, train_step, batches):
    losses = []
    for batch in batches:
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def _params(state):
    return {k: v.clone() for k, v in param_tree(state.model).items()}


@pytest.mark.parametrize("name,k,cut", [(n, 1, 3) for n in SUPPORTED_OPTIMIZERS]
                         + [("Adam", 2, 3)])
def test_resume_continues_bit_for_bit(tmp_path, name, k, cut):
    """``cut`` steps, a save, a restore into a model drawn from another seed
    with a fresh optimizer, the rest of the run: every later loss and the
    final weights equal the uninterrupted run's exactly (with k=2 the save
    falls inside an accumulation window: the running mean round-trips)."""
    batches = _batches(6)
    state, step = _state(name, k)
    full = _run(state, step, batches)
    want = _params(state)

    state, step = _state(name, k)
    first = _run(state, step, batches[:cut])
    with CheckpointManager(str(tmp_path / "ckpt")) as mngr:
        mngr.save(state.step, state, {"val_loss": 1.0})
    fresh, fresh_step = _state(name, k, seed=1)
    restore_train_state(str(tmp_path / "ckpt"), fresh)
    assert fresh.step == cut and fresh.seed == 7
    rest = _run(fresh, fresh_step, batches[cut:])
    assert first + rest == full
    got = _params(fresh)
    assert all(torch.equal(got[p], want[p]) for p in want)


def test_async_save_copies_the_state_before_it_returns(tmp_path):
    state, _ = _state()
    before = _params(state)
    mngr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    assert mngr.save(1, state, {"val_loss": 1.0})
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    mngr.close()
    saved = restore_params(str(tmp_path / "ckpt"))
    assert all(torch.equal(saved[p], before[p]) for p in before)


@pytest.mark.parametrize("mode,kept,best", [("min", [2, 4], 4), ("max", [1, 3], 1)])
def test_best_k_retention(tmp_path, mode, kept, best):
    state, _ = _state()
    losses = {1: 5.0, 2: 3.0, 3: 4.0, 4: 2.0}
    with CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, mode=mode,
                           async_save=False) as mngr:
        for step, loss in losses.items():
            state.step = step
            mngr.save(step, state, {"val_loss": loss})
        assert mngr.all_steps == kept and mngr.best_step == best
        assert mngr.latest_step == kept[-1]
        assert mngr.restore_metrics()["val_loss"] == losses[best]
        fresh, _ = _state(seed=2)
        mngr.restore_state(fresh)
        assert fresh.step == best
    # a manager over the same directory keeps ranking what is there
    with CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, mode=mode) as mngr:
        state.step = 5
        assert mngr.save(5, state, {"val_loss": 1.0 if mode == "min" else 9.0})
        assert mngr.all_steps == sorted([best, 5])
    with CheckpointManager(str(tmp_path / "tie"), max_to_keep=1) as mngr:
        for step in (1, 2):
            mngr.save(step, state, {"val_loss": 1.0})
        assert mngr.all_steps == [2]  # a tie keeps the newer step


def test_last_slot_and_prefer_latest(tmp_path):
    """The ranked slot keeps its champion, ``last/`` the newest state:
    ``prefer_latest`` resumes from ``last/``, the default restore from the
    best; at one step ``last/`` wins the tie."""
    batches = _batches(4)
    state, step = _state()
    directory = str(tmp_path / "ckpt")
    with CheckpointManager(directory, async_save=False) as mngr:
        _run(state, step, batches[:1])
        mngr.save(state.step, state, {"val_loss": 1.0})
        champion = _params(state)
        _run(state, step, batches[1:3])
        mngr.save_last(state.step, state)
        newest = _params(state)
    fresh, _ = _state(seed=1)
    restore_train_state(directory, fresh, prefer_latest=True)
    assert fresh.step == 3 and all(torch.equal(_params(fresh)[p], newest[p]) for p in newest)
    restore_train_state(directory, fresh)
    assert fresh.step == 1 and all(torch.equal(_params(fresh)[p], champion[p])
                                   for p in champion)
    # one step in both slots: last/ holds the later state and wins
    with CheckpointManager(directory, async_save=False) as mngr:
        mngr.save(3, state, {"val_loss": 0.5})
        _run(state, step, batches[3:])
        mngr.save_last(3, state)
        later = _params(state)
    restore_train_state(directory, fresh, prefer_latest=True)
    assert all(torch.equal(_params(fresh)[p], later[p]) for p in later)
    assert sorted(os.listdir(os.path.join(directory, LAST_SUBDIR))) == ["3", "digests.json"]


def test_bad_candidates_fall_back_then_raise(tmp_path):
    """A truncated newest step warns and falls back; a step whose params
    still load but differ from the recorded digest warns and falls back;
    with every candidate bad the last error is raised."""
    state, _ = _state()
    directory = str(tmp_path / "ckpt")
    saved = {}
    with CheckpointManager(directory, max_to_keep=3, async_save=False) as mngr:
        for step in (1, 2, 3):
            state.step = step
            with torch.no_grad():
                next(state.model.parameters()).add_(1.0)
            mngr.save(step, state, {"val_loss": float(step)})
            saved[step] = _params(state)
    for path in glob.glob(os.path.join(directory, "3", "*")):
        open(path, "wb").close()  # the killed-mid-save signature
    fresh, _ = _state(seed=1)
    with pytest.warns(UserWarning, match="failed to restore"):
        restore_train_state(directory, fresh, prefer_latest=True)
    assert fresh.step == 2 and all(torch.equal(_params(fresh)[p], saved[2][p])
                                   for p in saved[2])
    # step 2's params altered after the save: it still loads
    path = os.path.join(directory, "2", PARAMS_FILE)
    tree = torch.load(path, weights_only=True)
    first = sorted(tree)[0]
    tree[first].view(-1)[0] += 1.0
    torch.save(tree, path)
    with pytest.warns(UserWarning, match="does not match the save-time sidecar"):
        restore_train_state(directory, fresh, prefer_latest=True)
    assert fresh.step == 1
    for path in glob.glob(os.path.join(directory, "1", "*")):
        open(path, "wb").close()
    with pytest.raises(Exception), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        restore_train_state(directory, fresh, prefer_latest=True)


def test_module_level_readers(tmp_path):
    """``resolve_checkpoint_step`` (explicit, best, latest),
    ``load_hparams``, ``restore_params`` and ``restore_raw_params`` (the
    best step's tree), ``restore_encoder_params`` (the encoder subtree,
    which loads into another model's encoder)."""
    state, _ = _state()
    directory = str(tmp_path / "ckpt")
    hparams = {"num_latents": 8, "optimizer": OptimizerConfig(one_cycle_lr=True)}
    with CheckpointManager(directory, max_to_keep=3, hparams=hparams) as mngr:
        state.step = 1
        mngr.save(1, state, {"val_loss": 0.4})
        best = _params(state)
        with torch.no_grad():
            for p in state.model.parameters():
                p.mul_(2.0)
        state.step = 2
        mngr.save(2, state, {"val_loss": 0.7})
    assert load_hparams(directory)["optimizer"]["one_cycle_lr"] is True
    assert resolve_checkpoint_step(directory) == 1
    assert resolve_checkpoint_step(directory, step=2) == 2
    assert resolve_checkpoint_step(directory, monitor="val_loss", mode="max") == 2
    assert resolve_checkpoint_step(directory, monitor="missing") == 2  # latest
    params = restore_params(directory, param_tree(state.model))
    assert all(torch.equal(params[p], best[p]) for p in best)
    raw, step = restore_raw_params(directory, step=2)
    assert step == 2 and torch.equal(raw[sorted(raw)[0]], 2 * best[sorted(raw)[0]])
    other, _ = _state(seed=3)
    encoder = restore_encoder_params(directory, {k[len("encoder/"):]: v for k, v in
                                                 param_tree(other.model).items()
                                                 if k.startswith("encoder/")})
    from perceiver_io_torch.interop import load_param_tree

    load_param_tree(other.model.encoder, encoder)
    got = param_tree(other.model)
    assert all(torch.equal(got[p], best[p]) for p in best if p.startswith("encoder/"))
    assert not all(torch.equal(got[p], best[p]) for p in best if p.startswith("decoder/"))
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint_step(str(tmp_path / "empty"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_digest_matches_jax(dtype):
    """The same tiny-MLM weights give the JAX package's digest, f32 and bf16
    (the bf16 leaves as ``ml_dtypes.bfloat16`` on the JAX side)."""
    jmodel = jax_tiny_mlm()
    ids = jnp.zeros((1, 64), jnp.int32)
    params = jmodel.init({"params": jax.random.key(3), "masking": jax.random.key(1)},
                         ids, ids == 1)["params"]
    model = presets.tiny_mlm(device="cpu")
    if dtype == "bfloat16":
        params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
        model = model.to(torch.bfloat16)
        # numpy has no bf16: carry the 2-byte words
        tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).view(np.int16)).view(
            torch.bfloat16), params)
    else:
        tree = jax.tree.map(np.asarray, params)
    model = from_jax_params(model, tree)
    assert {str(p.dtype) for p in model.parameters()} == {f"torch.{dtype}"}
    assert tree_digest(param_tree(model)) == jax_tree_digest(params)
    # and a different leaf gives a different digest
    first = sorted(param_tree(model))[0]
    changed = dict(param_tree(model))
    changed[first] = changed[first] + 1
    assert tree_digest(changed) != jax_tree_digest(params)


def test_next_version_dir_matches_jax(tmp_path):
    ours = [os.path.relpath(next_version_dir(str(tmp_path / "a"), "exp"), tmp_path / "a")
            for _ in range(3)]
    theirs = [os.path.relpath(jax_next_version_dir(str(tmp_path / "b"), "exp"), tmp_path / "b")
              for _ in range(3)]
    assert ours == theirs == [os.path.join("exp", f"version_{i}") for i in range(3)]
