"""The port's sequence-classification CLI, transfer and the reference
checkpoint import, on the CPU:

- the reference ``.ckpt`` import: files written by the JAX package's
  ``export_lightning_checkpoint`` (an MLM and a classifier, hparams in the
  reference's spellings) read by the port give the JAX
  ``import_lightning_checkpoint`` trees exactly, and the same hparams; a
  file the weights-only unpickler refuses raises unless
  ``allow_unsafe_pickle`` (``--unsafe_load``), which warns;
- ``cli.train_seq_clf`` and the JAX CLI on the same flags, both from one
  reference ``.ckpt`` with ``--freeze_encoder`` and AdamW with weight decay
  and ``--grad_clip_norm``, f32: the classifier built at the checkpoint's
  widths, validation at the same steps with losses within 1e-4 relative, the
  encoder equal to the checkpoint's at the end; ``--clf_checkpoint`` of a
  ``.ckpt`` loads the whole classifier; a tree that does not fit is refused;
- transfer from the port's own ``train_mlm``: ``--mlm_checkpoint <run>/
  checkpoints`` grafts the best step's encoder (read with the MLM run's
  tokenizer file, not a retrained one), ``--freeze_encoder`` leaves it bit
  for bit as saved while the decoder trains, and ``--clf_checkpoint`` of that
  run restores its weights, optimizer, step and ``freeze_encoder``;
- the flags' refusals and the reference defaults.
"""

import argparse
import fractions
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import common as jcommon
from perceiver_io_tpu.cli import train_seq_clf as jax_train_seq_clf
from perceiver_io_tpu.interop import export_lightning_checkpoint
from perceiver_io_tpu.interop import import_lightning_checkpoint as jax_import
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics
from perceiver_io_torch.cli import common, train_mlm, train_seq_clf
from perceiver_io_torch.data.imdb import IMDBDataModule
from perceiver_io_torch.interop import (
    flatten_tree,
    from_jax_params,
    import_lightning_checkpoint,
    param_tree,
)
from perceiver_io_torch.training.checkpoint import resolve_checkpoint_step, restore_raw_params

WIDTHS = dict(num_latents=8, num_latent_channels=16, num_encoder_layers=2,
              num_self_attention_layers_per_block=1, num_cross_attention_heads=4,
              num_self_attention_heads=4, max_seq_len=48, vocab_size=300)
DATA = ["--synthetic", "--synthetic_size", "192", "--batch_size", "16", "--dtype", "float32",
        "--log_every_n_steps", "1", "--no_tensorboard"]
TINY = DATA + [f"--{k}={v}" for k, v in WIDTHS.items()]


def _namespace(**kw) -> argparse.Namespace:
    base = dict(dtype="float32", dropout=0.0, attn_impl="xla", remat=False, no_reuse_kv=False,
                pad_vocab_multiple=None, **WIDTHS)
    return argparse.Namespace(**{**base, **kw})


def _tokenizer_size(root: str) -> int:
    """The vocab of the synthetic corpus's tokenizer under ``root`` (trained
    there once, then read by every CLI given that root)."""
    module = IMDBDataModule(root=root, max_seq_len=48, vocab_size=300, synthetic=True,
                            synthetic_size=192)
    module.prepare_data()
    module.setup()
    return module.tokenizer.get_vocab_size()


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _export(path, layout: str, vocab: int, seed: int = 0) -> dict:
    """A reference ``.ckpt`` of a JAX model (weights from ``seed``) at WIDTHS,
    written by the JAX package; returns its flat tree."""
    args = _namespace()
    ids = np.zeros((1, 48), np.int32)
    if layout == "mlm":
        model = jcommon.build_mlm(args, vocab, 48)
        rngs = {"params": jax.random.key(seed), "masking": jax.random.key(1)}
    else:
        model = jcommon.build_text_classifier(args, vocab, 48)
        rngs = {"params": jax.random.key(seed)}
    params = jax.jit(model.init)(rngs, ids, pad_mask=ids == 0)["params"]
    export_lightning_checkpoint(params, str(path), hparams=WIDTHS, layout=layout)
    return _flat(params)


# -- the reference checkpoint import --------------------------------------------------


@pytest.mark.parametrize("layout", ["mlm", "classifier"])
def test_reference_ckpt_import_matches_jax(tmp_path, layout):
    path = tmp_path / "model.ckpt"
    exported = _export(path, layout, vocab=120)
    for encoder_only in (False, True):
        tree, hparams = import_lightning_checkpoint(str(path), encoder_only=encoder_only)
        jtree, jhparams = jax_import(str(path), encoder_only=encoder_only)
        got, want = flatten_tree(tree), _flat(jtree)
        assert sorted(got) == sorted(want) and hparams == jhparams
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    assert hparams["num_cross_attention_heads"] == 4  # the reference's name, converted
    if layout == "classifier":
        got = flatten_tree(import_lightning_checkpoint(str(path))[0])
        assert all(np.array_equal(got[k], exported[k]) for k in exported)


def test_unsafe_pickles_need_the_opt_in(tmp_path):
    path = tmp_path / "odd.ckpt"
    torch.save({"state_dict": {"latent": torch.zeros(2, 2)},
                "hyper_parameters": {"num_latents": 2}, "extra": fractions.Fraction(1, 3)},
               str(path))
    with pytest.raises(ValueError, match="unsafe_load"):
        import_lightning_checkpoint(str(path))
    with pytest.warns(UserWarning, match="unrestricted pickle loader"):
        tree, hparams = import_lightning_checkpoint(str(path), allow_unsafe_pickle=True)
    assert flatten_tree(tree)["encoder/latent"].shape == (2, 2) and hparams == {"num_latents": 2}
    # the CLI flag: refused without --unsafe_load
    with pytest.raises(ValueError, match="unsafe_load"):
        train_seq_clf.prepare(["--cpu", "--max_steps", "1", "--mlm_checkpoint", str(path)])


# -- the CLI against the JAX CLI, and from a reference checkpoint ---------------------


def test_seq_clf_cli_matches_jax_from_a_reference_ckpt(tmp_path, monkeypatch):
    """Both CLIs from one reference MLM ``.ckpt`` with ``--freeze_encoder``
    and AdamW + clipping, the port's decoder from the JAX run's initial
    weights: validation at steps 2 and 4 within 1e-4 relative."""
    vocab = _tokenizer_size(str(tmp_path / "port"))
    os.makedirs(tmp_path / "jax")
    for name in os.listdir(tmp_path / "port"):  # one tokenizer file for both
        with open(tmp_path / "port" / name, "rb") as src, open(tmp_path / "jax" / name,
                                                               "wb") as dst:
            dst.write(src.read())
    ckpt = tmp_path / "mlm.ckpt"
    mlm = _export(ckpt, "mlm", vocab)
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)  # the trainer donates its buffers
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = common.build_text_classifier
    monkeypatch.setattr(common, "build_text_classifier",
                        lambda *a, **k: from_jax_params(build(*a, **k), seen["params"]))
    # the widths come from the checkpoint: the flags give others
    run = DATA + ["--num_latents", "4", "--max_seq_len", "48", "--vocab_size", "300",
                  "--mlm_checkpoint", str(ckpt), "--freeze_encoder", "--dropout", "0",
                  "--optimizer", "AdamW", "--grad_clip_norm", "0.05", "--learning_rate",
                  "0.01", "--max_steps", "4", "--eval_every_n_steps", "2"]
    with pytest.warns(UserWarning, match="locally-trained tokenizer"):
        jax_dir = jax_train_seq_clf.main(run + ["--root", str(tmp_path / "jax"),
                                                "--logdir", str(tmp_path / "jax_logs")])
    with pytest.warns(UserWarning, match="locally-trained tokenizer"):
        trainer, data = train_seq_clf.prepare(run + ["--cpu", "--root", str(tmp_path / "port"),
                                                     "--logdir", str(tmp_path / "port_logs")])
    model = trainer.state.model
    assert model.encoder.latent.shape == (8, 16)
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    jax_val = [(r["step"], r["val_loss"]) for r in read_metrics(jax_dir) if "val_loss" in r]
    rows = [json.loads(line) for line in open(f"{trainer.run_dir}/metrics.jsonl")]
    port_val = [(r["step"], r["val_loss"]) for r in rows if "val_loss" in r]
    assert [s for s, _ in port_val] == [s for s, _ in jax_val] == [2, 4]
    np.testing.assert_allclose([v for _, v in port_val], [v for _, v in jax_val], rtol=1e-4)
    assert abs(port_val[1][1] - port_val[0][1]) > 1e-4  # the decoder trained
    got = param_tree(model)
    for k, v in mlm.items():  # the frozen encoder is the checkpoint's, bit for bit
        if k.startswith("encoder/"):
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert all({"train_loss", "train_acc", "tokens_per_sec"} <= set(r) for r in rows
               if "train_loss" in r)
    assert all("val_acc" in r for r in rows if "val_loss" in r)


def test_clf_ckpt_loads_the_whole_classifier_and_refuses_a_tree_that_does_not_fit(tmp_path):
    vocab = _tokenizer_size(str(tmp_path))
    ckpt = tmp_path / "clf.ckpt"
    exported = _export(ckpt, "classifier", vocab, seed=4)
    base = DATA + ["--cpu", "--root", str(tmp_path), "--logdir", str(tmp_path / "logs"),
                   "--max_seq_len", "48", "--vocab_size", "300", "--max_steps", "1"]
    with pytest.warns(UserWarning, match="locally-trained tokenizer"):
        trainer, _ = train_seq_clf.prepare(base + ["--clf_checkpoint", str(ckpt)])
    got = param_tree(trainer.state.model)
    assert sorted(got) == sorted(exported)
    assert all(np.array_equal(got[k].numpy(), exported[k]) for k in exported)
    assert trainer.state.step == 0  # a .ckpt carries weights, not a run
    trainer.close()
    # a tree that lacks leaves of the model is refused
    state = torch.load(str(ckpt), weights_only=True)
    state["state_dict"] = {k: v for k, v in state["state_dict"].items()
                           if not k.endswith(".1.output")}  # the decoder query
    torch.save(state, str(tmp_path / "cut.ckpt"))
    with pytest.warns(UserWarning), pytest.raises(SystemExit, match="missing"):
        train_seq_clf.prepare(base + ["--clf_checkpoint", str(tmp_path / "cut.ckpt")])


# -- transfer from the port's train_mlm -----------------------------------------------


def test_transfer_from_the_port_mlm(tmp_path):
    root, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    common_flags = TINY + ["--cpu", "--root", root, "--logdir", logs]
    mlm_dir = train_mlm.main(common_flags + ["--preset", "reference", "--max_steps", "4",
                                             "--eval_every_n_steps", "2", "--max_to_keep", "2",
                                             "--predict_samples"])
    tokenizer = os.path.join(root, "imdb-synthetic-tokenizer-300.json")
    stamp = os.stat(tokenizer).st_mtime_ns
    ckpt = f"{mlm_dir}/checkpoints"
    best = resolve_checkpoint_step(ckpt)
    saved, _ = restore_raw_params(ckpt, best)
    # the widths come from the MLM run's hparams, whatever the flags say
    argv = (DATA + ["--cpu", "--root", root, "--logdir", logs, "--num_latents", "4",
                    "--mlm_checkpoint", ckpt, "--freeze_encoder", "--max_steps", "4",
                    "--eval_every_n_steps", "2", "--weight_decay", "0.1"])
    trainer, data = train_seq_clf.prepare(argv)
    model = trainer.state.model
    start = {k: v.clone() for k, v in param_tree(model).items()}
    assert all(torch.equal(start[k], v) for k, v in saved.items() if k.startswith("encoder/"))
    assert data.tokenizer.get_vocab_size() == model.encoder.input_adapter.text_embedding \
        .embedding.shape[0]
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    end = param_tree(model)
    for k in start:
        assert torch.equal(end[k], start[k]) == k.startswith("encoder/"), k
    assert os.stat(tokenizer).st_mtime_ns == stamp  # the MLM run's tokenizer, read
    rows = [json.loads(line) for line in open(f"{trainer.run_dir}/metrics.jsonl")]
    assert [r["step"] for r in rows if "val_acc" in r] == [2, 4]
    # --clf_checkpoint: weights, optimizer, step and the freeze come back
    clf_ckpt = f"{trainer.run_dir}/checkpoints"
    again, _ = train_seq_clf.prepare(DATA + ["--cpu", "--root", root, "--logdir", logs,
                                             "--clf_checkpoint", clf_ckpt, "--max_steps",
                                             "6"])
    best_clf = resolve_checkpoint_step(clf_ckpt)
    restored, _ = restore_raw_params(clf_ckpt, best_clf)
    assert again.state.step == best_clf
    assert all(torch.equal(param_tree(again.state.model)[k], v) for k, v in restored.items())
    assert not any(p.requires_grad for p in again.state.model.encoder.parameters())
    assert all(p.requires_grad for p in again.state.model.decoder.parameters())
    assert again.state.optimizer.state_dict()["state"]  # the moments came back
    again.close()


def _stopped_by_sigterm(argv, at_step: int) -> str:
    """A ``train_seq_clf`` run of ``argv`` that SIGTERM stops inside step
    ``at_step`` (it saves ``last/``); its run directory."""
    trainer, data = train_seq_clf.prepare(argv)
    inner = trainer.train_step

    def step(state, batch, **kwargs):
        out = inner(state, batch, **kwargs)
        if state.step == at_step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = step
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    assert trainer.state.step == at_step
    return trainer.run_dir


def test_transfer_runs_resume_after_sigterm(tmp_path):
    """``--resume`` of a ``--mlm_checkpoint --freeze_encoder`` run, then of
    a ``--clf_checkpoint`` run of it, each stopped by SIGTERM: the run-start
    flags stay in the run's hparams but do not come back, so the resume is
    not refused; it continues from ``last/`` with the freeze to the run's
    ``max_steps``, and the encoder stays the MLM checkpoint's bit for bit."""
    root, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    base = DATA + ["--cpu", "--root", root, "--logdir", logs, "--eval_every_n_steps", "2"]
    mlm_dir = train_mlm.main(TINY + ["--cpu", "--root", root, "--logdir", logs, "--preset",
                                     "reference", "--max_steps", "2", "--predict_samples"])
    mlm_ckpt = f"{mlm_dir}/checkpoints"
    saved, _ = restore_raw_params(mlm_ckpt, resolve_checkpoint_step(mlm_ckpt))
    first = None
    for start, stop, end in ((["--mlm_checkpoint", mlm_ckpt, "--freeze_encoder"], 3, 4),
                             (["--clf_checkpoint", "first"], 5, 6)):
        start = [f"{first}/checkpoints" if x == "first" else x for x in start]
        run_dir = _stopped_by_sigterm(base + start + ["--max_steps", str(end)], stop)
        with open(f"{run_dir}/checkpoints/hparams.json") as f:
            assert json.load(f)[start[0][2:]] == start[1]
        trainer, data = train_seq_clf.prepare(["--cpu", "--resume", run_dir])
        assert trainer.state.step == stop and trainer.run_dir == os.path.abspath(run_dir)
        with trainer:
            trainer.fit(data.train_dataloader(), data.val_dataloader())
        model = trainer.state.model
        assert trainer.state.step == end
        assert not any(p.requires_grad for p in model.encoder.parameters())
        tree = param_tree(model)
        assert all(torch.equal(tree[k], v) for k, v in saved.items() if k.startswith("encoder/"))
        first = run_dir


def test_mlm_checkpoints_without_head_counts_still_load(tmp_path):
    """A ``train_mlm`` run whose hparams predate the head-count flags loads
    for serving and for transfer at 4 heads, as it was trained; the
    builders run on the CUDA card unless asked for the CPU."""
    from perceiver_io_torch.inference.mlm import load_mlm_checkpoint

    run = train_mlm.main(TINY + ["--cpu", "--preset", "reference", "--max_steps", "1",
                                 "--predict_samples", "--root", str(tmp_path),
                                 "--logdir", str(tmp_path / "logs")])
    path = f"{run}/checkpoints/hparams.json"
    with open(path) as f:
        hparams = json.load(f)
    assert hparams.pop("num_cross_attention_heads") == 4
    del hparams["num_self_attention_heads"]
    with open(path, "w") as f:
        json.dump(hparams, f)
    model, params, _ = load_mlm_checkpoint(f"{run}/checkpoints", device="cpu")
    assert model.decoder.cross_attention_layer.cross_attention.attention.num_heads == 4
    assert sorted(params) == sorted(param_tree(model))
    trainer, _ = train_seq_clf.prepare(DATA + ["--cpu", "--root", str(tmp_path), "--logdir",
                                               str(tmp_path / "clf"), "--max_steps", "1",
                                               "--mlm_checkpoint", f"{run}/checkpoints"])
    trainer.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_mlm_checkpoint(f"{run}/checkpoints")


def test_refusals_and_reference_defaults(tmp_path):
    for extra in (["--mlm_checkpoint", "a", "--clf_checkpoint", "b"],
                  ["--resume", str(tmp_path), "--mlm_checkpoint", "a"]):
        with pytest.raises(SystemExit):
            train_seq_clf.prepare(["--cpu", "--max_steps", "1"] + extra)
    ours = train_seq_clf.build_parser().parse_args(["--max_steps", "1"])
    theirs = jax_train_seq_clf.build_parser().parse_args(["--max_steps", "1"])
    for key in ("batch_size", "weight_decay", "dropout", "num_latents", "num_latent_channels",
                "num_encoder_layers", "num_self_attention_layers_per_block", "attn_impl",
                "experiment", "max_seq_len", "vocab_size", "freeze_encoder", "unsafe_load"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert (ours.batch_size, ours.weight_decay, ours.dropout) == (128, 1e-3, 0.1)
    assert common.MODEL_HPARAM_KEYS == jcommon.MODEL_HPARAM_KEYS
    args = argparse.Namespace(num_latents=1, vocab_size=5, dropout=0.3)
    common.override_model_args(args, {"num_latents": 7, "dropout": 0.0, "max_seq_len": 9})
    assert (args.num_latents, args.dropout, args.max_seq_len) == (7, 0.3, 9)
