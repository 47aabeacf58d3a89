"""The port's ImageNet CLI (``perceiver_io_torch/cli/train_imagenet.py``)
against the JAX package's, on the CPU:

- the defaults, the Perceiver paper's ImageNet configuration (224 × 224 × 3
  images, 64 bands, 512 latents × 1024 channels, 6 encoder layers × 6 self
  layers, one cross head and 8 self heads, batch 64, AdamW 4e-3 with weight
  decay 0.1, ``--num_workers 8``, ``--attn_impl auto``, bf16), the same as
  the JAX CLI's;
- remat is on at ``--image_size`` 64 and above unless ``--no_remat``;
- both CLIs on the same flags (``--synthetic`` 8 × 8 × 3 images, latents
  (8, 32), f32), the port from the JAX run's initial weights: validation
  at steps 2 and 4, ``val_loss`` and ``val_acc`` within 1e-4 relative;
- a run stopped by SIGTERM inside step 3 and resumed to step 6 gives the
  train rows of a run never stopped, bit for bit, and the same last
  validation;
- the CLI refuses ``--attn_impl pallas_sp``, and raises without ``--cpu``
  on a machine without a CUDA card.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import train_imagenet as jax_train_imagenet
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics
from perceiver_io_torch.cli import common, train_imagenet
from perceiver_io_torch.interop import from_jax_params

TINY = ["--synthetic", "--synthetic_size", "40", "--image_size", "8",
        "--num_frequency_bands", "4", "--num_latents", "8", "--num_latent_channels", "32",
        "--num_encoder_layers", "2", "--num_self_attention_layers_per_block", "1",
        "--num_self_attention_heads", "4", "--batch_size", "8", "--num_workers", "2",
        "--dtype", "float32", "--log_every_n_steps", "1", "--no_tensorboard"]


def test_imagenet_defaults_match_jax():
    ours = train_imagenet.build_parser().parse_args([])
    theirs = jax_train_imagenet.build_parser().parse_args([])
    for key in ("num_latents", "num_latent_channels", "num_encoder_layers",
                "num_self_attention_layers_per_block", "num_cross_attention_heads",
                "num_self_attention_heads", "batch_size", "image_size", "num_workers",
                "num_frequency_bands", "synthetic", "synthetic_size", "synthetic_classes",
                "dataset_name", "root", "no_remat", "remat", "dtype", "attn_impl", "dropout",
                "experiment", "optimizer", "learning_rate", "weight_decay", "seed"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert (ours.image_size, ours.num_latents, ours.num_latent_channels,
            ours.num_encoder_layers, ours.num_self_attention_layers_per_block,
            ours.num_cross_attention_heads, ours.num_self_attention_heads, ours.batch_size,
            ours.optimizer, ours.learning_rate, ours.weight_decay, ours.attn_impl,
            ours.dtype) == (224, 512, 1024, 6, 6, 1, 8, 64, "AdamW", 4e-3, 0.1, "auto",
                            "bfloat16")


@pytest.mark.parametrize("size,flags,remat", [(64, [], True), (63, [], False),
                                              (224, ["--no_remat"], False),
                                              (8, ["--remat"], True)])
def test_remat_from_the_image_size(size, flags, remat):
    args = train_imagenet.build_parser().parse_args(
        TINY + ["--image_size", str(size), *flags])
    model = train_imagenet.build_model(args, 10, "cpu")
    assert model.encoder.remat is remat and args.remat is remat


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_imagenet_cli_matches_jax(tmp_path, monkeypatch, impl):
    """Both CLIs on the same flags, the port from the JAX run's initial
    weights: validation at steps 2 and 4 within 1e-4 relative."""
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)  # the trainer donates its buffers
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = common.build_image_classifier
    monkeypatch.setattr(common, "build_image_classifier",
                        lambda *a, **k: from_jax_params(build(*a, **k), seen["params"]))
    run = TINY + ["--max_steps", "4", "--eval_every_n_steps", "2", "--attn_impl", impl]
    jax_dir = jax_train_imagenet.main(run + ["--logdir", str(tmp_path / "jax_logs")])
    port_dir = train_imagenet.main(run + ["--cpu", "--logdir", str(tmp_path / "port_logs")])
    assert port_dir == str(tmp_path / "port_logs" / "imagenet" / "version_0")
    jax_val = [r for r in read_metrics(jax_dir) if "val_loss" in r]
    rows = [json.loads(line) for line in open(f"{port_dir}/metrics.jsonl")]
    port_val = [r for r in rows if "val_loss" in r]
    assert [r["step"] for r in port_val] == [r["step"] for r in jax_val] == [2, 4]
    for key in ("val_loss", "val_acc"):
        np.testing.assert_allclose([r[key] for r in port_val], [r[key] for r in jax_val],
                                   rtol=1e-4, err_msg=key)
    assert abs(port_val[1]["val_loss"] - port_val[0]["val_loss"]) > 1e-4  # the weights moved
    train = [r for r in rows if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all({"train_loss", "train_acc", "lr", "step_s", "examples_per_sec"} <= set(r)
               for r in train)
    with open(f"{port_dir}/checkpoints/hparams.json") as f:
        hparams = json.load(f)
    assert (hparams["image_size"], hparams["num_latent_channels"], hparams["remat"]) == (
        8, 32, False)


def _stopped_by_sigterm(argv, at_step: int) -> str:
    """A ``train_imagenet`` run of ``argv`` that SIGTERM stops inside step
    ``at_step`` (it saves ``last/``); its run directory."""
    trainer, data = train_imagenet.prepare(argv)
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


def test_sigterm_and_resume_match_an_unstopped_run(tmp_path):
    """Stopped inside step 3 (mid-epoch: 40 images are 5 steps an epoch) and
    resumed to step 6 (into the second epoch), the run's train rows are
    those of a run never stopped, bit for bit, and its last validation the
    same."""
    run = TINY + ["--cpu", "--max_steps", "6", "--eval_every_n_steps", "3"]
    whole = train_imagenet.main(run + ["--logdir", str(tmp_path / "whole")])
    stopped = _stopped_by_sigterm(run + ["--logdir", str(tmp_path / "stopped")], 3)
    trainer, data = train_imagenet.prepare(["--cpu", "--resume", stopped])
    assert trainer.state.step == 3
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    assert trainer.state.step == 6

    def rows(run_dir):
        with open(f"{run_dir}/metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    def train_rows(run_dir):
        return {r["step"]: {k: r[k] for k in ("train_loss", "train_acc", "lr")}
                for r in rows(run_dir) if "train_loss" in r}

    assert sorted(train_rows(stopped)) == list(range(1, 7))
    assert train_rows(stopped) == train_rows(whole)
    last = [[r for r in rows(d) if "val_loss" in r][-1] for d in (whole, stopped)]
    assert last[0]["step"] == last[1]["step"] == 6
    assert {k: last[0][k] for k in ("val_loss", "val_acc")} == \
        {k: last[1][k] for k in ("val_loss", "val_acc")}


def test_imagenet_cli_refusals(tmp_path):
    """The CLI refuses ``--attn_impl pallas_sp``, and without ``--cpu`` it
    runs on the CUDA card or raises."""
    with pytest.raises(SystemExit, match="not ported"):
        train_imagenet.main(TINY + ["--cpu", "--max_steps", "1", "--attn_impl", "pallas_sp",
                                    "--logdir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_imagenet.main(TINY + ["--max_steps", "1", "--logdir", str(tmp_path)])
