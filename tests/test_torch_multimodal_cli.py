"""The port's multimodal CLI (``perceiver_io_torch/cli/train_multimodal.py``)
against the JAX package's, on the CPU:

- the defaults, the Perceiver IO paper's Kinetics configuration (16 × 224 ×
  224 × 3 video in (1, 4, 4) patches, 30,720 audio samples in patches of
  16, 32 / 64 bands, 8 modality channels, 784 × 512 latents, 1 encoder
  layer of 8 self layers, 1 cross head, 8 self heads, 4 classes, batch 8,
  bf16, ``--attn_impl xla``, synthetic clips), the same as the JAX CLI's;
- both CLIs on the same flags (2 × 8 × 8 × 3 synthetic clips, 64 samples,
  latents (8, 32), f32), the port from the JAX run's initial weights:
  validation at steps 2 and 4 with every ``val_*`` within 1e-4 relative,
  once with the video loss in pixel space under ``--attn_impl xla`` and
  once in patch space under ``pallas`` (the JAX side in interpret mode);
- a run stopped by SIGTERM inside step 3 and resumed to step 6 gives the
  train rows of a run never stopped, bit for bit, and the same last
  validation;
- ``common.build_multimodal_model`` from the parsed flags; the CLI refuses
  ``--attn_impl pallas_sp``, and raises without ``--cpu`` on a machine
  without a CUDA card.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import train_multimodal as jax_train_multimodal
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics
from perceiver_io_torch.cli import common, train_multimodal
from perceiver_io_torch.interop import from_jax_params

TINY = ["--synthetic_size", "40", "--video_frames", "2", "--video_size", "8",
        "--audio_samples", "64", "--samples_per_patch", "8", "--video_frequency_bands", "2",
        "--audio_frequency_bands", "3", "--num_latents", "8", "--num_latent_channels", "32",
        "--num_self_attention_layers_per_block", "1", "--num_self_attention_heads", "2",
        "--batch_size", "8", "--dtype", "float32", "--log_every_n_steps", "1",
        "--no_tensorboard"]
VAL_KEYS = ("val_loss", "val_video_loss", "val_audio_loss", "val_label_loss",
            "val_video_psnr", "val_acc")


def test_multimodal_defaults_match_jax():
    ours = train_multimodal.build_parser().parse_args(["--max_steps", "1"])
    theirs = jax_train_multimodal.build_parser().parse_args(["--max_steps", "1"])
    for key in ("num_latents", "num_latent_channels", "num_encoder_layers",
                "num_self_attention_layers_per_block", "num_cross_attention_heads",
                "num_self_attention_heads", "batch_size", "video_frames", "video_size",
                "video_channels", "audio_samples", "audio_channels", "num_classes",
                "synthetic", "synthetic_size", "samples_per_patch", "num_modality_channels",
                "video_frequency_bands", "audio_frequency_bands", "video_patch_loss",
                "video_weight", "audio_weight", "label_weight", "dtype", "attn_impl",
                "dropout", "experiment", "optimizer", "learning_rate", "weight_decay", "root"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert tuple(ours.video_patch) == tuple(theirs.video_patch) == (1, 4, 4)
    assert (ours.video_frames, ours.video_size, ours.audio_samples, ours.num_latents,
            ours.num_latent_channels, ours.num_self_attention_layers_per_block,
            ours.num_cross_attention_heads, ours.batch_size, ours.dtype, ours.attn_impl,
            ours.synthetic) == (16, 224, 30720, 784, 512, 8, 1, 8, "bfloat16", "xla", True)
    assert train_multimodal.build_parser().parse_args(["--real_data"]).synthetic is False


@pytest.mark.parametrize("impl,patch_loss", [("xla", False), ("pallas", True)])
def test_multimodal_cli_matches_jax(tmp_path, monkeypatch, impl, patch_loss):
    """Both CLIs on the same flags, the port from the JAX run's initial
    weights: validation at steps 2 and 4, every ``val_*`` within 1e-4
    relative; the train rows carry every metric."""
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)  # the trainer donates its buffers
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = common.build_multimodal_model
    monkeypatch.setattr(common, "build_multimodal_model",
                        lambda *a, **k: from_jax_params(build(*a, **k), seen["params"]))
    run = TINY + ["--max_steps", "4", "--eval_every_n_steps", "2", "--attn_impl", impl]
    run += ["--video_patch_loss"] if patch_loss else []
    jax_dir = jax_train_multimodal.main(run + ["--logdir", str(tmp_path / "jax_logs")])
    port_dir = train_multimodal.main(run + ["--cpu", "--logdir", str(tmp_path / "port_logs")])
    assert port_dir == str(tmp_path / "port_logs" / "multimodal" / "version_0")
    jax_val = [r for r in read_metrics(jax_dir) if "val_loss" in r]
    rows = [json.loads(line) for line in open(f"{port_dir}/metrics.jsonl")]
    port_val = [r for r in rows if "val_loss" in r]
    assert [r["step"] for r in port_val] == [r["step"] for r in jax_val] == [2, 4]
    for key in VAL_KEYS:
        np.testing.assert_allclose([r[key] for r in port_val], [r[key] for r in jax_val],
                                   rtol=1e-4, err_msg=key)
    assert abs(port_val[1]["val_loss"] - port_val[0]["val_loss"]) > 1e-4  # the weights moved
    train = [r for r in rows if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all({"train_loss", "video_loss", "audio_loss", "label_loss", "video_psnr",
                "train_acc", "lr", "step_s", "examples_per_sec"} <= set(r) for r in train)
    with open(f"{port_dir}/checkpoints/hparams.json") as f:
        hparams = json.load(f)
    assert (hparams["video_size"], hparams["audio_samples"], hparams["video_patch"],
            hparams["video_patch_loss"]) == (8, 64, [1, 4, 4], patch_loss)


def _stopped_by_sigterm(argv, at_step: int) -> str:
    """A ``train_multimodal`` run of ``argv`` that SIGTERM stops inside step
    ``at_step`` (it saves ``last/``); its run directory."""
    trainer, data = train_multimodal.prepare(argv)
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
    """Stopped inside step 3 (mid-epoch: 35 clips are 4 steps an epoch) and
    resumed to step 6, the run's train rows are those of a run never
    stopped, bit for bit, and its last validation the same."""
    run = TINY + ["--cpu", "--max_steps", "6", "--eval_every_n_steps", "3"]
    whole = train_multimodal.main(run + ["--logdir", str(tmp_path / "whole")])
    stopped = _stopped_by_sigterm(run + ["--logdir", str(tmp_path / "stopped")], 3)
    trainer, data = train_multimodal.prepare(["--cpu", "--resume", stopped])
    assert trainer.state.step == 3
    with trainer:
        trainer.fit(data.train_dataloader(), data.val_dataloader())
    assert trainer.state.step == 6

    def rows(run_dir):
        with open(f"{run_dir}/metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    def train_rows(run_dir):
        return {r["step"]: {k: r[k] for k in ("train_loss", "video_loss", "audio_loss",
                                               "label_loss", "lr")}
                for r in rows(run_dir) if "train_loss" in r}

    assert sorted(train_rows(stopped)) == list(range(1, 7))
    assert train_rows(stopped) == train_rows(whole)
    last = [[r for r in rows(d) if "val_loss" in r][-1] for d in (whole, stopped)]
    assert last[0]["step"] == last[1]["step"] == 6
    assert {k: last[0][k] for k in VAL_KEYS} == {k: last[1][k] for k in VAL_KEYS}


def test_build_multimodal_model_follows_the_flags():
    """``common.build_multimodal_model`` shapes the model from the parsed
    flags: the clip, the patches, the bands and the modality channels set
    the encoder's input width, the patch grid and audio patches the
    decoder's queries, the classes the label head."""
    args = train_multimodal.build_parser().parse_args(
        TINY + ["--video_patch", "2", "4", "2", "--num_modality_channels", "3",
                "--num_classes", "5", "--video_patch_loss"])
    model = common.build_multimodal_model(args, (2, 8, 8, 3), 5, "cpu")
    adapter = model.encoder.input_adapter
    assert adapter.num_input_channels == 2 * 4 * 2 * 3 + 3 * (2 * 2 + 1) + 3
    assert adapter.num_tokens == 1 * 2 * 4 + 64 // 8
    assert tuple(model.decoder.output.shape) == (8 + 8 + 1, 32)
    assert model.decoder.output_adapter.adapters_2_1.linear.kernel.shape == (32, 5)
    video = torch.from_numpy(np.random.default_rng(0).random((3, 2, 8, 8, 3), np.float32))
    audio = torch.zeros(3, 64, 1)
    with torch.no_grad():
        out = model({"video": video, "audio": audio})
    assert out["video"].shape == (3, 8, 48) and out["audio"].shape == (3, 64, 1)
    assert out["label"].shape == (3, 5) and all(torch.isfinite(v).all() for v in out.values())


def test_multimodal_cli_refusals(tmp_path):
    """The CLI refuses ``--attn_impl pallas_sp``, and without ``--cpu`` it
    runs on the CUDA card or raises."""
    with pytest.raises(SystemExit, match="not ported"):
        train_multimodal.main(TINY + ["--cpu", "--max_steps", "1", "--attn_impl", "pallas_sp",
                                      "--logdir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_multimodal.main(TINY + ["--max_steps", "1", "--logdir", str(tmp_path)])
