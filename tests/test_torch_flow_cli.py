"""The port's optical-flow CLI (``perceiver_io_torch/cli/train_flow.py``)
against the JAX package's, on the CPU:

- the defaults, the Perceiver IO paper's flow configuration (368 × 496 × 3,
  patch 3, 64 bands, 2048 × 512 latents, 1 encoder layer of 24 self layers,
  1 cross head, 8 self heads, batch 8, bf16, ``--attn_impl auto``), the
  same as the JAX CLI's;
- both CLIs on the same flags (9 × 11 × 2 synthetic frames, latents
  (8, 32), f32, ``--attn_impl auto``), the port from the JAX run's initial
  weights: validation at steps 2 and 4 with losses within 1e-4 relative;
  the rows and the checkpoint's hparams; then ``--resume`` takes the
  port's run to step 6;
- ``common.build_flow_model`` from the parsed flags; the CLI refuses
  ``--attn_impl pallas_sp``.
"""

import json

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import train_flow as jax_train_flow
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics
from perceiver_io_torch.cli import common, train_flow
from perceiver_io_torch.interop import from_jax_params

TINY = ["--synthetic", "--synthetic_size", "64", "--image_height", "9", "--image_width", "11",
        "--image_channels", "2", "--batch_size", "8", "--num_latents", "8",
        "--num_latent_channels", "32", "--num_self_attention_layers_per_block", "1",
        "--num_cross_attention_heads", "1", "--num_self_attention_heads", "2",
        "--num_frequency_bands", "4", "--dtype", "float32", "--log_every_n_steps", "1",
        "--no_tensorboard"]


def test_flow_defaults_match_jax():
    ours = train_flow.build_parser().parse_args(["--max_steps", "1"])
    theirs = jax_train_flow.build_parser().parse_args(["--max_steps", "1"])
    for key in ("num_latents", "num_latent_channels", "num_encoder_layers",
                "num_self_attention_layers_per_block", "num_cross_attention_heads",
                "num_self_attention_heads", "batch_size", "image_height", "image_width",
                "image_channels", "patch_size", "num_frequency_bands", "synthetic_size",
                "dtype", "attn_impl", "dropout", "experiment", "optimizer", "learning_rate",
                "weight_decay", "root"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert (ours.image_height, ours.image_width, ours.num_latents, ours.num_latent_channels,
            ours.num_self_attention_layers_per_block, ours.num_cross_attention_heads,
            ours.batch_size, ours.dtype, ours.attn_impl) == (368, 496, 2048, 512, 24, 1, 8,
                                                             "bfloat16", "auto")


def test_flow_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the same flags, the port from the JAX run's initial
    weights: validation at steps 2 and 4, losses within 1e-4 relative; then
    ``--resume`` takes the port's run to step 6."""
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)  # the trainer donates its buffers
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = common.build_flow_model
    monkeypatch.setattr(common, "build_flow_model",
                        lambda *a, **k: from_jax_params(build(*a, **k), seen["params"]))
    # both validations' checkpoints kept, so the resume starts from step 4
    # whichever of the two scored better
    run = TINY + ["--max_steps", "4", "--eval_every_n_steps", "2", "--attn_impl", "auto",
                  "--max_to_keep", "2"]
    jax_dir = jax_train_flow.main(run + ["--logdir", str(tmp_path / "jax_logs")])
    port_dir = train_flow.main(run + ["--cpu", "--logdir", str(tmp_path / "port_logs")])
    assert port_dir == str(tmp_path / "port_logs" / "flow" / "version_0")
    jax_val = [(r["step"], r["val_loss"]) for r in read_metrics(jax_dir) if "val_loss" in r]
    rows = [json.loads(line) for line in open(f"{port_dir}/metrics.jsonl")]
    port_val = [(r["step"], r["val_loss"]) for r in rows if "val_loss" in r]
    assert [s for s, _ in port_val] == [s for s, _ in jax_val] == [2, 4]
    np.testing.assert_allclose([v for _, v in port_val], [v for _, v in jax_val], rtol=1e-4)
    assert abs(port_val[1][1] - port_val[0][1]) > 1e-4  # the weights moved
    train = [r for r in rows if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all({"train_loss", "lr", "step_s", "examples_per_sec"} <= set(r) for r in train)
    with open(f"{port_dir}/checkpoints/hparams.json") as f:
        hparams = json.load(f)
    assert (hparams["image_height"], hparams["image_channels"],
            hparams["patch_size"]) == (9, 2, 3)
    train_flow.main(["--cpu", "--max_steps", "6", "--resume", port_dir])
    rows = [json.loads(line) for line in open(f"{port_dir}/metrics.jsonl")]
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2, 3, 4, 5, 6]
    assert [r["step"] for r in rows if "val_loss" in r] == [2, 4, 6]


def test_build_flow_model_follows_the_flags():
    """``common.build_flow_model`` shapes the model from the parsed flags:
    the frame, the patch and the bands set the encoder's input channels,
    the frame the decoder's one query a pixel, the latents and heads their
    layers; a batch of frame pairs gives one flow vector a pixel."""
    args = train_flow.build_parser().parse_args(
        TINY + ["--patch_size", "5", "--num_frequency_bands", "3"])
    model = common.build_flow_model(args, (9, 11, 2), "cpu")
    adapter = model.encoder.input_adapter
    assert (adapter.patch_size, adapter.num_frequency_bands) == (5, 3)
    assert adapter.num_input_channels == 2 * 5**2 * 2 + 2 * (2 * 3 + 1)
    assert tuple(model.encoder.latent.shape) == (8, 32)
    assert tuple(model.decoder.output.shape) == (9 * 11, 32)
    assert model.encoder.layer_1.self_attention_block.num_layers == 1
    x = torch.from_numpy(np.random.default_rng(0).random((3, 2, 9, 11, 2), np.float32))
    with torch.no_grad():
        flow = model(x)
    assert flow.shape == (3, 9, 11, 2) and torch.isfinite(flow).all()


def test_flow_cli_refuses_unported_attention(tmp_path):
    with pytest.raises(SystemExit, match="not ported"):
        train_flow.main(TINY + ["--cpu", "--max_steps", "1", "--attn_impl", "pallas_sp",
                                "--logdir", str(tmp_path)])
