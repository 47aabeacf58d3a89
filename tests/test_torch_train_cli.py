"""The port's training entry point and its data on the CPU: the IMDB data
module gives the JAX package's batches (same tokenizer ids, same seeded
shuffle), the trainer writes ``metrics.jsonl``, and the CLI trains a tiny
model with ``--cpu``, needs a card without it, and raises on what the port
does not have yet (``--fused_head pallas``, ``--dropout``)."""

import json

import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.imdb import IMDBDataModule as JaxIMDBDataModule
from perceiver_io_torch.cli import train_mlm
from perceiver_io_torch.data.imdb import IMDBDataModule

TINY = ["--preset", "reference", "--synthetic", "--batch_size", "32", "--max_seq_len", "48", "--vocab_size", "300",
        "--num_latents", "8", "--num_latent_channels", "16", "--num_encoder_layers", "2",
        "--num_self_attention_layers_per_block", "1", "--log_every_n_steps", "1"]


def test_data_module_batches_match_jax(tmp_path):
    kwargs = dict(max_seq_len=48, vocab_size=300, batch_size=8, synthetic=True,
                  synthetic_size=96, seed=3)
    modules = [JaxIMDBDataModule(root=str(tmp_path / "jax"), **kwargs),
               IMDBDataModule(root=str(tmp_path / "port"), **kwargs)]
    batches = []
    for module in modules:
        module.prepare_data()
        module.setup()
        train = module.train_dataloader()
        batches.append([b for _, b in zip(range(3), train)]
                       + [next(iter(train))]          # the second epoch's shuffle
                       + list(module.val_dataloader()))
    assert len(batches[0]) == len(batches[1]) == 4 + 64 // 8  # validation: 64 texts
    for jb, pb in zip(*batches):
        for key in ("label", "token_ids", "pad_mask"):
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]))


def test_cli_trains_on_the_cpu_and_writes_metrics(tmp_path):
    run_dir = train_mlm.main(TINY + ["--cpu", "--max_steps", "3", "--eval_every_n_steps", "2",
                                     "--grad_clip_norm", "1.0", "--root", str(tmp_path),
                                     "--logdir", str(tmp_path / "logs")])
    assert run_dir == str(tmp_path / "logs" / "mlm" / "version_0")
    rows = [json.loads(line) for line in open(f"{run_dir}/metrics.jsonl")]
    train = [r for r in rows if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    for r in train:
        assert np.isfinite(r["train_loss"]) and r["lr"] == 1e-3
        assert r["step_s"] > 0 and r["tokens_per_sec"] > 0
    val = [r for r in rows if "val_loss" in r]
    assert [r["step"] for r in val] == [2] and np.isfinite(val[0]["val_loss"])


def test_cli_needs_a_card_and_refuses_what_is_not_ported(tmp_path, monkeypatch):
    args = TINY + ["--max_steps", "1", "--root", str(tmp_path),
                   "--logdir", str(tmp_path / "logs")]
    with pytest.raises(SystemExit, match="ROADMAP Queue 2"):
        train_mlm.main(args + ["--cpu", "--fused_head", "pallas"])
    with pytest.raises(SystemExit, match="ROADMAP Queue 1"):
        train_mlm.main(args + ["--cpu", "--dropout", "0.1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mlm.main(args)


def test_presets_fill_only_the_unset_widths():
    args = train_mlm.apply_preset(train_mlm.build_parser().parse_args(
        ["--preset", "flagship_tpu", "--max_steps", "1", "--num_latents", "32"]))
    assert (args.num_latents, args.num_latent_channels) == (32, 512)
    assert (args.batch_size, args.max_seq_len, args.fused_head) == (64, 512, "auto")
