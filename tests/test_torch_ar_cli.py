"""The port's Perceiver-AR training entry point, ``cli/train_ar.py``, on the
CPU: ``train_ar --cpu --synthetic`` at tiny widths writes ``metrics.jsonl``;
against the JAX CLI on the same flags its vocab head has the tokenizer's
size and its validation runs at the same steps; ``--preset`` fills only the
unset widths; what it refuses (``--dropout``, the attention names the port
lacks, and ``packed``, which takes no causal offset)."""

import json

import numpy as np
import pytest

from perceiver_io_tpu.cli import common as jax_common
from perceiver_io_tpu.cli import train_ar as jax_train_ar
from perceiver_io_tpu.training import read_metrics
from perceiver_io_torch.cli import common, train_ar
from perceiver_io_torch.data.imdb import IMDBDataModule
from perceiver_io_torch.ops import attention_kernel as ak

# flags both CLIs take: 64 synthetic texts in batches of 32 are two steps an
# epoch; the tokenizer's target is above what the small corpus yields
TINY = ["--preset", "reference", "--synthetic", "--synthetic_size", "64", "--batch_size", "32",
        "--max_seq_len", "48", "--vocab_size", "1000", "--num_latents", "8",
        "--num_latent_channels", "16", "--num_encoder_layers", "2",
        "--num_self_attention_layers_per_block", "1", "--log_every_n_steps", "1",
        "--dtype", "float32"]
BOTH = TINY + ["--max_steps", "3", "--eval_every_n_steps", "2"]


def _spy_vocab(monkeypatch, module) -> list:
    """Records the vocab size each ``build_ar`` call of ``module`` gets."""
    seen, build = [], module.build_ar

    def spy(args, vocab_size, *rest, **kwargs):
        seen.append(vocab_size)
        return build(args, vocab_size, *rest, **kwargs)

    monkeypatch.setattr(module, "build_ar", spy)
    return seen


def test_cli_trains_and_matches_the_jax_cli(tmp_path, monkeypatch):
    """``train_ar --cpu`` and the JAX CLI on the same flags: the port writes
    ``<logdir>/ar/version_0/metrics.jsonl`` with finite train losses at
    every step, both build the vocab head at the tokenizer's size (below
    ``--vocab_size``), and both validate at steps 2 and 3. Every attention
    call of the port's run is causal."""
    jax_vocab = _spy_vocab(monkeypatch, jax_common)
    port_vocab = _spy_vocab(monkeypatch, common)
    jax_dir = jax_train_ar.main(BOTH + ["--sample_prefix_len", "0",
                                        "--root", str(tmp_path / "jax"),
                                        "--logdir", str(tmp_path / "jax_logs")])
    for c in (ak.counter, ak.causal_counter, ak.dq_counter, ak.dq_causal_counter):
        c.reset()
    port_dir = train_ar.main(BOTH + ["--cpu", "--root", str(tmp_path / "port"),
                                     "--logdir", str(tmp_path / "port_logs")])
    assert port_dir == str(tmp_path / "port_logs" / "ar" / "version_0")
    module = IMDBDataModule(root=str(tmp_path / "port"), max_seq_len=48, vocab_size=1000,
                            synthetic=True, synthetic_size=64)
    module.setup()
    assert port_vocab == jax_vocab == [module.tokenizer.get_vocab_size()]
    assert port_vocab[0] < 1000
    rows = [json.loads(line) for line in open(f"{port_dir}/metrics.jsonl")]
    train = [r for r in rows if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert np.isfinite([r["train_loss"] for r in train]).all()
    assert all(r["tokens_per_sec"] > 0 for r in train)
    jax_val = [r["step"] for r in read_metrics(jax_dir) if "val_loss" in r]
    assert [r["step"] for r in rows if "val_loss" in r] == jax_val == [2, 3]
    assert ak.counter.plain_calls == ak.causal_counter.plain_calls > 0
    assert ak.dq_counter.plain_calls == ak.dq_causal_counter.plain_calls == 5 * 3


def test_cli_presets_and_refusals(tmp_path):
    """``--preset`` fills only the unset widths; ``--dropout`` and the
    attention names the port lacks exit, and ``packed`` raises the JAX
    package's ``ValueError`` (it takes no causal offset)."""
    args = train_ar.apply_preset(train_ar.build_parser().parse_args(
        ["--preset", "flagship_tpu", "--max_steps", "1", "--num_latents", "32"]))
    assert (args.num_latents, args.num_latent_channels, args.attn_impl) == (32, 512, "pallas")
    assert (args.batch_size, args.max_seq_len, args.num_encoder_layers) == (64, 512, 3)
    tiny = TINY + ["--cpu", "--max_steps", "1", "--root", str(tmp_path),
                   "--logdir", str(tmp_path / "logs")]
    with pytest.raises(SystemExit, match="dropout is not ported"):
        train_ar.main(tiny + ["--dropout", "0.1"])
    with pytest.raises(SystemExit, match="not ported yet"):
        train_ar.main(tiny + ["--attn_impl", "auto"])
    with pytest.raises(ValueError, match="does not implement causal_offset"):
        train_ar.main(tiny + ["--attn_impl", "packed"])
