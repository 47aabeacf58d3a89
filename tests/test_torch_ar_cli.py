"""The port's Perceiver-AR training entry point, ``cli/train_ar.py``, on the
CPU: ``train_ar --cpu --synthetic`` at tiny widths writes ``metrics.jsonl``;
against the JAX CLI on the same flags its vocab head has the tokenizer's
size, its validation runs at the same steps, and from the JAX run's initial
weights its validation losses are the JAX CLI's at f32 (with ``--optimizer
SGD --momentum 0.9 --accumulate_steps 2``, and with NAdam and OneCycle);
``--preset`` fills only the unset widths and the JAX presets' ``auto``
attention, which sends every causal call to the einsum path; ``--dropout``
trains; ``pallas_sp`` exits, and ``packed``, which takes no causal offset,
raises."""

import json

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)

from perceiver_io_tpu.cli import common as jax_common
from perceiver_io_tpu.cli import train_ar as jax_train_ar
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics
from perceiver_io_torch.cli import common, train_ar
from perceiver_io_torch.data.imdb import IMDBDataModule
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.ops import attention as pat
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
    call of the port's run is causal, so under the preset's ``auto`` every
    one takes the einsum path and none the kernels."""
    jax_vocab = _spy_vocab(monkeypatch, jax_common)
    port_vocab = _spy_vocab(monkeypatch, common)
    jax_dir = jax_train_ar.main(BOTH + ["--sample_prefix_len", "0",
                                        "--root", str(tmp_path / "jax"),
                                        "--logdir", str(tmp_path / "jax_logs")])
    for c in (ak.counter, ak.causal_counter, ak.dq_counter, ak.dq_causal_counter,
              pat.xla_counter):
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
    assert pat.xla_counter.calls > 0
    assert ak.counter.plain_calls == ak.causal_counter.plain_calls == 0
    assert ak.dq_counter.plain_calls == ak.dq_causal_counter.plain_calls == 0


def test_cli_trains_through_the_causal_kernels(tmp_path):
    """``--attn_impl pallas``: every attention call of the run goes through
    the kernels' causal path (their plain versions on the CPU), 5 causal
    backward calls a step (2 cross, 2 self and the decode at this depth),
    and none through the einsum path (the sample hook, whose decode steps
    attend with the pad mask alone, is off)."""
    for c in (ak.counter, ak.causal_counter, ak.dq_counter, ak.dq_causal_counter,
              pat.xla_counter):
        c.reset()
    run_dir = train_ar.main(BOTH + ["--cpu", "--attn_impl", "pallas", "--sample_prefix_len", "0",
                                    "--root", str(tmp_path), "--logdir", str(tmp_path / "logs")])
    rows = [json.loads(line) for line in open(f"{run_dir}/metrics.jsonl")]
    assert np.isfinite([r["train_loss"] for r in rows if "train_loss" in r]).all()
    assert ak.counter.plain_calls == ak.causal_counter.plain_calls > 0
    assert ak.dq_counter.plain_calls == ak.dq_causal_counter.plain_calls == 5 * 3
    assert pat.xla_counter.calls == 0


def test_cli_presets_and_refusals(tmp_path):
    """``--preset`` fills only the unset widths and the JAX preset's
    ``auto``; ``--dropout 0.1`` trains (the kernels' causal path with
    ``--attn_impl pallas`` in validation only: training's calls drop
    probabilities on the einsum path); ``pallas_sp`` exits, and ``packed``
    raises the JAX package's ``ValueError`` (it takes no causal offset)."""
    args = train_ar.apply_preset(train_ar.build_parser().parse_args(
        ["--preset", "flagship_tpu", "--max_steps", "1", "--num_latents", "32"]))
    assert (args.num_latents, args.num_latent_channels, args.attn_impl) == (32, 512, "auto")
    assert (args.batch_size, args.max_seq_len, args.num_encoder_layers) == (64, 512, 3)
    theirs = jax_train_ar.apply_preset(jax_train_ar.build_parser().parse_args(
        ["--preset", "flagship_tpu", "--max_steps", "1"]))
    assert theirs.attn_impl == args.attn_impl
    tiny = TINY + ["--cpu", "--max_steps", "1", "--root", str(tmp_path),
                   "--logdir", str(tmp_path / "logs")]
    for c in (ak.causal_counter, ak.dq_causal_counter, pat.xla_counter):
        c.reset()
    run_dir = train_ar.main(tiny + ["--dropout", "0.1", "--attn_impl", "pallas"])
    rows = [json.loads(line) for line in open(f"{run_dir}/metrics.jsonl")]
    assert np.isfinite([r.get("train_loss", r.get("val_loss")) for r in rows
                        if "tag" not in r]).all()  # text rows: the sample hook
    # one training forward on the einsum path (2 cross + 2 self + the
    # decode), validation's forwards on the causal kernel, no kernel backward
    assert pat.xla_counter.calls == 5 and ak.dq_causal_counter.plain_calls == 0
    assert ak.causal_counter.plain_calls > 0 and ak.causal_counter.plain_calls % 5 == 0
    with pytest.raises(SystemExit, match="not ported yet"):
        train_ar.main(tiny + ["--attn_impl", "pallas_sp"])
    with pytest.raises(ValueError, match="does not implement causal_offset"):
        train_ar.main(tiny + ["--attn_impl", "packed"])


@pytest.mark.parametrize("flags", [
    ["--optimizer", "SGD", "--momentum", "0.9", "--accumulate_steps", "2",
     "--learning_rate", "0.05"],
    ["--optimizer", "NAdam", "--one_cycle_lr", "--one_cycle_pct_start", "0.3",
     "--learning_rate", "0.01", "--weight_decay", "0.01"]])
def test_cli_val_losses_match_jax(tmp_path, monkeypatch, flags):
    """Both CLIs on the same flags (the reference preset's ``auto``, f32),
    the port from the JAX run's initial weights: validation at steps 2 and 4
    gives the JAX CLI's losses within 1e-4 relative (AR evaluation draws
    nothing, so no masking stands in)."""
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)  # the trainer donates its buffers
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = common.build_ar
    monkeypatch.setattr(common, "build_ar",
                        lambda *a, **k: from_jax_params(build(*a, **k), seen["params"]))
    run = TINY + flags + ["--max_steps", "4", "--eval_every_n_steps", "2"]
    jax_dir = jax_train_ar.main(run + ["--sample_prefix_len", "0",
                                       "--root", str(tmp_path / "jax"),
                                       "--logdir", str(tmp_path / "jax_logs")])
    port_dir = train_ar.main(run + ["--cpu", "--root", str(tmp_path / "port"),
                                    "--logdir", str(tmp_path / "port_logs")])
    jax_val = [(r["step"], r["val_loss"]) for r in read_metrics(jax_dir) if "val_loss" in r]
    port_val = [(r["step"], r["val_loss"]) for r in
                map(json.loads, open(f"{port_dir}/metrics.jsonl")) if "val_loss" in r]
    assert [s for s, _ in port_val] == [s for s, _ in jax_val] == [2, 4]
    np.testing.assert_allclose([v for _, v in port_val], [v for _, v in jax_val], rtol=1e-4)
    assert abs(port_val[1][1] - port_val[0][1]) > 1e-3
