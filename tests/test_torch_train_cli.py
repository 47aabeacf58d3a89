"""The port's training entry point and its data on the CPU: the IMDB data
module gives the JAX package's batches (same tokenizer ids, same seeded
shuffle), the trainer writes ``metrics.jsonl``, and the CLI trains a tiny
model with ``--cpu`` (each ``--fused_head``, a padded vocab head), resolves
``--fused_head auto`` by device and width, needs a card without ``--cpu``,
trains with ``--dropout``, ``--remat`` and every ``--attn_impl`` the port
has (``auto``, ``xla``, ``pallas``, ``packed``) and refuses ``pallas_sp``.
Against the JAX CLI on the same flags: the vocab head has the tokenizer's
size, validation runs at the same steps (per epoch, or every N steps plus
the tail), the presets pick the same attention, and from the JAX run's
initial weights, with a masking both packages draw alike, ``--optimizer
SGD --momentum 0.9 --accumulate_steps 2`` (and the other new flags) give
the JAX CLI's validation losses at f32."""

import json

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

import jax
import jax.numpy as jnp

from perceiver_io_tpu.cli import common as jax_common
from perceiver_io_tpu.cli import train_mlm as jax_train_mlm
from perceiver_io_tpu.data.imdb import IMDBDataModule as JaxIMDBDataModule
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics
from perceiver_io_torch.cli import common
from perceiver_io_torch.cli import train_mlm
from perceiver_io_torch.data.imdb import IMDBDataModule
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.models import presets
from perceiver_io_torch.ops import attention as pat
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import ce_kernel as ck
from perceiver_io_torch.ops import packed_attention_kernel as pk

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
    # step 2, and the final partial interval at step 3, as the JAX trainer does
    assert [r["step"] for r in val] == [2, 3] and np.isfinite([r["val_loss"] for r in val]).all()


def test_cli_needs_a_card_and_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """``--dropout 0.1`` trains (its training calls on the einsum path, the
    validation's not: evaluation runs without dropout); ``pallas_sp`` exits
    naming its ROADMAP item; without ``--cpu`` the CLI needs a card."""
    args = TINY + ["--max_steps", "1", "--root", str(tmp_path),
                   "--logdir", str(tmp_path / "logs")]
    pat.xla_counter.reset()
    run_dir = train_mlm.main(args + ["--cpu", "--dropout", "0.1", "--attn_impl", "pallas"])
    rows = [json.loads(line) for line in open(f"{run_dir}/metrics.jsonl")]
    assert np.isfinite([r.get("train_loss", r.get("val_loss")) for r in rows
                        if "tag" not in r]).all()  # text rows: the sample hook
    assert pat.xla_counter.calls == 5  # one training forward: 2 cross + 2 self + 1 decoder
    with pytest.raises(SystemExit, match="ROADMAP Queue 1 item 8"):
        train_mlm.main(args + ["--cpu", "--attn_impl", "pallas_sp"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mlm.main(args)


@pytest.mark.parametrize("flags,ce_calls", [(["--fused_head", "pallas"], 1),
                                            (["--fused_head", "xla"], 0),
                                            (["--pad_vocab_multiple", "128"], 0)])
def test_cli_trains_the_fused_heads_and_a_padded_vocab(tmp_path, flags, ce_calls):
    """One step with each fused head, and with the vocab head padded to a
    multiple of 128 (``--cpu`` resolves ``auto`` to the unfused head): a
    finite loss; ``pallas`` goes through the CE kernels' wrappers (their
    plain versions on the CPU), ``xla`` and the unfused head do not."""
    counters = (ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)
    for c in counters:
        c.reset()
    run_dir = train_mlm.main(TINY + ["--cpu", "--max_steps", "1", "--root", str(tmp_path),
                                     "--logdir", str(tmp_path / "logs")] + flags)
    rows = [json.loads(line) for line in open(f"{run_dir}/metrics.jsonl")]
    assert np.isfinite([r["train_loss"] for r in rows if "train_loss" in r]).all()
    assert np.isfinite([r["val_loss"] for r in rows if "val_loss" in r]).all()
    assert [c.plain_calls for c in counters][1:] == [ce_calls] * 2
    assert counters[0].plain_calls >= ce_calls and not any(c.launches for c in counters)


def test_fused_head_auto_resolves_by_device_and_width():
    """``auto``: the CE kernels on the CUDA card at C <= 128, the unfused
    head on the CPU or at C > 128; an explicit choice stands."""
    resolve = train_mlm.resolve_fused_head
    assert resolve("auto", torch.device("cuda"), 64) == "pallas"
    assert resolve("auto", "cuda:0", 128) == "pallas"
    assert resolve("auto", torch.device("cuda"), 512) == "off"
    assert resolve("auto", torch.device("cpu"), 64) == "off"
    assert resolve("pallas", torch.device("cpu"), 512) == "pallas"
    assert resolve("xla", torch.device("cuda"), 64) == "xla"


def test_presets_fill_only_the_unset_widths():
    args = train_mlm.apply_preset(train_mlm.build_parser().parse_args(
        ["--preset", "flagship_tpu", "--max_steps", "1", "--num_latents", "32"]))
    assert (args.num_latents, args.num_latent_channels) == (32, 512)
    assert (args.batch_size, args.max_seq_len, args.fused_head) == (64, 512, "auto")


def test_cli_trains_with_packed_attention(tmp_path):
    """``--attn_impl packed``: one step of the tiny shape through the packed
    kernels' wrappers (their plain versions on the CPU), a finite loss, no
    call of the fused attention wrappers."""
    counters = (pk.fwd_counter, pk.dq_counter, pk.dkv_counter, ak.counter, ak.dq_counter)
    for c in counters:
        c.reset()
    run_dir = train_mlm.main(TINY + ["--cpu", "--attn_impl", "packed", "--max_steps", "1",
                                     "--root", str(tmp_path), "--logdir", str(tmp_path / "logs")])
    rows = [json.loads(line) for line in open(f"{run_dir}/metrics.jsonl")]
    assert np.isfinite([r["train_loss"] for r in rows if "train_loss" in r]).all()
    # 2 encoder cross + 2 self + 1 decoder per forward
    assert [c.plain_calls for c in counters][1:] == [5, 5, 0, 0]
    assert counters[0].plain_calls > 5 and not any(c.launches for c in counters)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas_sp"])
def test_cli_refuses_unported_attn_impls(tmp_path, impl):
    """``auto`` and ``xla`` train (one step and its validation, every call
    of these tiny shapes on the einsum path); ``pallas_sp`` is not ported
    and exits."""
    args = TINY + ["--cpu", "--attn_impl", impl, "--max_steps", "1", "--root", str(tmp_path),
                   "--logdir", str(tmp_path / "logs")]
    if impl == "pallas_sp":
        with pytest.raises(SystemExit, match="not ported yet"):
            train_mlm.main(args)
        return
    for c in (pat.xla_counter, ak.counter, ak.dq_counter):
        c.reset()
    run_dir = train_mlm.main(args)
    rows = [json.loads(line) for line in open(f"{run_dir}/metrics.jsonl")]
    assert np.isfinite([r.get("train_loss", r.get("val_loss")) for r in rows
                        if "tag" not in r]).all()  # text rows: the sample hook
    assert pat.xla_counter.calls > 5 and ak.counter.plain_calls == ak.dq_counter.plain_calls == 0


# flags both CLIs take: 64 synthetic texts in batches of 32 are two steps an
# epoch; the tokenizer's target is above what the small corpus yields
BOTH = ["--preset", "reference", "--synthetic", "--synthetic_size", "64", "--batch_size", "32",
        "--max_seq_len", "48", "--vocab_size", "1000", "--num_latents", "8",
        "--num_latent_channels", "16", "--num_encoder_layers", "2",
        "--num_self_attention_layers_per_block", "1", "--log_every_n_steps", "1",
        "--dtype", "float32"]


def _spy_vocab(monkeypatch, module) -> list:
    """Records the vocab size each ``build_mlm`` call of ``module`` gets."""
    seen, build = [], module.build_mlm

    def spy(args, vocab_size, *rest, **kwargs):
        seen.append(vocab_size)
        return build(args, vocab_size, *rest, **kwargs)

    monkeypatch.setattr(module, "build_mlm", spy)
    return seen


@pytest.mark.parametrize("flags,val_steps", [(["--max_steps", "5"], [2, 4, 5]),
                                             (["--max_steps", "3", "--eval_every_n_steps", "2"],
                                              [2, 3])])
def test_cli_vocab_and_validation_steps_match_jax(tmp_path, monkeypatch, flags, val_steps):
    """The two CLIs on the same flags, over more than one epoch: both build
    the vocab head at the tokenizer's size (below ``--vocab_size``), and
    validate at the same steps: at each epoch's end and at ``max_steps``
    with ``--eval_every_n_steps`` unset; at each multiple and at the tail
    with it set."""
    jax_vocab = _spy_vocab(monkeypatch, jax_common)
    port_vocab = _spy_vocab(monkeypatch, common)
    jax_dir = jax_train_mlm.main(BOTH + flags + ["--root", str(tmp_path / "jax"),
                                                 "--logdir", str(tmp_path / "jax_logs")])
    port_dir = train_mlm.main(BOTH + flags + ["--cpu", "--root", str(tmp_path / "port"),
                                              "--logdir", str(tmp_path / "port_logs")])
    module = IMDBDataModule(root=str(tmp_path / "port"), max_seq_len=48, vocab_size=1000,
                            synthetic=True, synthetic_size=64)
    module.setup()
    assert port_vocab == jax_vocab == [module.tokenizer.get_vocab_size()]
    assert port_vocab[0] < 1000
    jax_val = [r["step"] for r in read_metrics(jax_dir) if "val_loss" in r]
    port_val = [json.loads(line)["step"] for line in open(f"{port_dir}/metrics.jsonl")
                if "val_loss" in line]
    assert port_val == jax_val == val_steps


def test_presets_pick_the_jax_cli_attention():
    """One command line, one function: each preset's ``--attn_impl`` is the
    JAX CLI's, and an explicit flag overrides it."""
    for preset in ("reference", "flagship_tpu"):
        argv = ["--preset", preset, "--max_steps", "1"]
        ours = train_mlm.apply_preset(train_mlm.build_parser().parse_args(argv))
        theirs = jax_train_mlm.apply_preset(jax_train_mlm.build_parser().parse_args(argv))
        assert ours.attn_impl == theirs.attn_impl == {"reference": "auto",
                                                      "flagship_tpu": "xla"}[preset]
        for flag in ("dropout", "optimizer", "momentum", "one_cycle_pct_start",
                     "accumulate_steps", "remat", "no_reuse_kv"):
            assert getattr(ours, flag) == getattr(theirs, flag), flag
    args = train_mlm.apply_preset(train_mlm.build_parser().parse_args(
        ["--preset", "flagship_tpu", "--max_steps", "1", "--attn_impl", "pallas"]))
    assert args.attn_impl == "pallas"


class _JaxRuleMasking:
    """Masks every non-pad position p with p % 5 == 2 (label: its token):
    a masking both packages draw alike, so their losses can be compared."""

    def __init__(self, **_):
        pass

    def __call__(self, key, x, pad):
        sel = (jnp.arange(x.shape[1])[None, :] % 5 == 2) & ~pad
        return jnp.where(sel, 2, x), jnp.where(sel, x, -100)


class _RuleMasking:
    """The port's twin of :class:`_JaxRuleMasking`."""

    def __init__(self, *_, **__):
        pass

    def __call__(self, generator, x, pad):
        sel = (torch.arange(x.shape[1])[None, :] % 5 == 2) & ~pad
        return torch.where(sel, 2, x), torch.where(sel, x.long(), -100)


def _carry_jax_init(monkeypatch, jax_cli_module, port_common, builder: str) -> None:
    """The port's CLI starts from the weights the JAX CLI's run drew."""
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)  # the trainer donates its buffers
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = getattr(port_common, builder)

    def carried(*args, **kwargs):
        return from_jax_params(build(*args, **kwargs), seen["params"])

    monkeypatch.setattr(port_common, builder, carried)


@pytest.mark.parametrize("flags", [
    ["--optimizer", "SGD", "--momentum", "0.9", "--accumulate_steps", "2",
     "--learning_rate", "0.05"],
    ["--optimizer", "RAdam", "--one_cycle_lr", "--one_cycle_pct_start", "0.3", "--remat",
     "--no_reuse_kv", "--weight_decay", "0.01", "--learning_rate", "0.03"]])
def test_cli_val_losses_match_jax(tmp_path, monkeypatch, flags):
    """Both CLIs on the same flags (the reference preset's ``auto``
    attention, f32) from the JAX run's initial weights, with the rule
    masking on both sides: validation at steps 2 and 4 gives the JAX CLI's
    losses within 1e-4 relative."""
    monkeypatch.setattr(jax_common, "TextMasking", _JaxRuleMasking)
    monkeypatch.setattr(presets, "TextMasking", _RuleMasking)
    _carry_jax_init(monkeypatch, jax_train_mlm, common, "build_mlm")
    run = BOTH + flags + ["--max_steps", "4", "--eval_every_n_steps", "2"]
    jax_dir = jax_train_mlm.main(run + ["--root", str(tmp_path / "jax"),
                                        "--logdir", str(tmp_path / "jax_logs")])
    port_dir = train_mlm.main(run + ["--cpu", "--root", str(tmp_path / "port"),
                                     "--logdir", str(tmp_path / "port_logs")])
    jax_val = [(r["step"], r["val_loss"]) for r in read_metrics(jax_dir) if "val_loss" in r]
    port_val = [(r["step"], r["val_loss"]) for r in
                map(json.loads, open(f"{port_dir}/metrics.jsonl")) if "val_loss" in r]
    assert [s for s, _ in port_val] == [s for s, _ in jax_val] == [2, 4]
    np.testing.assert_allclose([v for _, v in port_val], [v for _, v in jax_val], rtol=1e-4)
    # the weights moved: the second validation is not the first
    assert abs(port_val[1][1] - port_val[0][1]) > 1e-3
