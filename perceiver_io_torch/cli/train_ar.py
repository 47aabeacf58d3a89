"""Perceiver-AR causal LM pretraining on the CUDA card (the port's subset of
``perceiver_io_tpu/cli/train_ar.py``).

    python -m perceiver_io_torch.cli.train_ar --preset flagship_tpu \\
        --synthetic --max_steps 30

Trains :class:`~perceiver_io_torch.models.perceiver.PerceiverARLM` on
next-token prediction over a causal latent window covering the last
``--num_latents`` positions of each sequence, on the IMDB text pipeline
(``--synthetic`` works offline). ``--preset`` fills the widths the flags
leave unset: ``reference`` is 64 latents × 64 channels (head depth 16),
``flagship_tpu`` the ``flagship_ar`` widths, 256 latents × 512 channels
(head depth 128). The vocab head has a row for each piece the tokenizer
learned, as the JAX CLI builds it. ``--attn_impl`` defaults to the presets'
``auto``, as the JAX CLI's, which sends every causal call to the einsum path;
``pallas`` takes every causal call through the attention kernels' causal
offset (the forward and both backward kernels); ``packed`` takes no causal
offset and raises ``ValueError``. ``--dropout`` and the optimizer flags are
the MLM CLI's; ``--remat`` and ``--no_reuse_kv`` are accepted and, as in the
JAX CLI, do not touch the AR model. After each validation the sample hook
continues the first ``--sample_prefix_len`` tokens of the first validation
row by ``--sample_new_tokens`` greedy tokens through ``ARGenerator`` and logs
them as a ``continuation`` text row. ``--bucket_widths`` pads each batch to
its bucket, so a short review's latent window covers its text (at
``--max_seq_len 512`` without buckets the synthetic reviews leave the window
all padding). Runs on the CUDA card; ``--cpu`` runs the kernels' plain
versions. Writes ``metrics.jsonl`` and ``checkpoints/`` under
``<logdir>/<experiment>/version_n`` (experiment ``ar``); ``--resume <that
dir>`` continues the run, and ``cli.serve --task generate --checkpoint <that
dir>/checkpoints`` serves it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from perceiver_io_torch.cli import common
from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.inference.generate import ARGenerator, SamplingConfig
from perceiver_io_torch.training.steps import make_ar_steps
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.training.trainer import Trainer

# the JAX CLI's presets (perceiver_io_tpu/cli/train_ar.py)
PRESET_DEFAULTS = {
    "reference": {"num_latents": 64, "num_latent_channels": 64, "attn_impl": "auto"},
    "flagship_tpu": {"num_latents": 256, "num_latent_channels": 512, "attn_impl": "auto"},
}


def apply_preset(args: argparse.Namespace) -> argparse.Namespace:
    """Fill any still-None width or attention arg from the chosen preset."""
    for key, value in PRESET_DEFAULTS[args.preset].items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    return args


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_trainer_args(parser)
    common.add_compute_args(parser)
    common.add_model_args(parser)
    common.add_optimizer_args(parser)
    common.add_imdb_args(parser)
    g = parser.add_argument_group("task (AR generation)")
    g.add_argument("--preset", choices=sorted(PRESET_DEFAULTS), default="reference",
                   help="model-width preset; explicit width flags override")
    g.add_argument("--sample_prefix_len", type=int, default=16,
                   help="after each validation, continue this many tokens of the first "
                        "validation row (0 disables the hook)")
    g.add_argument("--sample_new_tokens", type=int, default=12)
    parser.set_defaults(experiment="ar")
    return parser


def make_sample_hook(collator, prefix_len: int, new_tokens: int, example_ids: np.ndarray):
    """The sample hook: greedy-continue the first ``prefix_len`` tokens of
    ``example_ids`` (pad id 0 dropped) by ``new_tokens`` through
    ``ARGenerator`` over the state's model, logged as a ``continuation``
    text row."""
    if prefix_len <= 0 or new_tokens <= 0:
        return None
    prefix = [int(t) for t in example_ids[:prefix_len] if int(t) != 0]
    if len(prefix) < 2:
        return None
    tokenizer = collator.tokenizer

    def hook(state, logger, step):
        gen = ARGenerator(state.model, None, max_seq_len=collator.max_seq_len,
                          chunk=min(8, new_tokens),
                          device=next(state.model.parameters()).device)
        tokens, _ = gen.generate(prefix, new_tokens, SamplingConfig())
        text = " ".join(tokenizer.id_to_token(int(t)) for t in tokens)
        logger.log_text("continuation", step, f"prefix({len(prefix)} toks) → {text}")

    return hook


def prepare(argv: Optional[Sequence[str]] = None):
    """The run ``main`` fits, built from ``argv`` and not yet started:
    ``(trainer, data)``, the data module set up and, with ``--resume``, the
    train state restored."""
    args = apply_preset(common.parse_with_resume(build_parser(), argv))
    common.check_attn_impl(args)
    device = resolve_device("cpu" if args.cpu else None)
    data = common.data_module(args)

    model = common.build_ar(args, data.tokenizer.get_vocab_size(), args.max_seq_len, device)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=args.seed + 2)
    state, resume_dir = common.resume_state(args, state)
    train_step, eval_step, _ = make_ar_steps(model, schedule)
    example = next(iter(data.val_dataloader()))
    trainer = Trainer(train_step, eval_step, state, common.trainer_config(args),
                      tokens_per_example=args.max_seq_len, hparams=vars(args),
                      predict_hook=make_sample_hook(data.collator, args.sample_prefix_len,
                                                    args.sample_new_tokens,
                                                    np.asarray(example["token_ids"][0])),
                      run_dir=resume_dir)
    return trainer, data


def main(argv: Optional[Sequence[str]] = None):
    trainer, data = prepare(argv)
    with trainer:
        common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
    return trainer.run_dir


if __name__ == "__main__":
    main()
