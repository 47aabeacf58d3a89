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
JAX CLI, do not touch the AR model. Runs on the CUDA card; ``--cpu`` runs the
kernels' plain versions. Writes ``metrics.jsonl`` under
``<logdir>/ar/version_n``. The JAX CLI's sample hook
(``--sample_prefix_len``, ``--sample_new_tokens``) is not ported.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from perceiver_io_torch.cli import common
from perceiver_io_torch.data.imdb import IMDBDataModule
from perceiver_io_torch.device import resolve_device
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
    return parser


def prepare(argv: Optional[Sequence[str]] = None):
    """The run ``main`` fits, built from ``argv`` and not yet started:
    ``(trainer, data)``, the data module set up."""
    args = apply_preset(build_parser().parse_args(argv))
    common.check_attn_impl(args)
    device = resolve_device("cpu" if args.cpu else None)

    data = IMDBDataModule(root=args.root, max_seq_len=args.max_seq_len,
                          vocab_size=args.vocab_size, batch_size=args.batch_size,
                          synthetic=args.synthetic, synthetic_size=args.synthetic_size,
                          seed=args.seed)
    data.prepare_data()
    data.setup()

    model = common.build_ar(args, data.tokenizer.get_vocab_size(), args.max_seq_len, device)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=args.seed + 2)
    train_step, eval_step, _ = make_ar_steps(model, schedule)
    trainer = Trainer(train_step, eval_step, state, common.trainer_config(args, "ar"),
                      tokens_per_example=args.max_seq_len)
    return trainer, data


def main(argv: Optional[Sequence[str]] = None):
    trainer, data = prepare(argv)
    trainer.fit(data.train_dataloader(), data.val_dataloader())
    return trainer.run_dir


if __name__ == "__main__":
    main()
