"""MLM pretraining on the CUDA card (the port's subset of
``perceiver_io_tpu/cli/train_mlm.py``).

    python -m perceiver_io_torch.cli.train_mlm --preset flagship_tpu \\
        --synthetic --max_steps 30

``--preset`` fills the widths the flags leave unset: ``reference`` is 64
latents × 64 channels (head depth 16), ``flagship_tpu`` 256 latents × 512
channels (head depth 128). ``--vocab_size`` is the tokenizer's training
target; the model's vocab head has a row for each piece the tokenizer
learned (``data.tokenizer.get_vocab_size()``, as the JAX CLI builds it: 405
rows on the synthetic corpus). Masked positions decode through the gathered
head at ``--loss_gather_capacity`` (-1 = ``mlm_gather_capacity``) into the
vocab head: ``--fused_head pallas`` is the CE kernels, ``xla`` the chunked
plain-PyTorch head, ``off`` the unfused head, and ``auto`` (the default)
resolves to ``pallas`` on the CUDA card at C <= 128 and to ``off`` otherwise,
as the JAX package's rule does with its accelerator (so ``reference`` trains
through the CE kernels, ``flagship_tpu`` unfused). ``--attn_impl`` picks the
attention, by default the preset's, as the JAX CLI's presets pick it:
``reference`` ``auto`` (the H100 rule, ``ops.attention.auto_attention_impl``),
``flagship_tpu`` ``xla`` (the einsum path); ``pallas`` and ``packed`` are the
kernels. ``--dropout``, ``--remat``, ``--no_reuse_kv``, the eight
``--optimizer`` names with ``--momentum``, ``--one_cycle_pct_start`` and
``--accumulate_steps`` are the JAX CLI's flags. Runs on the CUDA card;
``--cpu`` runs the kernels' plain versions. Writes ``metrics.jsonl`` under
``<logdir>/mlm/version_n``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from perceiver_io_torch.cli import common
from perceiver_io_torch.data.imdb import IMDBDataModule
from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.training.steps import make_mlm_steps, mlm_gather_capacity
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.training.trainer import Trainer

# the JAX CLI's presets (perceiver_io_tpu/cli/train_mlm.py): one command
# line means one function in both packages
PRESET_DEFAULTS = {
    "reference": {"num_latents": 64, "num_latent_channels": 64, "attn_impl": "auto"},
    "flagship_tpu": {"num_latents": 256, "num_latent_channels": 512, "attn_impl": "xla"},
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
    g = parser.add_argument_group("task (MLM)")
    g.add_argument("--preset", choices=sorted(PRESET_DEFAULTS), default="reference")
    g.add_argument("--loss_gather_capacity", type=int, default=-1,
                   help="decode only the masked positions, up to this many per row; "
                        "-1 = auto (2·mask_p·seq_len), 0 = full decode")
    g.add_argument("--fused_head", choices=["auto", "pallas", "xla", "off"], default="auto",
                   help="fuse the vocab projection into the CE: pallas = the CE kernels, "
                        "xla = the chunked plain-PyTorch head, off = unfused; auto = "
                        "pallas on the CUDA card at C <= 128, else off")
    return parser


def resolve_fused_head(choice: str, device, num_latent_channels: int) -> str:
    """``--fused_head`` as the run takes it: ``auto`` is ``pallas`` on the
    CUDA card at C <= 128 and ``off`` elsewhere (the JAX package's rule,
    with the card in its accelerator's place)."""
    if choice != "auto":
        return choice
    on_card = torch.device(device).type == "cuda"
    return "pallas" if on_card and num_latent_channels <= 128 else "off"


def prepare(argv: Optional[Sequence[str]] = None):
    """The run ``main`` fits, built from ``argv`` and not yet started:
    ``(trainer, data)``, the data module set up."""
    args = apply_preset(build_parser().parse_args(argv))
    common.check_attn_impl(args)
    device = resolve_device("cpu" if args.cpu else None)
    fused = resolve_fused_head(args.fused_head, device, args.num_latent_channels)

    data = IMDBDataModule(root=args.root, max_seq_len=args.max_seq_len,
                          vocab_size=args.vocab_size, batch_size=args.batch_size,
                          synthetic=args.synthetic, synthetic_size=args.synthetic_size,
                          seed=args.seed)
    data.prepare_data()
    data.setup()

    model = common.build_mlm(args, data.tokenizer.get_vocab_size(), args.max_seq_len, device)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=args.seed + 2)
    capacity = args.loss_gather_capacity
    if capacity < 0:
        capacity = mlm_gather_capacity(args.max_seq_len)
    train_step, eval_step, _ = make_mlm_steps(
        model, schedule, loss_gather_capacity=capacity or None,
        fused_head={"pallas": "pallas", "xla": True, "off": False}[fused])
    trainer = Trainer(train_step, eval_step, state, common.trainer_config(args, "mlm"),
                      tokens_per_example=args.max_seq_len)
    return trainer, data


def main(argv: Optional[Sequence[str]] = None):
    trainer, data = prepare(argv)
    trainer.fit(data.train_dataloader(), data.val_dataloader())
    return trainer.run_dir


if __name__ == "__main__":
    main()
