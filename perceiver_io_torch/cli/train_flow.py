"""Optical-flow training on the CUDA card (the port of
``perceiver_io_tpu/cli/train_flow.py``).

    python -m perceiver_io_torch.cli.train_flow --synthetic --max_steps 30

The JAX CLI's defaults, the Perceiver IO paper's flow configuration: a
368 × 496 × 3 frame pair (182,528 tokens of 2·3²·3 = 54 patch channels and
2·(2·64+1) = 258 Fourier channels), 2048 × 512 latents, 1 encoder layer of
one cross-attention head of depth 512 and 24 self-attention layers of 8
heads of depth 64, one decoder query per pixel with one head of depth 512,
batch 8, bf16, ``--attn_impl auto`` (the H100 rule,
``ops.attention.auto_attention_impl``, call by call: at batch 8 both
crosses take the attention kernels' D=512 design). The loss is the mean
end-point error. ``--synthetic`` trains on smooth random flow fields
(``--synthetic_size`` pairs, an eighth held out); otherwise the MPI-Sintel
tree must lie under ``<root>/Sintel`` (nothing is downloaded). Runs on the
CUDA card; ``--cpu`` runs the kernels' plain versions. Writes
``metrics.jsonl`` (``train_loss``, ``val_loss``) and ``checkpoints/`` under
``<logdir>/flow/version_n``; ``--resume <that dir>`` continues it, and
SIGTERM saves ``checkpoints/last/<step>`` at the next step boundary.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from perceiver_io_torch.cli import common
from perceiver_io_torch.data.flow import FlowDataModule
from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.training.steps import make_flow_steps
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.training.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_trainer_args(parser)
    common.add_compute_args(parser)
    common.add_model_args(parser)
    common.add_optimizer_args(parser)
    g = parser.add_argument_group("data (optical flow)")
    g.add_argument("--root", default=".cache",
                   help="holds the MPI-Sintel tree under <root>/Sintel")
    g.add_argument("--batch_size", type=int, default=8)
    g.add_argument("--image_height", type=int, default=368)
    g.add_argument("--image_width", type=int, default=496)
    g.add_argument("--image_channels", type=int, default=3)
    g.add_argument("--synthetic", action="store_true",
                   help="smooth random flow fields instead of Sintel")
    g.add_argument("--synthetic_size", type=int, default=512)
    t = parser.add_argument_group("task (optical flow)")
    t.add_argument("--patch_size", type=int, default=3)
    t.add_argument("--num_frequency_bands", type=int, default=64)
    parser.set_defaults(experiment="flow", num_latents=2048, num_latent_channels=512,
                        num_encoder_layers=1, num_self_attention_layers_per_block=24,
                        num_cross_attention_heads=1, num_self_attention_heads=8,
                        attn_impl="auto")
    return parser


def prepare(argv: Optional[Sequence[str]] = None):
    """The run ``main`` fits, built from ``argv`` and not yet started:
    ``(trainer, data)``, the data module set up and, with ``--resume``, the
    train state restored."""
    args = common.parse_with_resume(build_parser(), argv)
    common.check_attn_impl(args)
    device = resolve_device("cpu" if args.cpu else None)
    image_shape = (args.image_height, args.image_width, args.image_channels)
    data = FlowDataModule(root=args.root, image_shape=image_shape,
                          batch_size=args.batch_size, synthetic=args.synthetic,
                          synthetic_size=args.synthetic_size, seed=args.seed)
    data.prepare_data()
    data.setup()
    model = common.build_flow_model(args, image_shape, device)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=args.seed + 2)
    state, resume_dir = common.resume_state(args, state)
    train_step, eval_step = make_flow_steps(model, schedule)
    trainer = Trainer(train_step, eval_step, state, common.trainer_config(args),
                      hparams=vars(args), run_dir=resume_dir)
    return trainer, data


def main(argv: Optional[Sequence[str]] = None):
    trainer, data = prepare(argv)
    with trainer:
        common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
    return trainer.run_dir


if __name__ == "__main__":
    main()
