"""ImageNet classification on the CUDA card (the port of
``perceiver_io_tpu/cli/train_imagenet.py``).

    python -m perceiver_io_torch.cli.train_imagenet --synthetic --max_steps 30

The JAX CLI's defaults, the Perceiver paper's ImageNet configuration: 224 ×
224 × 3 images (50,176 pixel positions, each its 3 values and 2·(2·64+1) =
258 Fourier channels: 261 input channels), 512 latents × 1024 channels, 6
encoder layers (layer 1 its own, layers 2..6 one shared weight set that
reuses one K/V projection of the pixels), each a cross-attention of one head
of depth 1024 and 6 self-attention layers of 8 heads of depth 128, a
one-query class decoder of one head of depth 1024, batch 64, bf16, AdamW at
4e-3 with weight decay 0.1, ``--attn_impl auto`` (the H100 rule,
``ops.attention.auto_attention_impl``, call by call: the JAX rule's line
sends the D=1024 crosses to the einsum path, the self layers to the
kernels; ``--attn_impl pallas`` runs the crosses on the attention kernels'
D=1024 design). Remat (each encoder layer recomputed in the backward) is on
at ``--image_size`` 64 and above unless ``--no_remat``. ``--synthetic``
trains on class templates plus noise (``--synthetic_size`` images of
``--synthetic_classes`` classes, an eighth more held out); otherwise the
ImageFolder tree must lie under ``<root>/<dataset_name>/{train,val}``
(nothing is downloaded; reading it needs Pillow). ``--num_workers`` threads
decode each batch. Runs on the CUDA card; ``--cpu`` runs the kernels' plain
versions. Writes ``metrics.jsonl`` (``train_loss``, ``train_acc``,
``val_loss``, ``val_acc``) and ``checkpoints/`` under
``<logdir>/imagenet/version_n``; ``--resume <that dir>`` continues it, and
SIGTERM saves ``checkpoints/last/<step>`` at the next step boundary.

One process, one card: the JAX CLI's mesh and multi-host flags (data and
sequence parallelism, host sharding of the loader) come with the
distribution slice (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from perceiver_io_torch.cli import common
from perceiver_io_torch.data.imagefolder import ImageFolderDataModule
from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.training.steps import make_classifier_steps
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.training.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_trainer_args(parser)
    common.add_compute_args(parser)
    common.add_model_args(parser)
    common.add_optimizer_args(parser)
    g = parser.add_argument_group("data (ImageFolder)")
    g.add_argument("--root", default=".cache")
    g.add_argument("--dataset_name", default="imagenet",
                   help="subdirectory of --root holding the train/val tree")
    g.add_argument("--image_size", type=int, default=224)
    g.add_argument("--batch_size", type=int, default=64)
    g.add_argument("--num_workers", type=int, default=8,
                   help="threads that decode a batch's images")
    g.add_argument("--synthetic", action="store_true")
    g.add_argument("--synthetic_size", type=int, default=4096)
    g.add_argument("--synthetic_classes", type=int, default=10)
    t = parser.add_argument_group("task (ImageNet classification)")
    t.add_argument("--num_frequency_bands", type=int, default=64)
    t.add_argument("--no_remat", action="store_true",
                   help="disable the remat-by-default applied at image_size >= 64")
    parser.set_defaults(experiment="imagenet", num_latents=512, num_latent_channels=1024,
                        num_encoder_layers=6, num_self_attention_layers_per_block=6,
                        num_cross_attention_heads=1, num_self_attention_heads=8,
                        weight_decay=1e-1, optimizer="AdamW", learning_rate=4e-3,
                        attn_impl="auto")
    return parser


def apply_remat_default(args) -> None:
    """Remat on at ``image_size >= 64`` unless ``--no_remat`` (the JAX CLI's
    rule: at 50,176 pixels the encoder's activations dominate memory)."""
    if args.image_size >= 64 and not args.no_remat:
        args.remat = True


def build_model(args, num_classes: int, device):
    """The classifier of the parsed flags (the remat default applied),
    weights drawn from ``--seed``."""
    apply_remat_default(args)
    return common.build_image_classifier(
        args, (args.image_size, args.image_size, 3), num_classes, device,
        num_frequency_bands=args.num_frequency_bands)


def prepare(argv: Optional[Sequence[str]] = None):
    """The run ``main`` fits, built from ``argv`` and not yet started:
    ``(trainer, data)``, the data module set up and, with ``--resume``, the
    train state restored."""
    args = common.parse_with_resume(build_parser(), argv)
    common.check_attn_impl(args)
    device = resolve_device("cpu" if args.cpu else None)
    data = ImageFolderDataModule(
        root=args.root, name=args.dataset_name, image_size=args.image_size,
        batch_size=args.batch_size, synthetic=args.synthetic,
        synthetic_size=args.synthetic_size, synthetic_classes=args.synthetic_classes,
        num_workers=args.num_workers, seed=args.seed)
    data.prepare_data()
    data.setup()
    model = build_model(args, data.num_classes, device)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=args.seed + 2)
    state, resume_dir = common.resume_state(args, state)
    train_step, eval_step = make_classifier_steps(model, schedule, input_kind="image")
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
