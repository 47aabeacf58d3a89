"""MNIST image classification on the CUDA card (the port of
``perceiver_io_tpu/cli/train_img_clf.py``).

    python -m perceiver_io_torch.cli.train_img_clf --synthetic --max_steps 30

The reference's defaults: 32 latents × 128 channels (4 heads of depth 32), 3
encoder layers × (cross-attention + 3 self-attention layers), batch 128,
``--num_frequency_bands 32`` (each pixel's value and its 2·(2·32+1) = 130
Fourier channels: 131 input channels), ``--attn_impl auto`` (the H100 rule,
``ops.attention.auto_attention_impl``, call by call). The model is built from
the data module's image shape and class count (``--random_crop`` trains on
crops, validates on the centre crop). ``--synthetic`` trains on the offline
synthetic digits; otherwise the MNIST idx files must lie under ``--root``
(nothing is downloaded). Runs on the CUDA card; ``--cpu`` runs the kernels'
plain versions. Writes ``metrics.jsonl`` (``train_loss``, ``train_acc``,
``val_loss``, ``val_acc``) and ``checkpoints/`` under
``<logdir>/img_clf/version_n``; ``--resume <that dir>`` continues it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from perceiver_io_torch.cli import common
from perceiver_io_torch.data.mnist import MNISTDataModule
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
    common.add_mnist_args(parser)
    g = parser.add_argument_group("task (image classification)")
    g.add_argument("--num_frequency_bands", type=int, default=32)
    parser.set_defaults(experiment="img_clf", num_latents=32, num_latent_channels=128,
                        num_encoder_layers=3, num_self_attention_layers_per_block=3,
                        attn_impl="auto")
    return parser


def prepare(argv: Optional[Sequence[str]] = None):
    """The run ``main`` fits, built from ``argv`` and not yet started:
    ``(trainer, data)``, the data module set up and, with ``--resume``, the
    train state restored."""
    args = common.parse_with_resume(build_parser(), argv)
    common.check_attn_impl(args)
    device = resolve_device("cpu" if args.cpu else None)
    data = MNISTDataModule(root=args.root, batch_size=args.batch_size,
                           random_crop=args.random_crop, synthetic=args.synthetic,
                           synthetic_size=args.synthetic_size, seed=args.seed)
    data.prepare_data()
    data.setup()
    model = common.build_image_classifier(args, data.dims, data.num_classes, device,
                                          num_frequency_bands=args.num_frequency_bands)
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
