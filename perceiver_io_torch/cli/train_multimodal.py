"""Multimodal audio-video autoencoding on the CUDA card (the port of
``perceiver_io_tpu/cli/train_multimodal.py``).

    python -m perceiver_io_torch.cli.train_multimodal --max_steps 30

The JAX CLI's defaults, the Perceiver IO paper's Kinetics configuration: a
16 × 224 × 224 × 3 video cut into (1, 4, 4) patches (50,176 tokens of 48
patch and 3·(2·32+1) = 195 Fourier channels) and 30,720 audio samples in
patches of 16 (1,920 tokens of 16 + 129 channels, padded to 243), fused
into one 52,096-token stream of 251 channels (8 of them the modality
embedding); 784 × 512 latents, 1 encoder layer of one cross-attention head
of depth 512 and 8 self-attention layers of 8 heads of depth 64; 52,097
decoder queries (every video and audio patch, and one label query), each
with one head of depth 512; batch 8, bf16, ``--attn_impl xla`` (the JAX
CLI's preset: every call on the einsum path; ``pallas`` runs every call on
the attention kernels, ``auto`` the H100 rule call by call). The loss is
MSE(video) + MSE(audio) + CE(label), each weighted (``--video_weight``,
``--audio_weight``, ``--label_weight``); ``--video_patch_loss`` takes the
video MSE in patch space. ``--synthetic`` (the default) trains on
class-conditioned clips (``--synthetic_size``, an eighth held out);
``--real_data`` reads ``<root>/av/<split>/<class>/*.npz`` (nothing is
downloaded). Runs on the CUDA card; ``--cpu`` runs the kernels' plain
versions. Writes ``metrics.jsonl`` (``train_loss``, ``video_loss``,
``audio_loss``, ``label_loss``, ``video_psnr``, ``train_acc``, ``val_*``)
and ``checkpoints/`` under ``<logdir>/multimodal/version_n``; ``--resume
<that dir>`` continues it, and SIGTERM saves ``checkpoints/last/<step>`` at
the next step boundary.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from perceiver_io_torch.cli import common
from perceiver_io_torch.data.av import AVDataModule
from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.training.steps import make_multimodal_steps
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.training.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_trainer_args(parser)
    common.add_compute_args(parser)
    common.add_model_args(parser)
    common.add_optimizer_args(parser)
    g = parser.add_argument_group("data (audio/video)")
    g.add_argument("--root", default=".cache",
                   help="holds <root>/av/<split>/<class>/<clip>.npz with --real_data")
    g.add_argument("--batch_size", type=int, default=8)
    g.add_argument("--video_frames", type=int, default=16)
    g.add_argument("--video_size", type=int, default=224)
    g.add_argument("--video_channels", type=int, default=3)
    g.add_argument("--audio_samples", type=int, default=30720)
    g.add_argument("--audio_channels", type=int, default=1)
    g.add_argument("--num_classes", type=int, default=4)
    g.add_argument("--synthetic", action="store_true", default=True)
    g.add_argument("--real_data", dest="synthetic", action="store_false",
                   help="read <root>/av/<split>/<class>/<clip>.npz instead of generating "
                        "synthetic clips")
    g.add_argument("--synthetic_size", type=int, default=256)
    t = parser.add_argument_group("task (multimodal)")
    t.add_argument("--video_patch", type=int, nargs=3, default=(1, 4, 4),
                   metavar=("PT", "PH", "PW"))
    t.add_argument("--samples_per_patch", type=int, default=16)
    t.add_argument("--num_modality_channels", type=int, default=8)
    t.add_argument("--video_frequency_bands", type=int, default=32)
    t.add_argument("--audio_frequency_bands", type=int, default=64)
    t.add_argument("--video_patch_loss", action="store_true",
                   help="take the video reconstruction loss in patch space (the target "
                        "patchified instead of the prediction un-patchified: the same "
                        "elements, so the same loss up to the order of the sum); the "
                        "parameters and checkpoints are unaffected")
    t.add_argument("--video_weight", type=float, default=1.0)
    t.add_argument("--audio_weight", type=float, default=1.0)
    t.add_argument("--label_weight", type=float, default=1.0)
    parser.set_defaults(experiment="multimodal", num_latents=784, num_latent_channels=512,
                        num_encoder_layers=1, num_self_attention_layers_per_block=8,
                        num_cross_attention_heads=1, num_self_attention_heads=8,
                        attn_impl="xla")
    return parser


def prepare(argv: Optional[Sequence[str]] = None):
    """The run ``main`` fits, built from ``argv`` and not yet started:
    ``(trainer, data)``, the data module set up and, with ``--resume``, the
    train state restored."""
    args = common.parse_with_resume(build_parser(), argv)
    common.check_attn_impl(args)
    device = resolve_device("cpu" if args.cpu else None)
    video_shape = (args.video_frames, args.video_size, args.video_size, args.video_channels)
    data = AVDataModule(root=args.root, video_shape=video_shape,
                        num_audio_samples=args.audio_samples,
                        num_audio_channels=args.audio_channels, num_classes=args.num_classes,
                        batch_size=args.batch_size, synthetic=args.synthetic,
                        synthetic_size=args.synthetic_size, seed=args.seed)
    data.prepare_data()
    data.setup()
    model = common.build_multimodal_model(args, video_shape, data.num_classes, device)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=args.seed + 2)
    state, resume_dir = common.resume_state(args, state)
    train_step, eval_step = make_multimodal_steps(model, schedule,
                                                  video_weight=args.video_weight,
                                                  audio_weight=args.audio_weight,
                                                  label_weight=args.label_weight)
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
