"""Argument groups and builders shared by the port's training entry points
(the port's single-process subset of ``perceiver_io_tpu/cli/common.py``),
with the resume plumbing: :func:`parse_with_resume` takes a resumed run's
hparams as the flags' defaults, :func:`resume_state` restores its newest
checkpoint, and :func:`run_fit` drives the trainer."""

from __future__ import annotations

import argparse
import os

import torch

from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.models import presets
from perceiver_io_torch.models.adapters import (
    ClassificationOutputAdapter,
    ImageInputAdapter,
    TextInputAdapter,
    TextOutputAdapter,
)
from perceiver_io_torch.models.perceiver import (
    PerceiverDecoder,
    PerceiverEncoder,
    PerceiverIO,
    PerceiverMLM,
    init_params,
)
from perceiver_io_torch.ops.attention import ATTN_IMPLS, NOT_PORTED_ATTN_IMPLS
from perceiver_io_torch.training.optim import (
    SUPPORTED_OPTIMIZERS,
    OptimizerConfig,
    make_optimizer,
)
from perceiver_io_torch.training.checkpoint import load_hparams, restore_train_state
from perceiver_io_torch.training.trainer import TrainerConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_model_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("model")
    g.add_argument("--num_latents", type=int, default=None,
                   help="default: the task's preset")
    g.add_argument("--num_latent_channels", type=int, default=None,
                   help="default: the task's preset")
    g.add_argument("--num_encoder_layers", type=int, default=3)
    g.add_argument("--num_self_attention_layers_per_block", type=int, default=6)
    g.add_argument("--num_cross_attention_heads", type=int, default=4)
    g.add_argument("--num_self_attention_heads", type=int, default=4)
    g.add_argument("--dropout", type=float, default=0.0,
                   help="dropout rate of every layer (attention probabilities and "
                        "residual branches) in training; evaluation runs without it")
    g.add_argument("--pad_vocab_multiple", type=int, default=None,
                   help="round the vocab projection width up to this multiple (padded "
                        "logits pinned to -1e30)")


def add_optimizer_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("optimizer")
    g.add_argument("--optimizer", choices=SUPPORTED_OPTIMIZERS, default="Adam",
                   help="torch.optim name, with torch's update rule (weight decay coupled "
                        "L2 for all but AdamW)")
    g.add_argument("--learning_rate", type=float, default=1e-3)
    g.add_argument("--weight_decay", type=float, default=0.0)
    g.add_argument("--momentum", type=float, default=0.0,
                   help="SGD momentum (ignored by the other optimizers)")
    g.add_argument("--one_cycle_lr", action="store_true")
    g.add_argument("--one_cycle_pct_start", type=float, default=0.1)
    g.add_argument("--grad_clip_norm", type=float, default=None,
                   help="clip the global gradient norm to this value before each update")
    g.add_argument("--accumulate_steps", type=int, default=1,
                   help="average gradients over N micro-batches per optimizer update "
                        "(effective batch = N * batch_size)")


def add_trainer_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("trainer")
    g.add_argument("--max_epochs", type=int, default=None)
    g.add_argument("--max_steps", type=int, default=None)
    g.add_argument("--log_every_n_steps", type=int, default=50)
    g.add_argument("--eval_every_n_steps", type=int, default=None,
                   help="validate every N steps (default: once per epoch)")
    g.add_argument("--logdir", default="logs")
    g.add_argument("--experiment", default="default",
                   help="runs go to <logdir>/<experiment>/version_n")
    g.add_argument("--max_to_keep", type=int, default=1,
                   help="checkpoints kept, best by val_loss")
    g.add_argument("--no_tensorboard", action="store_true")
    g.add_argument("--resume", default=None, metavar="RUN_DIR",
                   help="continue a previous run in place: restore its newest checkpoint "
                        "(the preemption last/ slot if it is newer), take the flags not "
                        "given here from its hparams, and keep logging into RUN_DIR")
    g.add_argument("--skip_nonfinite_steps", action="store_true",
                   help="read each step's loss on the host and skip a step whose loss or "
                        "gradients are not finite (the pre-step state kept); after "
                        "--rollback_after_bad_steps in a row, roll back to the newest "
                        "checkpoint. One host sync a step")
    g.add_argument("--rollback_after_bad_steps", type=int, default=3,
                   help="with --skip_nonfinite_steps: bad steps in a row before a rollback "
                        "(0 = skip only)")
    g.add_argument("--dispatch_error_retries", type=int, default=0,
                   help="retry a train step that fails with a transient error (a dropped "
                        "connection; never a CUDA error, an OOM or divergence) before its "
                        "update up to N times. 0 disables")
    g.add_argument("--fit_attempts", type=int, default=1,
                   help="total fit attempts: after a transient failure the trainer resumes "
                        "from the newest checkpoint (1 = no supervisor)")


def add_compute_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("compute")
    g.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="compute dtype over f32 master weights")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions); the default "
                        "is the CUDA card")
    g.add_argument("--attn_impl", choices=ATTN_IMPLS + NOT_PORTED_ATTN_IMPLS,
                   default=None,
                   help="attention: pallas = the fused attention kernels on head-split "
                        "views, packed = the packed-heads kernels, xla = the einsum path, "
                        "auto = per call (ops.attention.auto_attention_impl); calls with "
                        "active dropout take the einsum path; pallas_sp is not ported "
                        "(ROADMAP Queue 1 item 8). Default: the preset's")
    g.add_argument("--remat", action="store_true",
                   help="recompute each encoder layer's forward in the backward (memory "
                        "for compute; the MLM encoder)")
    g.add_argument("--no_reuse_kv", action="store_true",
                   help="project the shared layer_n's cross-attention k/v again at each "
                        "application instead of reusing them (the MLM encoder)")


def add_imdb_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("data (IMDB)")
    g.add_argument("--root", default=".cache")
    g.add_argument("--max_seq_len", type=int, default=512)
    g.add_argument("--vocab_size", type=int, default=10003)
    g.add_argument("--batch_size", type=int, default=64)
    g.add_argument("--synthetic", action="store_true",
                   help="the offline synthetic review corpus instead of aclImdb")
    g.add_argument("--synthetic_size", type=int, default=2048)
    g.add_argument("--bucket_widths", type=int, nargs="+", default=None,
                   help="pad each batch to the smallest of these sequence widths that holds "
                        "it (max_seq_len is always the last); combine with "
                        "--length_sort_window")
    g.add_argument("--length_sort_window", type=int, default=8,
                   help="with --bucket_widths: sort examples by length within windows of "
                        "this many batches (their order re-shuffled; 0 = off)")


def add_mnist_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("data (MNIST)")
    g.add_argument("--dataset", choices=("mnist",), default="mnist")
    g.add_argument("--root", default=".cache",
                   help="holds the MNIST idx files (<root>/MNIST/raw or <root>, raw or .gz)")
    g.add_argument("--batch_size", type=int, default=128)
    g.add_argument("--random_crop", type=int, default=None,
                   help="train on random crops of this size (validation: the centre crop)")
    g.add_argument("--synthetic", action="store_true",
                   help="the offline synthetic digits instead of the MNIST files")
    g.add_argument("--synthetic_size", type=int, default=4096)


def data_module(args):
    """The IMDB data module of the parsed flags, set up."""
    from perceiver_io_torch.data.imdb import IMDBDataModule

    data = IMDBDataModule(root=args.root, max_seq_len=args.max_seq_len,
                          vocab_size=args.vocab_size, batch_size=args.batch_size,
                          synthetic=args.synthetic, synthetic_size=args.synthetic_size,
                          seed=args.seed, bucket_widths=args.bucket_widths,
                          length_sort_window=args.length_sort_window)
    data.prepare_data()
    data.setup()
    return data


def check_attn_impl(args) -> None:
    if args.attn_impl in NOT_PORTED_ATTN_IMPLS:
        raise SystemExit(
            f"--attn_impl {args.attn_impl}: not ported yet (ROADMAP Queue 1 item 8, the "
            f"distribution slice); the port trains with {', '.join(ATTN_IMPLS)}")


def trainer_config(args) -> TrainerConfig:
    """Logs go to ``<logdir>/<experiment>/version_n``."""
    return TrainerConfig(
        max_epochs=args.max_epochs, max_steps=args.max_steps,
        log_every_n_steps=args.log_every_n_steps, eval_every_n_steps=args.eval_every_n_steps,
        logdir=args.logdir, experiment=args.experiment, max_to_keep=args.max_to_keep,
        use_tensorboard=not args.no_tensorboard,
        skip_nonfinite_steps=args.skip_nonfinite_steps,
        rollback_after_bad_steps=args.rollback_after_bad_steps,
        dispatch_error_retries=args.dispatch_error_retries, fit_attempts=args.fit_attempts)


def run_fit(trainer, train_loader, val_loader=None):
    """``trainer.fit``, under the ``fit_with_recovery`` supervisor when the
    config asks for more than one attempt."""
    if trainer.config.fit_attempts > 1:
        return trainer.fit_with_recovery(train_loader, val_loader)
    return trainer.fit(train_loader, val_loader)


# flags that describe where this invocation runs, not the recipe: a resume
# never takes them from the resumed run's hparams
_ENV_FLAGS = {"resume", "cpu"}


def parse_with_resume(parser: argparse.ArgumentParser, argv, not_inherited=()):
    """Parse ``argv``; with ``--resume RUN_DIR``, parse again with the
    resumed run's hparams as the parser's defaults, so every flag of the
    original run comes back (the model's shapes, the optimizer's structure)
    while the flags given on this command line win. ``--resume`` itself,
    ``--cpu`` and the flags named in ``not_inherited`` never come from the
    hparams."""
    args = parser.parse_args(argv)
    if not getattr(args, "resume", None):
        return args
    try:
        hparams = load_hparams(os.path.join(args.resume, "checkpoints"))
    except (FileNotFoundError, NotADirectoryError):
        raise SystemExit(_nothing_to_resume(args.resume)) from None
    known = vars(args)
    parser.set_defaults(**{k: v for k, v in hparams.items()
                           if k in known and k not in _ENV_FLAGS
                           and k not in not_inherited})
    args = parser.parse_args(argv)
    args.resume = os.path.abspath(known["resume"])
    return args


def _nothing_to_resume(path: str) -> str:
    return (f"--resume {path}: no usable checkpoint under {path}/checkpoints: the run was "
            f"probably stopped before its first checkpoint (start fresh without --resume), "
            f"or the path is not a run directory (the version_N dir holding checkpoints/)")


def resume_state(args, state):
    """After the fresh train state is built: with ``--resume``, restore the
    newest checkpoint of the run into it (the ``last/`` slot when it is the
    newest). Returns ``(state, run_dir)``: the resumed directory, or None
    for a fresh run."""
    if not getattr(args, "resume", None):
        return state, None
    try:
        restore_train_state(os.path.join(args.resume, "checkpoints"), state,
                            prefer_latest=True)
    except (FileNotFoundError, NotADirectoryError):
        raise SystemExit(_nothing_to_resume(args.resume)) from None
    return state, args.resume


def optimizer_from_args(args, params):
    return make_optimizer(OptimizerConfig(
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, one_cycle_lr=args.one_cycle_lr,
        one_cycle_pct_start=args.one_cycle_pct_start, max_steps=args.max_steps,
        momentum=args.momentum, grad_clip_norm=args.grad_clip_norm,
        accumulate_steps=args.accumulate_steps), params)


def _init(model, args, device):
    """``model`` with its weights drawn from ``--seed`` on the CPU (the same
    weights on every device), moved to ``device`` (None: the CUDA card)."""
    init_params(model, torch.Generator().manual_seed(args.seed))
    return model.to(resolve_device(device))


def _encoder(args, input_adapter) -> PerceiverEncoder:
    return PerceiverEncoder(
        input_adapter=input_adapter,
        latent_shape=(args.num_latents, args.num_latent_channels),
        num_layers=args.num_encoder_layers,
        num_cross_attention_heads=args.num_cross_attention_heads,
        num_self_attention_heads=args.num_self_attention_heads,
        num_self_attention_layers_per_block=args.num_self_attention_layers_per_block,
        dtype=DTYPES[args.dtype], attn_impl=args.attn_impl, dropout=args.dropout,
        remat=args.remat, reuse_kv=not args.no_reuse_kv)


def _decoder(args, output_adapter) -> PerceiverDecoder:
    return PerceiverDecoder(
        output_adapter=output_adapter,
        latent_shape=(args.num_latents, args.num_latent_channels),
        num_cross_attention_heads=args.num_cross_attention_heads, dtype=DTYPES[args.dtype],
        attn_impl=args.attn_impl, dropout=args.dropout)


def build_text_encoder(args, vocab_size: int, max_seq_len: int) -> PerceiverEncoder:
    """Text input adapter + encoder at the parsed widths (the embedding width
    is the latent channel count), its weights not drawn yet: the MLM's and
    the sequence classifier's encoder, one parameter tree."""
    return _encoder(args, TextInputAdapter(vocab_size, max_seq_len, args.num_latent_channels,
                                           DTYPES[args.dtype]))


def build_mlm(args, vocab_size: int, max_seq_len: int, device) -> PerceiverMLM:
    """The MLM at the parsed widths, weights drawn from ``--seed``."""
    return _init(presets.mlm_model(
        build_text_encoder(args, vocab_size, max_seq_len),
        _decoder(args, TextOutputAdapter(
            vocab_size, max_seq_len, num_output_channels=args.num_latent_channels,
            dtype=DTYPES[args.dtype], pad_classes_to=args.pad_vocab_multiple))), args, device)


def _classes(args, num_classes: int) -> ClassificationOutputAdapter:
    return ClassificationOutputAdapter(num_classes=num_classes,
                                       num_output_channels=args.num_latent_channels,
                                       dtype=DTYPES[args.dtype],
                                       pad_classes_to=args.pad_vocab_multiple)


def build_text_classifier(args, vocab_size: int, max_seq_len: int, device,
                          num_classes: int = 2) -> PerceiverIO:
    """The sequence classifier: the MLM's encoder and a one-query class
    decoder, weights drawn from ``--seed``."""
    return _init(PerceiverIO(build_text_encoder(args, vocab_size, max_seq_len),
                             _decoder(args, _classes(args, num_classes))), args, device)


def build_image_classifier(args, image_shape, num_classes: int, device,
                           num_frequency_bands: int = 32) -> PerceiverIO:
    """The image classifier: pixels and their Fourier encodings into the
    encoder, a one-query class decoder, weights drawn from ``--seed``."""
    adapter = ImageInputAdapter(tuple(image_shape), num_frequency_bands, DTYPES[args.dtype])
    return _init(PerceiverIO(_encoder(args, adapter),
                             _decoder(args, _classes(args, num_classes))), args, device)


def build_flow_model(args, image_shape, device) -> PerceiverIO:
    """The optical-flow model (``models.flow``): frame-pair patches and their
    Fourier encodings into the encoder, one decoder query per pixel, weights
    drawn from ``--seed``."""
    from perceiver_io_torch.models.flow import build_optical_flow_model

    return _init(build_optical_flow_model(
        image_shape=tuple(image_shape), latent_shape=(args.num_latents, args.num_latent_channels),
        num_layers=args.num_encoder_layers,
        num_self_attention_layers_per_block=args.num_self_attention_layers_per_block,
        num_cross_attention_heads=args.num_cross_attention_heads,
        num_self_attention_heads=args.num_self_attention_heads, patch_size=args.patch_size,
        num_frequency_bands=args.num_frequency_bands, dropout=args.dropout,
        dtype=DTYPES[args.dtype], attn_impl=args.attn_impl, remat=args.remat,
        reuse_kv=not args.no_reuse_kv), args, device)


def build_multimodal_model(args, video_shape, num_classes: int, device):
    """The multimodal autoencoder (``models.multimodal``): video patches
    and audio patches fused into the encoder's input, video, audio and one
    label query out of the decoder, weights drawn from ``--seed``."""
    from perceiver_io_torch.models.multimodal import build_multimodal_autoencoder

    return _init(build_multimodal_autoencoder(
        video_shape=tuple(video_shape), num_audio_samples=args.audio_samples,
        samples_per_patch=args.samples_per_patch, num_audio_channels=args.audio_channels,
        num_classes=num_classes, latent_shape=(args.num_latents, args.num_latent_channels),
        video_patch_shape=tuple(args.video_patch), num_layers=args.num_encoder_layers,
        num_self_attention_layers_per_block=args.num_self_attention_layers_per_block,
        num_cross_attention_heads=args.num_cross_attention_heads,
        num_self_attention_heads=args.num_self_attention_heads,
        num_modality_channels=args.num_modality_channels,
        video_frequency_bands=args.video_frequency_bands,
        audio_frequency_bands=args.audio_frequency_bands, dropout=args.dropout,
        dtype=DTYPES[args.dtype], attn_impl=args.attn_impl, remat=args.remat,
        reuse_kv=not args.no_reuse_kv, video_patch_loss=args.video_patch_loss), args, device)


# the flags that shape a model: a checkpoint's hparams override them, so a
# restored encoder fits what it was trained as
MODEL_HPARAM_KEYS = ("num_latents", "num_latent_channels", "num_encoder_layers",
                     "num_self_attention_layers_per_block", "num_cross_attention_heads",
                     "num_self_attention_heads", "vocab_size", "max_seq_len")


def override_model_args(args, hparams: dict) -> None:
    """Set the model-shaping flags from a checkpoint's hparams."""
    for key in MODEL_HPARAM_KEYS:
        if key in hparams:
            setattr(args, key, hparams[key])


def build_ar(args, vocab_size: int, max_seq_len: int, device):
    """The Perceiver-AR causal LM at the parsed widths, weights drawn from
    ``--seed`` (the counterpart of the JAX CLI's ``build_ar``, which takes
    neither ``--remat`` nor ``--no_reuse_kv``: the AR model has neither)."""
    return presets.flagship_ar(
        vocab_size=vocab_size, max_seq_len=max_seq_len, num_latents=args.num_latents,
        num_channels=args.num_latent_channels, num_layers=args.num_encoder_layers,
        num_self_attention_layers_per_block=args.num_self_attention_layers_per_block,
        num_cross_attention_heads=args.num_cross_attention_heads,
        num_self_attention_heads=args.num_self_attention_heads,
        dtype=DTYPES[args.dtype], device=device, seed=args.seed,
        attn_impl=args.attn_impl, pad_classes_to=args.pad_vocab_multiple,
        dropout=args.dropout)
