"""IMDB sequence classification on the CUDA card, with transfer from an MLM
run (the port of ``perceiver_io_tpu/cli/train_seq_clf.py``).

    python -m perceiver_io_torch.cli.train_seq_clf --synthetic \\
        --mlm_checkpoint logs/mlm/version_0/checkpoints --freeze_encoder

Three ways to start:

- ``--mlm_checkpoint``: a ``train_mlm`` run's checkpoints directory (its
  best step's encoder, ``training.checkpoint.restore_encoder_params``) or a
  reference Lightning ``.ckpt``; the classifier is built at the widths the
  checkpoint was trained at and its encoder takes the checkpoint's weights
  before the optimizer is built. ``--freeze_encoder`` keeps those weights
  as they are: the encoder leaves the optimizer (the clip norm, the weight
  decay and the moments cover the decoder only) and runs in eval mode with
  no gradient;
- ``--clf_checkpoint``: a ``train_seq_clf`` run's checkpoints directory
  (its best step's weights, optimizer and step, with the optimizer flags
  and ``--freeze_encoder`` it was trained with) or a reference ``.ckpt``
  (weights only, a fresh optimizer);
- neither: from scratch.

Read the MLM run's own tokenizer: give the same ``--root`` (and
``--synthetic``); a tokenizer trained again in another process can differ.
A reference ``.ckpt`` loads with the weights-only unpickler;
``--unsafe_load`` allows the unrestricted one, for trusted files only.

The reference's defaults: batch 128, weight decay 1e-3, dropout 0.1, 64
latents × 64 channels, 3 encoder layers, ``--attn_impl auto`` (calls under
active dropout take the einsum path). Runs on the CUDA card; ``--cpu`` runs
the kernels' plain versions. Writes ``metrics.jsonl`` and ``checkpoints/``
under ``<logdir>/seq_clf/version_n``; ``--resume <that dir>`` continues it.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from typing import Mapping, Optional, Sequence

from perceiver_io_torch.cli import common
from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.interop import (
    import_lightning_checkpoint,
    load_param_tree,
    param_tree,
)
from perceiver_io_torch.training.checkpoint import (
    load_hparams,
    restore_encoder_params,
    restore_train_state,
)
from perceiver_io_torch.training.optim import freeze_subtrees
from perceiver_io_torch.training.steps import make_classifier_steps
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.training.trainer import Trainer

# what --clf_checkpoint restores besides the model's shape: the optimizer's
# structure and the freeze
RESTORED_TRAINING_KEYS = ("optimizer", "weight_decay", "one_cycle_lr", "freeze_encoder")
# the flags that start a run from another run's weights: --resume does not
# take them from the resumed run's hparams (its own checkpoint holds the
# weights; the widths and the freeze come back with the other hparams)
RUN_START_FLAGS = ("mlm_checkpoint", "clf_checkpoint", "unsafe_load")


def _is_torch_ckpt(path: str) -> bool:
    return os.path.isfile(path) and path.endswith(".ckpt")


def _load_imported(module, tree: Mapping, source: str) -> None:
    """Load an imported tree into ``module``, which it must fit exactly
    (paths and shapes): anything else means the checkpoint was trained at
    other widths, and the run stops naming it."""
    try:
        load_param_tree(module, tree)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"imported checkpoint {source} does not fit the model: "
                         f"{e}") from None


def _warn_if_vocab_mismatch(tokenizer_path: str, ckpt: str) -> None:
    """A reference ``.ckpt``'s embedding rows follow the reference's vocab;
    a locally trained WordPiece of the same size passes every shape check
    with other ids. Warn, so the misaligned embeddings are seen."""
    try:
        with open(tokenizer_path, encoding="utf-8") as f:
            native = json.load(f).get("format", "").startswith("perceiver_io")
    except (OSError, ValueError):
        native = False
    if native:
        warnings.warn(
            f"importing {ckpt} while using a locally-trained tokenizer ({tokenizer_path}): "
            f"token ids almost certainly differ from the vocab the checkpoint was trained "
            f"with, so the pretrained embeddings will be misaligned. Put the reference's "
            f"tokenizer JSON at that path for its ids.", stacklevel=2)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_trainer_args(parser)
    common.add_compute_args(parser)
    common.add_model_args(parser)
    common.add_optimizer_args(parser)
    common.add_imdb_args(parser)
    g = parser.add_argument_group("task (sequence classification)")
    g.add_argument("--mlm_checkpoint", default=None,
                   help="checkpoints dir of a train_mlm run, or a reference .ckpt: transfer "
                        "its encoder")
    g.add_argument("--clf_checkpoint", default=None,
                   help="checkpoints dir of a train_seq_clf run (weights, optimizer and "
                        "step), or a reference .ckpt (weights)")
    g.add_argument("--freeze_encoder", action="store_true",
                   help="keep the encoder's weights: out of the optimizer, run in eval mode "
                        "with no gradient")
    g.add_argument("--unsafe_load", action="store_true",
                   help="load a .ckpt that the weights-only unpickler refuses with the "
                        "unrestricted one (runs code embedded in the file: trusted files "
                        "only)")
    parser.set_defaults(experiment="seq_clf", batch_size=128, weight_decay=1e-3, dropout=0.1,
                        num_latents=64, num_latent_channels=64, num_encoder_layers=3,
                        attn_impl="auto")
    return parser


def prepare(argv: Optional[Sequence[str]] = None):
    """The run ``main`` fits, built from ``argv`` and not yet started:
    ``(trainer, data)``, the data module set up, the encoder or the
    classifier loaded from the checkpoint flags and, with ``--resume``, the
    train state restored."""
    args = common.parse_with_resume(build_parser(), argv, not_inherited=RUN_START_FLAGS)
    common.check_attn_impl(args)
    if args.mlm_checkpoint and args.clf_checkpoint:
        raise SystemExit("--mlm_checkpoint and --clf_checkpoint are exclusive")
    if args.resume and (args.mlm_checkpoint or args.clf_checkpoint):
        raise SystemExit("--resume is exclusive with --mlm_checkpoint/--clf_checkpoint: "
                         "--resume continues one run in place, the checkpoint flags start a "
                         "new run from another run's weights")
    device = resolve_device("cpu" if args.cpu else None)

    source = args.mlm_checkpoint or args.clf_checkpoint
    imported = None  # the tree of a reference .ckpt (its encoder's alone for transfer)
    if source and _is_torch_ckpt(source):
        imported, source_hparams = import_lightning_checkpoint(
            source, encoder_only=bool(args.mlm_checkpoint),
            allow_unsafe_pickle=args.unsafe_load)
        common.override_model_args(args, source_hparams)
    elif source:
        common.override_model_args(args, load_hparams(source))
    if args.clf_checkpoint and imported is None:
        hparams = load_hparams(args.clf_checkpoint)
        for key in RESTORED_TRAINING_KEYS:
            if key in hparams:
                setattr(args, key, hparams[key])

    data = common.data_module(args)
    if imported is not None:
        _warn_if_vocab_mismatch(data.tokenizer_path, source)
    model = common.build_text_classifier(args, data.tokenizer.get_vocab_size(),
                                         args.max_seq_len, device)
    # every load below replaces parameters: before the optimizer is built
    if args.mlm_checkpoint and imported is not None:
        _load_imported(model.encoder, imported["encoder"], args.mlm_checkpoint)
    elif args.mlm_checkpoint:
        load_param_tree(model.encoder, restore_encoder_params(args.mlm_checkpoint,
                                                              param_tree(model.encoder)))
    if args.clf_checkpoint and imported is not None:
        _load_imported(model, imported, args.clf_checkpoint)

    params = (freeze_subtrees(model, ["encoder"]) if args.freeze_encoder
              else list(model.parameters()))
    optimizer, schedule = common.optimizer_from_args(args, params)
    state = TrainState.create(model, optimizer, schedule, seed=args.seed + 2)
    state, resume_dir = common.resume_state(args, state)
    if args.clf_checkpoint and imported is None:
        restore_train_state(args.clf_checkpoint, state)
    train_step, eval_step = make_classifier_steps(model, schedule, input_kind="text",
                                                  frozen_encoder=args.freeze_encoder)
    trainer = Trainer(train_step, eval_step, state, common.trainer_config(args),
                      tokens_per_example=args.max_seq_len, hparams=vars(args),
                      run_dir=resume_dir)
    return trainer, data


def main(argv: Optional[Sequence[str]] = None):
    trainer, data = prepare(argv)
    with trainer:
        common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
    return trainer.run_dir


if __name__ == "__main__":
    main()
