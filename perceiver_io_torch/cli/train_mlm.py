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
``--accumulate_steps`` are the JAX CLI's flags. After each validation the
top ``--num_predictions`` fills of the first ``[MASK]`` of each
``--predict_samples`` text are logged as a ``predictions`` text row. Runs on
the CUDA card; ``--cpu`` runs the kernels' plain versions. Writes
``metrics.jsonl`` and ``checkpoints/`` under ``<logdir>/<experiment>/
version_n`` (experiment ``mlm``); ``--resume <that dir>`` continues the run
from its newest checkpoint, and ``cli.serve --checkpoint <that
dir>/checkpoints`` serves it.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from perceiver_io_torch.cli import common
from perceiver_io_torch.data.tokenizer import MASK_TOKEN
from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.inference.mlm import encode_masked_texts
from perceiver_io_torch.training.steps import make_mlm_steps, mlm_gather_capacity
from perceiver_io_torch.training.train_state import TrainState
from perceiver_io_torch.training.trainer import Trainer

DEFAULT_PREDICT_SAMPLES = (
    "i have watched this [MASK] and it was awesome",
    "this movie was [MASK] from start to finish",
)

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
    g.add_argument("--num_predictions", "--predict_k", type=int, default=5,
                   help="top-k fills logged per sample after each validation")
    g.add_argument("--predict_samples", nargs="*", default=list(DEFAULT_PREDICT_SAMPLES),
                   help="texts holding [MASK] whose fills are logged (none: no hook)")
    parser.set_defaults(experiment="mlm")
    return parser


def encode_masked_samples(collator, samples: Sequence[str]):
    """``(token_ids, pad_mask)`` of raw strings holding the ``[MASK]``
    literal, at the collator's ``max_seq_len``."""
    return encode_masked_texts(collator.tokenizer, samples, collator.max_seq_len)


def make_predict_hook(predict_fn, collator, samples: Sequence[str], k: int):
    """The sample-prediction hook: the no-masking forward decoded at the first
    ``[MASK]`` of each sample, its top-``k`` tokens logged as one
    ``predictions`` text row (samples without a mask are left out)."""
    if not samples:
        return None
    tokenizer = collator.tokenizer
    mask_id = tokenizer.token_to_id(MASK_TOKEN)
    token_ids, pad_mask = encode_masked_samples(collator, samples)
    has_mask = (token_ids == mask_id).any(axis=1)
    first_mask = np.where(has_mask, (token_ids == mask_id).argmax(axis=1),
                          0).astype(np.int64)[:, None]

    def hook(state, logger, step):
        device = next(state.model.parameters()).device
        logits = predict_fn(state.model, torch.from_numpy(token_ids).to(device),
                            torch.from_numpy(pad_mask).to(device),
                            torch.from_numpy(first_mask).to(device))
        logits = logits.float().cpu().numpy()
        lines = []
        for row in range(len(samples)):
            if not has_mask[row]:
                continue
            top = np.argsort(-logits[row, 0])[:k]
            filled = [samples[row].replace(MASK_TOKEN,
                                           f"**{tokenizer.id_to_token(int(t))}**", 1)
                      for t in top]
            lines.append(samples[row] + "\n\n" + "\n".join(f"- {s}" for s in filled))
        if lines:
            logger.log_text("predictions", step, "\n\n---\n\n".join(lines))

    return hook


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
    ``(trainer, data)``, the data module set up and, with ``--resume``, the
    train state restored."""
    args = apply_preset(common.parse_with_resume(build_parser(), argv))
    common.check_attn_impl(args)
    device = resolve_device("cpu" if args.cpu else None)
    fused = resolve_fused_head(args.fused_head, device, args.num_latent_channels)
    data = common.data_module(args)

    model = common.build_mlm(args, data.tokenizer.get_vocab_size(), args.max_seq_len, device)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=args.seed + 2)
    state, resume_dir = common.resume_state(args, state)
    capacity = args.loss_gather_capacity
    if capacity < 0:
        capacity = mlm_gather_capacity(args.max_seq_len)
    train_step, eval_step, predict_fn = make_mlm_steps(
        model, schedule, loss_gather_capacity=capacity or None,
        fused_head={"pallas": "pallas", "xla": True, "off": False}[fused])
    trainer = Trainer(train_step, eval_step, state, common.trainer_config(args),
                      tokens_per_example=args.max_seq_len, hparams=vars(args),
                      predict_hook=make_predict_hook(predict_fn, data.collator,
                                                     args.predict_samples,
                                                     args.num_predictions),
                      run_dir=resume_dir)
    return trainer, data


def main(argv: Optional[Sequence[str]] = None):
    trainer, data = prepare(argv)
    with trainer:
        common.run_fit(trainer, data.train_dataloader(), data.val_dataloader())
    return trainer.run_dir


if __name__ == "__main__":
    main()
