"""Serving from the command line (the port's ``--task mlm`` and single-process
``--task generate`` subsets of ``perceiver_io_tpu/cli/serve.py``).

    python -m perceiver_io_torch.cli.serve --preset flagship_tpu_mlm \\
        --init_seed 0 --tokenizer tokenizer.json --stdin < texts.txt
    python -m perceiver_io_torch.cli.serve --task generate --preset flagship_ar \\
        --init_seed 0 --dtype bfloat16 --tokenizer tokenizer.json --texts "a movie"

Weights come from ``--checkpoint`` (a train CLI's ``<run dir>/checkpoints``:
the model rebuilt from its hparams, the best step by val_loss or
``--step``), from ``--params_npz`` (a flax param tree flattened to
``/``-joined paths) or are drawn from ``--init_seed``. Fill-mask: each text
holding the ``[MASK]`` literal prints as one JSON line ``{"text", "fills"}``.
Generation: each prompt prints as one JSON line ``{"text",
"continuation_ids", "continuation"}``, with chunk-by-chunk progress on
stderr; without ``--tokenizer`` a prompt is whitespace-separated token ids
and the continuation its ids. ``--decode_batching`` serves them through the
continuous-batching engine (``inference/batching.py``), ``--decode_slots``
slots a width to start with. Before the first text the server warms its
program family (``MLMServer.warmup``: every width x K bucket x batch bucket;
``ARGenerator.warmup``: a decode program per width; each a CUDA graph on
the card), blocking; ``--no_warmup`` skips it, and the first request of
each shape then captures its program. Runs on the CUDA card; ``--cpu`` runs
the kernels' plain PyTorch versions instead.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from perceiver_io_torch.data.tokenizer import load_tokenizer
from perceiver_io_torch.inference.batching import ContinuousBatcher
from perceiver_io_torch.inference.engine import MLMServer
from perceiver_io_torch.inference.generate import (
    ARGenerator,
    SamplingConfig,
    load_ar_checkpoint,
)
from perceiver_io_torch.inference.mlm import load_mlm_checkpoint
from perceiver_io_torch.interop import load_params_npz
from perceiver_io_torch.models.presets import AR_PRESETS, PRESETS

DEFAULT_PRESETS = {"mlm": "flagship_tpu_mlm", "generate": "flagship_ar"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--task", choices=("mlm", "generate"), default="mlm",
                        help="'mlm' fills [MASK] tokens; 'generate' continues each "
                             "prompt with the Perceiver-AR model")
    parser.add_argument("--preset", choices=sorted(PRESETS), default=None,
                        help="model configuration (default: flagship_tpu_mlm for "
                             "--task mlm, flagship_ar for --task generate)")
    weights = parser.add_mutually_exclusive_group(required=True)
    weights.add_argument("--checkpoint", metavar="DIR",
                         help="a train run's checkpoints/ dir (the model from its hparams)")
    weights.add_argument("--params_npz", help="param tree flattened to '/'-joined paths")
    weights.add_argument("--init_seed", type=int, help="draw random weights from this seed")
    parser.add_argument("--step", type=int, default=None,
                        help="with --checkpoint: the step to serve (default: best by "
                             "val_loss)")
    parser.add_argument("--tokenizer", default=None,
                        help="tokenizer json (needed by --task mlm; without it "
                             "--task generate reads and prints token ids)")
    parser.add_argument("--stdin", action="store_true",
                        help="read one text per line from stdin")
    parser.add_argument("--texts", nargs="+", default=None,
                        help="texts to serve (instead of --stdin)")
    parser.add_argument("--k", type=int, default=5, help="top-k tokens per [MASK]")
    parser.add_argument("--max_batch", type=int, default=64,
                        help="micro-batch cap (power-of-two buckets below it)")
    parser.add_argument("--bucket_widths", type=int, nargs="+", default=None,
                        help="sequence-width serving buckets")
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip readying the program family before serving (the first "
                             "request of each shape then captures its program)")
    parser.add_argument("--blocking_warmup", action="store_true",
                        help="wait for the whole program family before serving: the "
                             "port's only warmup mode for now (accepted for the JAX "
                             "CLI's flags)")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                        help="serving compute dtype: bfloat16 casts the weights once; "
                             "default float32, or with --checkpoint the dtype the run "
                             "trained in, over its f32 weights as they were saved")
    parser.add_argument("--quantize", choices=("none", "int8", "int4"), default="none",
                        help="weight-only quantization of the matmul kernels")
    parser.add_argument("--group_size", type=int, default=None,
                        help="rows per int4 scale group (default 128)")
    gen = parser.add_argument_group("generation (--task generate)")
    gen.add_argument("--max_new_tokens", type=int, default=32,
                     help="tokens to generate per prompt")
    gen.add_argument("--temperature", type=float, default=0.0,
                     help="0 = greedy; > 0 samples at this temperature")
    gen.add_argument("--top_k", type=int, default=0,
                     help="sample from the k most likely tokens (0 = all)")
    gen.add_argument("--gen_seed", type=int, default=0,
                     help="root of the position-folded sampling draws")
    gen.add_argument("--generate_chunk", type=int, default=8,
                     help="decode steps per chunk (one device round trip each)")
    gen.add_argument("--decode_batching", action="store_true",
                     help="continuous batching: the streams' caches pooled in a slotted "
                          "arena, one batched step for every active stream (the same "
                          "tokens). It pays only at concurrency: this CLI serves its "
                          "prompts one after another, one stream at a time, where the "
                          "arena is slower than the per-stream engine; the flag mirrors "
                          "the JAX CLI's")
    gen.add_argument("--decode_slots", type=int, default=8,
                     help="with --decode_batching: each width's first arena slots "
                          "(rounded up to a power of two)")
    parser.add_argument("--cpu", action="store_true", help="serve on the CPU")
    return parser


def _texts(args) -> list:
    texts = args.texts or [line.rstrip("\n") for line in sys.stdin]
    return [t for t in texts if t]


def _model_and_params(args, tokenizer, dtype, device):
    """The model and its flat params tree (None: the model's own weights)."""
    if args.checkpoint is not None:
        load = load_ar_checkpoint if args.task == "generate" else load_mlm_checkpoint
        model, params, _ = load(args.checkpoint, tokenizer, step=args.step,
                                dtype=args.dtype, device=device)
        return model, params
    preset = args.preset or DEFAULT_PRESETS[args.task]
    if (preset in AR_PRESETS) != (args.task == "generate"):
        raise SystemExit(f"preset {preset!r} does not serve --task {args.task}")
    model = PRESETS[preset](
        dtype=dtype, device=device,
        **({} if args.init_seed is None else {"seed": args.init_seed}))
    return model, None if args.params_npz is None else load_params_npz(args.params_npz)


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    if args.task == "mlm" and args.tokenizer is None:
        raise SystemExit("--task mlm needs --tokenizer")
    if not (args.stdin or args.texts):
        raise SystemExit("nothing to serve: pass --stdin or --texts")
    device = "cpu" if args.cpu else None
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32  # the presets
    tokenizer = None if args.tokenizer is None else load_tokenizer(args.tokenizer)
    model, params = _model_and_params(args, tokenizer, dtype, device)
    mode = dict(compute_dtype="bfloat16" if args.dtype == "bfloat16" else None,
                quantize=None if args.quantize == "none" else args.quantize,
                group_size=args.group_size, device=device)
    if args.task == "generate":
        return _serve_generate(args, model, params, tokenizer, mode)
    server = MLMServer(
        model, params, tokenizer, model.encoder.input_adapter.max_seq_len,
        bucket_widths=args.bucket_widths, max_batch=args.max_batch, **mode)
    if not args.no_warmup:
        print(f"serve: warmed {server.warmup()} bucket programs", file=sys.stderr)
    texts = _texts(args)
    results = []
    for text, fills in zip(texts, server.fill_masks(texts, k=args.k)):
        line = {"text": text, "fills": fills}
        results.append(line)
        print(json.dumps(line))
    return results


def _serve_generate(args, model, params, tokenizer, mode):
    """``--task generate``: one JSON line per prompt on stdout, chunk progress
    on stderr."""
    vocab = model.input_adapter.text_embedding.embedding.shape[0]
    if tokenizer is not None and tokenizer.get_vocab_size() != vocab:
        raise SystemExit(f"the tokenizer has {tokenizer.get_vocab_size()} tokens, the "
                         f"model's vocab {vocab}: every generated id must name a token")
    max_seq_len = model.input_adapter.max_seq_len
    if args.decode_batching:
        gen = ContinuousBatcher(model, params, max_seq_len, chunk=args.generate_chunk,
                                slots=args.decode_slots, **mode)
    else:
        gen = ARGenerator(model, params, max_seq_len, chunk=args.generate_chunk, **mode)
    try:
        return _generate_lines(args, gen, tokenizer)
    finally:
        if args.decode_batching:
            gen.close()


def _generate_lines(args, gen, tokenizer):
    sampling = SamplingConfig(temperature=args.temperature, top_k=args.top_k,
                              seed=args.gen_seed)
    if not args.no_warmup:
        print(f"serve: warmed {gen.warmup(sampling)} generation programs", file=sys.stderr)

    def on_chunk(tokens, info):
        print(f"serve: +{len(tokens)} tokens @pos {info['pos']} "
              f"({info['chunk_ms']:.1f} ms)", file=sys.stderr, flush=True)

    results = []
    for text in _texts(args):
        if tokenizer is None:
            prefix = [int(t) for t in text.split()]
        else:
            prefix = tokenizer.encode_ids(text)
        tokens = []
        if prefix:
            tokens, _ = gen.generate(prefix, args.max_new_tokens, sampling,
                                     on_chunk=on_chunk)
        words = ([str(t) for t in tokens] if tokenizer is None
                 else [tokenizer.id_to_token(t) for t in tokens])
        line = {"text": text, "continuation_ids": tokens, "continuation": " ".join(words)}
        results.append(line)
        print(json.dumps(line))
    return results


if __name__ == "__main__":
    main()
