"""Fill-mask serving from the command line (the port's ``--task mlm`` subset
of ``perceiver_io_tpu/cli/serve.py``).

    python -m perceiver_io_torch.cli.serve --preset flagship_tpu_mlm \\
        --init_seed 0 --tokenizer tokenizer.json --stdin < texts.txt

Weights come from ``--params_npz`` (a flax param tree flattened to
``/``-joined paths) or are drawn from ``--init_seed``. Each text holding the
``[MASK]`` literal prints as one JSON line ``{"text", "fills"}``. Runs on
the CUDA card; ``--cpu`` runs the kernels' plain PyTorch versions instead.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from perceiver_io_torch.data.tokenizer import load_tokenizer
from perceiver_io_torch.inference.engine import MLMServer
from perceiver_io_torch.interop import load_params_npz
from perceiver_io_torch.models.presets import PRESETS


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", choices=sorted(PRESETS), default="flagship_tpu_mlm",
                        help="model configuration")
    weights = parser.add_mutually_exclusive_group(required=True)
    weights.add_argument("--params_npz", help="param tree flattened to '/'-joined paths")
    weights.add_argument("--init_seed", type=int, help="draw random weights from this seed")
    parser.add_argument("--tokenizer", required=True, help="tokenizer json")
    parser.add_argument("--stdin", action="store_true",
                        help="read one text per line from stdin")
    parser.add_argument("--k", type=int, default=5, help="top-k tokens per [MASK]")
    parser.add_argument("--max_batch", type=int, default=64,
                        help="micro-batch cap (power-of-two buckets below it)")
    parser.add_argument("--bucket_widths", type=int, nargs="+", default=None,
                        help="sequence-width serving buckets")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                        help="serving compute dtype")
    parser.add_argument("--quantize", choices=("none", "int8", "int4"), default="none",
                        help="weight-only quantization of the matmul kernels")
    parser.add_argument("--group_size", type=int, default=None,
                        help="rows per int4 scale group (default 128)")
    parser.add_argument("--cpu", action="store_true", help="serve on the CPU")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    if not args.stdin:
        raise SystemExit("nothing to serve: pass --stdin")
    device = "cpu" if args.cpu else None
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    tokenizer = load_tokenizer(args.tokenizer)
    model = PRESETS[args.preset](
        dtype=dtype, device=device,
        **({} if args.init_seed is None else {"seed": args.init_seed}))
    params = None if args.params_npz is None else load_params_npz(args.params_npz)
    server = MLMServer(
        model, params, tokenizer, model.encoder.input_adapter.max_seq_len,
        bucket_widths=args.bucket_widths, max_batch=args.max_batch,
        compute_dtype="bfloat16" if args.dtype == "bfloat16" else None,
        quantize=None if args.quantize == "none" else args.quantize,
        group_size=args.group_size, device=device)
    texts = [line.rstrip("\n") for line in sys.stdin]
    texts = [t for t in texts if t]
    results = []
    for text, fills in zip(texts, server.fill_masks(texts, k=args.k)):
        line = {"text": text, "fills": fills}
        results.append(line)
        print(json.dumps(line))
    return results


if __name__ == "__main__":
    main()
