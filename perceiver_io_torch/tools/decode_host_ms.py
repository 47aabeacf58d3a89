"""Host time a token of the one-stream Perceiver-AR decode (``ARGenerator``)
at ``flagship_ar`` width on the CUDA card, in phase 18's traffic shape:
prompts of 250, 120, 37 and 9 tokens (random ids from ``--seed``), greedy,
32 new tokens each in chunks of 8, bf16, weights from seed 0.

Usage, on the card:

    python perceiver_io_torch/tools/decode_host_ms.py [--rounds 4] [--label NAME]

It calls only ``presets.flagship_ar``, ``SamplingConfig`` and
``ARGenerator``'s constructor, ``warmup``, ``generate``, ``start`` and
``decode_chunk``, so the same file times another checkout's package: run it by
its path (not with ``-m``) with that checkout first on ``PYTHONPATH``. Two
checkouts are compared within one machine session, in turns (A, B, B, A).

Prints one JSON line: the label, the package's directory, the card's name
and power limit, per round the host ms a token (the chunks' wall as
``on_chunk`` reports it, one sync a chunk, over the tokens) and the wall of
the round's streams, each stream synchronised before and after, and the
device calls a step makes (kernel launches and ``cudaMemcpyAsync``, counted
by torch.profiler over one chunk of the 120-token prompt): the host's work
a step, which the card's timing noise does not touch.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

PROMPT_LENS, NEW_TOKENS, CHUNK = (250, 120, 37, 9), 32, 8


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from torch.profiler import ProfilerActivity, profile

    import perceiver_io_torch
    from perceiver_io_torch.inference.generate import ARGenerator, SamplingConfig
    from perceiver_io_torch.models import presets

    if not torch.cuda.is_available():
        raise SystemExit("decode_host_ms: no CUDA card")
    model = presets.flagship_ar(device="cuda", seed=0)
    gen = ARGenerator(model, None, 512, chunk=CHUNK, compute_dtype="bfloat16", device="cuda")
    gen.warmup()
    rng = np.random.default_rng(args.seed)
    prompts = [[int(t) for t in rng.integers(3, 10003, n)] for n in PROMPT_LENS]
    rounds = []
    for _ in range(args.rounds):
        chunk_ms, wall = [], 0.0
        for prompt in prompts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, _ = gen.generate(
                prompt, NEW_TOKENS, on_chunk=lambda toks, info: chunk_ms.append(info["chunk_ms"]))
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            if len(tokens) != NEW_TOKENS:
                raise AssertionError(f"{len(tokens)} tokens of {NEW_TOKENS}")
        n = NEW_TOKENS * len(prompts)
        rounds.append({"host_ms_per_token": sum(chunk_ms) / n, "stream_wall_s": wall})
    session = gen.start(prompts[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gen.decode_chunk(session, SamplingConfig(), CHUNK)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if "LaunchKernel" in e.key) / CHUNK
    copies = sum(e.count for e in events if e.key == "cudaMemcpyAsync") / CHUNK
    print(json.dumps({"label": args.label,
                      "package": os.path.dirname(os.path.abspath(perceiver_io_torch.__file__)),
                      "card": card_line(), "torch": torch.__version__,
                      "median_host_ms_per_token": statistics.median(
                          r["host_ms_per_token"] for r in rounds),
                      "launches_per_step": launches, "memcpy_per_step": copies,
                      "rounds": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
