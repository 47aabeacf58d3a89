#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (perceiver_io_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits nonzero):

1. print the card (``nvidia-smi`` name and power limit); build the CUDA
   kernels from ``perceiver_io_torch/csrc`` with ``nvcc`` and print the
   build seconds;
2. the attention kernel against its plain version at the flagship serving
   shapes (encoder cross-attention with ~30% of keys padded and one fully
   masked row, latent self-attention, the gathered decoder) and at the
   D=16 ``flagship_mlm`` cross shape, in f32 and bf16;
3. the dequant-matmul kernel against its plain version (int8 per-channel,
   int4 group 128; bf16 and f32) at the self-attention projection
   (M=16384, K=N=512) and the vocab head (M=512, K=512, N=10003);
4. the main path: ``MLMServer`` at ``flagship_tpu_mlm`` width (seeded random
   weights, a tokenizer trained on the synthetic corpus, width buckets
   128/256/512, max_batch 64) fills ~200 ``[MASK]`` texts, then encodes them
   and fills from the cached latents, under bf16, int8w and int4w; the
   kernels' launch counters must advance by 22 attention and 131 dequant
   launches per quantized fused forward, and the plain versions must never
   run;
5. the same serving pass at f32 with the plain versions put in the kernels'
   place must give the same top-1 fill on every mask.

f32 comparisons run with TF32 off. Tolerances against the plain versions:
f32 within 1e-4 of the reference's peak magnitude, bf16 within 2e-2. Times
are CUDA-event means over repeated launches after a warm-up; ``bound_ms`` is
the larger of bytes / 3.35 TB/s and operations / the H100 peak for the
inputs' type (989 TF/s bf16, 67 TF/s f32 without tensor cores). The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_PER_FORWARD = 22       # 3 encoder cross + 18 self + 1 decoder cross
DEQUANT_PER_FORWARD = 131   # 124 encoder (layer_n reuses its k/v) + 6 decoder + head
ATTN_PER_ENCODE, DEQUANT_PER_ENCODE = 21, 124
ATTN_PER_DECODE, DEQUANT_PER_DECODE = 1, 7


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got, ref, dtype: str) -> float:
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got.float() - ref.float()).abs().max())
    peak = float(ref.float().abs().max())
    if err > TOL[dtype] * peak:
        raise AssertionError(f"{name}: max|err| {err} > {TOL[dtype]} * {peak}")
    return err


def attention_phase(torch, ak):
    import torch.nn.functional as F

    shapes = [  # name, (B, T, S, H, D), padded keys
        ("enc_cross", (64, 256, 512, 4, 128), True),
        ("self", (64, 256, 256, 4, 128), False),
        ("dec_cross", (64, 8, 256, 4, 128), False),
        ("enc_cross_d16", (64, 256, 512, 4, 16), True),
    ]
    rows = []
    for name, (b, t, s, h, d), padded in shapes:
        g = torch.Generator().manual_seed(b + t + s + d)
        pad = None
        if padded:
            pad = torch.rand(b, s, generator=g) < 0.3
            pad[-1] = True  # one example with every key masked out
            pad = pad.cuda()
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            q = torch.randn(b, t, h, d, generator=g).to("cuda", dtype)
            k = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
            v = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
            err = check(f"attention {name} {dt}", ak.fused_attention(q, k, v, pad),
                        ak.attention_reference(q, k, v, pad), dt)
            bias = ak.pad_bias(pad, b, s, "cuda")
            mask = bias[:, None, None, :].to(dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            item = q.element_size()
            valid = s * b if pad is None else int((~pad).sum()) + s * int(pad.all(1).sum())
            nbytes = item * (2 * b * t * h * d + 2 * b * s * h * d) + 4 * b * s
            bound, by = bound_ms(nbytes, 4 * h * t * d * valid, dt)
            row = dict(kernel="attention_fwd", shape=name, dims=[b, t, s, h, d], dtype=dt,
                       max_abs_err=err, launches_per_forward=ATTN_PER_FORWARD,
                       kernel_ms=time_ms(lambda: ak.fused_attention(q, k, v, pad)),
                       plain_ms=time_ms(lambda: ak.attention_reference(q, k, v, pad), 3),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, attn_mask=mask)),
                       bound_ms=bound, bound_by=by)
            log(**row)
            rows.append(row)
    return rows


def dequant_phase(torch, qm, QKernel, pack_int4, quantize_array):
    import numpy as np

    rows = []
    for name, (m, k, n) in (("self_proj", (16384, 512, 512)), ("vocab_head", (512, 512, 10003))):
        rng = np.random.default_rng(m + n)
        w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
        for bits, gs in ((8, None), (4, 128)):
            qv, scale_np = quantize_array(w, bits=bits, group_size=gs)
            q = torch.from_numpy(pack_int4(qv) if bits == 4 else qv).cuda()
            scale = torch.from_numpy(scale_np).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                dt = str(dtype).split(".")[1]
                x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to("cuda", dtype)
                err = check(f"dequant {name} int{bits} {dt}",
                            qm.dequant_matmul(x, q, scale, bits, gs),
                            qm.dequant_matmul_reference(x, q, scale, bits, gs), dt)
                w_deq = QKernel(q, scale, bits, dtype).dequantize()
                nbytes = (x.element_size() * (m * k + m * n) + q.numel()
                          + 4 * scale.numel())
                bound, by = bound_ms(nbytes, 2 * m * k * n, dt)
                row = dict(kernel="dequant_matmul", shape=name, dims=[m, k, n],
                           quant=f"int{bits}" + (f"-g{gs}" if gs else ""), dtype=dt,
                           max_abs_err=err, launches_per_forward=DEQUANT_PER_FORWARD,
                           kernel_ms=time_ms(lambda: qm.dequant_matmul(x, q, scale, bits, gs)),
                           plain_ms=time_ms(lambda: qm.dequant_matmul_reference(
                               x, q, scale, bits, gs), 3),
                           library_ms=time_ms(lambda: torch.matmul(x, w_deq)),
                           bound_ms=bound, bound_by=by)
                log(**row)
                rows.append(row)
    return rows


def masked_texts(synthetic_reviews, n: int = 200):
    """~n texts of 20..~400 words with 1-3 ``[MASK]`` words each, so every
    width bucket (128 / 256 / 512) sees traffic."""
    import numpy as np

    reviews, _ = synthetic_reviews(n, seed=11)
    rng = np.random.default_rng(12)
    texts = []
    for i, review in enumerate(reviews):
        words = (review + " " + reviews[(i + 1) % n] + " " + reviews[(i + 2) % n]
                 if i % 4 == 0 else review).split()
        for j in rng.choice(len(words), size=int(rng.integers(1, 4)), replace=False):
            words[j] = "[MASK]"
        texts.append(" ".join(words))
    return texts


def use_plain_kernels(model, ak, qm, attention_cls, linear_cls) -> None:
    """Put the plain versions in the kernels' place on every layer."""
    for module in model.modules():
        if isinstance(module, attention_cls):
            module.attention = ak.attention_reference
        if isinstance(module, linear_cls):
            module.qmatmul = qm.dequant_matmul_reference


def serving_phase(torch, ak, qm, port, tokenizer, texts):
    counters = (ak.counter, qm.counter)
    model = port["presets"].flagship_tpu_mlm(device="cuda", seed=0)
    launches = {"attention_fwd": 0, "dequant_matmul": 0}
    for mode in ("bfloat16", "int8w", "int4w"):
        server = port["MLMServer"](model, None, tokenizer, 512, bucket_widths=[128, 256, 512],
                                   max_batch=64, compute_dtype=mode, device="cuda")
        quantized = mode != "bfloat16"
        for c in counters:
            c.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fills = server.fill_masks(texts, k=5)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        n_fwd = server.engine.dispatches
        expect = (ATTN_PER_FORWARD * n_fwd, DEQUANT_PER_FORWARD * n_fwd if quantized else 0)
        got = (ak.counter.launches, qm.counter.launches)
        if got != expect or ak.counter.plain_calls or qm.counter.plain_calls:
            raise AssertionError(f"{mode} fused: launches {got} != {expect} over {n_fwd} "
                                 f"forwards, or a plain version ran")
        launches["attention_fwd"] += got[0]
        launches["dequant_matmul"] += got[1]

        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        cached = server.encode(texts)
        cached_fills = server.fill_masks_cached(cached, k=5)
        torch.cuda.synchronize()
        cached_s = time.perf_counter() - t0
        n_enc, n_dec = server.encoder.dispatches, server.decoder.dispatches
        expect = (ATTN_PER_ENCODE * n_enc + ATTN_PER_DECODE * n_dec,
                  (DEQUANT_PER_ENCODE * n_enc + DEQUANT_PER_DECODE * n_dec) if quantized else 0)
        got = (ak.counter.launches, qm.counter.launches)
        if got != expect or ak.counter.plain_calls or qm.counter.plain_calls:
            raise AssertionError(f"{mode} cached: launches {got} != {expect}")
        launches["attention_fwd"] += got[0]
        launches["dequant_matmul"] += got[1]

        masks = [t.split().count("[MASK]") for t in texts]
        for out in (fills, cached_fills):
            if [len(r) for r in out] != masks or any(len(f) != 5 for r in out for f in r):
                raise AssertionError(f"{mode}: fills of the wrong shape")
        logits = server.decode(cached, [[0, 1]] * len(cached))
        import numpy as np

        if logits.shape != (len(texts), 2, 10003) or not np.isfinite(logits).all():
            raise AssertionError(f"{mode}: decode logits {logits.shape} not finite")
        top1 = [f[0] for r in fills for f in r]
        agree = float(np.mean([a == b for a, b in zip(top1, [f[0] for r in cached_fills
                                                             for f in r])]))
        if mode in ("bfloat16", "int8w"):
            profile_serving(torch, server, texts, mode)
        log(phase="serve", mode=mode, texts=len(texts), masks=sum(masks),
            fused_forwards=n_fwd, encodes=n_enc, decodes=n_dec,
            attention_per_forward=ATTN_PER_FORWARD,
            dequant_per_forward=DEQUANT_PER_FORWARD if quantized else 0,
            fill_masks_s=fused_s, encode_and_cached_fill_s=cached_s,
            cached_top1_agreement=agree, example=[texts[1][:60], fills[1]])
        del server
    return launches


def profile_serving(torch, server, texts, mode: str) -> None:
    """Where one fused fill-mask pass spends the card's time: device time
    by kernel (torch.profiler) against the host wall clock of the pass."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        server.fill_masks(texts, k=5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = []  # kernels only: an operator's device time repeats its kernels'
    for event in prof.key_averages():
        ms = event.self_device_time_total / 1e3
        if event.device_type == torch.autograd.DeviceType.CUDA and ms > 0:
            device.append((ms, event.count, event.key[:70]))
    device.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in device)
    log(phase="profile", mode=mode, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / wall_ms) if device else None,
        top=[dict(kernel=k, ms=ms, calls=c) for ms, c, k in device[:8]])


def plain_parity_phase(torch, ak, qm, port, tokenizer, texts):
    """f32 serving with the kernels, then with the plain versions in their
    place: the top-1 fill of every mask must agree."""
    model = port["presets"].flagship_tpu_mlm(dtype=torch.float32, device="cuda", seed=0)
    for quantize in (None, "int8"):
        kernel = port["MLMServer"](model, None, tokenizer, 512, bucket_widths=[128, 256, 512],
                                   max_batch=64, quantize=quantize, device="cuda")
        top_kernel = [f[0] for r in kernel.fill_masks(texts, k=1) for f in r]
        del kernel
        plain = port["MLMServer"](model, None, tokenizer, 512, bucket_widths=[128, 256, 512],
                                  max_batch=64, quantize=quantize, device="cuda")
        use_plain_kernels(plain.model, ak, qm, port["MultiHeadAttention"], port["Linear"])
        before = (ak.counter.launches, qm.counter.launches)
        top_plain = [f[0] for r in plain.fill_masks(texts, k=1) for f in r]
        if (ak.counter.launches, qm.counter.launches) != before:
            raise AssertionError("the plain pass launched a kernel")
        del plain
        mismatched = sum(a != b for a, b in zip(top_kernel, top_plain))
        log(phase="plain_parity", quantize=quantize or "none", masks=len(top_kernel),
            top1_mismatches=mismatched)
        if mismatched or len(top_kernel) != len(top_plain):
            raise AssertionError(f"f32 {quantize}: {mismatched} top-1 fills differ from plain")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from perceiver_io_torch.data.imdb import synthetic_reviews
    from perceiver_io_torch.data.tokenizer import WordPieceTokenizer
    from perceiver_io_torch.inference.engine import MLMServer
    from perceiver_io_torch.models import presets
    from perceiver_io_torch.ops import attention_kernel as ak
    from perceiver_io_torch.ops import build
    from perceiver_io_torch.ops import qmatmul as qm
    from perceiver_io_torch.ops.attention import Linear, MultiHeadAttention
    from perceiver_io_torch.quant.int8 import QKernel, pack_int4, quantize_array

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.library()
    log(phase="build", build_s=time.perf_counter() - t0, library=build.library_path().name)

    attn_rows = attention_phase(torch, ak)
    deq_rows = dequant_phase(torch, qm, QKernel, pack_int4, quantize_array)

    trained = WordPieceTokenizer()
    trained.train_from_iterator(synthetic_reviews(2000, seed=0)[0], 10003)
    # the synthetic corpus yields a few hundred pieces; reserved entries fill
    # the vocab to the model's 10003 so every predicted id names a token
    vocab = dict(trained.vocab)
    vocab.update({f"[unused{i}]": i for i in range(len(vocab), 10003)})
    tokenizer = WordPieceTokenizer(vocab=vocab)
    texts = masked_texts(synthetic_reviews)
    port = dict(presets=presets, MLMServer=MLMServer, MultiHeadAttention=MultiHeadAttention,
                Linear=Linear)
    launches = serving_phase(torch, ak, qm, port, tokenizer, texts)
    plain_parity_phase(torch, ak, qm, port, tokenizer, texts)

    def entry(rows, name, source, replaces, pick):
        row = next(r for r in rows if pick(r))
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"],
                    shape=row["shape"], dims=row["dims"], dtype=row["dtype"])

    kernels = [
        entry(attn_rows, "attention_fwd", "perceiver_io_torch/csrc/attention_fwd.cu",
              "perceiver_io_tpu/ops/pallas_attention.py:245",
              lambda r: r["shape"] == "enc_cross" and r["dtype"] == "bfloat16"),
        entry(deq_rows, "dequant_matmul", "perceiver_io_torch/csrc/dequant_matmul.cu",
              "perceiver_io_tpu/ops/pallas_matmul.py:163",
              lambda r: r["shape"] == "self_proj" and r["quant"] == "int8"
              and r["dtype"] == "bfloat16"),
    ]
    log(phase="done", total_s=time.perf_counter() - t_start)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
