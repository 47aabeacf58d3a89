"""Fill-mask serving (the port's subset of
``perceiver_io_tpu/inference/engine.py``).

:class:`MLMServer` tokenizes each text once, pads it to its width bucket,
and micro-batches requests of one shape (width, mask-count bucket) into
power-of-two batch buckets, over the three program families of
:func:`mlm_apply_fns`: the fused forward (encoder + gathered decode at the
``[MASK]`` positions), ``encode`` and ``decode``. It runs synchronously: a
request's ``result()`` runs every batch queued so far. Each (family,
signature, batch bucket) is one program (``inference/programs.py``): a CUDA
graph captured at the bucket's first batch, or ahead of traffic by
:meth:`MLMServer.warmup`, and replayed after. Threads, telemetry and
breakers of the JAX engine are host-side systems a later slice ports.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perceiver_io_torch.data.pipeline import resolve_bucket_width
from perceiver_io_torch.data.tokenizer import MASK_TOKEN, PAD_TOKEN
from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.inference.mlm import masked_token_ids, pad_token_rows, top_k_tokens
from perceiver_io_torch.inference.predictor import bucket_size, pad_rows, to_numpy
from perceiver_io_torch.inference.programs import ProgramCache, fill
from perceiver_io_torch.interop import flatten_tree, load_param_tree, param_tree
from perceiver_io_torch.quant.int8 import is_quantized, quantize_tree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_params_mode(compute_dtype: Optional[str],
                        quantize: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """Normalize (compute_dtype, quantize): ``'int8w'``/``'int4w'`` are bf16
    compute over int8/int4-stored weights."""
    if quantize not in (None, "int8", "int4"):
        raise ValueError(
            f"unknown quantize mode {quantize!r}; expected None, 'int8', or 'int4'")
    if compute_dtype == "int8w":
        compute_dtype, quantize = "bfloat16", "int8"
    elif compute_dtype == "int4w":
        compute_dtype, quantize = "bfloat16", "int4"
    if compute_dtype not in (None, *_DTYPES):
        raise ValueError(f"unknown compute dtype {compute_dtype!r}")
    return compute_dtype, quantize


def prepare_param_tree(params, compute_dtype: Optional[str], quantize: Optional[str],
                       group_size: Optional[int] = None) -> Dict[str, object]:
    """Load-time preparation of a ``{path: array}`` tree (flat or nested) under a
    serving mode: cast floating leaves to ``compute_dtype`` (bf16 path), or
    quantize the matmul kernels to int8/int4 with scales from the given
    (f32) values and the other floats cast (int8w/int4w). A tree already
    quantized is returned as it is."""
    flat = flatten_tree(params)
    if is_quantized(flat):
        return flat
    params = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
              for k, v in flat.items()}
    if quantize in ("int8", "int4"):
        return quantize_tree(params, compute_dtype=_DTYPES[compute_dtype or "float32"],
                             bits=8 if quantize == "int8" else 4,
                             group_size=group_size)
    if compute_dtype is not None:
        dt = _DTYPES[compute_dtype]
        return {k: v.to(dt) if v.is_floating_point() else v for k, v in params.items()}
    return params


def mlm_apply_fns(model) -> Dict[str, Callable]:
    """The three serving program families over one ``PerceiverMLM``."""

    def fused_apply(token_ids, pad_mask, positions):
        return model(token_ids, pad_mask, positions=positions)[0]

    def encode_apply(token_ids, pad_mask):
        return model.encode(token_ids, pad_mask)

    def decode_apply(latents, positions):
        return model.decode(latents, positions)

    return {"infer": fused_apply, "encode": encode_apply, "decode": decode_apply}


class _Future:
    """One request's result: its parts' output rows, concatenated, through
    an optional ``transform``."""

    def __init__(self, engine: Optional["BatchingEngine"], num_parts: int,
                 transform: Optional[Callable] = None):
        self._engine = engine
        self._parts: List[Optional[torch.Tensor]] = [None] * num_parts
        self._transform = transform
        self._value = None
        self._done = False

    def _deliver(self, index: int, rows: torch.Tensor) -> None:
        self._parts[index] = rows
        if all(p is not None for p in self._parts):
            out = self._parts[0] if len(self._parts) == 1 else torch.cat(self._parts)
            self._value = out if self._transform is None else self._transform(out)
            self._done = True

    def result(self):
        if not self._done:
            self._engine.flush()
        return self._value


def _done_future(value) -> _Future:
    fut = _Future(None, 0)
    fut._value, fut._done = value, True
    return fut


class BatchingEngine:
    """Micro-batches requests over one ``apply_fn(*batched_tensors)``:
    requests of one input signature (trailing shapes and dtypes) are sealed
    in arrival order into batches of at most ``max_batch`` rows, padded to a
    power-of-two bucket (rows repeat row 0) and run together; requests
    larger than ``max_batch`` split into parts. Floating inputs are cast to
    ``compute_dtype``; inputs from the host stay there until their batch
    runs.

    With ``programs`` (a :class:`ProgramCache`), each (signature, bucket)
    runs as one program keyed ``(name, signature, bucket)``: its first batch
    captures it, and every batch after copies its columns into the
    program's buffers and replays it; the rows handed out are a copy that
    no later replay touches. Without, ``apply_fn`` runs eagerly.
    ``host_output``: a batch's output comes to the host in one copy (the
    rows a caller reads there: one sync a batch, not one a request)."""

    def __init__(self, apply_fn: Callable, max_batch: int, device: torch.device,
                 compute_dtype: Optional[torch.dtype] = None,
                 programs: Optional[ProgramCache] = None, name: str = "engine",
                 host_output: bool = False):
        self.apply_fn = apply_fn
        self.max_batch = max_batch
        self.device = device
        self.compute_dtype = compute_dtype
        self.programs = programs
        self.name = name
        self.host_output = host_output
        self.dispatches = 0
        self._pending: Dict[tuple, List[Tuple[List[torch.Tensor], _Future, int]]] = {}

    def _tensor(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if self.compute_dtype is not None and t.is_floating_point():
            t = t.to(self.compute_dtype)
        return t

    @staticmethod
    def _key(arrays: Sequence[torch.Tensor]) -> tuple:
        return tuple((tuple(a.shape[1:]), a.dtype) for a in arrays)

    def submit(self, *inputs, transform: Optional[Callable] = None) -> _Future:
        arrays = [self._tensor(x) for x in inputs]
        n = arrays[0].shape[0]
        if n == 0 or any(a.shape[0] != n for a in arrays):
            raise ValueError("inputs must share a non-empty leading batch axis")
        starts = range(0, n, self.max_batch)
        fut = _Future(self, len(starts), transform)
        for index, start in enumerate(starts):
            chunk = [a[start: start + self.max_batch] for a in arrays]
            self._pending.setdefault(self._key(chunk), []).append((chunk, fut, index))
        return fut

    def predict(self, *inputs):
        return self.submit(*inputs).result()

    def flush(self) -> None:
        """Run every queued request."""
        while self._pending:
            key = next(iter(self._pending))
            queue = self._pending.pop(key)
            while queue:
                batch, rows = [], 0
                while queue and rows + queue[0][0][0].shape[0] <= self.max_batch:
                    part = queue.pop(0)
                    batch.append(part)
                    rows += part[0][0].shape[0]
                self._dispatch(batch, rows)

    @property
    def num_programs(self) -> int:
        """Distinct (signature, batch-bucket) programs captured or warmed."""
        if self.programs is None:
            return 0
        return self.programs.num_programs(lambda key: key[0] == self.name)

    def _run(self, cols: List[torch.Tensor], bucket: int) -> torch.Tensor:
        """One padded batch through its program (built at its first batch),
        or eagerly; the output may be a program's buffer."""
        with torch.inference_mode():
            if self.programs is None:
                return self.apply_fn(*[c.to(self.device) for c in cols])
            key = (self.name, self._key(cols), bucket)
            prog = self.programs.get(key)
            if prog is not None:
                return prog.run(*cols)
            statics = [torch.empty(c.shape, dtype=c.dtype, device=self.device) for c in cols]
            for static, col in zip(statics, cols):
                fill(static, col)
            return self.programs.build(key, self.apply_fn, statics).output

    def warmup(self, *example_inputs, buckets: Optional[Sequence[int]] = None) -> List[int]:
        """Ready every batch bucket for this input signature (row 0 of
        ``example_inputs``, tiled) ahead of traffic: one program each,
        captured now, so a batch of that shape captures nothing. One call per
        distinct signature, e.g. per serving width. Returns the warmed
        bucket list."""
        arrays = [self._tensor(x) for x in example_inputs]
        if any(a.shape[0] < 1 for a in arrays):
            raise ValueError("warmup needs at least one example row")
        if buckets is None:
            buckets, b = [], 1
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch)
        buckets = sorted({bucket_size(int(b), self.max_batch) for b in buckets})
        for b in buckets:
            self._run([a[:1].expand(b, *a.shape[1:]).contiguous() for a in arrays], b)
        return buckets

    def _dispatch(self, batch, rows: int) -> None:
        bucket = bucket_size(rows, self.max_batch)
        cols = []
        for i in range(len(batch[0][0])):
            parts = [chunk[i] for chunk, _, _ in batch]
            if len({p.device for p in parts}) > 1:
                parts = [p.to(self.device) for p in parts]
            cols.append(pad_rows(torch.cat(parts), bucket))
        out = self._run(cols, bucket)
        with torch.inference_mode():
            if self.host_output and out.device.type != "cpu":
                out = out.cpu()
            elif self.programs is not None:
                out = out.clone()  # the program's buffer is the next batch's
        self.dispatches += 1
        offset = 0
        for chunk, fut, index in batch:
            n = chunk[0].shape[0]
            fut._deliver(index, out[offset: offset + n])
            offset += n


class CachedLatents:
    """Result of :meth:`MLMServer.encode`: the latents (on the device) plus
    the request-side bookkeeping needed to decode against them later."""

    __slots__ = ("latents", "token_ids", "mask_positions")

    def __init__(self, latents: torch.Tensor, token_ids: List[np.ndarray],
                 mask_positions: List[np.ndarray]):
        self.latents = latents              # (B, N, C)
        self.token_ids = token_ids          # per row, at its serving width
        self.mask_positions = mask_positions  # per row, [MASK] indices

    def __len__(self) -> int:
        return self.latents.shape[0]


class MLMServer:
    """Text serving over a ``PerceiverMLM``: tokenize → width-bucket →
    micro-batch; fill-mask through the gathered decode, plus the
    encode-once / decode-many latent cache.

    ``params``: a flat ``{flax path: array}`` f32 tree (``interop``), or
    None for the model's own weights. The server serves a copy of ``model``
    on ``device`` holding the tree prepared ONCE under the serving mode
    (``compute_dtype='bfloat16'``, ``quantize='int8'|'int4'``, or the
    ``'int8w'``/``'int4w'`` shorthands) and shared by the three program
    families. ``bucket_widths``: sequence-width buckets; None = always
    ``max_seq_len``. The three families' programs share one
    :class:`ProgramCache` (``programs``); ``graphs=False`` keeps the eager
    path, which runs every operator from Python on every batch."""

    def __init__(self, model, params, tokenizer, max_seq_len: int,
                 bucket_widths: Optional[Sequence[int]] = None, max_batch: int = 64,
                 compute_dtype: Optional[str] = None, quantize: Optional[str] = None,
                 group_size: Optional[int] = None, device=None, graphs: bool = True):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.mask_id = tokenizer.token_to_id(MASK_TOKEN)
        self._pad_id = tokenizer.token_to_id(PAD_TOKEN)
        if bucket_widths:
            widths = sorted({int(w) for w in bucket_widths})
            if widths[0] <= 0 or widths[-1] > max_seq_len:
                raise ValueError(
                    f"bucket_widths must lie in [1, max_seq_len={max_seq_len}], "
                    f"got {widths}")
            if widths[-1] != max_seq_len:
                widths.append(max_seq_len)
            self.widths: List[int] = widths
        else:
            self.widths = [max_seq_len]

        compute_dtype, quantize = resolve_params_mode(compute_dtype, quantize)
        self.compute_dtype, self.quantize = compute_dtype, quantize
        tree = prepare_param_tree(param_tree(model) if params is None else params,
                                  compute_dtype, quantize, group_size)
        self.model = load_param_tree(copy.deepcopy(model).to(self.device), tree).eval()

        apply_fns = mlm_apply_fns(self.model)
        cast = _DTYPES[compute_dtype] if compute_dtype else None
        self.programs = ProgramCache(self.device) if graphs else None
        # the logits of the fused and decode families are read on the host;
        # the latents of encode stay on the card for later decodes
        self.engine, self.encoder, self.decoder = (
            BatchingEngine(apply_fns[name], max_batch, self.device, cast, self.programs, name,
                           host_output=name != "encode")
            for name in ("infer", "encode", "decode"))

    def warmup(self, batch_buckets: Optional[Sequence[int]] = None,
               query_buckets: Sequence[int] = (1, 2, 4)) -> int:
        """Ready the serving programs ahead of traffic, blocking: every width
        bucket x batch bucket (x K bucket for the fused and decode
        families), each family in priority order (smallest width and bucket
        first). Returns the number of programs warmed (on the eager path,
        the number of (shape, bucket) runs); after it, serving traffic of
        these shapes captures nothing."""
        count = 0

        def example(width: int):
            # pad nothing: a fully padded row would attend over no key
            return np.zeros((1, width), np.int32), np.zeros((1, width), bool)

        for width in self.widths:
            ids, pad = example(width)
            for kb in sorted({bucket_size(int(q), width) for q in query_buckets}):
                count += len(self.engine.warmup(ids, pad, np.zeros((1, kb), np.int32),
                                                buckets=batch_buckets))
        for width in self.widths:
            count += len(self.encoder.warmup(*example(width), buckets=batch_buckets))
        latent_row = self.encoder.predict(*example(self.widths[0]))
        for kb in sorted({bucket_size(int(q), self.max_seq_len) for q in query_buckets}):
            count += len(self.decoder.warmup(latent_row, np.zeros((1, kb), np.int32),
                                             buckets=batch_buckets))
        return count

    def num_programs(self) -> int:
        """Programs held across the three families."""
        return 0 if self.programs is None else self.programs.num_programs()

    def drop_programs(self) -> int:
        """Forget every program (the next batch of each shape captures
        again): what putting other implementations in the kernels' place
        on ``self.model`` needs, since a program replays what it captured.
        Returns how many went."""
        return 0 if self.programs is None else self.programs.drop()

    def _prepare(self, text: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Tokenize one text once and pad it to its width bucket:
        ``(token_ids (1, W), pad_mask (1, W), mask_positions)``."""
        row = masked_token_ids(self.tokenizer, text)
        width = resolve_bucket_width(len(row), self.widths)
        ids, pad = pad_token_rows([row], width, self._pad_id)
        return ids, pad, np.nonzero(ids[0] == self.mask_id)[0]

    def _positions_row(self, mask_pos: np.ndarray, width: int) -> np.ndarray:
        """(1, K-bucket) positions; filler slots repeat position 0."""
        kb = bucket_size(max(len(mask_pos), 1), width)
        row = np.zeros((1, kb), np.int32)
        row[0, : len(mask_pos)] = mask_pos
        return row

    def _topk_transform(self, n_masks: int, k: int):
        def transform(logits: torch.Tensor) -> List[List[str]]:
            return top_k_tokens(self.tokenizer, to_numpy(logits[0, :n_masks]), k)

        return transform

    def submit(self, text: str, k: int = 5) -> _Future:
        """Queue one fill-mask request; ``result()`` is the per-``[MASK]``
        top-k token lists."""
        ids, pad, mask_pos = self._prepare(text)
        if len(mask_pos) == 0:
            return _done_future([])
        positions = self._positions_row(mask_pos, ids.shape[1])
        return self.engine.submit(ids, pad, positions,
                                  transform=self._topk_transform(len(mask_pos), k))

    def fill_masks(self, texts: Sequence[str], k: int = 5) -> List[List[List[str]]]:
        """Submit everything, then collect: the whole set micro-batches."""
        futures = [self.submit(t, k) for t in texts]
        return [f.result() for f in futures]

    def encode(self, texts: Sequence[str]) -> CachedLatents:
        """Run the encoder half once per text and keep the latents."""
        prepared = [self._prepare(t) for t in texts]
        futures = [self.encoder.submit(ids, pad) for ids, pad, _ in prepared]
        latents = torch.cat([f.result() for f in futures])
        return CachedLatents(latents, [ids[0] for ids, _, _ in prepared],
                             [pos for _, _, pos in prepared])

    def decode(self, cached: CachedLatents, positions: np.ndarray) -> np.ndarray:
        """(B, K) query ``positions`` against cached latents → (B, K, vocab)
        logits on the host."""
        positions = np.asarray(positions, np.int32)
        if positions.shape[0] != len(cached):
            raise ValueError(
                f"positions rows {positions.shape[0]} != cached batch {len(cached)}")
        return to_numpy(self.decoder.predict(cached.latents, positions))

    def fill_masks_cached(self, cached: CachedLatents,
                          k: int = 5) -> List[List[List[str]]]:
        """Fill-mask from cached latents only: each row decodes its own
        ``[MASK]`` positions, no encoder work."""
        futures = []
        for row in range(len(cached)):
            mask_pos = cached.mask_positions[row]
            if len(mask_pos) == 0:
                futures.append(_done_future([]))
                continue
            positions = self._positions_row(mask_pos, self.max_seq_len)
            futures.append(self.decoder.submit(
                cached.latents[row: row + 1], positions,
                transform=self._topk_transform(len(mask_pos), k)))
        return [f.result() for f in futures]
