"""Incremental Perceiver-AR generation: encode the prefix once, then step the
cache rings on the device (the port's subset of
``perceiver_io_tpu/inference/generate.py``).

The model half is :class:`~perceiver_io_torch.models.perceiver.PerceiverARLM`:
``prefill`` runs one dense causal forward over the width-bucketed prefix and
keeps what it attends over as cache rings; ``step`` writes one token's rows
into them in place and recomputes only its latent row. This module is the
engine around that pair:

- **chunks**: a decode chunk chains its steps on the device; the sampled
  token ids stay there and are read back once per chunk (one sync a
  chunk, the counterpart of the JAX engine's ``fori_loop`` dispatch). The
  cache holds each row's position on the device and a step advances it
  there; the session knows it on the host too, so no step reads the device
  to find it. :func:`decode_rows` is the chunk, for one stream here and
  for every slot of the batched arena (``inference/batching.py``).
- **programs**: :class:`DecodeProgram` runs the same chunk with each step
  one CUDA graph per (width, rows, masked) over static rings
  (``inference/programs.py``), the counterpart of the JAX engine's decode
  program per (batch, chunk, sampling). Greedy rows take their argmax
  inside the graph; a sampled row's draw, from a generator re-seeded each
  step, stays outside it. Each width's program holds one resident
  session's rings: another session at that width copies its rings in on
  the device, and the resident one's go out to its own tensors.
- **seeded, position-folded sampling**: the random draw for the token at
  absolute position p comes from a ``torch.Generator`` on the device seeded
  by a pure function of ``(seed, p)`` (:func:`position_seed`, the
  counterpart of ``fold_in(key(seed), p)``). A stream re-encoded from its
  prefix at any point reproduces the same tokens. Torch's generator draws
  other bits than JAX's: sampled streams agree with the JAX engine's in
  distribution, greedy streams token for token.
- **episodes**: one prefill serves at most ``capacity - 1`` decode steps
  (the latent window must still cover the last prefix token); a longer
  continuation re-prefills from the extended prefix at the next width of
  the fixed episode grid (:attr:`ARGenerator.widths`).

:func:`load_ar_checkpoint` rebuilds a trained model from its checkpoint.
The JAX engine's metrics (``obs``), fault injection and
``GenerateSessionStore`` are not ported (ROADMAP).
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from perceiver_io_torch.device import resolve_device
from perceiver_io_torch.inference.engine import prepare_param_tree, resolve_params_mode
from perceiver_io_torch.inference.programs import ProgramCache, fill
from perceiver_io_torch.interop import load_param_tree, param_tree

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """How tokens are drawn from the step logits: ``temperature == 0`` is
    greedy argmax; otherwise logits / temperature, optionally cut to the
    ``top_k`` largest, feed a categorical draw. ``seed`` roots the
    position-folded draws."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def normalized(self) -> "SamplingConfig":
        t = float(self.temperature)
        k = int(self.top_k)
        if t < 0:
            raise ValueError(f"temperature must be >= 0, got {t}")
        if k < 0:
            raise ValueError(f"top_k must be >= 0, got {k}")
        return dataclasses.replace(self, temperature=t, top_k=k, seed=int(self.seed))


def position_seed(seed: int, position: int) -> int:
    """The generator seed of the token at absolute ``position`` of a stream
    rooted at ``seed``: a splitmix64 mix of the pair, so neighbouring
    positions and seeds draw unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15 + (position + 1) * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1  # 63 bits: what manual_seed takes


def sample_scores(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_k: int) -> torch.Tensor:
    """The (B, V) f32 scores whose argmax :func:`sample_logits` takes: the
    logits at temperature 0; otherwise logits / temperature cut to the
    ``top_k`` largest (0 = all) plus Gumbel noise from ``generator``'s
    uniforms."""
    logits = logits.float()
    if temperature == 0.0:
        return logits
    logits = logits / max(temperature, 1e-6)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, torch.finfo(torch.float32).min)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return logits + gumbel


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_k: int) -> torch.Tensor:
    """One token per row of (B, V) logits, as (B,) int64 on their device:
    argmax at temperature 0; otherwise the Gumbel-max draw from
    softmax(logits / temperature) cut to the ``top_k`` largest (0 = all),
    with the uniforms from ``generator`` (:func:`sample_scores`)."""
    return sample_scores(logits, generator, temperature, top_k).argmax(dim=-1)


def sample_logits_rows(logits: torch.Tensor, temperature: Sequence[float],
                       top_k: Sequence[int], seeds: Sequence[int],
                       positions: Sequence[int],
                       rows: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One token per row of (B, V) logits, as (B,) int64 on their device,
    with per-row sampling (host lists of B ``temperature``, ``top_k``,
    ``seeds`` and ``positions``): greedy rows (temperature 0) take one argmax
    over the batch; each sampled row named in ``rows`` (default: every
    sampled row) draws on its own (1, V) row through a generator seeded
    ``position_seed(seed, position)``, exactly as ``ARGenerator`` draws the
    token at that position. Sampled rows left out of ``rows`` keep the
    argmax."""
    tokens = logits.float().argmax(dim=-1)
    generator = None
    for b in range(len(temperature)) if rows is None else rows:
        if temperature[b] == 0.0:
            continue
        if generator is None:
            generator = torch.Generator(device=logits.device)
        generator.manual_seed(position_seed(seeds[b], positions[b]))
        tokens[b: b + 1] = sample_logits(logits[b: b + 1], generator, temperature[b],
                                         top_k[b])
    return tokens


def tree_map(fn, *trees):
    """``fn`` over the tensors of cache-shaped trees (dicts, lists, tuples)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def decode_rows(model, cache, logits: torch.Tensor, steps_left: Sequence[int],
                positions: Sequence[int], temperature: Sequence[float], top_k: Sequence[int],
                seeds: Sequence[int]) -> torch.Tensor:
    """One decode chunk over a ``cache`` of B rows and its pending next-token
    ``logits`` (B, V) f32, both updated in place: ``max(steps_left)`` steps
    of ``model.step``, row b stepping while ``i < steps_left[b]`` (host
    ints, as are the rows' ``positions`` at the chunk's start and their
    sampling parameters). The positions advance on the device, the logits
    of the rows that stepped are replaced, and the (B, steps) tokens (-1
    where a row did not step) come back as one device tensor, read by
    nothing here. A step that every row takes selects nothing (the B=1
    chunk of :class:`ARGenerator`)."""
    left = (None if min(steps_left) == max(steps_left)
            else torch.tensor(list(steps_left), device=logits.device))
    sampled = [b for b, t in enumerate(temperature) if t != 0.0 and steps_left[b]]
    outs = []
    for i in range(max(steps_left)):
        active = None if min(steps_left) > i else left > i
        tok = sample_logits_rows(logits, temperature, top_k, seeds,
                                 [p + i for p in positions],
                                 [b for b in sampled if steps_left[b] > i])
        new_logits, _ = model.step(cache, tok[:, None], active)
        if active is None:
            logits.copy_(new_logits)
            outs.append(tok)
        else:
            logits.copy_(torch.where(active[:, None], new_logits.float(), logits))
            outs.append(torch.where(active, tok, -1))
    return torch.stack(outs, dim=1)


class DecodeProgram:
    """:func:`decode_rows` with each step one program (a CUDA graph on the
    card) over static buffers: the rings ``cache`` and the next-token
    ``logits`` it steps in place, and its own control buffers, which a chunk
    fills once from the host (steps left and sampled rows) and the step
    advances on the device (the column of the token table ``out``). Greedy
    rows take ``argmax(logits)`` inside the step; a sampled row's draw is
    made before each replay, into ``drawn``. A ``masked`` program selects
    with ``active`` at every step, so that one program serves any steps left
    (the batched arena's one program a size); unmasked, every row takes
    every step (the B=1 chunk). The program is ``programs``' ``key``,
    captured at its first step."""

    def __init__(self, model, cache, logits: torch.Tensor, columns: int,
                 programs: ProgramCache, key, masked: bool):
        b, dev = logits.shape[0], logits.device
        self.model, self.cache, self.logits = model, cache, logits
        self.programs, self.key, self.masked = programs, key, masked
        self.ctl = torch.zeros((2 * b + 1,), dtype=torch.long, device=dev)
        self.drawn = torch.zeros((b,), dtype=torch.long, device=dev)
        self.out = torch.full((b, columns), -1, dtype=torch.long, device=dev)

    def _step(self) -> None:
        b = self.logits.shape[0]
        left, sampled, col = self.ctl[:b], self.ctl[b: 2 * b], self.ctl[2 * b:]
        tok = torch.where(sampled.bool(), self.drawn, self.logits.argmax(dim=-1))
        active = left > 0 if self.masked else None
        new_logits, _ = self.model.step(self.cache, tok[:, None], active)
        if active is None:
            self.logits.copy_(new_logits)
        else:
            self.logits.copy_(torch.where(active[:, None], new_logits.float(), self.logits))
            tok = torch.where(active, tok, -1)
            left.sub_(1)
        self.out.index_copy_(1, col, tok[:, None])
        col.add_(1)

    def run(self, steps_left: Sequence[int], positions: Sequence[int],
            temperature: Sequence[float], top_k: Sequence[int],
            seeds: Sequence[int]) -> torch.Tensor:
        """The chunk: :func:`decode_rows`'s contract and tokens."""
        if not self.masked and min(steps_left) != max(steps_left):
            raise ValueError("an unmasked decode program steps every row every step")
        flags = [int(t != 0.0) for t in temperature]
        cols, pieces = self.out.shape[1], []
        for lo in range(0, max(steps_left), cols):
            left = [max(0, k - lo) for k in steps_left]
            fill(self.ctl, torch.tensor(left + flags + [0]))
            n = min(cols, max(left))
            for i in range(n):
                rows = [b for b, f in enumerate(flags) if f and left[b] > i]
                if rows:
                    self.drawn.copy_(sample_logits_rows(
                        self.logits, temperature, top_k, seeds,
                        [p + lo + i for p in positions], rows))
                prog = self.programs.get(self.key)
                if prog is None:
                    self.programs.build(self.key, self._step, [])
                else:
                    prog.run()
            pieces.append(self.out[:, :n].clone())  # the next chunk's table is the same
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


class GenSession:
    """One generation stream: the device cache rings, the pending
    next-token logits, and the accepted token sequence (prompt +
    continuation) the cache encodes."""

    __slots__ = ("cache", "next_logits", "seq", "width", "seed", "steps")

    def __init__(self, cache, next_logits: torch.Tensor, seq: List[int], width: int,
                 seed: int):
        self.cache = cache
        self.next_logits = next_logits
        self.seq = seq          # the accepted sequence the cache encodes
        self.width = width      # the cross rings' capacity (an episode-grid width)
        self.seed = seed
        self.steps = 0          # decode steps taken over this session

    def remaining(self) -> int:
        """Decode steps this episode's rings can still take."""
        return self.width - len(self.seq)


class ARGenerator:
    """The incremental decode engine over one ``PerceiverARLM``.

    Prefill widths lie on the GLOBAL episode grid ``capacity, capacity +
    (capacity - 1), capacity + 2 (capacity - 1), ...`` capped at
    ``max_seq_len`` (flagship: 256, 511, 512): a fixed grid anchors the
    latent window of a stream re-encoded at any point where the
    uninterrupted stream had it, which keeps the position-folded tokens
    identical.

    ``params``: a flat ``{flax path: array}`` f32 tree (``interop``), or
    None for the model's own weights. The engine serves a copy of ``model``
    on ``device`` holding the tree prepared once under the serving mode
    (``compute_dtype='bfloat16'``, ``quantize='int8'|'int4'`` with
    ``group_size``, or the ``'int8w'``/``'int4w'`` shorthands). ``chunk``
    is the number of steps a decode chunk chains (and the streaming
    granularity ``on_chunk`` sees). A chunk's steps run as one
    :class:`DecodeProgram` per width (``programs``); ``graphs=False`` keeps
    the eager :func:`decode_rows`. The prefill runs eagerly.
    """

    def __init__(self, model, params, max_seq_len: int, chunk: int = 8,
                 compute_dtype: Optional[str] = None, quantize: Optional[str] = None,
                 group_size: Optional[int] = None, device=None, graphs: bool = True):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.device = resolve_device(device)
        self.max_seq_len = max_seq_len
        self.capacity = int(model.num_latents)
        if self.capacity < 2:
            raise ValueError("generation needs num_latents >= 2")
        self.chunk = int(chunk)
        widths, w = [], self.capacity
        while w < max_seq_len:
            widths.append(w)
            w += self.capacity - 1
        widths.append(max_seq_len)
        self.widths = widths
        compute_dtype, quantize = resolve_params_mode(compute_dtype, quantize)
        self.compute_dtype, self.quantize = compute_dtype, quantize
        tree = prepare_param_tree(param_tree(model) if params is None else params,
                                  compute_dtype, quantize, group_size)
        self.model = load_param_tree(copy.deepcopy(model).to(self.device), tree).eval()
        self.prefills = 0   # prefix encodes (session starts and episode re-encodes)
        self.steps = 0      # decode steps taken
        self.programs = ProgramCache(self.device) if graphs else None
        # per width: the decode program and the session whose rings it holds
        self._decoders: Dict[int, DecodeProgram] = {}
        self._residents: Dict[int, GenSession] = {}
        self._decode_lock = threading.Lock()

    def plan_width(self, prefix_len: int) -> int:
        """The prefill width (ring capacity, latent-window end) of a
        ``prefix_len`` prefix: the smallest grid point past it. The grid's
        spacing ``capacity - 1`` keeps the last prefix token inside the
        window (``W <= prefix_len - 1 + capacity``)."""
        if prefix_len >= self.max_seq_len:
            raise ValueError(
                f"prefix {prefix_len} leaves no room under max_seq_len {self.max_seq_len}")
        return next(w for w in self.widths if w > prefix_len)

    @torch.inference_mode()
    def start(self, prefix: Sequence[int], seed: int = 0,
              width: Optional[int] = None) -> GenSession:
        """Prefix-encode a session at width :meth:`plan_width` (or at the grid
        width ``width``, past the prefix and within the latent window of its
        last token)."""
        prefix = [int(t) for t in prefix]
        p = len(prefix)
        if p < 1:
            raise ValueError("generation needs a non-empty prefix")
        w = self.plan_width(p) if width is None else width
        if w not in self.widths or not p < w <= p - 1 + self.capacity:
            raise ValueError(f"width {w} is off the grid {self.widths} or does not fit a "
                             f"{p}-token prefix")
        ids = torch.zeros((1, w), dtype=torch.long)
        ids[0, :p] = torch.tensor(prefix)
        pad = torch.arange(w)[None, :] >= p
        logits, cache = self.model.prefill(ids.to(self.device), pad.to(self.device),
                                           length=p)
        # the next-token logits: the window row of the last real token
        row = p - 1 - (w - logits.shape[1])
        self.prefills += 1
        return GenSession(cache, logits[:, row].float(), prefix, w, seed)

    @torch.inference_mode()
    def decode_chunk(self, session: GenSession, sampling: SamplingConfig,
                     n_steps: Optional[int] = None) -> List[int]:
        """Take ``n_steps`` (default ``chunk``) decode steps on the device and
        return the new tokens, read back once; ``session`` now encodes
        them."""
        n = self.chunk if n_steps is None else n_steps
        if n > session.remaining():
            raise ValueError(f"chunk {n} exceeds the session's ring capacity "
                             f"(remaining {session.remaining()})")
        rows = ([n], [len(session.seq)], [sampling.temperature], [sampling.top_k],
                [session.seed])
        if self.programs is None:
            out = decode_rows(self.model, session.cache, session.next_logits, *rows)
        else:
            with self._decode_lock:
                out = self._resident(session).run(*rows)
        new = out[0].tolist()  # the chunk's one sync
        self.steps += n
        session.seq = session.seq + new
        session.steps += n
        return new

    def _resident(self, session: GenSession) -> DecodeProgram:
        """The decode program of ``session``'s width with the session's rings
        and logits in its static buffers, which ``session`` then points at.
        The session they held before gets copies of them, on the device."""
        w = session.width
        dec = self._decoders.get(w)
        if dec is not None and session.cache is dec.cache and session.next_logits is dec.logits:
            return dec
        if dec is None:
            dec = DecodeProgram(self.model, tree_map(torch.clone, session.cache),
                                session.next_logits.clone(), self.chunk, self.programs,
                                ("decode", w, 1, False), masked=False)
            self._decoders[w] = dec
        else:
            held = self._residents.get(w)
            if held is not None and held.cache is dec.cache:
                held.cache = tree_map(torch.clone, dec.cache)
                held.next_logits = dec.logits.clone()
            tree_map(lambda static, x: static.copy_(x), dec.cache, session.cache)
            dec.logits.copy_(session.next_logits)
        session.cache, session.next_logits = dec.cache, dec.logits
        self._residents[w] = session
        return dec

    def num_programs(self) -> int:
        """Decode programs held (0 on the eager path)."""
        return 0 if self.programs is None else self.programs.num_programs()

    def drop_programs(self) -> int:
        """Forget every decode program (the next chunk at each width, or of
        each arena, captures again): what putting other implementations in
        the kernels' place on ``self.model`` needs. A resident session keeps
        its rings. Returns how many programs went."""
        with self._decode_lock:
            self._decoders.clear()
            self._residents.clear()
            return 0 if self.programs is None else self.programs.drop()

    def generate(self, prefix: Sequence[int], max_new: int,
                 sampling: Optional[SamplingConfig] = None,
                 on_chunk: Optional[Callable[[List[int], Dict[str, Any]], None]] = None,
                 session: Optional[GenSession] = None) -> Tuple[List[int], GenSession]:
        """Up to ``max_new`` tokens after ``prefix``, each chunk streamed to
        ``on_chunk(tokens, info)``. When the latent window fills, the episode
        re-prefills from the extended prefix. Returns ``(new_tokens,
        session)``; pass the session back with the extended prefix to
        continue without a fresh encode."""
        sampling = (sampling or SamplingConfig()).normalized()
        prefix = [int(t) for t in prefix]
        produced: List[int] = []
        if session is not None and (session.seq != prefix or session.seed != sampling.seed):
            session = None  # the resident state diverged: re-encode
        while len(produced) < max_new:
            cur = prefix + produced
            if len(cur) >= self.max_seq_len:
                break  # the absolute position budget is spent
            if session is None or session.remaining() < 1:
                session = self.start(cur, seed=sampling.seed)
            n = min(self.chunk, max_new - len(produced), session.remaining())
            t0 = time.perf_counter()
            tokens = self.decode_chunk(session, sampling, n_steps=n)
            produced.extend(tokens)
            if on_chunk is not None:
                on_chunk(tokens, {"pos": len(session.seq), "steps": n,
                                  "chunk_ms": round((time.perf_counter() - t0) * 1e3, 3)})
        return produced, session

    def warmup(self, sampling: SamplingConfig = SamplingConfig()) -> int:
        """Run each width of the grid once (a prefill and one decode step),
        which captures the width's decode program: a later chunk at any grid
        width captures nothing. Returns the number of decode programs held
        (on the eager path, the number of widths run)."""
        sampling = sampling.normalized()
        for w in self.widths:
            session = self.start([0] * max(1, w - self.capacity + 1), seed=sampling.seed,
                                 width=w)
            self.decode_chunk(session, sampling, n_steps=1)
        return len(self.widths) if self.programs is None else self.num_programs()


def load_ar_checkpoint(checkpoint_dir: str, tokenizer=None, step: Optional[int] = None,
                       dtype: Optional[str] = None, device=None):
    """Rebuild a ``PerceiverARLM`` from the hparams embedded in a
    ``cli/train_ar.py`` checkpoint and restore its best (or chosen) step:
    ``(model, params, max_seq_len)``, as ``inference.mlm.load_mlm_checkpoint``
    does for the MLM."""
    from perceiver_io_torch.cli import common
    from perceiver_io_torch.inference.mlm import checkpoint_args, checkpoint_vocab
    from perceiver_io_torch.training.checkpoint import restore_params

    args, hparams = checkpoint_args(checkpoint_dir, dtype)
    max_seq_len = hparams["max_seq_len"]
    vocab = checkpoint_vocab(checkpoint_dir, tokenizer, step,
                             "input_adapter/text_embedding/embedding")
    model = common.build_ar(args, vocab, max_seq_len, device)
    params = restore_params(checkpoint_dir, param_tree(model), step=step)
    return model, params, max_seq_len
