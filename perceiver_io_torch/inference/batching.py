"""Continuous batching for Perceiver-AR decode: a slotted cache arena and ONE
batched step for every active stream (the port of
``perceiver_io_tpu/inference/batching.py``).

:class:`~perceiver_io_torch.inference.generate.ARGenerator` serves each
session on its own chain of B=1 steps, so at any concurrency the card reads
the whole weight stream, and the host makes every launch of a step, once a
token for each stream. This module pays both once a step for all of them:

- **slotted cache arena**: the per-session cache rings are pooled into one
  buffer per episode width, the session cache dict with a leading slot axis
  (``len`` a (slots,) long tensor of per-slot positions on the device) plus
  the next-token logits (slots, vocab) in f32. A free slot holds zero rings,
  which the step reads as valid keys, so no row ever sees only padding.
  Retiring a stream only relabels its slot (resident or free).
- **one batched step**: every active slot advances through
  ``PerceiverARLM.step`` with per-row positions and an ``active`` mask (the
  JAX arena vmaps the B=1 step and selects with ``where``; the port's step
  takes the batch as it is and selects inside): an inactive slot's rings
  pass through bit for bit. A chunk (``generate.decode_rows``, the chunk
  ``ARGenerator`` runs at B=1) chains up to ``chunk`` steps, each slot
  running its own ``steps_left``; the positions advance on the device and
  the chunk's tokens are read back once. Every step selects with
  ``active``, so each (width, slots) is ONE program
  (``generate.DecodeProgram``, a CUDA graph over the arena's own buffers),
  captured on the dispatcher thread at the arena's first chunk; admission
  installs into those buffers in place, and a grow, which replaces them,
  drops the program.
- **continuous scheduling**: streams are admitted and retired at chunk
  boundaries. A dispatcher thread owns the arenas and does all device work;
  caller threads enqueue streams and drain their own token queues, so a slow
  consumer cannot stall the batch. New streams of one width are encoded in
  admission waves of up to ``_MAX_PREFILL_ROWS``: one prefill of the
  right-padded prompts with per-row lengths and one indexed install. The
  JAX engine rounds a wave up to a power of two to close XLA's program
  family; the port's prefill is not a program yet and takes each wave at
  its exact size.

Stream identity: a sampled row draws through a ``torch.Generator`` seeded
``position_seed(seed, p)`` on its own (1, vocab) row
(``generate.sample_logits_rows``), as ``ARGenerator`` draws, so a stream
served here, by ``ARGenerator`` alone, or re-encoded at any point gives the
same tokens wherever its logits agree. The batched step's products run at
other batch sizes than the B=1 step's and may round otherwise, so in bf16 a
stream may part from ``ARGenerator``'s at a near tie of its two best scores.

Not ported (the JAX engine's serving-tier parts): the ``obs`` metrics,
spans and registry, ``DecodeFlightRecorder``, the ``Heartbeat`` watchdog,
``faults.inject``, the on-disk ``compile_cache`` / ``ExecutableCache``,
``release_session`` and the ``GenerateSessionStore`` hooks, and
``token_stats``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from perceiver_io_torch.inference.generate import (
    ARGenerator,
    DecodeProgram,
    SamplingConfig,
    decode_rows,
    tree_leaves,
    tree_map,
)

# the most same-width prompts one admission wave encodes together
_MAX_PREFILL_ROWS = 8


def _round_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ArenaSession:
    """Host handle of a RESIDENT arena continuation: the accepted sequence
    and a (width, slot, epoch) claim on the rings that encode it. The arena
    bumps a slot's epoch whenever it is reclaimed or adopted, so a handle
    whose slot moved on re-encodes from its prefix. Duck-typed to
    ``GenSession`` (``seq``, ``width``, ``seed``, ``steps``, ``remaining``)."""

    __slots__ = ("seq", "width", "seed", "steps", "slot", "epoch")

    def __init__(self, seq: List[int], width: int, seed: int, steps: int, slot: int,
                 epoch: int):
        self.seq = seq
        self.width = width
        self.seed = seed
        self.steps = steps
        self.slot = slot
        self.epoch = epoch

    def remaining(self) -> int:
        return self.width - len(self.seq)


_FREE, _ACTIVE, _RESIDENT = "free", "active", "resident"


class _Slot:
    __slots__ = ("state", "epoch", "stream", "last")

    def __init__(self):
        self.state = _FREE
        self.epoch = 0
        self.stream = None          # the _Stream while _ACTIVE
        self.last = 0.0             # LRU stamp for resident reclamation


class _Arena:
    """One episode width's pooled rings: the device buffer (``{"cache",
    "logits"}`` with a leading slot axis; None until the width's first wave,
    whose cache gives the rings' shapes and dtypes), the host slot table and
    the per-slot sampling parameters. The buffer is touched only by the
    dispatcher thread; the table only under the batcher's lock."""

    __slots__ = ("width", "n_slots", "buf", "decoder", "slots", "temp", "top_k", "seeds")

    def __init__(self, width: int, n_slots: int):
        self.width = width
        self.n_slots = n_slots
        self.buf = None
        self.decoder: Optional[DecodeProgram] = None  # over buf, made at the first chunk
        self.slots = [_Slot() for _ in range(n_slots)]
        self.temp = [0.0] * n_slots
        self.top_k = [0] * n_slots
        self.seeds = [0] * n_slots


class _Stream:
    """One in-flight continuation: the dispatcher's state (tokens produced,
    placement) and the caller's event queue (token chunks, then done or
    error) that ``generate`` drains."""

    __slots__ = ("prefix", "max_new", "sampling", "adopt", "q", "tokens", "width",
                 "slot", "placed", "cancelled", "ended", "session_out", "wants_chunks",
                 "at_width")

    def __init__(self, prefix: List[int], max_new: int, sampling: SamplingConfig,
                 adopt: Optional[ArenaSession], wants_chunks: bool,
                 at_width: Optional[int] = None):
        self.prefix = prefix
        self.at_width = at_width    # the first episode's width, if not the planned one
        self.max_new = max_new
        self.sampling = sampling
        self.adopt = adopt          # a resident session to resume, tried once
        self.q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.tokens: List[int] = []
        self.width = 0
        self.slot = -1
        self.placed = False
        self.cancelled = False
        self.ended = False
        self.session_out: Optional[ArenaSession] = None
        self.wants_chunks = wants_chunks

    def cur_len(self) -> int:
        return len(self.prefix) + len(self.tokens)

    def end(self, kind: str, payload) -> None:
        """The caller's last event: ``done`` (the tokens) or ``error``."""
        self.ended = True
        self.q.put((kind, payload))


class ContinuousBatcher(ARGenerator):
    """Continuous-batching decode engine over one ``PerceiverARLM``: the
    ``ARGenerator`` surface (``generate(prefix, max_new, sampling,
    on_chunk=..., session=...)``, the episode grid, the streamed chunks),
    with the steps of every concurrent stream run by one dispatcher thread
    as one batched step per arena.

    ``slots`` (rounded up to a power of two) is each width's first arena
    size; an arena doubles up to ``max_slots`` when admissions outrun
    retirements, copying every ring into the larger buffer. A full arena
    queues admissions to the next chunk boundary. A dispatcher fault raises
    out of every affected caller's ``generate``; after :meth:`close`,
    ``generate`` raises ``RuntimeError``. The arenas' programs, keyed
    ``("decode", width, slots, True)``, live in the inherited ``programs``
    beside ``ARGenerator``'s B=1 ones, so ``num_programs`` and
    ``drop_programs`` cover them (an arena's next chunk captures again).
    ``graphs=False`` keeps the eager chunk.
    """

    def __init__(self, model, params, max_seq_len: int, chunk: int = 8, slots: int = 8,
                 max_slots: int = 64, compute_dtype: Optional[str] = None,
                 quantize: Optional[str] = None, group_size: Optional[int] = None,
                 device=None, name: str = "generate", graphs: bool = True):
        super().__init__(model, params, max_seq_len, chunk=chunk,
                         compute_dtype=compute_dtype, quantize=quantize,
                         group_size=group_size, device=device, graphs=graphs)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.name = name
        self.slots = _round_pow2(slots)
        self.max_slots = max(_round_pow2(max_slots), self.slots)
        # the current CUDA device is per thread: the dispatcher takes the
        # constructing thread's where the device names none
        self._cuda_index = None
        if self.device.type == "cuda":
            self._cuda_index = (self.device.index if self.device.index is not None
                                else torch.cuda.current_device())
        self._cv = threading.Condition()
        self._arenas: Dict[int, _Arena] = {}
        self._pending: "deque[_Stream]" = deque()
        self._stats = {"dispatches": 0, "steps": 0, "fill_sum": 0.0, "chunk_ms_sum": 0.0,
                       "admitted": 0, "retired": 0, "waves": 0, "batched_steps": 0}
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, name=f"{name}-arena-dispatch",
                                        daemon=True)
        self._thread.start()

    # -- arena allocation (dispatcher thread) -------------------------------

    def _ensure_arena(self, width: int) -> _Arena:
        with self._cv:
            return self._arenas.setdefault(width, _Arena(width, self.slots))

    def _grow(self, arena: _Arena) -> bool:
        """Double the arena up to ``max_slots``: every ring leaf is copied
        into a buffer with zero rings in the new slots. The old size's
        program goes with the old buffers."""
        if arena.n_slots >= self.max_slots:
            return False
        new_n = min(arena.n_slots * 2, self.max_slots)
        pad_n = new_n - arena.n_slots
        buf = arena.buf
        if buf is not None:
            buf = tree_map(lambda x: torch.cat([x, x.new_zeros((pad_n,) + x.shape[1:])]), buf)
        if self.programs is not None:
            self.programs.drop(lambda key: key == self._arena_key(arena))
        with self._cv:
            arena.buf = buf
            arena.decoder = None
            arena.n_slots = new_n
            arena.slots.extend(_Slot() for _ in range(pad_n))
            arena.temp.extend([0.0] * pad_n)
            arena.top_k.extend([0] * pad_n)
            arena.seeds.extend([0] * pad_n)
        return True

    # -- slot lifecycle (under self._cv) -------------------------------------

    def _claim_slot(self, arena: _Arena) -> Optional[int]:
        for i, s in enumerate(arena.slots):
            if s.state == _FREE:
                s.epoch += 1
                return i
        # reclaim the least recently used resident (its session re-encodes
        # when it returns)
        lru, lru_t = None, None
        for i, s in enumerate(arena.slots):
            if s.state == _RESIDENT and (lru_t is None or s.last < lru_t):
                lru, lru_t = i, s.last
        if lru is None:
            return None
        s = arena.slots[lru]
        s.state = _FREE
        s.epoch += 1
        s.stream = None
        return lru

    def _bind_slot(self, arena: _Arena, slot: int, st: _Stream) -> None:
        s = arena.slots[slot]
        s.state = _ACTIVE
        s.epoch += 1           # stale out any stored handle to this slot
        s.stream = st
        s.last = time.monotonic()
        arena.temp[slot] = st.sampling.temperature
        arena.top_k[slot] = st.sampling.top_k
        arena.seeds[slot] = st.sampling.seed
        st.width = arena.width
        st.slot = slot
        st.placed = True
        self._stats["admitted"] += 1

    def _retire_slot(self, arena: _Arena, slot: int, resident: bool) -> None:
        s = arena.slots[slot]
        s.stream = None
        s.state = _RESIDENT if resident else _FREE
        if not resident:
            s.epoch += 1
        s.last = time.monotonic()
        self._stats["retired"] += 1

    # -- the serving surface -------------------------------------------------

    def warmup(self, sampling: SamplingConfig = SamplingConfig()) -> int:
        """Serve one stream at each width of the grid (as
        ``ARGenerator.warmup`` picks its prefix): one admission wave and one
        decode chunk of one step, through the dispatcher, whose chunk
        captures the (width, slots) program of each arena at its current
        size. Returns the number of programs held (on the eager path, the
        number of widths run)."""
        sampling = sampling.normalized()
        for w in self.widths:
            self._serve(_Stream([0] * max(1, w - self.capacity + 1), 1, sampling, None,
                                False, at_width=w), None)
        return len(self.widths) if self.programs is None else self.num_programs()

    def generate(self, prefix: Sequence[int], max_new: int,
                 sampling: Optional[SamplingConfig] = None,
                 on_chunk: Optional[Callable[[List[int], Dict[str, Any]], None]] = None,
                 session=None) -> Tuple[List[int], Optional[ArenaSession]]:
        """``ARGenerator.generate``'s contract, the steps run in the shared
        batched step: tokens stream through ``on_chunk(tokens, info)`` on THIS
        thread (``info``: ``pos``, ``steps``, ``chunk_ms`` and ``batched``,
        the slots that stepped in that chunk), episodes re-prefill on the
        grid, and a valid resident ``session`` resumes with no prefill.
        Returns ``(new_tokens, session)``, the session an
        :class:`ArenaSession` (None when the slot's rings are spent)."""
        if self._closed.is_set():
            raise RuntimeError(f"batcher {self.name!r} is closed")
        sampling = (sampling or SamplingConfig()).normalized()
        prefix = [int(t) for t in prefix]
        if len(prefix) < 1:
            raise ValueError("generation needs a non-empty prefix")
        adopt = None
        if (isinstance(session, ArenaSession) and session.seq == prefix
                and session.seed == sampling.seed):
            adopt = session
        if max_new <= 0:
            return [], adopt
        return self._serve(_Stream(prefix, max_new, sampling, adopt,
                                   wants_chunks=on_chunk is not None), on_chunk)

    def _serve(self, st: _Stream, on_chunk) -> Tuple[List[int], Optional[ArenaSession]]:
        """Queue ``st`` for the dispatcher and drain its events."""
        with self._cv:
            self._pending.append(st)
            self._cv.notify_all()
        while True:
            try:
                kind, payload = st.q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError(f"batcher {self.name!r}: the dispatcher thread "
                                       f"died") from None
                continue
            if kind == "tokens":
                if on_chunk is not None:
                    try:
                        on_chunk(*payload)
                    except BaseException:
                        self.cancel(st)  # the consumer died: our stream only
                        raise
            elif kind == "done":
                return payload, st.session_out
            else:
                raise payload

    def cancel(self, st: _Stream) -> None:
        with self._cv:
            st.cancelled = True
            self._cv.notify_all()

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the dispatcher: streams still queued or running end with
        ``RuntimeError`` in their callers, and a later ``generate`` raises."""
        self._closed.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)

    def stats(self) -> Dict[str, Any]:
        """Cumulative aggregates: ``dispatches`` (chunks run), ``steps``
        (stream steps taken), ``batched_steps`` (batched steps launched),
        ``waves`` (admission waves encoded), ``admitted``, ``retired``,
        ``slots`` (allocated across widths), ``arena_bytes`` (their device
        buffers), ``slot_occupancy_mean`` (the mean share of an arena's
        slots that stepped in a chunk), ``steps_per_dispatch_mean`` and
        ``chunk_ms_mean`` (a chunk's host wall, from its launch to its tokens
        read back)."""
        with self._cv:
            d = dict(self._stats)
            d["slots"] = sum(a.n_slots for a in self._arenas.values())
            d["arena_bytes"] = sum(x.numel() * x.element_size()
                                   for a in self._arenas.values() if a.buf is not None
                                   for x in tree_leaves(a.buf))
        n = d["dispatches"]
        fill, chunk_ms = d.pop("fill_sum"), d.pop("chunk_ms_sum")
        d["slot_occupancy_mean"] = round(fill / n, 4) if n else None
        d["steps_per_dispatch_mean"] = round(d["steps"] / n, 3) if n else None
        d["chunk_ms_mean"] = round(chunk_ms / n, 3) if n else None
        return d

    def peek_logits(self, session: ArenaSession) -> Optional[torch.Tensor]:
        """The resident next-token logits (vocab,) f32 of a session, a copy
        on the engine's device, or None when its slot moved on."""
        with self._cv:
            arena = self._arenas.get(session.width)
            if arena is None or arena.buf is None or session.slot >= arena.n_slots:
                return None
            s = arena.slots[session.slot]
            if s.state != _RESIDENT or s.epoch != session.epoch:
                return None
            with torch.inference_mode():
                # enqueued under the lock: before any later install into the slot
                return arena.buf["logits"][session.slot].clone()

    # -- the dispatcher ------------------------------------------------------

    def _has_work(self) -> bool:
        if self._pending:
            return True
        return any(s.state == _ACTIVE for a in self._arenas.values() for s in a.slots)

    def _loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        with torch.inference_mode():   # thread-local: the step writes rings in place
            while True:
                with self._cv:
                    while not self._closed.is_set() and not self._has_work():
                        self._cv.wait(timeout=0.5)
                    if self._closed.is_set():
                        streams = list(self._pending) + [
                            s.stream for a in self._arenas.values() for s in a.slots
                            if s.state == _ACTIVE and s.stream is not None]
                        self._pending.clear()
                        break
                try:
                    self._admit()
                    self._dispatch_round()
                except Exception as e:  # fail the streams, keep the loop
                    self._fail_all(e)
        err = RuntimeError(f"batcher {self.name!r} closed")
        for st in streams:
            st.end("error", err)

    def _fail_all(self, e: BaseException) -> None:
        with self._cv:
            streams = [s.stream for a in self._arenas.values() for s in a.slots
                       if s.state == _ACTIVE and s.stream is not None]
            for a in self._arenas.values():
                for i, s in enumerate(a.slots):
                    if s.state == _ACTIVE:
                        self._retire_slot(a, i, resident=False)
            streams += list(self._pending)
            self._pending.clear()
        for st in streams:
            st.end("error", e)

    def _admit(self) -> None:
        """Place every pending stream it can: adopt a valid resident slot, or
        claim a slot (reclaiming the LRU resident, else growing the arena) and
        encode it in its width's admission waves. Runs at chunk boundaries,
        between batched chunks. A fault here (a grow's copy out of memory,
        say) fails the streams taken off the queue and not yet bound, frees
        the slots reserved for them and goes up to ``_loop``, which fails
        the rest."""
        blocked: List[_Stream] = []
        batch: List[_Stream] = []
        try:
            while True:
                with self._cv:
                    batch = list(self._pending)
                    self._pending.clear()
                    if not batch:
                        self._pending.extend(blocked)
                        return
                self._admit_batch(batch, blocked)
        except BaseException as e:
            with self._cv:
                for a in self._arenas.values():
                    for s in a.slots:
                        if s.state == _ACTIVE and s.stream is None:  # reserved, never bound
                            s.state = _FREE
                            s.epoch += 1
            for st in {id(st): st for st in batch + blocked}.values():
                if not st.placed and not st.ended:
                    st.end("error", e)
            raise

    def _admit_batch(self, batch: List[_Stream], blocked: List[_Stream]) -> None:
        """``_admit``'s placement of one batch taken off the queue; streams
        no slot can take yet go to ``blocked``."""
        fresh: Dict[int, List[Tuple[_Stream, List[int]]]] = {}
        for st in batch:
            if st.cancelled:
                st.end("error", RuntimeError("stream cancelled"))
                continue
            if st.adopt is not None and self._try_adopt(st):
                continue
            cur = st.prefix + st.tokens
            if len(cur) >= self.max_seq_len or len(st.tokens) >= st.max_new:
                self._finish(st, resident_ok=False)
                continue
            width = st.at_width or self.plan_width(len(cur))
            st.at_width = None
            fresh.setdefault(width, []).append((st, cur))
        for width, items in fresh.items():
            arena = self._ensure_arena(width)
            placed: List[Tuple[_Stream, List[int], int]] = []
            for st, cur in items:
                while True:
                    with self._cv:
                        slot = self._claim_slot(arena)
                        if slot is not None:
                            # reserved now: a wave claims several slots
                            # before it binds any
                            arena.slots[slot].state = _ACTIVE
                    if slot is not None:
                        placed.append((st, cur, slot))
                        break
                    if not self._grow(arena):
                        blocked.append(st)
                        break
            for lo in range(0, len(placed), _MAX_PREFILL_ROWS):
                self._encode_group(arena, placed[lo: lo + _MAX_PREFILL_ROWS])

    def _try_adopt(self, st: _Stream) -> bool:
        """Resume on the resident slot with no prefill; False for a stale or
        spent handle (the stream is then encoded afresh)."""
        ses = st.adopt
        st.adopt = None
        with self._cv:
            arena = self._arenas.get(ses.width)
            s = (arena.slots[ses.slot]
                 if arena is not None and ses.slot < arena.n_slots else None)
            if (s is not None and s.state == _RESIDENT and s.epoch == ses.epoch
                    and ses.remaining() >= 1):
                st.tokens = []
                self._bind_slot(arena, ses.slot, st)
                return True
        return False

    def _encode_group(self, arena: _Arena, rows) -> None:
        """One admission wave: the same-width prompts right-padded into one
        (K, W) prefill with per-row lengths, each row's next-token logits
        taken at its own last real token, then all K rows installed into
        their claimed slots by one indexed copy a leaf."""
        if not rows:
            return
        width, dev = arena.width, self.device
        lengths = [len(cur) for _, cur, _ in rows]
        ids = torch.zeros((len(rows), width), dtype=torch.long)
        for j, (_, cur, _) in enumerate(rows):
            ids[j, : len(cur)] = torch.tensor(cur)
        length = torch.tensor(lengths)
        pad = torch.arange(width)[None, :] >= length[:, None]
        try:
            logits, cache = self.model.prefill(ids.to(dev), pad.to(dev), length=length.to(dev))
            last = (length - 1 - (width - logits.shape[1])).to(dev)
            logits = logits[torch.arange(len(rows), device=dev), last].float()
            if arena.buf is None:
                n = arena.n_slots
                buf = tree_map(lambda x: x.new_zeros((n,) + x.shape[1:]),
                               {"cache": cache, "logits": logits})
                with self._cv:
                    arena.buf = buf
            slots = torch.tensor([slot for _, _, slot in rows], device=dev)
            tree_map(lambda b, x: b.index_copy_(0, slots, x), arena.buf,
                     {"cache": cache, "logits": logits})
        except Exception as e:
            # the wave is the blast radius: free its slots, fail its streams
            with self._cv:
                for _, _, slot in rows:
                    arena.slots[slot].state = _FREE
                    arena.slots[slot].epoch += 1
            for st, _, _ in rows:
                st.end("error", e)
            return
        with self._cv:
            for st, _, slot in rows:
                self._bind_slot(arena, slot, st)
            self._stats["waves"] += 1
        self.prefills += len(rows)

    def _finish(self, st: _Stream, resident_ok: bool) -> None:
        """Complete a stream: mint its session handle (a resident slot claim
        while the rings can serve a follow-up) and signal the caller."""
        ses = None
        if st.placed:
            resident = resident_ok and st.width - st.cur_len() >= 1
            with self._cv:
                arena = self._arenas[st.width]
                self._retire_slot(arena, st.slot, resident=resident)
                if resident:
                    ses = ArenaSession(st.prefix + st.tokens, st.width, st.sampling.seed,
                                       len(st.tokens), st.slot, arena.slots[st.slot].epoch)
        st.session_out = ses
        st.end("done", list(st.tokens))

    def _dispatch_round(self) -> None:
        """One chunk boundary: launch every arena's chunk with active slots
        (each enqueues its steps before any chunk's tokens are read back, so
        two widths' chunks overlap on the card), then deliver the tokens,
        retire finished streams and requeue those at an episode boundary."""
        with self._cv:
            widths = [w for w, a in self._arenas.items()
                      if any(s.state == _ACTIVE for s in a.slots)]
        launched = [self._launch_arena(w) for w in widths]
        for rec in launched:
            if rec is not None:
                self._complete_arena(*rec)

    def _launch_arena(self, width: int):
        with self._cv:
            arena = self._arenas[width]
            n = arena.n_slots
            steps_left, positions = [0] * n, [0] * n
            by_slot: Dict[int, _Stream] = {}
            for i, s in enumerate(arena.slots):
                if s.state != _ACTIVE or s.stream is None:
                    continue
                st = s.stream
                if st.cancelled:
                    self._retire_slot(arena, i, resident=False)
                    st.end("error", RuntimeError("stream cancelled"))
                    continue
                steps_left[i] = max(0, min(self.chunk, st.max_new - len(st.tokens),
                                           width - st.cur_len()))
                positions[i] = st.cur_len()
                by_slot[i] = st
            sampling = (list(arena.temp), list(arena.top_k), list(arena.seeds))
        if not by_slot:
            return None
        total = sum(steps_left)
        if total == 0:
            # every bound stream is at a boundary: bookkeeping, no launch
            return arena, by_slot, steps_left, None, 0.0, 0
        t0 = time.perf_counter()
        out = self._decode(arena, steps_left, positions, *sampling)
        return arena, by_slot, steps_left, out, t0, sum(1 for k in steps_left if k)

    @staticmethod
    def _arena_key(arena: _Arena) -> tuple:
        return ("decode", arena.width, arena.n_slots, True)

    def _decode(self, arena: _Arena, steps_left: List[int], positions: List[int],
                temp: List[float], top_k: List[int], seeds: List[int]) -> torch.Tensor:
        rows = (steps_left, positions, temp, top_k, seeds)
        if self.programs is None:
            out = decode_rows(self.model, arena.buf["cache"], arena.buf["logits"], *rows)
        else:
            if arena.decoder is None:
                arena.decoder = DecodeProgram(
                    self.model, arena.buf["cache"], arena.buf["logits"], self.chunk,
                    self.programs, self._arena_key(arena), masked=True)
            out = arena.decoder.run(*rows)
        with self._cv:
            self._stats["batched_steps"] += out.shape[1]
        return out

    def _complete_arena(self, arena: _Arena, by_slot, steps_left, out, t0,
                        active_n: int) -> None:
        total = sum(steps_left)
        if out is None:
            rows, chunk_ms = None, 0.0
        else:
            rows = out.tolist()  # the chunk's one device read
            chunk_ms = round((time.perf_counter() - t0) * 1e3, 3)
            self.steps += total
            with self._cv:
                self._stats["dispatches"] += 1
                self._stats["steps"] += total
                self._stats["fill_sum"] += active_n / max(arena.n_slots, 1)
                self._stats["chunk_ms_sum"] += chunk_ms
        events, requeue = [], []
        with self._cv:
            for i, st in by_slot.items():
                toks = rows[i][: steps_left[i]] if rows is not None else []
                st.tokens.extend(toks)
                if toks and st.wants_chunks:
                    events.append((st, toks, {"pos": st.cur_len(), "steps": len(toks),
                                              "chunk_ms": chunk_ms, "batched": active_n}))
                done = len(st.tokens) >= st.max_new or st.cur_len() >= self.max_seq_len
                if not done and st.cur_len() >= arena.width:
                    # the episode is spent: free the slot, re-place the stream
                    # at the next grid width (a prefill of the extended prefix)
                    self._retire_slot(arena, i, resident=False)
                    st.placed = False
                    requeue.append(st)
            self._pending.extend(requeue)
        for st, toks, info in events:
            st.q.put(("tokens", (toks, info)))
        for st in by_slot.values():
            if len(st.tokens) >= st.max_new or st.cur_len() >= self.max_seq_len:
                self._finish(st, resident_ok=st.cur_len() < self.max_seq_len)
