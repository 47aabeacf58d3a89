"""Captured programs: the serving engines' closed families of CUDA graphs
(the port's counterpart of the JAX engine's compiled executables,
``ServingEngine._execute`` / ``_aot_program`` and ``aot/cache.py``'s
``ExecutableCache``, in process only: a CUDA graph cannot be written to
disk).

A program is one function over static buffers, kept in a
:class:`ProgramCache` under its signature: the engine's family, the
trailing shapes and dtypes of its inputs, the batch bucket, and the code
path (whether a decode step selects rows with ``active``, say). Its inputs
are buffers the program owns: a call copies each input into its buffer
(from pinned host memory where the input lies on the host) and the
function's output is copied into a static output buffer, which the caller
must copy before the next call of the same cache overwrites it.

On CUDA the first call of a key runs the function for real on the cache's
side stream (the warm-up, whose result that call returns), then captures
it with a CUDA graph into the cache's memory pool; every later call
replays the graph. The function must therefore read and write nothing but
its static buffers (and the model's weights, which must be loaded into the
live tensors and never replaced after a capture). A capture or a replay
that fails raises: there is no eager fallback. On the CPU a call runs the
same static-buffer path with a direct call of the function in place of the
replay.

The kernels' launch counters (``ops/build.LaunchCounter``) count the
wrappers' Python calls: the calls a capture makes on its thread go to the
capture's record instead (``build.capturing``), and each replay adds them,
so a counter reads the launches the card ran whether they came from a
replay or an eager call, and other threads' launches during a capture
count once.

Every program of one cache shares one memory pool. That is safe because
the programs of a cache run one after another on one stream and their
outputs are copied into buffers allocated outside the capture, so no
program's intermediate tensors outlive its replay. A cache that has dropped
all its programs, or whose capture failed, takes a new pool: PyTorch's
allocator refuses to record into a pool whose graphs are gone, or into one
a failed capture left open.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from perceiver_io_torch.ops import build


def fill(static: torch.Tensor, value: torch.Tensor) -> None:
    """Copy ``value`` into the program buffer ``static``: from pinned host
    memory, without waiting, where ``value`` lies on the host and ``static``
    on the card."""
    if value is static:
        return
    if static.device.type == "cuda" and value.device.type == "cpu":
        static.copy_(value.pin_memory(), non_blocking=True)
    else:
        static.copy_(value)


class Program:
    """One function over its static ``inputs``; ``output`` is the static
    buffer its result is copied into (None for a function that writes its
    buffers in place and returns None). ``graph`` is None on the CPU."""

    __slots__ = ("fn", "inputs", "output", "graph", "deltas")

    def __init__(self, fn: Callable, inputs: List[torch.Tensor]):
        self.fn = fn
        self.inputs = inputs
        self.output: Optional[torch.Tensor] = None
        self.graph = None
        self.deltas: List[Tuple[build.LaunchCounter, int]] = []

    def _call(self) -> None:
        """The function once, its result into ``output``."""
        out = self.fn(*self.inputs)
        if self.output is not None:
            self.output.copy_(out)

    def run(self, *values: torch.Tensor) -> Optional[torch.Tensor]:
        """Fill the inputs with ``values`` (all or none), replay (the CPU:
        call), return the static output."""
        for static, value in zip(self.inputs, values):
            fill(static, value)
        if self.graph is None:
            self._call()
        else:
            self.graph.replay()
            for counter, n in self.deltas:
                counter.launches += n
        return self.output


class ProgramCache:
    """The programs of one engine (or of engines that share a stream), by
    key. ``captures`` counts the programs built, ``pool_bytes()`` the card
    memory their pools hold."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.captures = 0
        self._programs: Dict[Hashable, Program] = {}
        self._lock = threading.Lock()
        self._pool = self._stream = None
        self._pools: List[tuple] = []  # every pool this cache recorded into
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._new_pool()

    def _new_pool(self) -> None:
        if self._stream is not None:
            self._pool = torch.cuda.graph_pool_handle()
            self._pools.append(tuple(self._pool))

    def get(self, key: Hashable) -> Optional[Program]:
        with self._lock:
            return self._programs.get(key)

    def keys(self) -> List[Hashable]:
        with self._lock:
            return list(self._programs)

    def num_programs(self, where: Optional[Callable[[Hashable], bool]] = None) -> int:
        """The programs held (those whose key ``where`` accepts)."""
        with self._lock:
            return sum(1 for k in self._programs if where is None or where(k))

    def pool_bytes(self) -> int:
        """Card memory the pools of this cache's captures hold (0 on the
        CPU): the segments the allocator reserved for them."""
        if self._stream is None:
            return 0
        pools = set(self._pools)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)

    def drop(self, where: Optional[Callable[[Hashable], bool]] = None) -> int:
        """Forget the programs whose key ``where`` accepts (default all):
        what a swap of implementations or of buffers must do, since a
        program replays what it captured. Returns how many went."""
        with self._lock:
            gone = [k for k in self._programs if where is None or where(k)]
            for k in gone:
                del self._programs[k]
            if not self._programs:
                self._new_pool()
        return len(gone)

    def build(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor]) -> Program:
        """The program ``key`` of ``fn(*inputs)`` over the static ``inputs``
        (already filled): runs ``fn`` once for real (the caller's call;
        ``output`` holds its result, if it returns one) and on CUDA captures
        it. Raises when the capture fails; nothing is kept then."""
        prog = Program(fn, list(inputs))
        if self._stream is None:
            out = fn(*prog.inputs)
            if out is not None:
                prog.output = out.clone()
        else:
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = fn(*prog.inputs)  # the warm-up, and this call's result
            current.wait_stream(self._stream)
            if out is not None:
                prog.output = out.clone()
            del out
            try:
                prog.graph, prog.deltas = self._capture(prog)
            except BaseException:
                self._new_pool()
                raise
        with self._lock:
            self._programs[key] = prog
            self.captures += 1
        return prog

    def _capture(self, prog: Program):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream), build.capturing() as launched:
            # thread_local: CUDA calls of other threads (callers of a
            # batcher's dispatcher, say) cannot invalidate this capture
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                prog._call()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is void; the function's error is the one to see
                raise
            graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return graph, [(c, n) for c, n in launched.items() if n]
