"""The port's continuous batching for Perceiver-AR decode
(perceiver_io_torch/inference/batching.py, ``PerceiverARLM.step`` with
per-row positions, the wave ``prefill``, ``serve --decode_batching``)
against the JAX package and the port's own ``ARGenerator``, on the CPU,
where the kernels' wrappers run their plain versions.

``tiny_ar`` in f32 with the JAX weights carried over by ``interop``; the
JAX model runs ``attn_impl='xla'``:

- the per-row step at B=4 (four positions, one inactive row) against the
  JAX ``step`` run row by row: logits and written rings within 2e-5, the
  inactive row's rings, pad mask and position bit for bit; a zero slot
  reads finite values;
- the wave prefill (K=3, ragged lengths) against the JAX prefill per row,
  2e-5;
- ``sample_logits_rows`` against ``sample_logits`` row by row: the same
  tokens over greedy, sampled and ``top_k`` rows;
- 8 mixed concurrent streams over fewer slots, crossing width 16 -> 31:
  each identical to the port's ``ARGenerator``, the greedy ones identical to
  the JAX ``ContinuousBatcher``'s;
- a resident session resumes with no prefill; ``peek_logits`` against the
  JAX dense forward, 2e-5;
- churn: 16 streams over 2 -> 4 slots; ``close()``, after which
  ``generate`` raises; a dispatcher fault, in a step or in admission,
  raises in every caller;
- the ``int8w`` arena against the ``int8w`` ``ARGenerator``;
- the CLI's ``--decode_batching`` lines equal its lines without the flag.
"""

import json
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.inference.batching import ContinuousBatcher as JaxContinuousBatcher
from perceiver_io_tpu.inference.generate import SamplingConfig as JaxSamplingConfig
from perceiver_io_tpu.models import presets as jpresets
from perceiver_io_torch.cli import serve
from perceiver_io_torch.inference.batching import ArenaSession, ContinuousBatcher
from perceiver_io_torch.inference.generate import (
    ARGenerator,
    SamplingConfig,
    position_seed,
    sample_logits,
    sample_logits_rows,
)
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.models import presets

VOCAB = 503
TOL = dict(atol=2e-5, rtol=2e-5)
W = 16  # tiny_ar's first episode width (16 latents)


@pytest.fixture(scope="module")
def pair():
    """(JAX tiny_ar, its params, the port's tiny_ar carrying them), f32."""
    jmodel = jpresets.tiny_ar(dtype=jnp.float32, attn_impl="xla")
    ids = np.zeros((1, 64), np.int32)
    params = jmodel.init({"params": jax.random.key(0)}, ids, ids == 0)["params"]
    port = presets.tiny_ar(dtype=torch.float32, device="cpu")
    return jmodel, params, from_jax_params(port, jax.tree.map(np.asarray, params)).eval()


@pytest.fixture(scope="module")
def oracle(pair):
    return ARGenerator(pair[2], None, 64, chunk=4, device="cpu")


@pytest.fixture(scope="module")
def batcher(pair):
    bat = ContinuousBatcher(pair[2], None, 64, chunk=4, slots=4, max_slots=4, device="cpu")
    yield bat
    bat.close()


@pytest.fixture(scope="module")
def jax_batcher(pair):
    jmodel, params, _ = pair
    bat = JaxContinuousBatcher(jmodel, params, max_seq_len=64, chunk=4, slots=4,
                               max_slots=4, name="torch-batching")
    yield bat
    bat.close()


def _leaves(cache):
    """The cache's arrays in one order for both packages (``len`` aside)."""
    tree = {k: cache[k] for k in ("cross", "pad", "latent", "final")}
    return jax.tree_util.tree_leaves(tree)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _wave(rng, lengths, w=W):
    ids = np.zeros((len(lengths), w), np.int64)
    for j, p in enumerate(lengths):
        ids[j, :p] = rng.integers(3, VOCAB, p)
    pad = np.arange(w)[None, :] >= np.asarray(lengths)[:, None]
    return ids, pad


def _jax_prefill(jmodel, params, ids, pad, p):
    return jmodel.apply({"params": params}, ids[None].astype(np.int32), pad[None],
                        length=jnp.asarray(p, jnp.int32), method="prefill")


def test_wave_prefill_matches_jax_prefill_per_row(pair):
    """K=3 prompts of ragged lengths in one prefill: each row's logits and
    cache (per-row ``len``) against the JAX prefill of that row alone."""
    jmodel, params, port = pair
    lengths = [2, 9, 15]
    ids, pad = _wave(np.random.default_rng(1), lengths)
    with torch.inference_mode():
        logits, cache = port.prefill(torch.from_numpy(ids), torch.from_numpy(pad),
                                     length=torch.tensor(lengths))
    assert cache["len"].tolist() == lengths and cache["len"].dtype == torch.long
    for j, p in enumerate(lengths):
        jlogits, jcache = _jax_prefill(jmodel, params, ids[j], pad[j], p)
        np.testing.assert_allclose(logits[j].numpy(), np.asarray(jlogits)[0], **TOL)
        for a, r in zip(_leaves(cache), _leaves(jcache)):
            np.testing.assert_allclose(_np(a[j]), _np(r[0]), **TOL)


def test_step_rows_match_jax_step_row_by_row(pair):
    """B=4 at four positions, row 2 inactive: the active rows' logits and
    every ring against the JAX step of that row alone (2e-5); the inactive
    row's rings, pad mask and position bit for bit; a zero cache (an arena's
    free slots) gives finite logits."""
    jmodel, params, port = pair
    rng = np.random.default_rng(2)
    lengths = [3, 7, 10, 12]
    ids, pad = _wave(rng, lengths)
    tok = rng.integers(3, VOCAB, (4, 1))
    active = torch.tensor([True, True, False, True])
    with torch.inference_mode():
        _, cache = port.prefill(torch.from_numpy(ids), torch.from_numpy(pad),
                                length=torch.tensor(lengths))
        before = [x.clone() for x in _leaves(cache)]
        logits, cache = port.step(cache, torch.from_numpy(tok), active)
    assert cache["len"].tolist() == [4, 8, 10, 13]
    for j, p in enumerate(lengths):
        if not active[j]:
            assert all(torch.equal(a[j], b[j]) for a, b in zip(_leaves(cache), before))
            continue
        _, jcache = _jax_prefill(jmodel, params, ids[j], pad[j], p)
        jlogits, jcache = jmodel.apply({"params": params}, jcache,
                                       tok[j: j + 1].astype(np.int32), method="step")
        np.testing.assert_allclose(logits[j].numpy(), np.asarray(jlogits)[0], **TOL)
        for a, r in zip(_leaves(cache), _leaves(jcache)):
            np.testing.assert_allclose(_np(a[j]), _np(r[0]), **TOL)
    with torch.inference_mode():
        zero = jax.tree_util.tree_map(torch.zeros_like, cache)
        out, zero = port.step(zero, torch.from_numpy(tok), torch.zeros(4, dtype=torch.bool))
    assert bool(torch.isfinite(out).all()) and zero["len"].tolist() == [0] * 4


def test_sample_logits_rows_matches_sample_logits():
    """Greedy, sampled and top_k rows in one batch: each row's token equals
    ``sample_logits`` on that row with the generator ``ARGenerator`` seeds."""
    logits = torch.from_numpy(np.random.default_rng(4).normal(size=(6, VOCAB)).astype(
        np.float32)) * 3
    temperature = [0.0, 0.8, 1.3, 0.0, 0.5, 0.8]
    top_k = [0, 0, 16, 5, 1, VOCAB]
    seeds = [0, 1, 2, 3, 4, 5]
    positions = [7, 30, 12, 3, 63, 30]
    got = sample_logits_rows(logits, temperature, top_k, seeds, positions)
    for b in range(6):
        gen = torch.Generator().manual_seed(position_seed(seeds[b], positions[b]))
        want = sample_logits(logits[b: b + 1], gen, temperature[b], top_k[b])
        assert int(got[b]) == int(want[0]), b
    assert int(got[4]) == int(logits[4].argmax())  # top_k 1 is greedy
    # rows left out of ``rows`` keep the argmax
    only = sample_logits_rows(logits, temperature, top_k, seeds, positions, rows=[2])
    assert int(only[1]) == int(logits[1].argmax()) and int(only[2]) == int(got[2])


def _fan_out(bat, cases):
    """Every (prefix, max_new, sampling) case through ``bat`` from its own
    thread; the tokens per case, in order."""
    got, errs = [None] * len(cases), []

    def one(i):
        try:
            got[i] = bat.generate(*cases[i])[0]
        except Exception as e:  # re-raised below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a stream did not finish"
    if errs:
        raise errs[0]
    return got


def _cases(rng, n, budget=22):
    cases = []
    for i in range(n):
        prefix = [int(t) for t in rng.integers(3, VOCAB, int(rng.integers(2, 10)))]
        temp = float(rng.choice([0.0, 0.8]))
        cases.append((prefix, int(rng.integers(1, budget)),
                      SamplingConfig(temperature=temp, top_k=16, seed=i)))
    return cases


def test_concurrent_streams_match_argenerator_and_jax_batcher(oracle, batcher, jax_batcher):
    """8 mixed streams over 4 slots, budgets crossing the 16 -> 31 episode
    boundary: each identical to the port's ``ARGenerator`` serving it alone;
    the greedy ones identical to the JAX ``ContinuousBatcher``'s (one at a
    time there: its greedy tokens do not depend on the company)."""
    cases = _cases(np.random.default_rng(5), 8)
    cases[0] = (cases[0][0], 21, SamplingConfig(seed=0))  # one greedy stream crosses
    want = [oracle.generate(*case)[0] for case in cases]
    before = batcher.stats()
    got = _fan_out(batcher, cases)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"stream {i} diverged: {g} vs {w}"
    greedy = [i for i, case in enumerate(cases) if case[2].temperature == 0.0]
    assert len(greedy) >= 2 and 0 in greedy
    for i in greedy:
        prefix, max_new, _ = cases[i]
        assert jax_batcher.generate(prefix, max_new, JaxSamplingConfig())[0] == got[i]
    stats = batcher.stats()
    assert stats["admitted"] - before["admitted"] >= 9  # stream 0 re-placed at width 31
    assert stats["dispatches"] > before["dispatches"] and stats["slots"] == 8


def test_resident_session_adopts_without_prefill(oracle, batcher):
    """A follow-up on the returned ``ArenaSession`` resumes its slot with no
    prefill and continues the stream the engine gives in one call; a stale
    handle re-encodes."""
    prefix = [int(t) for t in np.random.default_rng(6).integers(3, VOCAB, 5)]
    sampling = SamplingConfig(temperature=0.8, top_k=16, seed=3)
    full, _ = oracle.generate(prefix, 8, sampling)
    a, session = batcher.generate(prefix, 4, sampling)
    assert isinstance(session, ArenaSession) and session.seq == prefix + a
    before = batcher.prefills
    b, session2 = batcher.generate(prefix + a, 4, sampling, session=session)
    assert a + b == full and batcher.prefills == before
    assert session2.slot == session.slot and session2.epoch != session.epoch
    batcher.generate(prefix + a, 4, sampling, session=session)  # stale: re-encoded
    assert batcher.prefills == before + 1


def test_peek_logits_matches_jax_dense_forward(pair, batcher):
    """The resident next-token logits against the JAX dense forward of the
    accepted sequence at the session's width, 2e-5."""
    jmodel, params, _ = pair
    rng = np.random.default_rng(7)
    for plen, max_new in ((4, 6), (12, 9)):  # the second crosses into width 31
        prefix = [int(t) for t in rng.integers(3, VOCAB, plen)]
        _, session = batcher.generate(prefix, max_new, SamplingConfig())
        seq, w = session.seq, session.width
        assert w == (16 if len(seq) < 16 else 31)
        ids = np.zeros((1, w), np.int32)
        ids[0, : len(seq)] = seq
        dense = np.asarray(jmodel.apply({"params": params}, ids,
                                        np.arange(w)[None] >= len(seq)))
        row = len(seq) - 1 - (w - dense.shape[1])
        np.testing.assert_allclose(batcher.peek_logits(session).numpy(), dense[0, row],
                                   **TOL)


def test_churn_grows_the_arena_then_close_refuses(pair, oracle):
    """16 streams over 2 slots a width, growing to 4: every stream equal to
    the engine's; residents reclaimed and slots re-bound; then
    ``close()``, after which ``generate`` raises."""
    bat = ContinuousBatcher(pair[2], None, 64, chunk=4, slots=2, max_slots=4, device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # thread switches in the middle of the slot table's updates
    try:
        cases = _cases(np.random.default_rng(8), 16, budget=12)
        got = _fan_out(bat, cases)
        assert got == [oracle.generate(*case)[0] for case in cases]
        stats = bat.stats()
        assert stats["admitted"] >= 16 and stats["retired"] == stats["admitted"]
        # two widths at 2 slots each, and at least one of them doubled
        assert 4 < stats["slots"] <= 8 and 0 < stats["slot_occupancy_mean"] <= 1
        assert stats["arena_bytes"] > 0 and stats["waves"] >= 1
    finally:
        sys.setswitchinterval(interval)
        bat.close()
    with pytest.raises(RuntimeError, match="closed"):
        bat.generate([5, 6, 7], 4)


def test_dispatcher_fault_raises_in_every_caller(pair):
    """A step that raises fails every stream it carried, in its caller's
    ``generate``; the dispatcher serves on once the fault is gone."""
    bat = ContinuousBatcher(pair[2], None, 64, chunk=4, slots=4, device="cpu")
    try:
        step = bat.model.step

        def broken(*args, **kwargs):
            raise RuntimeError("injected step fault")

        bat.model.step = broken
        errs = []

        def one(prefix):
            try:
                bat.generate(prefix, 4)
            except RuntimeError as e:
                errs.append(str(e))

        threads = [threading.Thread(target=one, args=([5 + i, 6, 7],)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert errs == ["injected step fault"] * 3
        bat.model.step = step
        assert len(bat.generate([5, 6, 7], 4)[0]) == 4
    finally:
        bat.close()


@pytest.mark.parametrize("where", ["_grow", "_claim_slot"])
def test_admission_fault_raises_in_every_caller(pair, where):
    """Four streams taken off the queue in one admission, one slot: a fault
    in the arena's growth (or in a slot claim) while they wait for a slot
    raises in all four callers' ``generate``, the slot reserved for the
    first is freed, and the dispatcher serves on once the fault is gone."""
    bat = ContinuousBatcher(pair[2], None, 64, chunk=4, slots=1, max_slots=2, device="cpu")
    gate = threading.Event()
    has_work = bat._has_work
    bat._has_work = lambda: gate.is_set() and has_work()  # hold the dispatcher
    try:
        def broken(*args, **kwargs):
            raise RuntimeError(f"injected {where} fault")

        setattr(bat, where, broken)  # with "_grow", the first stream takes the one slot
        errs = []

        def one(prefix):
            try:
                bat.generate(prefix, 20)
            except RuntimeError as e:
                errs.append(str(e))

        threads = [threading.Thread(target=one, args=([5 + i, 6, 7],)) for i in range(4)]
        for t in threads:
            t.start()
        while len(bat._pending) < 4:
            assert all(t.is_alive() for t in threads)
            threading.Event().wait(0.01)
        gate.set()
        with bat._cv:
            bat._cv.notify_all()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "a caller was never told of the fault"
        assert errs == [f"injected {where} fault"] * 4
        delattr(bat, where)
        assert all(s.state != "active" for a in bat._arenas.values() for s in a.slots)
        assert len(bat.generate([5, 6, 7], 4)[0]) == 4
    finally:
        bat.close()


def test_int8w_arena_matches_int8w_argenerator(pair):
    """int8 weights (bf16 compute): the arena's streams equal the int8w
    per-session engine's over the same tree."""
    port = pair[2]
    q8 = ARGenerator(port, None, 64, chunk=4, compute_dtype="int8w", device="cpu")
    bat = ContinuousBatcher(port, None, 64, chunk=4, slots=4, compute_dtype="int8w",
                            device="cpu")
    try:
        cases = _cases(np.random.default_rng(9), 5, budget=10)
        assert _fan_out(bat, cases) == [q8.generate(*case)[0] for case in cases]
        assert bat.quantize == "int8" and bat.compute_dtype == "bfloat16"
        assert bat.warmup() == len(bat.widths)
    finally:
        bat.close()


def _serve(capsys, argv):
    results = serve.main(["--task", "generate", "--cpu", "--preset", "tiny_ar",
                          "--init_seed", "0", "--max_new_tokens", "6", "--generate_chunk",
                          "4", "--texts", "5 6 7", "9 10 11 12", "3", *argv])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == results
    return lines


def test_serve_cli_decode_batching_lines(capsys):
    """``--decode_batching --decode_slots 2`` prints the lines it prints
    without the flag, greedy and sampled."""
    for extra in ([], ["--temperature", "0.8", "--top_k", "8", "--gen_seed", "2"]):
        plain = _serve(capsys, extra)
        assert len(plain) == 3 and all(len(x["continuation_ids"]) == 6 for x in plain)
        assert _serve(capsys, ["--decode_batching", "--decode_slots", "2", *extra]) == plain


def test_batching_imports_no_jax():
    code = ("import sys, perceiver_io_torch.inference.batching; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'perceiver_io_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
