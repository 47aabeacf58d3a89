"""The serving engines' program families (``inference/programs.py``) on the
CPU, where a program runs its static-buffer path with a direct call in
place of a CUDA graph's replay, so that its keys, capture counts, buffers
and aliasing rules are the card's:

- ``ProgramCache``: keys, captures, the static output a call hands back,
  ``drop``; a capture's launch record takes only its own thread's launches;
- two dispatches of one bucket whose outputs do not alias (the first
  result, and ``MLMServer.encode``'s latents, unchanged after the second);
- ``BatchingEngine.warmup``'s bucket list and ``MLMServer.warmup``'s count
  against the JAX engines' on a tiny configuration, and serving after the
  warmup captures nothing (the JAX zero-compile tests' counterpart), with
  fills and logits equal to the eager path's bit for bit;
- ``tiny_ar`` greedy streams of ``ARGenerator`` and ``ContinuousBatcher``
  through the program path identical to the JAX engines', two sessions
  interleaved at one width each getting the tokens it gets alone, and the
  program path equal to the eager path for sampled streams too;
- an arena grow that drops the old size's program and captures at the new
  (width, slots), and a batcher's ``drop_programs`` that drops its arenas'
  programs;
- ``serve`` warms by default and ``--no_warmup`` skips it, with the same
  lines.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.data import imdb as jimdb
from perceiver_io_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from perceiver_io_tpu.inference.batching import ContinuousBatcher as JaxContinuousBatcher
from perceiver_io_tpu.inference.engine import MLMServer as JaxMLMServer
from perceiver_io_tpu.inference.engine import ServingEngine as JaxServingEngine
from perceiver_io_tpu.inference.generate import ARGenerator as JaxARGenerator
from perceiver_io_tpu.inference.generate import SamplingConfig as JaxSamplingConfig
from perceiver_io_tpu.models import presets as jpresets
from perceiver_io_torch.cli import serve
from perceiver_io_torch.data.tokenizer import load_tokenizer
from perceiver_io_torch.inference.batching import ContinuousBatcher
from perceiver_io_torch.inference.engine import BatchingEngine, MLMServer
from perceiver_io_torch.inference.generate import ARGenerator, SamplingConfig
from perceiver_io_torch.inference.programs import ProgramCache
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.models import presets
from perceiver_io_torch.ops import build

CPU = torch.device("cpu")
VOCAB = 503


@pytest.fixture(scope="module")
def tokenizer_file(tmp_path_factory):
    texts, _ = jimdb.synthetic_reviews(120, seed=1)
    tok = JaxTokenizer()
    tok.train_from_iterator(texts, 300)
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return path


@pytest.fixture(scope="module")
def mlm(tokenizer_file):
    """The JAX tiny MLM (f32), its params, the port's model holding them, and
    texts of several widths and mask counts."""
    jmodel = jpresets.tiny_mlm()
    ids = jnp.zeros((1, 32), jnp.int32)
    params = jmodel.init({"params": jax.random.key(3), "masking": jax.random.key(1)},
                         ids, ids == 1)["params"]
    model = from_jax_params(presets.tiny_mlm(device="cpu"),
                            jax.tree.map(np.asarray, params)).eval()
    texts = [t[: 20 + 7 * i] + " [MASK] " + t[40:50] + " [MASK]" * (1 + i % 3)
             for i, t in enumerate(jimdb.synthetic_reviews(7, seed=2)[0])]
    return jmodel, params, model, texts


@pytest.fixture(scope="module")
def ar_pair():
    """(JAX tiny_ar with ``attn_impl='xla'``, its params, the port's tiny_ar
    holding them), f32."""
    jmodel = jpresets.tiny_ar(dtype=jnp.float32, attn_impl="xla")
    ids = np.zeros((1, 64), np.int32)
    params = jmodel.init({"params": jax.random.key(0)}, ids, ids == 0)["params"]
    port = presets.tiny_ar(dtype=torch.float32, device="cpu")
    return jmodel, params, from_jax_params(port, jax.tree.map(np.asarray, params)).eval()


def _prefix(seed: int, n: int):
    return [int(t) for t in np.random.default_rng(seed).integers(3, VOCAB, n)]


def _fan_out(bat, cases):
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
        t.join(timeout=120)
        assert not t.is_alive(), "a stream did not finish"
    if errs:
        raise errs[0]
    return got


# -- the cache ------------------------------------------------------------------


def test_program_keys_captures_and_static_output():
    cache = ProgramCache(CPU)
    x = torch.arange(6.0).reshape(2, 3)
    prog = cache.build(("double", (3,), 2), lambda a: a * 2, [x.clone()])
    assert cache.captures == 1 and cache.keys() == [("double", (3,), 2)]
    assert torch.equal(prog.output, x * 2)
    first = prog.output
    out = cache.get(("double", (3,), 2)).run(x + 1)
    assert out is first and torch.equal(out, (x + 1) * 2)  # the static buffer, refilled
    assert cache.captures == 1 and cache.pool_bytes() == 0
    assert cache.get(("double", (3,), 4)) is None
    cache.build(("double", (3,), 4), lambda a: a * 2, [torch.zeros(4, 3)])
    assert cache.num_programs() == 2
    assert cache.num_programs(lambda key: key[2] == 4) == 1
    assert cache.drop(lambda key: key[2] == 2) == 1 and cache.keys() == [("double", (3,), 4)]
    assert cache.drop() == 1 and cache.num_programs() == 0 and cache.captures == 2


def test_in_place_program_has_no_output():
    cache = ProgramCache(CPU)
    state = torch.zeros(3)

    def bump():
        state.add_(1)

    prog = cache.build("bump", bump, [])
    assert prog.output is None and prog.run() is None
    assert torch.equal(state, torch.full((3,), 2.0))


def test_capture_takes_only_its_own_threads_launches():
    """During a capture the launches of the capturing thread go to its
    record, which each replay adds; another thread's launches in that window
    count on the counter once, as they ran."""
    counter = build.LaunchCounter()
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait()
        counter.launches += 1
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with build.capturing() as launched:
        counter.launches += 1
        inside.set()
        done.wait(timeout=30)
        counter.launches += 2
    t.join()
    assert launched == {counter: 3} and counter.launches == 1
    counter.launches += 1  # outside the capture: counts
    assert counter.launches == 2
    counter.reset()
    assert counter.launches == 0


@pytest.mark.parametrize("rows", [1, 3])
def test_dispatch_outputs_do_not_alias(rows):
    """A second batch of the same (signature, bucket) replays the program
    that wrote the first one's output: the rows handed out first must stay
    as they were."""
    cache = ProgramCache(CPU)
    eng = BatchingEngine(lambda a: a * 10, 4, CPU, programs=cache, name="x10")
    a = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    first = eng.predict(a)
    again = first.clone()
    second = eng.predict(a + 100)
    assert cache.captures == 1 and eng.num_programs == 1 and eng.dispatches == 2
    assert torch.equal(first, again) and torch.equal(second, torch.from_numpy(a + 100) * 10)


def test_encoded_latents_survive_later_encodes(mlm, tokenizer_file):
    _, _, model, texts = mlm
    tok = load_tokenizer(str(tokenizer_file))
    server = MLMServer(model, None, tok, 32, max_batch=2, device="cpu")
    cached = server.encode(texts[:2])
    kept = cached.latents.clone()
    server.encode(texts[2:4])
    assert torch.equal(cached.latents, kept)
    logits = server.decode(cached, np.zeros((2, 1), np.int32))
    eager = MLMServer(model, None, tok, 32, max_batch=2, device="cpu", graphs=False)
    ref = eager.decode(eager.encode(texts[:2]), np.zeros((2, 1), np.int32))
    np.testing.assert_array_equal(logits, ref)


# -- warmup against the JAX engines --------------------------------------------


@pytest.mark.parametrize("max_batch,buckets", [(6, None), (8, None), (8, [3, 1, 8, 9])])
def test_batching_engine_warmup_buckets_match_jax(max_batch, buckets):
    example = np.ones((1, 3), np.float32)
    with JaxServingEngine(lambda p, x: x * p, jnp.float32(2.0), max_batch=max_batch) as jeng:
        want = jeng.warmup(example, buckets=buckets)
    cache = ProgramCache(CPU)
    eng = BatchingEngine(lambda x: x * 2, max_batch, CPU, programs=cache, name="e")
    assert eng.warmup(example, buckets=buckets) == want
    assert eng.num_programs == len(want) == cache.captures
    for n in want + [2 * max_batch + 1]:  # warm buckets only: nothing captured
        eng.predict(np.ones((n, 3), np.float32))
    assert cache.captures == len(want)


@pytest.mark.parametrize("widths,query_buckets", [([16], (1, 2)), (None, (1, 2, 4))])
def test_mlm_warmup_count_matches_jax_and_serving_captures_nothing(
        mlm, tokenizer_file, widths, query_buckets):
    jmodel, params, model, texts = mlm
    kwargs = dict(bucket_widths=widths, max_batch=2)
    with JaxMLMServer(jmodel, params, JaxTokenizer.from_file(str(tokenizer_file)), 32,
                      **kwargs) as jserver:
        want = jserver.warmup(query_buckets=query_buckets)
        jfills = jserver.fill_masks(texts, k=3)
    tok = load_tokenizer(str(tokenizer_file))
    server = MLMServer(model, None, tok, 32, device="cpu", **kwargs)
    assert server.warmup(query_buckets=query_buckets) == want == server.num_programs()
    assert server.programs.captures == want
    fills = server.fill_masks(texts, k=3)
    cached = server.encode(texts)
    cached_fills = server.fill_masks_cached(cached, k=3)
    if query_buckets == (1, 2, 4):  # every mask-count bucket of the texts is warm
        assert server.programs.captures == want
    assert fills == jfills == cached_fills
    eager = MLMServer(model, None, tok, 32, device="cpu", graphs=False, **kwargs)
    assert eager.warmup(query_buckets=query_buckets) == want and eager.num_programs() == 0
    assert eager.fill_masks(texts, k=3) == fills
    np.testing.assert_array_equal(
        server.decode(cached, np.tile(np.arange(2, dtype=np.int32), (len(texts), 1))),
        eager.decode(eager.encode(texts), np.tile(np.arange(2, dtype=np.int32),
                                                  (len(texts), 1))))


def test_drop_programs_recaptures(mlm, tokenizer_file):
    _, _, model, texts = mlm
    server = MLMServer(model, None, load_tokenizer(str(tokenizer_file)), 32, max_batch=2,
                       device="cpu")
    fills = server.fill_masks(texts[:2], k=2)
    n = server.num_programs()
    assert n >= 1 and server.drop_programs() == n and server.num_programs() == 0
    assert server.fill_masks(texts[:2], k=2) == fills and server.num_programs() == n
    assert server.programs.captures == 2 * n


# -- generation -----------------------------------------------------------------


def test_ar_warmup_captures_every_width_then_nothing(ar_pair):
    gen = ARGenerator(ar_pair[2], None, 64, chunk=4, device="cpu")
    assert gen.warmup() == len(gen.widths) == 5
    assert sorted(gen.programs.keys()) == [("decode", w, 1, False) for w in gen.widths]
    gen.generate(_prefix(1, 5), 64)  # crosses every episode boundary
    assert gen.programs.captures == 5
    assert gen.drop_programs() == 5 and gen.num_programs() == 0


def test_ar_greedy_streams_match_jax_through_programs(ar_pair):
    jmodel, params, port = ar_pair
    jgen = JaxARGenerator(jmodel, params, max_seq_len=64, chunk=16, name="programs")
    gen = ARGenerator(port, None, 64, chunk=4, device="cpu")
    for seed, n in ((4, 5), (8, 20)):
        prefix = _prefix(seed, n)
        assert gen.generate(prefix, 64)[0] == jgen.generate(prefix, 64, JaxSamplingConfig())[0]
    assert gen.num_programs() == 5


@pytest.mark.parametrize("sampling", [SamplingConfig(),
                                      SamplingConfig(temperature=0.8, top_k=16, seed=3)])
def test_interleaved_sessions_at_one_width_match_alone(ar_pair, sampling):
    """Two sessions at width 16 take turns chunk by chunk on the width's one
    program: each gets the tokens it gets alone, and the eager path's."""
    port = ar_pair[2]
    gen = ARGenerator(port, None, 64, chunk=2, device="cpu")
    eager = ARGenerator(port, None, 64, chunk=2, device="cpu", graphs=False)
    prefixes = [_prefix(11, 4), _prefix(12, 6)]
    alone = [gen.generate(p, 8, sampling)[0] for p in prefixes]
    assert alone == [eager.generate(p, 8, sampling)[0] for p in prefixes]
    sessions = [gen.start(p, seed=sampling.seed) for p in prefixes]
    assert {s.width for s in sessions} == {16}
    got = [[], []]
    for _ in range(4):
        for j, s in enumerate(sessions):
            got[j] += gen.decode_chunk(s, sampling)
    assert got == alone
    assert gen.programs.captures == 1


def test_arena_streams_match_jax_and_eager_through_programs(ar_pair):
    jmodel, params, port = ar_pair
    rng = np.random.default_rng(5)
    cases = [(_prefix(20 + i, int(rng.integers(2, 10))), int(rng.integers(3, 22)),
              SamplingConfig(temperature=0.8 * (i % 2), top_k=16, seed=i)) for i in range(6)]
    bat = ContinuousBatcher(port, None, 64, chunk=4, slots=4, max_slots=4, device="cpu")
    eager = ContinuousBatcher(port, None, 64, chunk=4, slots=4, max_slots=4, device="cpu",
                              graphs=False)
    jbat = JaxContinuousBatcher(jmodel, params, max_seq_len=64, chunk=4, slots=4,
                                max_slots=4, name="programs")
    try:
        assert bat.warmup() == len(bat.widths) == bat.num_programs()
        captures = bat.programs.captures
        got = _fan_out(bat, cases)
        assert bat.programs.captures == captures  # the family was warm
        assert got == _fan_out(eager, cases)
        for case, tokens in zip(cases, got):
            if case[2].temperature == 0.0:
                assert jbat.generate(case[0], case[1], JaxSamplingConfig())[0] == tokens
        assert sorted(bat.programs.keys()) == [("decode", w, 4, True)
                                                    for w in bat.widths]
    finally:
        for b in (bat, eager, jbat):
            b.close()


def test_arena_grow_recaptures_at_the_new_size(ar_pair):
    port = ar_pair[2]
    oracle = ARGenerator(port, None, 64, chunk=4, device="cpu")
    bat = ContinuousBatcher(port, None, 64, chunk=4, slots=1, max_slots=4, device="cpu")
    try:
        bat.generate(_prefix(30, 5), 2)
        assert bat.programs.keys() == [("decode", 16, 1, True)]
        cases = [(_prefix(31 + i, 3 + i), 6, SamplingConfig()) for i in range(3)]
        got = _fan_out(bat, cases)
        assert got == [oracle.generate(*case)[0] for case in cases]
        keys = bat.programs.keys()
        assert ("decode", 16, 1, True) not in keys and len(keys) == 1
        assert keys[0][:2] == ("decode", 16) and keys[0][2] in (2, 4)
        assert bat._arenas[16].n_slots == keys[0][2]
        assert bat.programs.captures >= 2
    finally:
        bat.close()


def test_arena_drop_programs_recaptures(ar_pair):
    """A batcher's ``drop_programs`` forgets its arenas' programs (what a swap
    of implementations needs): none is held after it, and the next chunk
    captures again with the same tokens."""
    port = ar_pair[2]
    bat = ContinuousBatcher(port, None, 64, chunk=4, slots=2, max_slots=2, device="cpu")
    try:
        case = (_prefix(40, 5), 6, SamplingConfig())
        first = bat.generate(*case)[0]
        n = bat.num_programs()
        assert n == 1 and bat.programs.keys() == [("decode", 16, 2, True)]
        assert bat.drop_programs() == n and bat.num_programs() == 0
        assert bat.generate(*case)[0] == first
        assert bat.num_programs() == n and bat.programs.captures == 2 * n
    finally:
        bat.close()


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("task", ["mlm", "generate"])
def test_serve_warms_by_default_and_no_warmup_skips(tokenizer_file, capsys, task):
    if task == "mlm":
        argv = ["--preset", "tiny", "--init_seed", "0", "--tokenizer", str(tokenizer_file),
                "--cpu", "--max_batch", "2", "--bucket_widths", "32",
                "--texts", "a [MASK] movie", "the [MASK] was [MASK]"]
    else:
        argv = ["--task", "generate", "--preset", "tiny_ar", "--init_seed", "0", "--cpu",
                "--max_new_tokens", "6", "--texts", "5 17 42", "7 8"]
    warm = serve.main(argv + ["--blocking_warmup"])
    err = capsys.readouterr().err
    assert "serve: warmed" in err
    cold = serve.main(argv + ["--no_warmup"])
    out, err = capsys.readouterr()
    assert "serve: warmed" not in err
    assert cold == warm == [json.loads(line) for line in out.splitlines()]
