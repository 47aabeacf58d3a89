"""The port's Perceiver-AR generation (perceiver_io_torch/models/perceiver.py
``PerceiverARLM``, perceiver_io_torch/inference/generate.py, the serve CLI's
``--task generate``) against the JAX package, on the CPU, where the attention
wrapper runs its plain version with the causal offset.

- the model: the dense forward, ``prefill``'s logits and every cache tensor,
  and three ``step``s against the JAX ``PerceiverARLM`` with the weights
  carried by path, on ``tiny_ar`` and on ``flagship_ar`` shrunk as
  tests/test_generate.py shrinks it (64 tokens, 16 latents, 3-layer blocks,
  f32); the JAX side runs ``attn_impl='xla'``, the same function as its
  kernel path (tests/test_masking.py pins that). f32, 1e-5.
- the port's own spine: every step's logits equal the dense forward of the
  same prefix within 2e-5, across the padded prefill width.
- the engine: greedy tokens identical to the JAX ``ARGenerator``'s across
  every episode boundary of ``tiny_ar`` (widths 16, 31, 46, 61, 64); sampled
  streams split-consistent (a stream re-encoded from its prefix at any point
  continues identically), ``top_k=1`` equal to greedy, ``SamplingConfig``'s
  refusals as JAX's; a session passed back continues without a prefill.
- the kernel calls a prefill and a step make at the flagship depth: 22
  attention calls each (causal in the prefill, pad-masked in the step) and
  131 dequant matmuls each on the int8 path.
- what raises: ``'packed'`` with a causal offset. The dense forward under
  autograd gives the JAX model's gradients. The CLI prints one JSON line per
  prompt.
"""

import functools
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.inference.generate import ARGenerator as JaxARGenerator
from perceiver_io_tpu.inference.generate import SamplingConfig as JaxSamplingConfig
from perceiver_io_tpu.models import adapters as jad
from perceiver_io_tpu.models import presets as jpresets
from perceiver_io_torch.cli import serve
from perceiver_io_torch.data.imdb import synthetic_reviews
from perceiver_io_torch.data.tokenizer import WordPieceTokenizer
from perceiver_io_torch.inference.generate import ARGenerator, SamplingConfig, position_seed
from perceiver_io_torch.interop import flatten_tree, from_jax_params, load_param_tree
from perceiver_io_torch.models import adapters as pad_
from perceiver_io_torch.models import presets
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import qmatmul as qm
from perceiver_io_torch.ops.attention import MultiHeadAttention

VOCAB = 503
TOL = dict(atol=1e-5, rtol=1e-5)
# flagship_ar at its structure (C=512, 4 heads of depth 128, 3 layers), its
# sequence, window and blocks shrunk for the CPU as tests/test_generate.py does
CONFIGS = {
    "tiny_ar": dict(),
    "flagship_ar": dict(max_seq_len=64, num_latents=16, num_self_attention_layers_per_block=3),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, its params, the port's model carrying them), f32."""
    jmodel = getattr(jpresets, name)(**CONFIGS[name], dtype=jnp.float32, attn_impl="xla")
    ids = np.zeros((1, 64), np.int32)
    params = jmodel.init({"params": jax.random.key(0)}, ids, ids == 0)["params"]
    port = getattr(presets, name)(**CONFIGS[name], dtype=torch.float32, device="cpu")
    return jmodel, params, from_jax_params(port, jax.tree.map(np.asarray, params))


def _padded_prefix(rng, b, p, w):
    ids = np.zeros((b, w), np.int32)
    ids[:, :p] = rng.integers(3, VOCAB, (b, p))
    return ids, np.broadcast_to(np.arange(w)[None, :] >= p, (b, w)).copy()


def _cache_leaves(cache):
    """The cache's arrays in one order for both packages (``len`` aside)."""
    tree = {k: cache[k] for k in ("cross", "pad", "latent", "final")}
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32)
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ar_model_matches_jax(name):
    """Dense forward, prefill logits and cache, and three steps (logits and
    the cache after them) against the JAX model, f32, 1e-5."""
    jmodel, params, port = _pair(name)
    rng = np.random.default_rng(1)
    b, p, w = 2, 9, 15
    ids, pad = _padded_prefix(rng, b, p, w)
    jp = {"params": params}
    with torch.inference_mode():
        dense = port(torch.from_numpy(ids), torch.from_numpy(pad)).numpy()
        logits, cache = port.prefill(torch.from_numpy(ids), torch.from_numpy(pad), length=p)
    np.testing.assert_allclose(dense, np.asarray(jmodel.apply(jp, ids, pad)), **TOL)
    jlogits, jcache = jmodel.apply(jp, ids, pad, length=jnp.asarray(p, jnp.int32),
                                   method="prefill")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert cache["len"].tolist() == [int(jcache["len"])] * b and int(jcache["len"]) == p
    got, ref = _cache_leaves(cache), _cache_leaves(jcache)
    assert len(got) == len(ref)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, **TOL)
    for _ in range(3):
        tok = rng.integers(3, VOCAB, (b, 1)).astype(np.int32)
        jstep, jcache = jmodel.apply(jp, jcache, tok, method="step")
        with torch.inference_mode():
            step, cache = port.step(cache, torch.from_numpy(tok))
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL)
    assert cache["len"].tolist() == [int(jcache["len"])] * b and int(jcache["len"]) == p + 3
    for a, r in zip(_cache_leaves(cache), _cache_leaves(jcache)):
        np.testing.assert_allclose(a, r, **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_incremental_matches_dense_forward(name):
    """Every step's logits equal the dense forward of the same prefix (same
    padded width and window anchor) within 2e-5, for every slot of the
    prefill's padded width; a step past the width writes only the rings'
    last slots."""
    _, _, port = _pair(name)
    rng = np.random.default_rng(2)
    b, p, w = 2, 9, 16
    ids, pad = _padded_prefix(rng, b, p, w)
    cap = port.num_latents
    with torch.inference_mode():
        _, cache = port.prefill(torch.from_numpy(ids), torch.from_numpy(pad), length=p)
        for t in range(w - p):
            tok = rng.integers(3, VOCAB, (b, 1))
            step, cache = port.step(cache, torch.from_numpy(tok))
            ids[:, p + t] = tok[:, 0]
            pad_t = np.broadcast_to(np.arange(w)[None, :] >= p + t + 1, (b, w))
            dense = port(torch.from_numpy(ids), torch.from_numpy(pad_t.copy()))
            row = (p + t) - (w - min(cap, w))
            err = float((step - dense[:, row]).abs().max())
            assert err < 2e-5, f"{name} step {t}: parity error {err}"
    # past the window the step clamps into the rings' last slots, as the
    # arena's free rows need: every other slot stays bit for bit
    before = _cache_leaves(cache)
    with torch.inference_mode():
        step, cache = port.step(cache, torch.from_numpy(tok))
    assert bool(torch.isfinite(step).all()) and cache["len"].tolist() == [w + 1] * b
    for a, r in zip(_cache_leaves(cache), before):
        np.testing.assert_array_equal(a[:, :-1], r[:, :-1])


def test_text_input_adapter_positions_match_flax():
    ids = np.random.default_rng(3).integers(0, 50, (2, 3)).astype(np.int32)
    positions = np.array([[7, 2, 9], [0, 15, 4]], np.int32)
    jmodule = jad.TextInputAdapter(vocab_size=50, max_seq_len=16, num_channels=32)
    params = jmodule.init(jax.random.key(0), ids, positions=positions)["params"]
    port = load_param_tree(pad_.TextInputAdapter(50, 16, 32), jax.tree.map(np.asarray, params))
    got = port(torch.from_numpy(ids), positions=torch.from_numpy(positions))
    ref = jmodule.apply({"params": params}, ids, positions=positions)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


# -- the engine -------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _generators():
    """The JAX and the port's ``ARGenerator`` over the same tiny_ar weights
    (the JAX chunk is its compiled loop's trip count; the port's only sets
    how often tokens are read back, which the tokens do not depend on)."""
    jmodel, params, port = _pair("tiny_ar")
    return (JaxARGenerator(jmodel, params, max_seq_len=64, chunk=16, name="torch-parity"),
            ARGenerator(port, None, 64, chunk=4, device="cpu"))


def test_greedy_tokens_match_jax_across_episodes():
    jgen, gen = _generators()
    assert gen.widths == jgen.widths == [16, 31, 46, 61, 64]
    prefix = [int(t) for t in np.random.default_rng(4).integers(3, VOCAB, 5)]
    ref, _ = jgen.generate(prefix, 64, JaxSamplingConfig())
    before = gen.prefills
    got, session = gen.generate(prefix, 64)
    assert len(got) == 64 - len(prefix)  # up to max_seq_len
    assert got == ref
    assert gen.prefills - before == 5 and session.width == 64  # one prefill per width


def test_sampled_streams_are_split_consistent():
    """Re-encoding from the prefix at a split point (one inside an episode,
    one across the width-16 boundary) continues the identical sampled
    stream: the draw at position p depends on (seed, p) only."""
    _, gen = _generators()
    prefix = [int(t) for t in np.random.default_rng(5).integers(3, VOCAB, 9)]
    sampling = SamplingConfig(temperature=0.8, top_k=16, seed=3)
    full, _ = gen.generate(prefix, 12, sampling)
    assert len(full) == 12
    for cut in (5, 7):
        a, _ = gen.generate(prefix, cut, sampling)
        b, _ = gen.generate(prefix + a, 12 - cut, sampling)
        assert a + b == full, f"diverged at cut {cut}"
    other, _ = gen.generate(prefix, 12, SamplingConfig(temperature=0.8, top_k=16, seed=4))
    assert other != full and all(0 <= t < VOCAB for t in other)


def test_sampling_modes():
    _, gen = _generators()
    prefix = [int(t) for t in np.random.default_rng(6).integers(3, VOCAB, 8)]
    greedy, _ = gen.generate(prefix, 8)
    assert gen.generate(prefix, 8, SamplingConfig(seed=99))[0] == greedy  # seed unused
    assert gen.generate(prefix, 8, SamplingConfig(temperature=0.7, top_k=1, seed=2))[0] == greedy
    for bad in (dict(temperature=-1.0), dict(top_k=-1)):
        for config in (SamplingConfig, JaxSamplingConfig):
            with pytest.raises(ValueError):
                config(**bad).normalized()
    assert position_seed(0, 5) != position_seed(0, 6) != position_seed(1, 5)
    assert 0 <= position_seed(2**40, 511) < 2**63


def test_session_passed_back_skips_the_prefill():
    _, gen = _generators()
    prefix = [int(t) for t in np.random.default_rng(7).integers(3, VOCAB, 7)]
    sampling = SamplingConfig(temperature=0.8, top_k=16, seed=5)
    full, _ = gen.generate(prefix, 8, sampling)  # one episode: width 16
    a, session = gen.generate(prefix, 4, sampling)
    before = gen.prefills
    b, _ = gen.generate(prefix + a, 4, sampling, session=session)
    assert a + b == full and gen.prefills == before
    gen.generate(prefix[1:], 4, sampling, session=session)  # diverged: re-encoded
    assert gen.prefills == before + 1
    assert gen.warmup() == 5 and gen.prefills == before + 6
    with pytest.raises(ValueError, match="non-empty prefix"):
        gen.start([])
    with pytest.raises(ValueError, match="no room under max_seq_len"):
        gen.plan_width(64)


def test_kernel_calls_per_prefill_and_step_at_flagship_depth():
    """The flagship depth (3 layers x (causal cross + 6 causal self)) at a
    tiny width: a prefill calls attention 22 times, every call causal (3
    cross + 18 self + 1 decode), and a step 22 times, none causal (its masks
    are the rings' pad masks); on the int8 path each makes 131 dequant
    matmuls (the shared layer's second and third applications reuse its
    cross k/v in the prefill; a step projects one row's k/v per weight
    set). On CPU tensors the wrappers count plain calls."""
    model = presets.tiny_ar(num_layers=3, num_self_attention_layers_per_block=6, device="cpu")
    gen = ARGenerator(model, None, 64, chunk=4, quantize="int8", device="cpu")
    for counter in (ak.counter, ak.causal_counter, qm.counter):
        counter.reset()
    session = gen.start([5, 6, 7])
    assert (ak.counter.plain_calls, ak.causal_counter.plain_calls,
            qm.counter.plain_calls) == (22, 22, 131)
    gen.decode_chunk(session, SamplingConfig(), n_steps=3)
    assert (ak.counter.plain_calls, ak.causal_counter.plain_calls,
            qm.counter.plain_calls) == (22 + 3 * 22, 22, 131 + 3 * 131)
    assert (ak.counter.launches, qm.counter.launches) == (0, 0)
    assert gen.quantize == "int8" and session.steps == 3


def test_quantized_generation_tracks_f32():
    """int8 weights: the greedy stream's first token and the prefill's
    next-token logits close to the f32 engine's (0.05 of the peak, the
    port's int8w bar)."""
    _, gen = _generators()
    _, _, port = _pair("tiny_ar")
    q8 = ARGenerator(port, None, 64, chunk=4, quantize="int8", device="cpu")
    prefix = [int(t) for t in np.random.default_rng(8).integers(3, VOCAB, 10)]
    ref, got = gen.start(prefix).next_logits, q8.start(prefix).next_logits
    assert float((got - ref).abs().max()) <= 0.05 * float(ref.abs().max())
    assert len(q8.generate(prefix, 6)[0]) == 6


def test_packed_attention_refuses_the_causal_offset():
    mha = MultiHeadAttention(32, 32, 4, attn_impl="packed")
    x = torch.randn(1, 8, 32)
    with torch.inference_mode(), pytest.raises(ValueError, match="does not implement causal"):
        mha(x, x, causal_offset=0)
    model = presets.tiny_ar(device="cpu", attn_impl="packed")
    with torch.inference_mode(), pytest.raises(ValueError, match="does not implement causal"):
        model(torch.tensor([[5, 6, 7]]))


def test_causal_forward_under_autograd_raises():
    """The dense forward under autograd, which raised before the attention
    backward took the causal offset: the gradients of a weighted sum of the
    logits against ``jax.grad`` of the JAX model's (``attn_impl='xla'``),
    every leaf within 1e-4 of its peak (``k_proj.bias``, zero by symmetry,
    against the other gradients' scale)."""
    jmodel, params, port = _pair("tiny_ar")
    rng = np.random.default_rng(12)
    ids = rng.integers(3, VOCAB, (2, 24)).astype(np.int32)
    pad = np.zeros((2, 24), bool)
    pad[1, 18:] = True
    w = rng.normal(size=(2, 16, VOCAB)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jmodel.apply({"params": p}, ids, pad) * w)

    jflat = {k: np.asarray(v) for k, v in flatten_tree(jax.grad(jloss)(params)).items()}
    port.requires_grad_(True)
    port.zero_grad(set_to_none=True)
    try:
        (port(torch.from_numpy(ids), torch.from_numpy(pad)) * torch.from_numpy(w)).sum().backward()
        grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    finally:
        port.zero_grad(set_to_none=True)
        port.requires_grad_(False)
    peak_all = max(float(np.abs(g).max()) for g in jflat.values())
    for name, got in grads.items():
        ref = jflat[name.replace(".", "/")]
        if name.endswith("k_proj.bias"):
            assert max(float(got.abs().max()), np.abs(ref).max()) < 1e-5 * peak_all, name
            continue
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-4 * np.abs(ref).max(), name


# -- the CLI ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizer_file(tmp_path_factory):
    """A tokenizer trained on synthetic reviews, its vocab filled with
    reserved entries to the model's VOCAB so every generated id names a
    token."""
    trained = WordPieceTokenizer()
    trained.train_from_iterator(synthetic_reviews(60, seed=0)[0], VOCAB)
    vocab = dict(trained.vocab)
    vocab.update({f"[unused{i}]": i for i in range(len(vocab), VOCAB)})
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    WordPieceTokenizer(vocab=vocab).save(str(path))
    return path


def _serve(capsys, monkeypatch, argv, stdin=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    results = serve.main(["--task", "generate", "--cpu", "--preset", "tiny_ar", *argv])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == results
    return lines


def test_serve_cli_generates_one_json_line_per_prompt(capsys, monkeypatch, tmp_path):
    """Token-id prompts (no tokenizer), weights from --init_seed: the
    greedy continuation is the engine's; then weights from --params_npz
    with int8 weights and sampling."""
    lines = _serve(capsys, monkeypatch, ["--init_seed", "0", "--texts", "5 6 7", "9 10 11 12",
                                         "--max_new_tokens", "5", "--generate_chunk", "2"])
    assert [line["text"] for line in lines] == ["5 6 7", "9 10 11 12"]
    gen = ARGenerator(presets.tiny_ar(device="cpu", seed=0), None, 64, device="cpu")
    for line, prefix in zip(lines, ([5, 6, 7], [9, 10, 11, 12])):
        assert line["continuation_ids"] == gen.generate(prefix, 5)[0]
        assert line["continuation"] == " ".join(map(str, line["continuation_ids"]))
    npz = tmp_path / "params.npz"
    np.savez(npz, **flatten_tree(jax.tree.map(np.asarray, _pair("tiny_ar")[1])))
    lines = _serve(capsys, monkeypatch, ["--params_npz", str(npz), "--stdin", "--quantize",
                                         "int8", "--temperature", "0.8", "--top_k", "8",
                                         "--max_new_tokens", "3"], stdin="5 6\n\n7 8 9\n")
    assert [len(line["continuation_ids"]) for line in lines] == [3, 3]


def test_serve_cli_with_a_tokenizer(capsys, monkeypatch, tokenizer_file, tmp_path):
    lines = _serve(capsys, monkeypatch, ["--init_seed", "1", "--tokenizer",
                                         str(tokenizer_file), "--texts", "a great movie",
                                         "--max_new_tokens", "4"])
    assert len(lines) == 1 and len(lines[0]["continuation_ids"]) == 4
    assert len(lines[0]["continuation"].split()) == 4
    short = tmp_path / "short.json"
    WordPieceTokenizer(vocab={"[PAD]": 0, "[UNK]": 1, "a": 2}).save(str(short))
    with pytest.raises(SystemExit, match="the model's vocab 503"):
        serve.main(["--task", "generate", "--cpu", "--preset", "tiny_ar", "--init_seed", "0",
                    "--tokenizer", str(short), "--texts", "a"])
    with pytest.raises(SystemExit, match="does not serve --task generate"):
        serve.main(["--task", "generate", "--cpu", "--preset", "tiny", "--init_seed", "0",
                    "--texts", "5"])
    with pytest.raises(SystemExit, match="does not serve --task mlm"):
        serve.main(["--cpu", "--preset", "tiny_ar", "--init_seed", "0",
                    "--tokenizer", str(tokenizer_file), "--texts", "a [MASK]"])
