"""The port's serving surface against the JAX package's: the tokenizer (same
ids from the same saved file, both file formats), the host-side helpers
(bucket widths, batch buckets, the synthetic corpus), ``MLMServer`` and
``MLMPredictor`` fill-mask against the JAX ``MLMPredictor`` (identical top-k
tokens, f32), the serve CLI, and the package's boundary rules: it imports
neither JAX nor the JAX package, and its entry points need ``device=`` when
there is no CUDA card."""

import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data import imdb as jimdb
from perceiver_io_tpu.data.pipeline import resolve_bucket_width as jresolve
from perceiver_io_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from perceiver_io_tpu.inference.mlm import MLMPredictor as JaxMLMPredictor
from perceiver_io_tpu.inference.predictor import bucket_size as jbucket_size
from perceiver_io_tpu.models.presets import tiny_mlm as jax_tiny_mlm
from perceiver_io_torch.cli import serve
from perceiver_io_torch.data.imdb import synthetic_reviews
from perceiver_io_torch.data.pipeline import resolve_bucket_width
from perceiver_io_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer
from perceiver_io_torch.inference.engine import MLMServer
from perceiver_io_torch.inference.mlm import MLMPredictor
from perceiver_io_torch.inference.predictor import bucket_size
from perceiver_io_torch.interop import flatten_tree, from_jax_params
from perceiver_io_torch.models import presets

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tokenizer_file(tmp_path_factory):
    texts, _ = jimdb.synthetic_reviews(120, seed=1)
    tok = JaxTokenizer()
    tok.train_from_iterator(texts, 300)
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return path


@pytest.fixture(scope="module")
def served(tokenizer_file):
    """JAX tiny MLM params (f32), the port model holding them, and texts."""
    jmodel = jax_tiny_mlm()
    ids = jnp.zeros((1, 64), jnp.int32)
    params = jmodel.init({"params": jax.random.key(3), "masking": jax.random.key(1)},
                         ids, ids == 1)["params"]
    tree = jax.tree.map(np.asarray, params)
    model = from_jax_params(presets.tiny_mlm(device="cpu"), tree).eval()
    texts = [t[: 40 + 9 * i] + " [MASK] " + t[60:80] + " [MASK]"
             for i, t in enumerate(jimdb.synthetic_reviews(10, seed=2)[0])]
    texts += ["[MASK] movie", "no mask at all", "great [MASK] [MASK] [MASK] film"]
    return jmodel, params, tree, model, texts


def test_tokenizer_same_ids_from_same_file(tokenizer_file, tmp_path):
    texts, _ = jimdb.synthetic_reviews(20, seed=5)
    texts.append("Café <br /> déjà-vu!! unseenword")
    jtok = JaxTokenizer.from_file(str(tokenizer_file))
    tok = load_tokenizer(str(tokenizer_file))
    assert tok.vocab == jtok.vocab
    for t in texts:
        assert tok.encode_ids(t) == jtok.encode_ids(t)
    hf = tmp_path / "hf.json"
    tok.save(str(hf), format="hf")
    assert JaxTokenizer.from_file(str(hf)).encode_ids(texts[0]) == jtok.encode_ids(texts[0])


def test_tokenizer_training_matches():
    texts, _ = synthetic_reviews(60, seed=4)
    tok, jtok = WordPieceTokenizer(), JaxTokenizer()
    tok.train_from_iterator(texts, 200)
    jtok.train_from_iterator(texts, 200)
    assert tok.vocab == jtok.vocab
    assert tok.decode(tok.encode_ids(texts[0])) == jtok.decode(jtok.encode_ids(texts[0]))


def test_host_helpers_match():
    assert synthetic_reviews(7, seed=9) == jimdb.synthetic_reviews(7, seed=9)
    widths = [8, 32, 64]
    for n in (0, 1, 8, 9, 33, 64, 500):
        assert resolve_bucket_width(n, widths) == jresolve(n, widths)
    for n in (1, 3, 4, 5, 64, 100):
        assert bucket_size(n, 64) == jbucket_size(n, 64)


def test_fill_masks_match_jax_predictor(served, tokenizer_file):
    jmodel, params, _, model, texts = served
    tok = load_tokenizer(str(tokenizer_file))
    expected = JaxMLMPredictor(jmodel, params, JaxTokenizer.from_file(str(tokenizer_file)),
                               64, max_batch=4).fill_masks(texts, k=3)
    assert sum(len(r) for r in expected) >= 20
    assert MLMPredictor(model, tok, 64, max_batch=4, device="cpu").fill_masks(
        texts, k=3) == expected
    server = MLMServer(model, None, tok, 64, bucket_widths=[16, 32], max_batch=4,
                       device="cpu")
    assert server.fill_masks(texts, k=3) == expected
    assert server.engine.dispatches >= 3  # several widths / mask-count buckets
    cached = server.encode(texts)
    assert server.fill_masks_cached(cached, k=3) == expected
    logits = server.decode(cached, np.zeros((len(texts), 2), np.int32))
    assert logits.shape == (len(texts), 2, 503) and np.isfinite(logits).all()


def test_server_quantized_modes_run(served, tokenizer_file):
    _, _, tree, model, texts = served
    tok = load_tokenizer(str(tokenizer_file))
    f32 = MLMServer(model, tree, tok, 64, max_batch=8, device="cpu").fill_masks(texts, k=1)
    for mode in ("int8w", "int4w"):
        server = MLMServer(model, tree, tok, 64, max_batch=8, compute_dtype=mode,
                           device="cpu")
        assert server.model.encoder.layer_1.cross_attention_layer.mlp.dense_1.qkernel.bits \
            == (8 if mode == "int8w" else 4)
        fills = server.fill_masks(texts, k=1)
        assert [len(r) for r in fills] == [len(r) for r in f32]
    with pytest.raises(ValueError, match="unknown quantize mode"):
        MLMServer(model, tree, tok, 64, quantize="int2", device="cpu")


def test_serve_cli_prints_one_json_line_per_text(served, tokenizer_file, tmp_path,
                                                 monkeypatch, capsys):
    _, _, tree, _, texts = served
    npz = tmp_path / "params.npz"
    np.savez(npz, **flatten_tree(tree))
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(texts[:4]) + "\n"))
    results = serve.main(["--preset", "tiny", "--params_npz", str(npz), "--tokenizer",
                          str(tokenizer_file), "--stdin", "--cpu", "--k", "2",
                          "--quantize", "int8", "--bucket_widths", "32"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines == results and [l["text"] for l in lines] == texts[:4]
    assert all(len(f) == 2 for line in lines for f in line["fills"])


def test_entry_points_need_a_device_without_cuda(monkeypatch, tokenizer_file):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok = load_tokenizer(str(tokenizer_file))
    for build in (presets.tiny_mlm, presets.flagship_mlm, presets.flagship_tpu_mlm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    model = presets.tiny_mlm(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MLMServer(model, None, tok, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MLMPredictor(model, tok, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--preset", "tiny", "--init_seed", "0", "--tokenizer",
                    str(tokenizer_file), "--stdin"])


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "perceiver_io_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'perceiver_io_tpu')]\n"
            "print(len(sys.modules)); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sources = list((ROOT / "perceiver_io_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for src in sources:
        for line in src.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in (
                    "jax", "jaxlib", "flax", "perceiver_io_tpu"), f"{src}: {line}"


def test_kernel_calls_per_forward_at_flagship_depth(tokenizer_file):
    """The flagship depth (3 layers x (cross + 6 self)) at a tiny width: one
    fused int8w forward calls attention 22 times (3 encoder cross + 18 self
    + 1 decoder cross) and the dequant matmul 131 times (the shared layer's
    second application reuses its k/v: 124 encoder + 6 decoder + 1 head);
    encode and decode split those counts. On CPU tensors the wrappers count
    plain calls where the card counts launches."""
    from perceiver_io_torch.ops import attention_kernel as ak
    from perceiver_io_torch.ops import qmatmul as qm

    model = presets.tiny_mlm(num_layers=3, num_self_attention_layers_per_block=6,
                             device="cpu")
    tok = load_tokenizer(str(tokenizer_file))
    server = MLMServer(model, None, tok, 64, max_batch=8, compute_dtype="int8w",
                       device="cpu")
    texts = ["a [MASK] movie", "the [MASK] plot was [MASK]"]
    for counter in (ak.counter, qm.counter):
        counter.reset()
    server.fill_masks(texts)
    n = server.engine.dispatches
    assert (ak.counter.plain_calls, qm.counter.plain_calls) == (22 * n, 131 * n)
    assert (ak.counter.launches, qm.counter.launches) == (0, 0)
    for counter in (ak.counter, qm.counter):
        counter.reset()
    server.fill_masks_cached(server.encode(texts))
    n_enc, n_dec = server.encoder.dispatches, server.decoder.dispatches
    assert ak.counter.plain_calls == 21 * n_enc + n_dec
    assert qm.counter.plain_calls == 124 * n_enc + 7 * n_dec
