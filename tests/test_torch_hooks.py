"""The sample hooks and serving from a checkpoint, on the CPU.

- ``train_mlm``'s predict hook against the JAX hook, the same f32 weights
  and samples: each sample's top-1 fill is the JAX hook's, and the top-k
  sets agree except at logits tied within 1e-5.
- ``train_ar``'s sample hook against the JAX hook: the same greedy
  continuation text.
- ``serve --checkpoint`` gives what ``serve --params_npz`` gives on the same
  weights, for ``--task mlm`` and ``--task generate``.
"""

import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import train_ar as jax_train_ar
from perceiver_io_tpu.cli import train_mlm as jax_train_mlm
from perceiver_io_tpu.data.imdb import Collator as JaxCollator
from perceiver_io_tpu.data.imdb import synthetic_reviews as jax_synthetic_reviews
from perceiver_io_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from perceiver_io_tpu.models.presets import tiny_ar as jax_tiny_ar
from perceiver_io_tpu.models.presets import tiny_mlm as jax_tiny_mlm
from perceiver_io_tpu.training import make_mlm_steps as jax_make_mlm_steps
from perceiver_io_torch.cli import serve, train_ar, train_mlm
from perceiver_io_torch.data.imdb import Collator, synthetic_reviews
from perceiver_io_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer
from perceiver_io_torch.interop import from_jax_params, param_tree
from perceiver_io_torch.models import presets
from perceiver_io_torch.training.checkpoint import restore_params
from perceiver_io_torch.training.metrics import read_metrics
from perceiver_io_torch.training.steps import make_mlm_steps

SEQ = 64


class _Logger:
    def __init__(self):
        self.rows = []

    def log_text(self, tag, step, text):
        self.rows.append((tag, step, text))


@pytest.fixture(scope="module")
def tokenizer_file(tmp_path_factory):
    """A tokenizer trained on the synthetic reviews, its vocab filled to
    ``tiny_mlm``'s 503 with reserved entries (so the tiny presets hold it)."""
    tok = JaxTokenizer()
    tok.train_from_iterator(jax_synthetic_reviews(200, seed=0)[0], 300)
    vocab = dict(tok.vocab)
    vocab.update({f"[unused{i}]": i for i in range(len(vocab), 503)})
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    WordPieceTokenizer(vocab=vocab).save(str(path))
    return path


def _jax_params(model, key: int, **init):
    ids = jnp.zeros((1, SEQ), jnp.int32)
    return model.init({"params": jax.random.key(key), **init}, ids, ids == 0)["params"]


def test_predict_hook_matches_jax(tokenizer_file):
    jtok = JaxTokenizer.from_file(str(tokenizer_file))
    tok = load_tokenizer(str(tokenizer_file))
    samples = list(jax_train_mlm.DEFAULT_PREDICT_SAMPLES) + [
        "the [MASK] was boring and the [MASK] too", "no mask here"]
    jmodel = jax_tiny_mlm()
    params = _jax_params(jmodel, 3, masking=jax.random.key(1))
    _, _, jax_predict = jax_make_mlm_steps(jmodel, None)
    jax_hook = jax_train_mlm.make_predict_hook(jax_predict, JaxCollator(jtok, SEQ), samples, 5)
    model = from_jax_params(presets.tiny_mlm(device="cpu"), jax.tree.map(np.asarray, params))
    _, _, predict = make_mlm_steps(model, None)
    hook = train_mlm.make_predict_hook(predict, Collator(tok, SEQ), samples, 5)
    theirs, ours = _Logger(), _Logger()
    jax_hook(SimpleNamespace(params=params), theirs, 7)
    hook(SimpleNamespace(model=model), ours, 7)
    assert [r[:2] for r in ours.rows] == [r[:2] for r in theirs.rows] == [("predictions", 7)]
    ours_blocks = ours.rows[0][2].split("\n\n---\n\n")
    theirs_blocks = theirs.rows[0][2].split("\n\n---\n\n")
    assert len(ours_blocks) == len(theirs_blocks) == 3  # the text without a mask is left out
    token_ids, pad_mask = train_mlm.encode_masked_samples(Collator(tok, SEQ), samples[:3])
    first = (token_ids == tok.token_to_id("[MASK]")).argmax(axis=1)
    logits = predict(model, torch.from_numpy(token_ids), torch.from_numpy(pad_mask),
                     torch.from_numpy(first[:, None].astype(np.int64)))[:, 0].numpy()
    for row, (o, t) in enumerate(zip(ours_blocks, theirs_blocks)):
        o_fills, t_fills = o.split("\n")[2:], t.split("\n")[2:]
        assert o.split("\n")[0] == samples[row] and o_fills[0] == t_fills[0]  # top-1
        fill = lambda line: re.search(r"\*\*(.+?)\*\*", line).group(1)  # noqa: E731
        differ = {fill(x) for x in o_fills} ^ {fill(x) for x in t_fills}
        kth = np.sort(logits[row])[-5]
        assert all(abs(logits[row, tok.token_to_id(w)] - kth) < 1e-5 for w in differ)


def test_sample_hook_matches_jax(tokenizer_file):
    jtok = JaxTokenizer.from_file(str(tokenizer_file))
    tok = load_tokenizer(str(tokenizer_file))
    jmodel = jax_tiny_ar(attn_impl="xla")
    params = _jax_params(jmodel, 4)
    ids = np.asarray(Collator(tok, SEQ).collate([(0, synthetic_reviews(3, seed=9)[0][1])])[
        "token_ids"][0])
    jax_hook = jax_train_ar.make_sample_hook(jmodel, JaxCollator(jtok, SEQ), 16, 12, ids)
    model = from_jax_params(presets.tiny_ar(device="cpu"), jax.tree.map(np.asarray, params))
    hook = train_ar.make_sample_hook(Collator(tok, SEQ), 16, 12, ids)
    theirs, ours = _Logger(), _Logger()
    jax_hook(SimpleNamespace(params=params), theirs, 3)
    hook(SimpleNamespace(model=model), ours, 3)
    assert ours.rows == theirs.rows
    assert ours.rows[0][2].startswith("prefix(16 toks) → ") and len(ours.rows[0][2].split()) \
        == 2 + 12 + 1
    assert train_ar.make_sample_hook(Collator(tok, SEQ), 0, 12, ids) is None


TINY_WIDTHS = ["--num_latents", "16", "--num_latent_channels", "32", "--num_encoder_layers",
               "2", "--num_self_attention_layers_per_block", "1", "--max_seq_len", str(SEQ)]


@pytest.mark.parametrize("task", ["mlm", "generate"])
def test_serve_checkpoint_equals_serve_params_npz(tmp_path, tokenizer_file, task):
    """A two-step ``--cpu`` run at the tiny preset's widths (its tokenizer
    file placed where the data module looks, so the vocab is the preset's
    503), served from ``<run>/checkpoints`` and from an ``.npz`` of the best
    step's weights with ``--preset tiny`` / ``tiny_ar``: the same lines."""
    root = tmp_path / "root"
    root.mkdir()
    (root / "imdb-synthetic-tokenizer-300.json").write_bytes(tokenizer_file.read_bytes())
    cli = train_mlm if task == "mlm" else train_ar
    run_dir = cli.main(["--cpu", "--synthetic", "--synthetic_size", "64", "--batch_size", "16",
                        "--vocab_size", "300", "--max_steps", "2", "--eval_every_n_steps", "1",
                        "--dtype", "float32", "--no_tensorboard", "--max_to_keep", "2",
                        "--root", str(root), "--logdir", str(tmp_path / "logs")] + TINY_WIDTHS)
    ckpt = os.path.join(run_dir, "checkpoints")
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **{k: v.numpy() for k, v in restore_params(ckpt).items()})
    if task == "mlm":
        texts = ["a [MASK] movie", "the [MASK] was [MASK] and boring"]
        common = ["--tokenizer", str(tokenizer_file), "--cpu", "--texts", *texts]
        preset = ["--preset", "tiny"]
    else:
        common = ["--task", "generate", "--cpu", "--max_new_tokens", "6", "--texts",
                  "5 17 42", "9 8 7 6 5 4 3"]
        preset = ["--preset", "tiny_ar"]
    got = serve.main(common + ["--checkpoint", ckpt])
    want = serve.main(common + preset + ["--params_npz", npz])
    assert got == want and len(got) == 2
    # an explicit --step serves that step
    steps = sorted(int(s) for s in os.listdir(ckpt) if s.isdigit())
    assert len(steps) == 2 and [r for r in read_metrics(run_dir) if "val_loss" in r]
    assert serve.main(common + ["--checkpoint", ckpt, "--step", str(steps[0])]) is not None
