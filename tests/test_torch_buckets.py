"""Width buckets on the CPU: the port's ``IMDBDataModule`` with
``bucket_widths`` and ``length_sort_window`` gives the JAX module's batches
(ids, widths, order) for two seeds, over two epochs and the validation
split; and ``train_ar --synthetic --bucket_widths 32 64 --max_seq_len 64``
at ``tiny_ar`` widths (and with 48 latents, more than a 32-wide batch
holds), from the JAX run's initial weights, stopped at step 3 and resumed
to 6 in both packages, gives the JAX CLI's validation losses within 1e-4
relative, with a train loss above 0."""

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)

from perceiver_io_tpu.cli import train_ar as jax_train_ar
from perceiver_io_tpu.data.imdb import IMDBDataModule as JaxIMDBDataModule
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics as jax_read_metrics
from perceiver_io_torch.cli import common, train_ar
from perceiver_io_torch.data.imdb import Collator, IMDBDataModule
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.training.metrics import read_metrics


@pytest.mark.parametrize("seed", [0, 5])
def test_bucketed_batches_match_jax(tmp_path, seed):
    kwargs = dict(max_seq_len=160, vocab_size=300, batch_size=8, synthetic=True,
                  synthetic_size=160, seed=seed, bucket_widths=[64, 96, 128],
                  length_sort_window=3)
    modules = [JaxIMDBDataModule(root=str(tmp_path / "jax"), **kwargs),
               IMDBDataModule(root=str(tmp_path / "port"), **kwargs)]
    batches = []
    for module in modules:
        module.prepare_data()
        module.setup()
        train = module.train_dataloader()
        batches.append(list(train) + list(train) + list(module.val_dataloader()))
    assert len(batches[0]) == len(batches[1]) == 2 * 20 + 64 // 8
    widths = [b["token_ids"].shape[1] for b in batches[1]]
    assert len(set(widths)) >= 2  # the sorted windows fill more than one bucket
    for jb, pb in zip(*batches):
        for key in ("label", "token_ids", "pad_mask"):
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]))


def test_collator_decides_the_width_locally():
    """Without a loader's width, the collator pads to the smallest bucket
    holding the batch; ``max_seq_len`` is always the last bucket."""
    from perceiver_io_torch.data.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer()
    tok.train_from_iterator(["a b c d e f g h"] * 4, 50)
    collator = Collator(tok, 12, bucket_widths=[4, 8])
    assert collator.bucket_widths == [4, 8, 12]
    assert collator.collate([(0, "a b")])["token_ids"].shape == (1, 4)
    assert collator.collate([(0, "a b c d e f")])["token_ids"].shape == (1, 8)
    assert collator.collate([(0, "a b c d e f g h a b c d e")])["token_ids"].shape == (1, 12)
    with pytest.raises(ValueError, match="bucket_widths"):
        Collator(tok, 12, bucket_widths=[16])


@pytest.mark.parametrize("latents", [16, 48])
def test_bucketed_train_ar_matches_jax(tmp_path, monkeypatch, latents):
    """Both CLIs take 3 bucketed steps, then ``--resume`` to 6: the
    validation losses at steps 3 and 6 agree within 1e-4 relative. At 48
    latents the 32-wide batches' latent window is the whole batch, narrower
    than the latents."""
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = common.build_ar
    monkeypatch.setattr(common, "build_ar",
                        lambda *a, **k: from_jax_params(build(*a, **k), seen["params"]))
    # tiny_ar's widths: 16 latents x 32 channels, 2 layers of (cross + 1 self)
    run = ["--preset", "reference", "--synthetic", "--synthetic_size", "64", "--batch_size",
           "16", "--max_seq_len", "64", "--vocab_size", "300", "--num_latents", str(latents),
           "--num_latent_channels", "32", "--num_encoder_layers", "2",
           "--num_self_attention_layers_per_block", "1", "--log_every_n_steps", "1",
           "--dtype", "float32", "--bucket_widths", "32", "64", "--length_sort_window", "2",
           "--eval_every_n_steps", "3", "--learning_rate", "0.01",
           "--sample_prefix_len", "0", "--no_tensorboard"]
    jax_args = run + ["--root", str(tmp_path / "jax"), "--logdir", str(tmp_path / "jax_logs")]
    port_args = run + ["--cpu", "--root", str(tmp_path / "port"),
                       "--logdir", str(tmp_path / "port_logs")]
    # 3 steps, then --resume to 6 (mid-epoch: 4 batches an epoch), in both CLIs
    jax_dir = jax_train_ar.main(jax_args + ["--max_steps", "3"])
    port_dir = train_ar.main(port_args + ["--max_steps", "3"])
    jax_train_ar.main(jax_args + ["--max_steps", "6", "--resume", jax_dir])
    train_ar.main(port_args + ["--max_steps", "6", "--resume", port_dir])
    jax_val = [(r["step"], r["val_loss"]) for r in jax_read_metrics(jax_dir) if "val_loss" in r]
    port_val = [(r["step"], r["val_loss"]) for r in read_metrics(port_dir) if "val_loss" in r]
    assert [s for s, _ in port_val] == [s for s, _ in jax_val] == [3, 6]
    np.testing.assert_allclose([v for _, v in port_val], [v for _, v in jax_val], rtol=1e-4)
    train = [r["train_loss"] for r in read_metrics(port_dir) if "train_loss" in r]
    assert len(train) == 6 and min(train) > 0
