"""The port's MNIST data and image-classification CLI against the JAX
package, on the CPU:

- ``synthetic_digits`` bit for bit the JAX package's (seeds 0, 3);
- the data module's batches (random crops in training, the centre crop in
  validation, ``Normalize(0.5, 0.5)``, channels-last, the seeded shuffle
  over two epochs) bit for bit the JAX module's;
- the idx reader on raw and ``.gz`` files in both layouts (``_find``), and
  ``prepare_data`` without files and without ``--synthetic`` raising with the
  files' names (the port downloads nothing);
- ``cli.train_img_clf`` and the JAX CLI on the same flags (14×14 crops, 2
  layers, C=32, f32, ``--attn_impl auto``), the port from the JAX run's
  initial weights: validation at the same steps with losses within 1e-4
  relative and the same accuracies; ``train_acc``/``val_acc`` rows; the
  reference defaults (32 latents × 128 channels, 3 × (cross + 3 self), 32
  bands); ``--resume`` continues the run.
"""

import gzip
import json
import struct

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)

from perceiver_io_tpu.cli import train_img_clf as jax_train_img_clf
from perceiver_io_tpu.data import mnist as jmnist
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import read_metrics
from perceiver_io_torch.cli import common, train_img_clf
from perceiver_io_torch.data import mnist
from perceiver_io_torch.interop import from_jax_params

TINY = ["--synthetic", "--synthetic_size", "320", "--random_crop", "14", "--batch_size", "32",
        "--num_latents", "8", "--num_latent_channels", "32", "--num_encoder_layers", "2",
        "--num_self_attention_layers_per_block", "1", "--num_frequency_bands", "4",
        "--dtype", "float32", "--log_every_n_steps", "1", "--no_tensorboard"]


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_digits_match_jax(seed):
    images, labels = mnist.synthetic_digits(200, seed=seed)
    jimages, jlabels = jmnist.synthetic_digits(200, seed=seed)
    assert images.dtype == np.uint8 and images.shape == (200, 28, 28)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(labels, jlabels)


@pytest.mark.parametrize("crop", [None, 14])
def test_batches_match_jax(crop):
    kwargs = dict(batch_size=16, random_crop=crop, synthetic=True, synthetic_size=256, seed=3)
    modules = [jmnist.MNISTDataModule(**kwargs), mnist.MNISTDataModule(**kwargs)]
    batches = []
    for module in modules:
        module.prepare_data()
        module.setup()
        train = module.train_dataloader()
        # whole epochs: the JAX loader's prefetch thread reads ahead of a
        # consumer that stops early, and each read draws a crop
        batches.append(list(train) + [next(iter(train))] + list(module.val_dataloader()))
    assert modules[0].dims == modules[1].dims == ((crop, crop, 1) if crop else (28, 28, 1))
    assert len(batches[1]) == 14 + 1 + 2  # 224 train examples, 32 in validation
    for jb, pb in zip(*batches):
        assert set(pb) == {"image", "label"} and pb["image"].dtype == np.float32
        assert pb["image"].shape[1:] == modules[1].dims and pb["label"].dtype == np.int32
        for key in ("image", "label"):
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]))
    assert -1.0 <= batches[1][0]["image"].min() and batches[1][0]["image"].max() <= 1.0


def _write_idx(path, array: np.ndarray) -> None:
    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(">" + "I" * array.ndim,
                                                                 *array.shape)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


@pytest.mark.parametrize("layout", ["raw", "gz", "flat"])
def test_idx_files_load_as_in_jax(tmp_path, layout):
    images, labels = mnist.synthetic_digits(40, seed=1)
    folder = tmp_path if layout == "flat" else tmp_path / "MNIST" / "raw"
    folder.mkdir(parents=True, exist_ok=True)
    suffix = ".gz" if layout == "gz" else ""
    for split, n in (("train", 30), ("t10k", 10)):
        part = slice(0, n) if split == "train" else slice(30, 40)
        _write_idx(folder / f"{split}-images-idx3-ubyte{suffix}", images[part])
        _write_idx(folder / f"{split}-labels-idx1-ubyte{suffix}", labels[part])
    for split in ("train", "test"):
        got, ref = mnist.load_mnist(str(tmp_path), split), jmnist.load_mnist(str(tmp_path),
                                                                           split)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    module = mnist.MNISTDataModule(root=str(tmp_path), batch_size=8, val_split=6)
    module.prepare_data()
    module.setup()
    assert len(module.ds_train) == 24 and len(module.ds_valid) == 6
    np.testing.assert_array_equal(module.ds_valid.labels, labels[24:30])


def test_prepare_data_names_the_missing_files(tmp_path):
    module = mnist.MNISTDataModule(root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte.*--synthetic"):
        module.prepare_data()
    with pytest.raises(FileNotFoundError, match="t10k|train"):  # the CLI, before a model
        train_img_clf.main(["--cpu", "--max_steps", "1", "--root", str(tmp_path)])


def test_reference_defaults():
    ours = train_img_clf.build_parser().parse_args(["--max_steps", "1"])
    theirs = jax_train_img_clf.build_parser().parse_args(["--max_steps", "1"])
    for key in ("num_latents", "num_latent_channels", "num_encoder_layers",
                "num_self_attention_layers_per_block", "num_cross_attention_heads",
                "num_self_attention_heads", "num_frequency_bands", "batch_size", "attn_impl",
                "dropout", "experiment", "optimizer", "learning_rate", "weight_decay"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert (ours.num_latents, ours.num_latent_channels, ours.num_encoder_layers,
            ours.num_self_attention_layers_per_block) == (32, 128, 3, 3)
    model = common.build_image_classifier(ours, (28, 28, 1), 10, "cpu")
    assert model.encoder.input_adapter.num_input_channels == 131
    layer = model.encoder.layer_1.cross_attention_layer.cross_attention.attention
    assert (layer.num_heads, layer.k_proj.kernel.shape) == (4, (131, 128))


def test_img_clf_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the same flags, the port from the JAX run's initial
    weights: validation at steps 2 and 4, losses within 1e-4 relative, the
    same accuracies; then ``--resume`` takes the port's run to step 6."""
    seen, create = {}, JaxTrainState.create

    def spy(cls, params, tx, rng):
        seen["params"] = jax.tree.map(np.array, params)  # the trainer donates its buffers
        return create(params, tx, rng)

    monkeypatch.setattr(JaxTrainState, "create", classmethod(spy))
    build = common.build_image_classifier
    monkeypatch.setattr(common, "build_image_classifier",
                        lambda *a, **k: from_jax_params(build(*a, **k), seen["params"]))
    run = TINY + ["--max_steps", "4", "--eval_every_n_steps", "2"]
    jax_dir = jax_train_img_clf.main(run + ["--logdir", str(tmp_path / "jax_logs")])
    port_dir = train_img_clf.main(run + ["--cpu", "--logdir", str(tmp_path / "port_logs")])
    assert port_dir == str(tmp_path / "port_logs" / "img_clf" / "version_0")
    jax_val = [(r["step"], r["val_loss"], r["val_acc"]) for r in read_metrics(jax_dir)
               if "val_loss" in r]
    rows = [json.loads(line) for line in open(f"{port_dir}/metrics.jsonl")]
    port_val = [(r["step"], r["val_loss"], r["val_acc"]) for r in rows if "val_loss" in r]
    assert [s for s, _, _ in port_val] == [s for s, _, _ in jax_val] == [2, 4]
    np.testing.assert_allclose([v for _, v, _ in port_val], [v for _, v, _ in jax_val],
                               rtol=1e-4)
    assert [a for _, _, a in port_val] == pytest.approx([a for _, _, a in jax_val], abs=1e-6)
    assert abs(port_val[1][1] - port_val[0][1]) > 1e-3  # the weights moved
    train = [r for r in rows if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all({"train_loss", "train_acc", "lr", "step_s", "examples_per_sec"} <= set(r)
               for r in train)
    with open(f"{port_dir}/checkpoints/hparams.json") as f:
        assert json.load(f)["num_frequency_bands"] == 4
    train_img_clf.main(["--cpu", "--max_steps", "6", "--resume", port_dir])
    rows = [json.loads(line) for line in open(f"{port_dir}/metrics.jsonl")]
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2, 3, 4, 5, 6]
