"""The port's audio-video data (``perceiver_io_torch/data/av.py``) against
the JAX package's, on the CPU:

- ``synthetic_av_clips`` bit for bit the JAX function's (numpy, the same
  seeds);
- ``AVDataModule``'s train / validation split and its batches (the seeded
  shuffle over two epochs, then validation in order and whole) bit for bit
  the JAX module's with one shard;
- ``load_av_tree`` on an ``.npz`` tree written under ``tmp_path`` against
  the JAX reader: the centre crop and truncations, the 1/255 rescale of
  integer clips (after the crop), clips too small skipped, a clip of the
  wrong rank refused; the module over that tree with a val split, without
  one (the seeded fallback split), and with a val split whose classes
  differ (refused); ``prepare_data`` without the tree and without
  ``synthetic`` raises (the port downloads nothing).
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)

from perceiver_io_tpu.data import av as jav
from perceiver_io_torch.data import av


@pytest.mark.parametrize("video_shape,samples,channels,classes,seed",
                         [((2, 6, 5, 3), 40, 1, 4, 0), ((3, 4, 7, 1), 33, 2, 7, 5)])
def test_synthetic_clips_match_jax(video_shape, samples, channels, classes, seed):
    got = av.synthetic_av_clips(6, video_shape, samples, channels, classes, seed)
    ref = jav.synthetic_av_clips(6, video_shape, samples, channels, classes, seed)
    assert got[0].shape == (6, *video_shape) and got[1].shape == (6, samples, channels)
    assert got[0].dtype == got[1].dtype == np.float32 and got[2].dtype == np.int32
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)
    assert 0 <= got[2].min() and got[2].max() < classes


def _module_batches(module):
    module.prepare_data()
    module.setup()
    train = module.train_dataloader()
    return list(train) + list(train) + list(module.val_dataloader())


@pytest.mark.parametrize("size,batch,train_n,val_n", [(40, 4, 35, 5), (9, 2, 8, 1)])
def test_batches_match_jax(size, batch, train_n, val_n):
    kwargs = dict(video_shape=(2, 4, 6, 3), num_audio_samples=24, num_classes=3,
                  batch_size=batch, synthetic=True, synthetic_size=size, seed=3)
    ours, theirs = av.AVDataModule(**kwargs), jav.AVDataModule(**kwargs)
    got, ref = _module_batches(ours), _module_batches(theirs)
    assert (len(ours.ds_train), len(ours.ds_valid)) == (train_n, val_n)
    assert len(got) == len(ref) == 2 * (train_n // batch) + -(-val_n // batch)
    for pb, jb in zip(got, ref):
        assert list(pb) == ["video", "audio", "label"] and pb["label"].dtype == np.int32
        for key in pb:
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]))
    assert len(got[-1]["label"]) == (val_n % batch or batch)  # validation keeps its tail
    assert not np.array_equal(got[0]["video"], got[train_n // batch]["video"])  # reshuffled
    with pytest.raises(ValueError, match="synthetic_size must be >= 2"):
        av.AVDataModule(**{**kwargs, "synthetic_size": 1}).setup()


def _write_clip(path, rng, shape, samples, integer=False):
    video = (rng.integers(0, 256, shape, dtype=np.uint8) if integer
             else rng.uniform(0, 1, shape).astype(np.float32))
    np.savez(path, video=video, audio=rng.normal(size=(samples, 2)).astype(np.float32))


def _write_tree(root, rng, splits=("train", "val"), val_classes=("drum", "flute")):
    """Two classes of clips under ``root/av``: uint8 and float videos larger
    than the crop, one clip too short in time and one with too few audio
    samples (both skipped)."""
    for split in splits:
        for name in (("drum", "flute") if split == "train" else val_classes):
            d = root / "av" / split / name
            d.mkdir(parents=True)
            _write_clip(d / "a.npz", rng, (5, 10, 12, 3), 50, integer=True)
            _write_clip(d / "b.npz", rng, (4, 9, 9, 4), 41)
            if split == "train":
                _write_clip(d / "c.npz", rng, (2, 10, 12, 3), 50)   # too few frames
                _write_clip(d / "d.npz", rng, (5, 10, 12, 3), 30)   # too few samples
                _write_clip(d / "e.npz", rng, (6, 11, 8, 3), 64, integer=True)


SHAPE, SAMPLES = (4, 8, 8, 3), 40


def test_load_av_tree_matches_jax(tmp_path):
    _write_tree(tmp_path, np.random.default_rng(0))
    root = str(tmp_path / "av")
    got = av.load_av_tree(root, "train", SHAPE, SAMPLES, 1)
    ref = jav.load_av_tree(root, "train", SHAPE, SAMPLES, 1)
    videos, audios, labels, classes = got
    assert videos.shape == (6, *SHAPE) and audios.shape == (6, SAMPLES, 1)
    assert videos.dtype == audios.dtype == np.float32
    assert labels.tolist() == [0, 0, 0, 1, 1, 1] and classes == ["drum", "flute"] == ref[3]
    for x, y in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(x, y)
    # the first clip, uint8 (5, 10, 12, 3): cropped at (1, 2), then scaled by 1/255
    with np.load(tmp_path / "av" / "train" / "drum" / "a.npz") as z:
        raw = z["video"]
    np.testing.assert_array_equal(videos[0], raw[:4, 1:9, 2:10, :3].astype(np.float32) / 255.0)
    assert 0.0 <= videos.min() and videos.max() <= 1.0
    with pytest.raises(FileNotFoundError, match="no class directories"):
        av.load_av_tree(root, "test", SHAPE, SAMPLES, 1)
    with pytest.raises(FileNotFoundError, match="no usable clips"):
        av.load_av_tree(root, "train", (4, 32, 32, 3), SAMPLES, 1)
    np.savez(tmp_path / "av" / "train" / "drum" / "z.npz", video=np.zeros((8, 8, 3)),
             audio=np.zeros((SAMPLES, 1)))
    with pytest.raises(ValueError, match="need video"):
        av.load_av_tree(root, "train", SHAPE, SAMPLES, 1)


@pytest.mark.parametrize("splits", [("train", "val"), ("train",)])
def test_module_over_a_tree_matches_jax(tmp_path, splits):
    """With a val split, both splits as written; without one, a tenth of
    train's clips (at least 1) held out in a permutation seeded by ``seed``;
    the batches as the JAX module's."""
    _write_tree(tmp_path, np.random.default_rng(1), splits)
    kwargs = dict(root=str(tmp_path), video_shape=SHAPE, num_audio_samples=SAMPLES,
                  num_audio_channels=2, num_classes=9, batch_size=2, synthetic=False, seed=4)
    ours, theirs = av.AVDataModule(**kwargs), jav.AVDataModule(**kwargs)
    got, ref = _module_batches(ours), _module_batches(theirs)
    assert ours.num_classes == theirs.num_classes == 2
    assert (len(ours.ds_train), len(ours.ds_valid)) == ((6, 4) if "val" in splits else (5, 1))
    assert len(got) == len(ref)
    for pb, jb in zip(got, ref):
        for key in pb:
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]))


def test_class_mismatch_and_missing_tree_raise(tmp_path):
    _write_tree(tmp_path, np.random.default_rng(2), val_classes=("drum", "harp"))
    kwargs = dict(root=str(tmp_path), video_shape=SHAPE, num_audio_samples=SAMPLES,
                  synthetic=False)
    for module in (av.AVDataModule(**kwargs), jav.AVDataModule(**kwargs)):
        module.prepare_data()
        with pytest.raises(ValueError, match=r"train/val class mismatch.*'flute'.*'harp'"):
            module.setup()
    with pytest.raises(FileNotFoundError, match="no AV data.*synthetic=True"):
        av.AVDataModule(root=str(tmp_path / "none"), synthetic=False).prepare_data()
    av.AVDataModule(root=str(tmp_path / "none")).prepare_data()  # synthetic by default
