"""The port's ImageNet data (``perceiver_io_torch/data/imagefolder.py``) and
its loader's decode pool (``data/pipeline.py``'s ``num_workers``) against
the JAX package, on the CPU, bit for bit:

- the synthetic train and validation sets and their loaders;
- a small ImageFolder tree written with PIL (PNG and JPEG, sizes off the
  crop): train examples (random-resized crops and flips from one seed, in
  read order) and validation centre crops; the loaders' batches;
- with no ``val/``, the split carved from train; train and val class
  directories that disagree raise in both;
- the same batches at ``num_workers`` 0 and 4 (the augmentation seeds drawn
  in the batch's order before the pool reads), and a dataset without
  seeds read through the pool in order.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
from PIL import Image

from perceiver_io_tpu.data import imagefolder as jif
from perceiver_io_torch.data import imagefolder as pif
from perceiver_io_torch.data.mnist import image_label_collate
from perceiver_io_torch.data.pipeline import DataLoader

SIZE = 16
CLASSES = ("n01", "n02", "n03")


def _tree(root, val: bool = True, val_classes=CLASSES):
    """<root>/imagenet/train/<class>/ with 4 images a class (PNG and JPEG,
    each its own size), and with ``val`` a val/ split of 2 a class."""
    rng = np.random.default_rng(11)
    for split, n, classes in (("train", 4, CLASSES), ("val", 2, val_classes)):
        if split == "val" and not val:
            continue
        for c, cls in enumerate(classes):
            d = root / "imagenet" / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                h, w = 20 + 7 * i + c, 26 - 3 * i + 2 * c
                pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                ext = "png" if i % 2 else "JPEG"
                Image.fromarray(pixels).save(d / f"img_{i}.{ext}")
            (d / "notes.txt").write_text("not an image")
    return str(root)


def _modules(root, **kw):
    args = dict(root=root, image_size=SIZE, batch_size=4, num_workers=0, seed=3, **kw)
    ours, theirs = pif.ImageFolderDataModule(**args), jif.ImageFolderDataModule(**args)
    for m in (ours, theirs):
        m.prepare_data()
        m.setup()
    return ours, theirs


def _same_batches(ours, theirs):
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b) == ["image", "label"]
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_synthetic_sets_match_jax():
    ours, theirs = _modules(".", synthetic=True, synthetic_size=40, synthetic_classes=5)
    assert ours.num_classes == theirs.num_classes == 5 and ours.dims == theirs.dims
    for a, b in ((ours.ds_train, theirs.ds_train), (ours.ds_valid, theirs.ds_valid)):
        assert len(a) == len(b) and a.image_shape == b.image_shape == (SIZE, SIZE, 3)
        for i in (0, 7, len(a) - 1):
            (x, y), (xj, yj) = a[i], b[i]
            assert x.dtype == xj.dtype == np.float32 and y == yj
            np.testing.assert_array_equal(x, xj)
    assert len(ours.ds_valid) == 32  # max(40 // 8, 32)
    _same_batches(ours.train_dataloader(), theirs.train_dataloader())
    _same_batches(ours.val_dataloader(), theirs.val_dataloader())


def test_image_tree_matches_jax(tmp_path):
    root = _tree(tmp_path)
    ours, theirs = _modules(root)
    assert ours.num_classes == theirs.num_classes == 3
    assert ours.ds_train.samples == theirs.ds_train.samples
    assert ours.ds_valid.samples == theirs.ds_valid.samples
    assert len(ours.ds_train) == 12 and len(ours.ds_valid) == 6
    # train crops and flips, read in order from one seed on both sides
    for i in range(len(ours.ds_train)):
        (x, y), (xj, yj) = ours.ds_train[i], theirs.ds_train[i]
        assert x.shape == (SIZE, SIZE, 3) and y == yj
        np.testing.assert_array_equal(x, xj)
    for i in range(len(ours.ds_valid)):
        np.testing.assert_array_equal(ours.ds_valid[i][0], theirs.ds_valid[i][0])
    ours, theirs = _modules(root)  # fresh seed streams for the loaders
    _same_batches(ours.train_dataloader(), theirs.train_dataloader())
    _same_batches(ours.val_dataloader(), theirs.val_dataloader())


def test_val_split_carved_from_train(tmp_path):
    ours, theirs = _modules(_tree(tmp_path, val=False))
    assert ours.ds_valid.samples == theirs.ds_valid.samples
    assert ours.ds_train.samples == theirs.ds_train.samples
    assert len(ours.ds_valid) == 1 and len(ours.ds_train) == 11  # max(12 // 50, 1)
    assert not set(ours.ds_valid.samples) & set(ours.ds_train.samples)
    assert ours.ds_valid.train is False and ours.ds_train.train is True


def test_class_directories_must_agree(tmp_path):
    root = _tree(tmp_path, val_classes=CLASSES[:2])
    for module in (pif, jif):
        data = module.ImageFolderDataModule(root=root, image_size=SIZE)
        data.prepare_data()
        with pytest.raises(ValueError, match="class directories disagree"):
            data.setup()
    with pytest.raises(FileNotFoundError, match="no image tree"):
        pif.ImageFolderDataModule(root=str(tmp_path / "nothing")).prepare_data()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no class directories"):
        pif.list_image_folder(str(empty))


@pytest.mark.parametrize("synthetic", [False, True])
def test_same_batches_for_every_num_workers(tmp_path, synthetic):
    """The pool reads a batch's examples in the batch's order, its
    augmentation seeds drawn first: two epochs at 4 workers are those at 0,
    and at 0 those of the JAX loader."""
    kw = dict(synthetic=True, synthetic_size=40) if synthetic else {}
    root = "." if synthetic else _tree(tmp_path)
    epochs = {}
    for workers in (0, 4):
        data = pif.ImageFolderDataModule(root=root, image_size=SIZE, batch_size=4,
                                         num_workers=workers, seed=5, **kw)
        data.setup()
        loader = data.train_dataloader()
        assert loader.num_workers == workers
        epochs[workers] = [list(loader), list(loader), list(data.val_dataloader())]
    for a, b in zip(epochs[0], epochs[4]):
        _same_batches(a, b)
    theirs = jif.ImageFolderDataModule(root=root, image_size=SIZE, batch_size=4, num_workers=0,
                                       seed=5, **kw)
    theirs.setup()
    loader = theirs.train_dataloader()
    _same_batches(epochs[0][0], list(loader))
    _same_batches(epochs[0][1], list(loader))


def test_pool_keeps_the_order_of_a_seedless_dataset():
    class Slow:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return np.full((2, 2, 1), i, np.float32), i

    for workers in (0, 3):
        loader = DataLoader(Slow(), 4, image_label_collate, shuffle=True, seed=1,
                            drop_last=False, num_workers=workers)
        batches = list(loader)
        labels = np.concatenate([b["label"] for b in batches])
        assert sorted(labels) == list(range(10)) and [len(b["label"]) for b in batches] == [4, 4, 2]
        np.testing.assert_array_equal(np.concatenate([b["image"] for b in batches])[:, 0, 0, 0],
                                      labels)
        if workers == 0:
            first = labels
        else:
            np.testing.assert_array_equal(labels, first)
