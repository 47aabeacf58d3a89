"""ImageNet-style image folders (the port's copy of
``perceiver_io_tpu/data/imagefolder.py``).

Reads the class-per-directory layout torchvision calls ImageFolder::

    <root>/<name>/train/<wnid-or-class>/*.JPEG
    <root>/<name>/val/<wnid-or-class>/*.JPEG

Images are decoded lazily per index with the standard recipe: train =
random-resized crop + horizontal flip, val = the shorter side resized to
1.15× the size, then the centre crop; both normalized by the ImageNet
channel statistics, channels-last float32. With no ``val/`` a fiftieth of
the train images (at least one) is carved off as the validation split, from
the seed. ``DataLoader(..., num_workers=N)`` decodes a batch's images in N
threads. ``synthetic=True`` makes a learnable class-template set (lazy, per
index) instead; it needs no Pillow, which only the file readers import.
Every example is bit for bit the JAX package's (numpy and PIL, the same
seeds); multi-host sharding stays with the distribution slice.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from perceiver_io_torch.data.mnist import image_label_collate
from perceiver_io_torch.data.pipeline import DataLoader

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_EXTENSIONS = (".jpeg", ".jpg", ".png", ".bmp", ".webp")


def list_image_folder(split_dir: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """``[(path, class_index)]`` and the sorted class names of a split dir."""
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    if not classes:
        raise FileNotFoundError(f"no class directories under {split_dir}")
    samples: List[Tuple[str, int]] = []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(split_dir, cls)
        for name in sorted(os.listdir(cdir)):
            if name.lower().endswith(_EXTENSIONS):
                samples.append((os.path.join(cdir, name), idx))
    if not samples:
        raise FileNotFoundError(f"no images under {split_dir} (extensions {_EXTENSIONS})")
    return samples, classes


def _random_resized_crop(img, size: int, rng: np.random.Generator):
    """torchvision's RandomResizedCrop: area scale U(0.08, 1), aspect
    log-U(3/4, 4/3), 10 attempts, then the centre crop."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(0.08, 1.0)
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target * aspect)))
        ch = int(round(np.sqrt(target / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            return img.resize((size, size), Image.BILINEAR,
                              box=(left, top, left + cw, top + ch))
    return _center_crop(img, size)


def _center_crop(img, size: int):
    from PIL import Image

    w, h = img.size
    scale = size * 1.15 / min(w, h)
    if scale != 1.0:
        img = img.resize((max(size, int(round(w * scale))),
                          max(size, int(round(h * scale)))), Image.BILINEAR)
        w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


class ImageFolderDataset:
    """Lazily decoded ``(path, label)`` samples, channels-last f32. A train
    read draws one seed (:meth:`draw_seed`) and augments from it
    (:meth:`read`); the loader's pool draws a batch's seeds in the batch's
    order before its threads read, so the crops are the same for every
    ``num_workers`` (the JAX pool's threads draw them in whatever order they
    take the lock; with no pool both draw them in read order)."""

    def __init__(self, samples: Sequence[Tuple[str, int]], image_size: int = 224,
                 train: bool = True, augment_seed: int = 0):
        self.samples = list(samples)
        self.image_size = image_size
        self.train = train
        # numpy Generators are not thread-safe: only a per-item seed is drawn
        # under the lock, the augmentation from a Generator of the item's own
        self._seed_rng = np.random.default_rng(augment_seed)
        self._seed_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.image_size, self.image_size, 3)

    def draw_seed(self) -> Optional[int]:
        """The next read's augmentation seed (None for a validation set)."""
        if not self.train:
            return None
        with self._seed_lock:
            return int(self._seed_rng.integers(2**63))

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        return self.read(i, self.draw_seed())

    def read(self, i: int, seed: Optional[int]) -> Tuple[np.ndarray, int]:
        """Example ``i``, a train crop and flip drawn from ``seed``."""
        from PIL import Image

        path, label = self.samples[i]
        if self.train:
            rng = np.random.default_rng(seed)
        with Image.open(path) as img:
            img = img.convert("RGB")
            if self.train:
                img = _random_resized_crop(img, self.image_size, rng)
                if rng.random() < 0.5:
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
            else:
                img = _center_crop(img, self.image_size)
            arr = np.asarray(img, np.float32) / 255.0
        return (arr - IMAGENET_MEAN) / IMAGENET_STD, label


class SyntheticImageDataset:
    """A learnable stand-in: per-class 8 × 8 templates repeated up to the
    image size, plus pixel noise seeded per index. Lazy per index."""

    def __init__(self, n: int, num_classes: int = 10, image_size: int = 224, seed: int = 0):
        self.n = n
        self.image_size = image_size
        base = np.random.default_rng(1234)  # the templates, shared across splits
        self.templates = base.uniform(0, 1, size=(num_classes, 8, 8, 3)).astype(np.float32)
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, num_classes, size=n).astype(np.int32)
        self.noise_seed = seed

    def __len__(self) -> int:
        return self.n

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.image_size, self.image_size, 3)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        label = int(self.labels[i])
        s = self.image_size
        t = self.templates[label]
        reps = -(-s // t.shape[0])
        img = np.repeat(np.repeat(t, reps, 0), reps, 1)[:s, :s]
        rng = np.random.default_rng(np.uint64(self.noise_seed) * 1000003 + np.uint64(i))
        img = np.clip(img + rng.normal(0, 0.15, img.shape).astype(np.float32), 0, 1)
        return (img - IMAGENET_MEAN) / IMAGENET_STD, label


class ImageFolderDataModule:
    """``prepare_data`` / ``setup`` / loaders, as the JAX package's module
    on one host: the train loader shuffled from ``seed``, the validation
    loader in order and whole; both decode in ``num_workers`` threads."""

    def __init__(self, root: str = ".cache", name: str = "imagenet", image_size: int = 224,
                 batch_size: int = 64, synthetic: bool = False, synthetic_size: int = 4096,
                 synthetic_classes: int = 10, num_workers: int = 8, seed: int = 0):
        self.root = root
        self.name = name
        self.image_size = image_size
        self.batch_size = batch_size
        self.synthetic = synthetic
        self.synthetic_size = synthetic_size
        self.synthetic_classes = synthetic_classes
        self.num_workers = num_workers
        self.seed = seed
        self.num_classes: Optional[int] = None
        self.ds_train = None
        self.ds_valid = None

    @property
    def dims(self) -> Tuple[int, int, int]:
        return (self.image_size, self.image_size, 3)

    def prepare_data(self) -> None:
        """Check that the train tree is there (or ``synthetic``)."""
        if not self.synthetic:
            train_dir = os.path.join(self.root, self.name, "train")
            if not os.path.isdir(train_dir):
                raise FileNotFoundError(
                    f"no image tree at {train_dir}: lay out "
                    f"{self.root}/{self.name}/{{train,val}}/<class>/*.JPEG, "
                    "or use synthetic=True")

    def setup(self) -> None:
        if self.synthetic:
            self.num_classes = self.synthetic_classes
            self.ds_train = SyntheticImageDataset(self.synthetic_size, self.synthetic_classes,
                                                  self.image_size, seed=self.seed)
            val = max(self.synthetic_size // 8, 32)
            self.ds_valid = SyntheticImageDataset(val, self.synthetic_classes, self.image_size,
                                                  seed=self.seed + 1)
            return
        base = os.path.join(self.root, self.name)
        train_samples, classes = list_image_folder(os.path.join(base, "train"))
        val_dir = os.path.join(base, "val")
        if os.path.isdir(val_dir):
            val_samples, val_classes = list_image_folder(val_dir)
            if val_classes != classes:
                raise ValueError(f"train/val class directories disagree under {base} "
                                 f"({len(classes)} vs {len(val_classes)} classes)")
        else:  # no val split on disk: a deterministic draw from train
            order = np.random.default_rng(self.seed).permutation(len(train_samples))
            n_val = max(len(train_samples) // 50, 1)
            val_samples = [train_samples[i] for i in order[:n_val]]
            train_samples = [train_samples[i] for i in order[n_val:]]
        self.num_classes = len(classes)
        self.ds_train = ImageFolderDataset(train_samples, self.image_size, train=True,
                                           augment_seed=self.seed)
        self.ds_valid = ImageFolderDataset(val_samples, self.image_size, train=False)

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_train, self.batch_size, image_label_collate, shuffle=True,
                          seed=self.seed, num_workers=self.num_workers)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_valid, self.batch_size, image_label_collate, shuffle=False,
                          drop_last=False, num_workers=self.num_workers)
