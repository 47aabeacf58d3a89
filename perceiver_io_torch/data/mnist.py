"""MNIST image data (the port's copy of ``perceiver_io_tpu/data/mnist.py``).

Channels-last (28, 28, 1) images, ``Normalize(0.5, 0.5)`` after scaling to
[0, 1] (pixel ∈ [-1, 1]), an optional random crop in training (a centre crop
of the same size in validation), a validation split carved from the train
set. The idx files are read from ``<root>/MNIST/raw`` (torchvision's layout)
or ``<root>``, raw or ``.gz``; the port downloads nothing: without local
files ``prepare_data`` raises and names them. ``synthetic=True`` makes a
learnable stand-in, each class a fixed smooth template plus pixel noise,
bit for bit the JAX package's (numpy, the same seeds).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from perceiver_io_torch.data.pipeline import Batch, DataLoader

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        ndim = struct.unpack(">I", f.read(4))[0] & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(root: str, base: str) -> str:
    for candidate in (os.path.join(root, "MNIST", "raw", base),
                      os.path.join(root, "MNIST", "raw", base + ".gz"),
                      os.path.join(root, base), os.path.join(root, base + ".gz")):
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(
        f"MNIST file {base} not found under {root}: place the idx files "
        f"({', '.join(_FILES.values())}, raw or .gz) at {root}/MNIST/raw, or use "
        f"synthetic=True (--synthetic); the port downloads nothing")


def load_mnist(root: str, split: str) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, 28, 28), labels uint8 (N,)) of 'train' or 'test'."""
    prefix = "train" if split == "train" else "test"
    return (_read_idx(_find(root, _FILES[f"{prefix}_images"])),
            _read_idx(_find(root, _FILES[f"{prefix}_labels"])))


def synthetic_digits(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` deterministic learnable examples: each class a fixed smooth random
    28×28 template (seed 1234, shared by every split and seed) plus pixel
    noise from ``seed``."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).uniform(0, 1, size=(10, 28, 28))
    for _ in range(2):  # smooth the templates so they look image-like...
        templates = (templates + np.roll(templates, 1, 1) + np.roll(templates, -1, 1)
                     + np.roll(templates, 1, 2) + np.roll(templates, -1, 2)) / 5.0
    # ...then restore full contrast, so the class signal dominates the noise
    tmin = templates.min(axis=(1, 2), keepdims=True)
    tmax = templates.max(axis=(1, 2), keepdims=True)
    templates = (templates - tmin) / (tmax - tmin)
    labels = rng.integers(0, 10, size=n).astype(np.uint8)
    images = templates[labels] + rng.normal(0, 0.15, size=(n, 28, 28))
    return (np.clip(images, 0, 1) * 255).astype(np.uint8), labels


def image_label_collate(batch) -> Batch:
    """(image, label) examples → ``{'image': (B, ...), 'label': (B,) int32}``."""
    return {"image": np.stack([img for img, _ in batch]),
            "label": np.asarray([y for _, y in batch], dtype=np.int32)}


class MNISTDataset:
    """Normalized channels-last examples; with ``crop``, a random crop drawn
    from ``augment_seed`` (in the order the examples are read) or, with
    ``random_crop=False``, the centre crop."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, crop: Optional[int] = None,
                 random_crop: bool = True, augment_seed: int = 0):
        self.images = images
        self.labels = labels
        self.crop = crop
        self.random_crop = random_crop
        self._rng = np.random.default_rng(augment_seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        img = self.images[i]
        if self.crop:
            s = self.crop
            h, w = img.shape
            if self.random_crop:
                top = int(self._rng.integers(0, h - s + 1))
                left = int(self._rng.integers(0, w - s + 1))
            else:
                top, left = (h - s) // 2, (w - s) // 2
            img = img[top: top + s, left: left + s]
        # ToTensor (→ [0, 1]) + Normalize(0.5, 0.5) + channels-last
        img = (img.astype(np.float32) / 255.0 - 0.5) / 0.5
        return img[..., None], int(self.labels[i])


class MNISTDataModule:
    """``prepare_data`` / ``setup`` / loaders, as the JAX package's module:
    ``val_split`` examples (on ``synthetic``, an eighth of
    ``synthetic_size``, at least 32) carved from the end of the train set,
    the train loader shuffled from ``seed``, the validation loader in order
    and whole."""

    num_classes = 10

    def __init__(self, root: str = ".cache", batch_size: int = 64,
                 random_crop: Optional[int] = None, val_split: int = 10000,
                 synthetic: bool = False, synthetic_size: int = 4096, seed: int = 0):
        self.root = root
        self.batch_size = batch_size
        self.random_crop = random_crop
        self.val_split = val_split
        self.synthetic = synthetic
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.ds_train: Optional[MNISTDataset] = None
        self.ds_valid: Optional[MNISTDataset] = None

    @property
    def dims(self) -> Tuple[int, int, int]:
        s = self.random_crop
        return (s, s, 1) if s else (28, 28, 1)

    def prepare_data(self) -> None:
        """Check that the idx files are there (or ``synthetic``)."""
        if not self.synthetic:
            for base in _FILES.values():
                _find(self.root, base)

    def setup(self) -> None:
        if self.synthetic:
            images, labels = synthetic_digits(self.synthetic_size, seed=self.seed)
            val = max(self.synthetic_size // 8, 32)
        else:
            images, labels = load_mnist(self.root, "train")
            val = self.val_split
        split = len(images) - val
        self.ds_train = MNISTDataset(images[:split], labels[:split], crop=self.random_crop,
                                     augment_seed=self.seed)
        self.ds_valid = MNISTDataset(images[split:], labels[split:], crop=self.random_crop,
                                     random_crop=False)

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_train, self.batch_size, image_label_collate, shuffle=True,
                          seed=self.seed)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_valid, self.batch_size, image_label_collate, shuffle=False,
                          drop_last=False)
