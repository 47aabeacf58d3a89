"""Audio-video clips for the multimodal autoencoder (the port's copy of
``perceiver_io_tpu/data/av.py``).

The port downloads nothing, so there is no Kinetics reader: ``synthetic=True``
(the default) makes class-conditioned clips with cross-modal structure (each
class fixes an audio tone's frequency and a video pattern's drift), bit for
bit the JAX package's (numpy, the same seeds). Real pre-extracted clips are
read from ``<root>/av/<split>/<class>/<clip>.npz`` with arrays ``video``
(T, H, W, C) float in [0, 1] (integer clips are rescaled by 1/255) and
``audio`` (S, C_a). The [0, 1] video is what makes the logged
``video_psnr`` comparable with published numbers. Batches are ``{'video':
(B, T, H, W, C) f32, 'audio': (B, S, C_a) f32, 'label': (B,) int32}``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from perceiver_io_torch.data.pipeline import DataLoader


def synthetic_av_clips(n: int, video_shape: Tuple[int, int, int, int], num_audio_samples: int,
                       num_audio_channels: int = 1, num_classes: int = 4,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(video (N, T, H, W, C), audio (N, S, C_a), labels (N,)): class k
    drives a drifting 2-D sinusoid in the video and a pure tone of
    class-dependent frequency in the audio, each with a little noise."""
    t, h, w, c = video_shape
    rng = np.random.default_rng(seed)
    videos = np.empty((n, *video_shape), np.float32)
    audios = np.empty((n, num_audio_samples, num_audio_channels), np.float32)
    labels = rng.integers(0, num_classes, n).astype(np.int32)

    ys = np.linspace(0, 2 * np.pi, h)[None, :, None]
    xs = np.linspace(0, 2 * np.pi, w)[None, None, :]
    ts = np.arange(t, dtype=np.float32)[:, None, None]
    s = np.arange(num_audio_samples)[:, None] / num_audio_samples
    for i in range(n):
        k = labels[i]
        angle = 2 * np.pi * k / num_classes
        phase = rng.uniform(0, 2 * np.pi)
        drift_y = 0.4 * np.cos(angle) * ts
        drift_x = 0.4 * np.sin(angle) * ts
        pattern = 0.5 + 0.5 * np.sin(
            (k % 3 + 1) * (ys + drift_y) + (k % 2 + 1) * (xs + drift_x) + phase)  # (T, H, W)
        videos[i] = np.repeat(pattern[..., None], c, axis=-1)
        videos[i] += rng.normal(0, 0.02, videos[i].shape)
        tone = np.sin(2 * np.pi * 20.0 * (k + 1) * s + phase)
        audios[i] = np.repeat(tone, num_audio_channels, axis=-1)
        audios[i] += rng.normal(0, 0.02, audios[i].shape)
    return videos, audios, labels


class AVDataset:
    def __init__(self, videos: np.ndarray, audios: np.ndarray, labels: np.ndarray):
        if not len(videos) == len(audios) == len(labels):
            raise ValueError(f"{len(videos)} videos, {len(audios)} audio clips and "
                             f"{len(labels)} labels")
        self.videos = videos
        self.audios = audios
        self.labels = labels

    def __len__(self) -> int:
        return len(self.videos)

    def __getitem__(self, i: int):
        return self.videos[i], self.audios[i], self.labels[i]


def _collate(batch: Sequence) -> Dict[str, np.ndarray]:
    return {"video": np.stack([v for v, _, _ in batch]),
            "audio": np.stack([a for _, a, _ in batch]),
            "label": np.asarray([label for _, _, label in batch], np.int32)}


def load_av_tree(root: str, split: str, video_shape: Tuple[int, int, int, int],
                 num_audio_samples: int, num_audio_channels: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Read ``<root>/<split>/<class>/*.npz``; the sorted class directories
    give the label ids. Each clip is centre-cropped (video) and truncated
    (video time, audio) to the requested shapes; a clip smaller than them
    is skipped. The crop comes first, then an integer clip is rescaled by
    1/255, so no float copy of an uncropped clip is made."""
    classes = sorted(d for d in glob.glob(os.path.join(root, split, "*")) if os.path.isdir(d))
    if not classes:
        raise FileNotFoundError(
            f"no class directories under {root}/{split}: place <class>/<clip>.npz clips "
            f"there, or use synthetic=True; the port downloads nothing")
    t, h, w, c = video_shape
    videos, audios, labels = [], [], []
    for label, class_dir in enumerate(classes):
        for path in sorted(glob.glob(os.path.join(class_dir, "*.npz"))):
            with np.load(path) as z:
                video, audio = z["video"], z["audio"]
            if video.ndim != 4 or audio.ndim != 2:
                raise ValueError(f"{path}: need video (T,H,W,C) + audio (S,C)")
            vt, vh, vw, vc = video.shape
            if (vt < t or vh < h or vw < w or vc < c or len(audio) < num_audio_samples
                    or audio.shape[1] < num_audio_channels):
                continue
            top, left = (vh - h) // 2, (vw - w) // 2
            crop = video[:t, top: top + h, left: left + w, :c]
            if np.issubdtype(crop.dtype, np.integer):
                crop = crop.astype(np.float32) / 255.0
            else:
                crop = crop.astype(np.float32)
            videos.append(crop)
            audios.append(audio[:num_audio_samples, :num_audio_channels])
            labels.append(label)
    if not videos:
        raise FileNotFoundError(
            f"no usable clips under {root}/{split}: every clip was smaller than the "
            f"requested video {video_shape} / audio {num_audio_samples}")
    return (np.stack(videos).astype(np.float32), np.stack(audios).astype(np.float32),
            np.asarray(labels, np.int32), [os.path.basename(c) for c in classes])


class AVDataModule:
    """``prepare_data`` / ``setup`` / loaders, as the JAX package's module
    with one shard. Synthetic: the last eighth of the clips (at least 1)
    held out. Real: ``<root>/av/train`` and ``<root>/av/val``, whose class
    directories must match train's (the label ids come from each split's
    own sorted directories); without a val split, a tenth of train's clips
    (at least 1) in a permutation seeded by ``seed`` is held out (the tree
    reader returns them class by class). The train loader is shuffled from
    ``seed``; the validation loader is in order and whole."""

    def __init__(self, root: str = ".cache",
                 video_shape: Tuple[int, int, int, int] = (16, 224, 224, 3),
                 num_audio_samples: int = 30720, num_audio_channels: int = 1,
                 num_classes: int = 4, batch_size: int = 8, synthetic: bool = True,
                 synthetic_size: int = 256, seed: int = 0):
        self.root = root
        self.video_shape = tuple(video_shape)
        self.num_audio_samples = num_audio_samples
        self.num_audio_channels = num_audio_channels
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.synthetic = synthetic
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.ds_train: Optional[AVDataset] = None
        self.ds_valid: Optional[AVDataset] = None

    def prepare_data(self) -> None:
        """Check that the clip tree is there (or ``synthetic``)."""
        if not self.synthetic:
            av = os.path.join(self.root, "av")
            if not os.path.isdir(os.path.join(av, "train")):
                raise FileNotFoundError(
                    f"no AV data under {av}: place <split>/<class>/<clip>.npz clips there, "
                    f"or use synthetic=True; the port downloads nothing")

    def setup(self) -> None:
        if self.synthetic:
            if self.synthetic_size < 2:
                raise ValueError(f"synthetic_size must be >= 2 to split train/val, got "
                                 f"{self.synthetic_size}")
            videos, audios, labels = synthetic_av_clips(
                self.synthetic_size, self.video_shape, self.num_audio_samples,
                self.num_audio_channels, self.num_classes, seed=self.seed)
            val = min(max(self.synthetic_size // 8, 1), len(videos) - 1)
            split = len(videos) - val
            self.ds_train = AVDataset(videos[:split], audios[:split], labels[:split])
            self.ds_valid = AVDataset(videos[split:], audios[split:], labels[split:])
            return
        av = os.path.join(self.root, "av")
        shapes = (self.video_shape, self.num_audio_samples, self.num_audio_channels)
        vt, at, lt, classes = load_av_tree(av, "train", *shapes)
        self.num_classes = len(classes)
        try:
            vv, av_, lv, val_classes = load_av_tree(av, "val", *shapes)
        except FileNotFoundError:
            if len(vt) < 2:
                raise ValueError(f"need at least 2 clips to split train/val, got {len(vt)}")
            order = np.random.default_rng(self.seed).permutation(len(vt))
            vt, at, lt = vt[order], at[order], lt[order]
            val = max(len(vt) // 10, 1)
            vv, av_, lv = vt[-val:], at[-val:], lt[-val:]
            vt, at, lt = vt[:-val], at[:-val], lt[:-val]
        else:
            if val_classes != classes:
                raise ValueError(f"train/val class mismatch under {av}: train={classes} "
                                 f"val={val_classes}")
        self.ds_train = AVDataset(vt, at, lt)
        self.ds_valid = AVDataset(vv, av_, lv)

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_train, self.batch_size, _collate, shuffle=True,
                          seed=self.seed)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_valid, self.batch_size, _collate, shuffle=False,
                          drop_last=False)
