"""Optical-flow data (the port's copy of ``perceiver_io_tpu/data/flow.py``).

Reads the MPI-Sintel tree (``training/clean/<scene>/frame_NNNN.png`` with
``training/flow/<scene>/frame_NNNN.flo``) from ``<root>/Sintel`` when it is
there; the port downloads nothing. ``synthetic=True`` makes smooth random
flow fields with ``frame2 = warp(frame1, flow)``, so a short run has signal
to fit, bit for bit the JAX package's (numpy, the same seeds). Batches are
``{'frames': (B, 2, H, W, C), 'flow': (B, H, W, 2)}`` f32.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from perceiver_io_torch.data.pipeline import DataLoader

_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo reader: (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - _FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(h * w * 2 * 4), dtype="<f4")
    return data.reshape(h, w, 2)


def _smooth_field(rng, h: int, w: int, channels: int, scale: float) -> np.ndarray:
    """Low-frequency random field: coarse noise, bilinearly upsampled."""
    ch, cw = max(h // 8, 2), max(w // 8, 2)
    coarse = rng.normal(0, scale, (ch, cw, channels)).astype(np.float32)
    ys = np.linspace(0, ch - 1, h)
    xs = np.linspace(0, cw - 1, w)
    y0 = np.clip(ys.astype(int), 0, ch - 2)
    x0 = np.clip(xs.astype(int), 0, cw - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    return (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
            + c10 * fy * (1 - fx) + c11 * fy * fx)


def warp_backward(image: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Bilinear backward warp: out(p) = image(p + flow(p)), border-clamped."""
    h, w, _ = image.shape
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sy = np.clip(gy + flow[..., 1], 0, h - 1)
    sx = np.clip(gx + flow[..., 0], 0, w - 1)
    y0 = np.clip(sy.astype(int), 0, h - 2)
    x0 = np.clip(sx.astype(int), 0, w - 2)
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]
    return (image[y0, x0] * (1 - fy) * (1 - fx) + image[y0, x0 + 1] * (1 - fy) * fx
            + image[y0 + 1, x0] * fy * (1 - fx)
            + image[y0 + 1, x0 + 1] * fy * fx).astype(np.float32)


def synthetic_flow_pairs(n: int, image_shape: Tuple[int, int, int], seed: int = 0,
                         max_disp: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """(frames (N, 2, H, W, C), flows (N, H, W, 2)) with frame2 consistent
    with the flow field."""
    h, w, c = image_shape
    rng = np.random.default_rng(seed)
    frames = np.empty((n, 2, h, w, c), np.float32)
    flows = np.empty((n, h, w, 2), np.float32)
    for i in range(n):
        frame1 = _smooth_field(rng, h, w, c, 1.0)
        flow = np.clip(_smooth_field(rng, h, w, 2, max_disp), -max_disp, max_disp)
        frames[i, 0] = frame1
        frames[i, 1] = warp_backward(frame1, flow)
        flows[i] = flow
    return frames, flows


class FlowDataset:
    def __init__(self, frames: np.ndarray, flows: np.ndarray):
        if len(frames) != len(flows):
            raise ValueError(f"{len(frames)} frame pairs for {len(flows)} flows")
        self.frames = frames
        self.flows = flows

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.frames[i], self.flows[i]


def _collate(batch: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {"frames": np.stack([f for f, _ in batch]),
            "flow": np.stack([g for _, g in batch])}


def load_sintel(root: str, image_shape: Tuple[int, int, int],
                split: str = "clean") -> Tuple[np.ndarray, np.ndarray]:
    """MPI-Sintel frame pairs and their ground-truth flow, centre-cropped to
    ``image_shape``; pairs without a ``.flo`` or smaller than the crop are
    skipped. Reads the PNGs with PIL."""
    from PIL import Image

    h, w, _ = image_shape
    frames_list: List[np.ndarray] = []
    flows_list: List[np.ndarray] = []
    scenes = sorted(glob.glob(os.path.join(root, "training", split, "*")))
    if not scenes:
        raise FileNotFoundError(
            f"no Sintel scenes under {root}/training/{split}: place the MPI-Sintel tree "
            f"there, or use synthetic=True (--synthetic); the port downloads nothing")
    split_dir = os.path.join(root, "training", split)
    flow_dir = os.path.join(root, "training", "flow")
    for scene in scenes:
        pngs = sorted(glob.glob(os.path.join(scene, "frame_*.png")))
        for first, second in zip(pngs, pngs[1:]):
            # the flow file by the frame's path relative to the split's
            # directory, whatever segments the root itself holds
            rel = os.path.relpath(first, split_dir)
            flo = os.path.join(flow_dir, rel[: -len(".png")] + ".flo")
            if not os.path.exists(flo):
                continue
            img1 = np.asarray(Image.open(first), np.float32) / 255.0
            img2 = np.asarray(Image.open(second), np.float32) / 255.0
            flow = read_flo(flo)
            ih, iw = img1.shape[:2]
            if ih < h or iw < w:
                continue
            top, left = (ih - h) // 2, (iw - w) // 2
            sl = np.s_[top: top + h, left: left + w]
            frames_list.append(np.stack([img1[sl], img2[sl]]))
            flows_list.append(flow[sl])
    if not frames_list:
        raise FileNotFoundError(
            f"no usable Sintel pairs under {split_dir}: every frame pair was skipped "
            f"(missing .flo under {flow_dir}, or frames smaller than the requested "
            f"{h}x{w} crop)")
    return np.stack(frames_list), np.stack(flows_list)


class FlowDataModule:
    """``prepare_data`` / ``setup`` / loaders, as the JAX package's module
    with one shard: the last eighth of the synthetic pairs (at least 4), or a
    tenth of Sintel's (at least 1), held out for validation; the train
    loader shuffled from ``seed``, the validation loader in order and
    whole."""

    def __init__(self, root: str = ".cache", image_shape: Tuple[int, int, int] = (368, 496, 3),
                 batch_size: int = 8, synthetic: bool = False, synthetic_size: int = 512,
                 seed: int = 0):
        self.root = root
        self.image_shape = tuple(image_shape)
        self.batch_size = batch_size
        self.synthetic = synthetic
        self.synthetic_size = synthetic_size
        self.seed = seed
        self.ds_train: Optional[FlowDataset] = None
        self.ds_valid: Optional[FlowDataset] = None

    def prepare_data(self) -> None:
        """Check that the Sintel tree is there (or ``synthetic``)."""
        if not self.synthetic:
            sintel = os.path.join(self.root, "Sintel")
            if not os.path.isdir(os.path.join(sintel, "training")):
                raise FileNotFoundError(
                    f"no Sintel data under {sintel}: place the MPI-Sintel tree there, or "
                    f"use synthetic=True (--synthetic); the port downloads nothing")

    def setup(self) -> None:
        if self.synthetic:
            frames, flows = synthetic_flow_pairs(self.synthetic_size, self.image_shape,
                                                 seed=self.seed)
            val = max(self.synthetic_size // 8, 4)
        else:
            frames, flows = load_sintel(os.path.join(self.root, "Sintel"), self.image_shape)
            val = max(len(frames) // 10, 1)
        if len(frames) < 2:
            raise ValueError(f"need at least 2 flow pairs to split train/val, got {len(frames)}")
        val = min(val, len(frames) - 1)  # keep the training set non-empty
        split = len(frames) - val
        self.ds_train = FlowDataset(frames[:split], flows[:split])
        self.ds_valid = FlowDataset(frames[split:], flows[split:])

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_train, self.batch_size, _collate, shuffle=True,
                          seed=self.seed)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.ds_valid, self.batch_size, _collate, shuffle=False,
                          drop_last=False)
