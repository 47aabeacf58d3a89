"""The port's optical-flow data (``perceiver_io_torch/data/flow.py``) against
the JAX package's, on the CPU:

- ``read_flo`` on a written Middlebury ``.flo`` (and its refusal of a bad
  magic number), the same array as the JAX reader's;
- ``synthetic_flow_pairs``, ``warp_backward`` and ``_smooth_field`` bit for
  bit the JAX functions' (numpy, the same seeds);
- ``FlowDataModule``'s batches (the seeded shuffle over two epochs, then
  validation in order) bit for bit the JAX module's, and its train /
  validation split;
- ``load_sintel`` on a tiny Sintel tree written under ``tmp_path`` (PNG
  frames, ``.flo`` flows, a pair without its ``.flo`` and a scene too small
  for the crop, both skipped) against the JAX loader; ``prepare_data``
  without the tree and without ``--synthetic`` raises (the port downloads
  nothing).
"""

import struct

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)

from perceiver_io_tpu.data import flow as jflow
from perceiver_io_torch.data import flow


def _write_flo(path, field: np.ndarray, magic: float = 202021.25) -> None:
    h, w, _ = field.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<f", magic) + struct.pack("<ii", w, h))
        f.write(field.astype("<f4").tobytes())


def test_read_flo_matches_jax(tmp_path):
    field = np.random.default_rng(0).normal(size=(5, 7, 2)).astype(np.float32)
    _write_flo(tmp_path / "a.flo", field)
    got = flow.read_flo(str(tmp_path / "a.flo"))
    assert got.shape == (5, 7, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, field)
    np.testing.assert_array_equal(got, jflow.read_flo(str(tmp_path / "a.flo")))
    _write_flo(tmp_path / "bad.flo", field, magic=1.0)
    with pytest.raises(ValueError, match="bad .flo magic"):
        flow.read_flo(str(tmp_path / "bad.flo"))


@pytest.mark.parametrize("shape,seed", [((9, 11, 3), 0), ((16, 8, 1), 4)])
def test_synthetic_pairs_match_jax(shape, seed):
    frames, flows = flow.synthetic_flow_pairs(5, shape, seed=seed)
    jframes, jflows = jflow.synthetic_flow_pairs(5, shape, seed=seed)
    assert frames.shape == (5, 2, *shape) and flows.shape == (5, *shape[:2], 2)
    assert frames.dtype == flows.dtype == np.float32
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(flows, jflows)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    field = flow._smooth_field(rng, *shape, 1.5)
    np.testing.assert_array_equal(field, jflow._smooth_field(jrng, *shape, 1.5))
    # the second frame is the first warped by the flow (the generator warps
    # the float64 field before it is stored as f32: one rounding apart)
    np.testing.assert_allclose(frames[2, 1], flow.warp_backward(frames[2, 0], flows[2]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(flow.warp_backward(frames[2, 0], flows[2] * 4),
                                  jflow.warp_backward(frames[2, 0], flows[2] * 4))


def test_batches_match_jax():
    kwargs = dict(image_shape=(6, 10, 3), batch_size=4, synthetic=True, synthetic_size=40,
                  seed=3)
    modules = [jflow.FlowDataModule(**kwargs), flow.FlowDataModule(**kwargs)]
    batches = []
    for module in modules:
        module.prepare_data()
        module.setup()
        train = module.train_dataloader()
        batches.append(list(train) + list(train) + list(module.val_dataloader()))
    assert len(modules[1].ds_train) == 35 and len(modules[1].ds_valid) == 5
    assert len(batches[1]) == 8 + 8 + 2  # 35 train pairs, drop_last; 5 in validation
    assert len(batches[0]) == len(batches[1])
    for jb, pb in zip(*batches):
        assert set(pb) == {"frames", "flow"} and pb["frames"].dtype == np.float32
        for key in ("frames", "flow"):
            np.testing.assert_array_equal(pb[key], np.asarray(jb[key]))
    assert batches[1][-1]["frames"].shape == (1, 2, 6, 10, 3)  # validation keeps its tail
    assert not np.array_equal(batches[1][0]["flow"], batches[1][8]["flow"])  # reshuffled


def _write_sintel(root, rng) -> None:
    from PIL import Image

    scenes = {"alley_1": (12, 14, 4), "ambush_2": (10, 16, 3), "tiny": (4, 4, 2)}
    for scene, (h, w, n) in scenes.items():
        clean = root / "Sintel" / "training" / "clean" / scene
        flows = root / "Sintel" / "training" / "flow" / scene
        clean.mkdir(parents=True)
        flows.mkdir(parents=True)
        for i in range(1, n + 1):
            pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(pixels).save(clean / f"frame_{i:04d}.png")
            if not (scene == "ambush_2" and i == 2):  # one pair without its flow
                _write_flo(flows / f"frame_{i:04d}.flo",
                           rng.normal(size=(h, w, 2)).astype(np.float32))


def test_load_sintel_matches_jax(tmp_path):
    _write_sintel(tmp_path, np.random.default_rng(1))
    sintel, shape = str(tmp_path / "Sintel"), (8, 10, 3)
    frames, flows = flow.load_sintel(sintel, shape)
    jframes, jflows = jflow.load_sintel(sintel, shape)
    # alley_1: 3 pairs; ambush_2: 1 of 2 (the second has no .flo); tiny: too small
    assert frames.shape == (4, 2, 8, 10, 3) and flows.shape == (4, 8, 10, 2)
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(flows, jflows)
    assert 0.0 <= frames.min() and frames.max() <= 1.0
    module = flow.FlowDataModule(root=str(tmp_path), image_shape=shape, batch_size=2)
    module.prepare_data()
    module.setup()
    assert len(module.ds_train) == 3 and len(module.ds_valid) == 1
    with pytest.raises(FileNotFoundError, match="no Sintel scenes"):
        flow.load_sintel(str(tmp_path / "Sintel"), shape, split="final")
    with pytest.raises(FileNotFoundError, match="no usable Sintel pairs"):
        flow.load_sintel(str(tmp_path / "Sintel"), (64, 64, 3))


def test_prepare_data_without_the_tree_raises(tmp_path):
    module = flow.FlowDataModule(root=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="Sintel.*--synthetic"):
        module.prepare_data()
    flow.FlowDataModule(root=str(tmp_path), synthetic=True).prepare_data()
