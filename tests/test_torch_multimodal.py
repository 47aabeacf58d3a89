"""The port's multimodal autoencoder (``perceiver_io_torch/models/
multimodal.py``) and its train step against the JAX package, on the CPU
(the kernels' plain versions; the JAX side runs its Pallas kernels in
interpret mode), f32, weights carried from the JAX tree:

- the audio, video and fusing input adapters and the audio and video heads
  against their JAX twins, 1e-6; ``patchify_video`` the exact inverse of
  the video head's un-patchify, and the JAX function's; the span routing
  of ``MultimodalOutputAdapter`` and its refusal of mixed widths;
- the JAX tree carries strictly, under flax's names (the sub-adapters
  ``adapters_<i>_1``; ``audio_padding``, ``video_modality``,
  ``audio_modality``, no ``video_padding``), and the port's own draw of the
  padding and modality vectors is flax's ``truncated_normal(0.02)``
  (within ±0.04);
- the autoencoder (video 2 × 8 × 8 × 3 in (1, 4, 4) patches, 64 audio
  samples in patches of 8, latents (8, 512): one cross head of depth 512
  and one self layer of 8 heads of depth 64) under ``'xla'`` and
  ``'pallas'``, with ``video_patch_loss`` off and on, 2e-5; the loss and
  every metric, 2e-5, and the patch-space loss equal to the pixel one;
- ``make_multimodal_steps``: every gradient within 1e-4 of its leaf's peak
  against ``jax.value_and_grad`` of the JAX loss (both JAX routes), 3 #1 /
  #2 / #3 calls a step under ``'pallas'``; three Adam steps' losses and
  metrics within 1e-4 relative of the JAX step's.

The data: tests/test_torch_av_data.py; the CLI: tests/test_torch_multimodal_cli.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.models import multimodal as jmm
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training.steps import make_multimodal_steps as jax_multimodal_steps
from perceiver_io_torch.interop import from_jax_params, load_param_tree, param_tree
from perceiver_io_torch.models import multimodal as mm
from perceiver_io_torch.models.perceiver import PerceiverDecoder, init_params
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.training import optim
from perceiver_io_torch.training.steps import make_multimodal_steps
from perceiver_io_torch.training.train_state import TrainState

B, VIDEO, SAMPLES, CLASSES = 3, (2, 8, 8, 3), 64, 3


def _model_kwargs(impl: str, patch_loss: bool = False) -> dict:
    return dict(video_shape=VIDEO, num_audio_samples=SAMPLES, samples_per_patch=8,
                num_classes=CLASSES, latent_shape=(8, 512), video_patch_shape=(1, 4, 4),
                num_self_attention_layers_per_block=1, num_self_attention_heads=8,
                video_frequency_bands=2, audio_frequency_bands=3, attn_impl=impl,
                video_patch_loss=patch_loss)


def _batch():
    rng = np.random.default_rng(7)
    return {"video": rng.uniform(0, 1, (B, *VIDEO)).astype(np.float32),
            "audio": rng.normal(0, 1, (B, SAMPLES, 1)).astype(np.float32),
            "label": np.asarray([0, 2, 1], np.int32)}


def _inputs(batch, to=jnp.asarray):
    return {"video": to(batch["video"]), "audio": to(batch["audio"])}


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX autoencoder's initial weights (numpy leaves)."""
    model = jmm.build_multimodal_autoencoder(**_model_kwargs("xla"))
    params = jax.jit(model.init)({"params": jax.random.key(3)}, _inputs(_batch()))["params"]
    return jax.tree.map(np.asarray, params)


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_model(impl: str, patch_loss: bool = False):
    return from_jax_params(mm.build_multimodal_autoencoder(**_model_kwargs(impl, patch_loss)),
                           _params())


# -- adapters -------------------------------------------------------------------------


@pytest.mark.parametrize("samples,per_patch,channels,bands", [(64, 8, 2, 4), (48, 16, 1, 3)])
def test_audio_input_adapter_matches_jax(samples, per_patch, channels, bands):
    x = np.random.default_rng(1).normal(size=(3, samples, channels)).astype(np.float32)
    adapter = mm.AudioInputAdapter(samples, per_patch, channels, bands)
    jadapter = jmm.AudioInputAdapter(num_samples=samples, samples_per_patch=per_patch,
                                     num_audio_channels=channels, num_frequency_bands=bands)
    ref = np.asarray(jadapter.apply({}, jnp.asarray(x)))
    got = adapter(torch.from_numpy(x)).numpy()
    assert adapter.num_tokens == jadapter.num_tokens == samples // per_patch
    assert adapter.num_input_channels == jadapter.num_input_channels == ref.shape[-1]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert not list(adapter.parameters()) and not adapter.state_dict()  # a constant buffer
    # the paper's audio: 16 samples a patch and 2·64 + 1 Fourier channels
    assert mm.AudioInputAdapter(30720, 16, 1, 64).num_input_channels == 145
    with pytest.raises(ValueError, match="required"):
        adapter(torch.zeros(3, samples + 1, channels))
    with pytest.raises(ValueError, match="not divisible"):
        mm.AudioInputAdapter(samples + 1, per_patch)


@pytest.mark.parametrize("video_shape,patch,bands", [((2, 8, 8, 3), (1, 4, 4), 2),
                                                      ((4, 8, 12, 2), (2, 4, 2), 3)])
def test_video_input_adapter_matches_jax(video_shape, patch, bands):
    x = np.random.default_rng(2).uniform(0, 1, (2, *video_shape)).astype(np.float32)
    adapter = mm.VideoInputAdapter(video_shape, patch, bands)
    jadapter = jmm.VideoInputAdapter(video_shape=video_shape, patch_shape=patch,
                                     num_frequency_bands=bands)
    ref = np.asarray(jadapter.apply({}, jnp.asarray(x)))
    got = adapter(torch.from_numpy(x)).numpy()
    assert adapter.grid_shape == jadapter.grid_shape
    assert adapter.num_input_channels == jadapter.num_input_channels == ref.shape[-1]
    assert got.shape == ref.shape == (2, adapter.num_tokens, ref.shape[-1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # token 0 holds the voxels [0:pt, 0:ph, 0:pw] in (t, h, w, c) order
    pt, ph, pw = patch
    np.testing.assert_array_equal(got[0, 0, :adapter.num_patch_channels],
                                  x[0, :pt, :ph, :pw].reshape(-1))
    # the paper's video: 48 patch channels and 3·(2·32 + 1) Fourier ones
    assert mm.VideoInputAdapter().num_input_channels == 48 + 195
    with pytest.raises(ValueError, match="required"):
        adapter(torch.zeros(2, *video_shape[:-1], video_shape[-1] + 1))


def test_multimodal_input_adapter_matches_jax():
    """The fused stream: each stream padded to the widest by its trainable
    vector, tagged by its modality embedding, concatenated along M; the
    JAX parameters carry strictly, and video (the widest) has no padding."""
    batch = _inputs(_batch(), np.asarray)
    subs = (("video", mm.VideoInputAdapter(VIDEO, (1, 4, 4), 2)),
            ("audio", mm.AudioInputAdapter(SAMPLES, 8, 1, 3)))
    jadapter = jmm.MultimodalInputAdapter(adapters=(
        ("video", jmm.VideoInputAdapter(video_shape=VIDEO, num_frequency_bands=2)),
        ("audio", jmm.AudioInputAdapter(num_samples=SAMPLES, samples_per_patch=8,
                                        num_frequency_bands=3))))
    variables = jax.tree.map(np.asarray, jadapter.init(jax.random.key(0),
                                                       jax.tree.map(jnp.asarray, batch)))
    assert sorted(variables["params"]) == ["audio_modality", "audio_padding",
                                           "video_modality"]
    ref = np.asarray(jadapter.apply(variables, jax.tree.map(jnp.asarray, batch)))
    adapter = load_param_tree(mm.MultimodalInputAdapter(subs), variables["params"])
    got = adapter({k: torch.from_numpy(v) for k, v in batch.items()}).detach().numpy()
    assert adapter.common_channels == jadapter.common_channels == 48 + 15
    assert adapter.num_input_channels == jadapter.num_input_channels == 63 + 8
    assert adapter.num_tokens == jadapter.num_tokens == 8 + 8
    assert got.shape == ref.shape == (B, 16, 71)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 8:, 15:63],  # audio's padding, every token
                                  np.broadcast_to(variables["params"]["audio_padding"],
                                                  (B, 8, 48)))
    bare = mm.MultimodalInputAdapter(subs, num_modality_channels=0)
    assert [n for n, _ in bare.named_parameters()] == ["audio_padding"]
    with pytest.raises(ValueError, match="at least one"):
        mm.MultimodalInputAdapter(())


def _head_params(jadapter, x):
    return jax.tree.map(np.asarray, jadapter.init(jax.random.key(1), jnp.asarray(x)))


@pytest.mark.parametrize("as_patches", [False, True])
def test_output_heads_match_jax(as_patches):
    x = np.random.default_rng(3).normal(size=(2, 8, 16)).astype(np.float32)
    jvideo = jmm.VideoOutputAdapter(video_shape=VIDEO, num_output_channels=16,
                                    as_patches=as_patches)
    params = _head_params(jvideo, x)
    video = load_param_tree(mm.VideoOutputAdapter(VIDEO, (1, 4, 4), 16, as_patches=as_patches),
                            params["params"])
    ref = np.asarray(jvideo.apply(params, jnp.asarray(x)))
    got = video(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == ((2, 8, 48) if as_patches else (2, *VIDEO))
    assert video.output_shape == jvideo.output_shape == (8, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    jaudio = jmm.AudioOutputAdapter(num_samples=SAMPLES, samples_per_patch=8,
                                    num_output_channels=16)
    params = _head_params(jaudio, x)
    audio = load_param_tree(mm.AudioOutputAdapter(SAMPLES, 8, 1, 16), params["params"])
    ref = np.asarray(jaudio.apply(params, jnp.asarray(x)))
    got = audio(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, SAMPLES, 1)
    assert audio.output_shape == jaudio.output_shape == (8, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("video_shape,patch", [((2, 8, 8, 3), (1, 4, 4)),
                                               ((4, 8, 12, 2), (2, 4, 2))])
def test_patchify_inverts_the_video_head(video_shape, patch):
    """``patchify_video`` is the exact inverse of the head's un-patchify
    (and the JAX function, bit for bit): a patch-space prediction and its
    pixels name the same elements."""
    head = mm.VideoOutputAdapter(video_shape, patch, num_output_channels=4)
    grid = head.grid_shape
    n, p = head.output_shape[0], head.linear.kernel.shape[1]
    patches = torch.from_numpy(np.random.default_rng(4).normal(size=(2, n, p)).astype(np.float32))
    head.linear = torch.nn.Identity()  # the un-patchify alone
    pixels = head(patches)
    assert pixels.shape == (2, *video_shape)
    assert torch.equal(mm.patchify_video(pixels, grid, patch), patches)
    np.testing.assert_array_equal(
        mm.patchify_video(pixels, grid, patch).numpy(),
        np.asarray(jmm.patchify_video(jnp.asarray(pixels.numpy()), grid, patch)))
    # the voxel (0, 0, pw) opens the second patch of the grid's first row
    assert torch.equal(pixels[1, 0, 0, patch[2], :], patches[1, 1, :video_shape[-1]])


def test_output_adapter_routes_spans_and_rejects_mixed_widths():
    class Rows(torch.nn.Module):
        def __init__(self, k, c):
            super().__init__()
            self.output_shape = (k, c)

        def forward(self, x):
            return x

    adapter = mm.MultimodalOutputAdapter((("a", Rows(2, 4)), ("b", Rows(3, 4)),
                                          ("c", Rows(1, 4))))
    assert adapter.output_shape == (6, 4)
    x = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    out = adapter(x)
    assert list(out) == ["a", "b", "c"]
    assert torch.equal(out["a"], x[:, :2]) and torch.equal(out["b"], x[:, 2:5])
    assert torch.equal(out["c"], x[:, 5:])
    mixed = mm.MultimodalOutputAdapter((("a", Rows(2, 4)), ("b", Rows(3, 8))))
    with pytest.raises(ValueError, match="one query channel width.*a:4, b:8"):
        mixed.output_shape
    with pytest.raises(ValueError, match="one query channel width"):
        jmm.MultimodalOutputAdapter(adapters=(
            ("a", jmm.AudioOutputAdapter(num_samples=16, samples_per_patch=8,
                                         num_output_channels=4)),
            ("b", jmm.AudioOutputAdapter(num_samples=16, samples_per_patch=8,
                                         num_output_channels=8)))).output_shape
    with pytest.raises(ValueError, match="one query channel width"):
        PerceiverDecoder(mixed, latent_shape=(8, 512))


# -- the model ------------------------------------------------------------------------


def test_autoencoder_tree_carries_strictly():
    """Every leaf of the JAX tree lands on the port's parameter of the same
    path, under flax's names; a tree missing a leaf, or with one too many,
    is refused."""
    flat = _flat(_params())
    tree = param_tree(_port_model("xla"))
    assert sorted(tree) == sorted(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(tree[path].numpy(), leaf)
    for name, features in (("adapters_0_1", 48), ("adapters_1_1", 8), ("adapters_2_1", CLASSES)):
        assert tree[f"decoder/output_adapter/{name}/linear/kernel"].shape == (512, features)
        assert tree[f"decoder/output_adapter/{name}/linear/bias"].shape == (features,)
    assert tree["encoder/input_adapter/audio_padding"].shape == (48,)
    assert tree["encoder/input_adapter/video_modality"].shape == (8,)
    assert tree["encoder/input_adapter/audio_modality"].shape == (8,)
    assert "encoder/input_adapter/video_padding" not in tree
    assert tree["decoder/output"].shape == (8 + 8 + 1, 512)
    model = mm.build_multimodal_autoencoder(**_model_kwargs("xla"))
    short = {k: v for k, v in flat.items() if k != "encoder/input_adapter/audio_padding"}
    with pytest.raises(KeyError, match="audio_padding"):
        load_param_tree(model, short)
    with pytest.raises(KeyError, match="video_padding"):
        load_param_tree(model, {**flat, "encoder/input_adapter/video_padding": np.zeros(1)})


def test_init_params_draws_the_jax_initializers():
    """The port's own draw: every leaf of the JAX tree's shape, finite; the
    padding and modality vectors flax's ``truncated_normal(0.02)``: none
    outside ±0.04 (as none of the JAX draw's), and over 40,000 draws a
    standard deviation near the truncated normal's 0.8796 · 0.02 = 0.0176;
    the latent array's rule is another, N(0, 0.02) clamped only at ±2."""
    tree = param_tree(init_params(mm.build_multimodal_autoencoder(**_model_kwargs("xla")),
                                  torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in tree.items()} == {
        k: v.shape for k, v in _flat(_params()).items()}
    assert all(bool(torch.isfinite(v).all()) for v in tree.values())
    names = [f"encoder/input_adapter/{n}" for n in ("audio_padding", "video_modality",
                                                     "audio_modality")]
    assert max(float(tree[n].abs().max()) for n in names) <= 0.04
    assert max(float(np.abs(_flat(_params())[n]).max()) for n in names) <= 0.04
    assert float(tree["encoder/latent"].abs().max()) > 0.04
    wide = init_params(mm.MultimodalInputAdapter(
        (("video", mm.VideoInputAdapter(VIDEO, (1, 4, 4), 2)),
         ("audio", mm.AudioInputAdapter(SAMPLES, 8, 1, 3))), num_modality_channels=20000),
        torch.Generator().manual_seed(1))
    vectors = torch.cat([p.detach() for p in wide.parameters()])
    assert len(vectors) == 48 + 2 * 20000
    assert float(vectors.abs().max()) <= 0.04
    assert 0.0170 < float(vectors.std()) < 0.0182
    assert float((vectors.abs() > 0.038).float().mean()) > 0  # the tails reach the cut


@pytest.mark.parametrize("patch_loss", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_autoencoder_forward_matches_jax(impl, patch_loss):
    batch = _batch()
    jmodel = jmm.build_multimodal_autoencoder(**_model_kwargs(impl, patch_loss))
    ref = jax.jit(jmodel.apply)({"params": _params()}, _inputs(batch))
    model = _port_model(impl, patch_loss).eval()
    before = ak.counter.plain_calls
    with torch.no_grad():
        got = model(_inputs(batch, torch.from_numpy))
    # the encoder's cross (D=512), one self layer (D=64), the decoder's cross
    assert ak.counter.plain_calls - before == (3 if impl == "pallas" else 0)
    assert list(got) == ["video", "audio", "label"]
    assert got["video"].shape == ((B, 8, 48) if patch_loss else (B, *VIDEO))
    assert got["audio"].shape == (B, SAMPLES, 1) and got["label"].shape == (B, CLASSES)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0), (2.0, 0.5, 0.25)])
def test_loss_and_metrics_match_jax(weights):
    """The loss and every metric of the port's outputs against the JAX loss
    of the JAX outputs, 2e-5; with the video in patch space (the geometry
    read off the adapter) the same loss as in pixel space, 1e-6 relative."""
    batch = _batch()
    jmodel = jmm.build_multimodal_autoencoder(**_model_kwargs("xla"))
    jout = jax.jit(jmodel.apply)({"params": _params()}, _inputs(batch))
    jloss, jmetrics = jmm.multimodal_autoencoding_loss(
        jout, jax.tree.map(jnp.asarray, batch), *weights)
    target = {k: torch.from_numpy(v) for k, v in batch.items()}
    readings = []
    for patch_loss in (False, True):
        model = _port_model("xla", patch_loss)
        with torch.no_grad():
            out = model(_inputs(batch, torch.from_numpy))
        info = mm.video_patch_info(model)
        assert info == (((2, 2, 2), (1, 4, 4)) if patch_loss else None)
        loss, metrics = mm.multimodal_autoencoding_loss(out, target, *weights,
                                                        video_patch_info=info)
        assert list(metrics) == ["video_loss", "audio_loss", "label_loss", "video_psnr", "acc"]
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5, atol=2e-5)
        for name, value in metrics.items():
            np.testing.assert_allclose(float(value), float(jmetrics[name]), rtol=2e-5,
                                       atol=2e-5, err_msg=name)
        readings.append(float(loss))
        if patch_loss:
            with pytest.raises(ValueError, match="video_patch_info"):
                mm.multimodal_autoencoding_loss(out, target)
    np.testing.assert_allclose(readings[1], readings[0], rtol=1e-6)
    # the PSNR clamps the MSE at 1e-10, as the JAX one does
    zero = {"video": target["video"], "audio": target["audio"],
            "label": torch.tensor([[9.0, 0.0, 0.0]] * B)}
    _, metrics = mm.multimodal_autoencoding_loss(zero, target)
    assert float(metrics["video_psnr"]) == pytest.approx(100.0)


# -- the train step -------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(impl: str):
    batch = _batch()
    jmodel = jmm.build_multimodal_autoencoder(**_model_kwargs(impl))

    def jloss(p):
        out = jmodel.apply({"params": p}, _inputs(batch))
        return jmm.multimodal_autoencoding_loss(out, jax.tree.map(jnp.asarray, batch))[0]

    val, grads = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, _params()))
    return float(val), _flat(grads)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_step_gradients_match_jax(jax_impl):
    """The port's train step (the kernels' plain versions) against
    ``jax.value_and_grad`` of the JAX loss: 2e-5, every gradient within
    1e-4 of its leaf's peak (``k_proj.bias``, zero by symmetry, against
    the other gradients' scale); the eval step carries no graph."""
    batch = _batch()
    jval, jflat = _jax_value_and_grad(jax_impl)
    model = _port_model("pallas")
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=2)
    train_step, eval_step = make_multimodal_steps(model, schedule)
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter)
    before = [c.plain_calls for c in counters]
    _, metrics = train_step(state, batch)  # the gradients stay on the parameters
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert [c.plain_calls - n for c, n in zip(counters, before)] == [3, 3, 3]
    assert list(metrics) == ["loss", "video_loss", "audio_loss", "label_loss", "video_psnr",
                             "acc", "lr"]
    np.testing.assert_allclose(float(metrics["loss"]), jval, rtol=2e-5, atol=2e-5)
    peak_all = max(float(np.abs(g).max()) for g in jflat.values())
    assert sorted(n.replace(".", "/") for n in grads) == sorted(jflat)
    for name, got in grads.items():
        ref, got = jflat[name.replace(".", "/")], got.numpy()
        if name.endswith("k_proj.bias"):  # zero by symmetry: rounding noise on both sides
            assert max(np.abs(got).max(), np.abs(ref).max()) < 1e-5 * peak_all, name
            continue
        assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.abs(ref).max()), name
    metrics = eval_step(None, batch)
    assert metrics["loss"].grad_fn is None and "lr" not in metrics


def test_three_adam_steps_match_jax():
    """Three Adam steps (lr 1e-3) of the port's train step against the JAX
    step from the same weights: the loss and every metric within 1e-4
    relative at each step, and the same lr."""
    tx, jschedule = joptim.make_optimizer(joptim.OptimizerConfig())
    jstep, _ = jax_multimodal_steps(jmm.build_multimodal_autoencoder(**_model_kwargs("xla")),
                                    jschedule)
    jstep = jax.jit(jstep)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, _params()), tx,
                                  jax.random.key(2))
    model = _port_model("xla")
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=2)
    step, _ = make_multimodal_steps(model, schedule)
    batch = _batch()
    for _ in range(3):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        assert set(m) == set(jm)
        for name in m:
            np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    assert state.step == int(jstate.step) == 3
