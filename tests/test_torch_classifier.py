"""The port's classification slice against the JAX package, on the CPU (the
kernels' plain versions; the JAX side runs its Pallas kernels in interpret
mode), f32, weights carried from the JAX tree:

- the Fourier encodings (``ops/fourier.py``) and ``ImageInputAdapter``,
  1e-6 (bit for bit in practice: the same numpy f32 arithmetic); a wrong
  image shape raises as in JAX;
- ``ClassificationOutputAdapter``'s ``pad_classes_to`` masking at 2 and 10
  classes;
- the text and image ``PerceiverIO`` forward against the JAX model, every
  ``attn_impl`` on the port's side, 2e-5;
- ``classification_loss_and_accuracy``;
- the classifier train step against ``jax.value_and_grad`` of the JAX
  step's loss, JAX ``'xla'`` and ``'pallas'`` (interpret mode): loss 2e-5,
  every gradient 1e-4 of its leaf's peak (``k_proj.bias``, zero by symmetry,
  against the other gradients' scale); with ``frozen_encoder`` the decoder's
  gradients are the same and the encoder records no graph (#1 only: no
  statistics, no #2/#3);
- three AdamW updates with weight decay and ``grad_clip_norm``, the
  encoder frozen (``optim.freeze_subtrees``) and not, from identical
  gradients, against the JAX ``freeze_subtrees`` transformation (1e-6 of
  the weights' peak) and torch's rule in float64 (1e-6 of each leaf's
  peak), the frozen leaves bit for bit as loaded (a clip norm over the
  frozen leaves too, or their decay, would miss); three frozen-encoder
  steps of the port's ``train_step`` against the JAX step, losses 1e-5.

The MNIST data and the image CLI: tests/test_torch_mnist.py; the sequence
CLI, transfer and the reference ``.ckpt`` import: tests/test_torch_seq_clf_cli.py.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import common as jcommon
from perceiver_io_tpu.models.adapters import ClassificationOutputAdapter as JaxClassAdapter
from perceiver_io_tpu.models.adapters import ImageInputAdapter as JaxImageAdapter
from perceiver_io_tpu.ops import fourier as jfourier
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import losses as jlosses
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training.steps import freeze_subtrees as jax_freeze_subtrees
from perceiver_io_tpu.training.steps import make_classifier_steps as jax_classifier_steps
from perceiver_io_torch.cli import common
from perceiver_io_torch.interop import from_jax_params, load_param_tree
from perceiver_io_torch.models.adapters import ClassificationOutputAdapter, ImageInputAdapter
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import fourier
from perceiver_io_torch.training import optim
from perceiver_io_torch.training.losses import classification_loss_and_accuracy
from perceiver_io_torch.training.steps import make_classifier_steps
from perceiver_io_torch.training.train_state import TrainState

B, IMAGE, BANDS, VOCAB, L = 8, (14, 14, 1), 4, 97, 24


def _args(attn_impl: str = "xla", **kw) -> argparse.Namespace:
    """The flags both packages' builders read: 2 layers × (cross + 1 self),
    8 latents × 32 channels (4 heads of depth 8), f32."""
    base = dict(dtype="float32", num_latents=8, num_latent_channels=32, num_encoder_layers=2,
                num_self_attention_layers_per_block=1, num_cross_attention_heads=4,
                num_self_attention_heads=4, dropout=0.0, attn_impl=attn_impl, remat=False,
                no_reuse_kv=False, pad_vocab_multiple=None, seed=0)
    return argparse.Namespace(**{**base, **kw})


def _batch(kind: str):
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 10 if kind == "image" else 2, B).astype(np.int32)
    if kind == "image":
        return {"image": rng.uniform(-1, 1, (B, *IMAGE)).astype(np.float32), "label": labels}
    ids = rng.integers(3, VOCAB, (B, L)).astype(np.int32)
    pad = np.arange(L)[None, :] >= rng.integers(4, L + 1, (B, 1))
    pad[-1, 1:] = True  # one example of a single token
    ids[pad] = 0
    return {"token_ids": ids, "pad_mask": pad, "label": labels}


def _jax_model(kind: str, impl: str):
    if kind == "image":
        return jcommon.build_image_classifier(_args(impl), IMAGE, 10, num_frequency_bands=BANDS)
    return jcommon.build_text_classifier(_args(impl), VOCAB, L)


def _port_model(kind: str, impl: str = "xla", **kw):
    args = _args(impl, **kw)
    if kind == "image":
        return common.build_image_classifier(args, IMAGE, 10, "cpu", num_frequency_bands=BANDS)
    return common.build_text_classifier(args, VOCAB, L, "cpu")


def _jax_inputs(kind: str, batch):
    if kind == "image":
        return (jnp.asarray(batch["image"]),), {}
    return (jnp.asarray(batch["token_ids"]),), {"pad_mask": jnp.asarray(batch["pad_mask"])}


@functools.lru_cache(maxsize=None)
def _params(kind: str):
    """The JAX classifier's initial weights (numpy leaves)."""
    args, kwargs = _jax_inputs(kind, _batch(kind))
    params = jax.jit(_jax_model(kind, "xla").init)({"params": jax.random.key(1)}, *args,
                                                   **kwargs)["params"]
    return jax.tree.map(np.asarray, params)


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_inputs(batch):
    if "image" in batch:
        return torch.from_numpy(batch["image"]), None
    return torch.from_numpy(batch["token_ids"]), torch.from_numpy(batch["pad_mask"])


# -- the Fourier encodings and the image adapter --------------------------------------


@pytest.mark.parametrize("shape,bands,max_freq,positions", [
    ((28, 28), 32, None, True), ((14, 14), 4, None, True), ((7,), 3, None, True),
    ((6, 10), 5, (12, 4), False), ((4, 3, 5), 2, None, True)])
def test_fourier_encodings_match_jax(shape, bands, max_freq, positions):
    p = fourier.spatial_positions(shape)
    np.testing.assert_array_equal(p, jfourier.spatial_positions(shape))
    got = fourier.fourier_position_encodings(p, bands, max_freq, positions)
    ref = jfourier.fourier_position_encodings(p, bands, max_freq, positions)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.shape[-1] == fourier.num_position_encoding_channels(len(shape), bands,
                                                                   positions)
    with pytest.raises(ValueError, match="one max frequency"):
        fourier.fourier_position_encodings(p, bands, (3,) * (len(shape) + 1))


@pytest.mark.parametrize("image_shape,bands", [((28, 28, 1), 32), ((14, 14, 1), 4),
                                               ((6, 8, 3), 2)])
def test_image_adapter_matches_jax(image_shape, bands):
    x = np.random.default_rng(2).uniform(-1, 1, (3, *image_shape)).astype(np.float32)
    adapter = ImageInputAdapter(image_shape, bands)
    jadapter = JaxImageAdapter(image_shape=image_shape, num_frequency_bands=bands)
    ref = np.asarray(jadapter.apply({}, jnp.asarray(x)))
    got = adapter(torch.from_numpy(x)).numpy()
    assert adapter.num_input_channels == jadapter.num_input_channels == ref.shape[-1]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # MNIST: each pixel and 2·(2·32 + 1) Fourier channels
    assert ImageInputAdapter().num_input_channels == 131
    assert not list(adapter.parameters()) and not adapter.state_dict()  # a constant buffer
    with pytest.raises(ValueError, match="different from required shape"):
        adapter(torch.zeros(3, image_shape[1], image_shape[0] + 1, image_shape[2]))


@pytest.mark.parametrize("num_classes,pad_to", [(2, None), (2, 8), (10, None), (10, 16)])
def test_class_adapter_padding_matches_jax(num_classes, pad_to):
    x = np.random.default_rng(4).normal(size=(5, 1, 12)).astype(np.float32)
    jadapter = JaxClassAdapter(num_classes=num_classes, num_output_channels=12,
                               pad_classes_to=pad_to)
    params = jadapter.init(jax.random.key(0), jnp.asarray(x))
    ref = np.asarray(jadapter.apply(params, jnp.asarray(x)))
    adapter = load_param_tree(ClassificationOutputAdapter(num_classes, num_output_channels=12,
                                                          pad_classes_to=pad_to),
                              jax.tree.map(np.asarray, params["params"]))
    got = adapter(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (5, adapter.padded_num_classes)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if pad_to:
        assert (got[:, num_classes:] == -1e30).all()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# -- the model ------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "pallas", "auto"])
@pytest.mark.parametrize("kind", ["image", "text"])
def test_perceiver_io_forward_matches_jax(kind, impl):
    batch = _batch(kind)
    args, kwargs = _jax_inputs(kind, batch)
    ref = np.asarray(jax.jit(_jax_model(kind, "xla").apply)({"params": _params(kind)}, *args,
                                                            **kwargs))
    model = from_jax_params(_port_model(kind, impl), _params(kind)).eval()
    x, pad = _port_inputs(batch)
    with torch.no_grad():
        got = model(x, pad).numpy()
        halves = model.decode(model.encode(x, pad)).numpy()
    assert got.shape == ref.shape == (B, 10 if kind == "image" else 2)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(halves, got)


def test_classification_loss_and_accuracy_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(32, 10)).astype(np.float32)
    logits[3, [1, 4]] = 9.0  # a tie: both packages take the first class
    labels = rng.integers(0, 10, 32).astype(np.int32)
    labels[3] = 1
    loss, acc = classification_loss_and_accuracy(torch.from_numpy(logits),
                                                 torch.from_numpy(labels))
    jloss, jacc = jlosses.classification_loss_and_accuracy(jnp.asarray(logits),
                                                          jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(acc) == float(jacc) and loss.dtype == acc.dtype == torch.float32


# -- the train step -------------------------------------------------------------------


def _port_state(kind: str, frozen: bool, config: optim.OptimizerConfig, impl: str = "xla"):
    model = from_jax_params(_port_model(kind, impl), _params(kind))
    params = optim.freeze_subtrees(model, ["encoder"]) if frozen else model.parameters()
    optimizer, schedule = optim.make_optimizer(config, params)
    return model, TrainState.create(model, optimizer, schedule, seed=2), schedule


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(kind: str, impl: str):
    """(loss, acc, flat gradients) of the JAX make_classifier_steps loss at
    the initial weights, on ``_batch(kind)``."""
    batch = _batch(kind)
    jmodel = _jax_model(kind, impl)
    args, kwargs = _jax_inputs(kind, batch)

    def jloss(p):
        logits = jmodel.apply({"params": p}, *args, **kwargs)
        return jlosses.classification_loss_and_accuracy(logits, jnp.asarray(batch["label"]))

    (val, acc), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, _params(kind)))
    return float(val), float(acc), _flat(grads)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["image", "text"])
def test_classifier_step_loss_and_gradients_match_jax(kind, jax_impl, frozen):
    batch = _batch(kind)
    jval, jacc, jflat = _jax_value_and_grad(kind, jax_impl)
    model, state, _ = _port_state(kind, frozen, optim.OptimizerConfig(), "pallas")
    train_step, eval_step = make_classifier_steps(model, input_kind=kind,
                                                  frozen_encoder=frozen)
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter)
    before = [c.plain_calls for c in counters]
    _, metrics = train_step(state, batch)
    calls = [c.plain_calls - n for c, n in zip(counters, before)]
    np.testing.assert_allclose(float(metrics["loss"]), float(jval), rtol=2e-5, atol=2e-5)
    assert float(metrics["acc"]) == float(jacc) and set(metrics) == {"loss", "acc"}
    # 2 layers × (cross + 1 self) and the decoder's cross; a frozen encoder
    # runs its 4 calls forward only, without statistics or a backward
    assert calls == ([5, 1, 1] if frozen else [5, 5, 5])
    peak_all = max(float(np.abs(g).max()) for g in jflat.values())
    for name, p in model.named_parameters():
        if frozen and name.startswith("encoder."):
            assert p.grad is None and not p.requires_grad, name
            continue
        ref, got = jflat[name.replace(".", "/")], p.grad.numpy()
        if name.endswith("k_proj.bias"):
            assert max(np.abs(got).max(), np.abs(ref).max()) < 1e-5 * peak_all, name
            continue
        assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.abs(ref).max()), name
    metrics = eval_step(state, batch, None)
    assert set(metrics) == {"loss", "acc"} and metrics["loss"].grad_fn is None


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(kind: str):
    """The jitted gradient of the JAX loss on ``_batch(kind)``'s inputs, as a
    function of (params, labels)."""
    jmodel = _jax_model(kind, "xla")
    args, kwargs = _jax_inputs(kind, _batch(kind))
    return jax.jit(jax.grad(lambda p, labels: jlosses.classification_loss_and_accuracy(
        jmodel.apply({"params": p}, *args, **kwargs), labels)[0]))


@pytest.mark.parametrize("frozen", [False, True])
def test_adamw_clipped_updates_match_freeze_subtrees(frozen):
    """Three AdamW updates (lr 3e-3, weight decay 0.1, the global norm
    clipped to 0.05, which every step's gradients exceed) of the port's
    optimizer over ``freeze_subtrees``' trainable parameters, from identical
    gradients (the JAX step's, at the JAX weights: Adam turns gradient
    rounding noise into weight differences above the bar):

    - against the JAX transformation under ``freeze_subtrees``: within 1e-6
      of the weights' peak (XLA's f32 Adam on the CPU sits ~7e-6 of a leaf's
      peak from the float64 update on the zero-initialized biases, ROADMAP
      trap);
    - against torch's AdamW rule in float64 with the norm taken over the
      trainable leaves: within 1e-6 of each leaf's peak;
    - the frozen leaves bit for bit as loaded.

    A norm over the frozen leaves too changes every update from the second
    on (Adam mixes steps clipped by other factors), and their decay changes
    them at once."""
    kind, batch = "text", _batch("text")
    lr, wd, clip = 3e-3, 0.1, 0.05
    config = dict(optimizer="AdamW", learning_rate=lr, weight_decay=wd, grad_clip_norm=clip)
    tx, _ = joptim.make_optimizer(joptim.OptimizerConfig(**config))
    jparams = jax.tree.map(jnp.asarray, _params(kind))
    if frozen:
        tx = jax_freeze_subtrees(tx, jparams, ["encoder"])
    jstate = JaxTrainState.create(jparams, tx, jax.random.key(2))
    apply = jax.jit(lambda state, grads: state.apply_gradients(grads))
    jgrad = _jax_grad_fn(kind)
    model, state, _ = _port_state(kind, frozen, optim.OptimizerConfig(**config))
    loaded = {k: v.detach().clone() for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters() if not (frozen and n.startswith("encoder."))]
    ref = {n: loaded[n].double() for n in names}
    m = {n: torch.zeros_like(ref[n]) for n in names}
    v = {n: torch.zeros_like(ref[n]) for n in names}
    rng = np.random.default_rng(9)
    for t in range(1, 4):
        labels = jnp.asarray(rng.integers(0, 2, B).astype(np.int32))
        jg = jgrad(jstate.params, labels)
        grads = _flat(jg)
        jstate = apply(jstate, jg)
        state.optimizer.zero_grad(set_to_none=True)
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[name.replace(".", "/")].copy())
        state.apply_gradients()
        g64 = {n: torch.tensor(grads[n.replace(".", "/")], dtype=torch.float64) for n in names}
        norm = float(torch.stack([x.norm() for x in g64.values()]).norm())
        assert norm > clip  # the clip acts at every step
        for n in names:  # torch's AdamW, float64
            g = g64[n] * (clip / norm)
            m[n] = 0.9 * m[n] + 0.1 * g
            v[n] = 0.999 * v[n] + 0.001 * g * g
            ref[n] = ref[n] * (1 - lr * wd) - lr * (m[n] / (1 - 0.9 ** t)) / (
                (v[n] / (1 - 0.999 ** t)).sqrt() + 1e-8)
        jflat = _flat(jstate.params)
        peak = max(float(np.abs(x).max()) for x in jflat.values())
        for name, p in model.named_parameters():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, jflat[name.replace(".", "/")], rtol=0,
                                       atol=1e-6 * peak, err_msg=name)
            if name in ref:
                want = ref[name].numpy()
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), name
    for name, value in model.state_dict().items():
        assert torch.equal(value, loaded[name]) == (frozen and name.startswith("encoder.")), name


def test_three_classifier_steps_match_jax():
    """Three AdamW steps with clipping of the port's frozen-encoder
    ``train_step`` against the JAX step under ``freeze_subtrees``, each on
    its own weights: losses within 1e-5 relative."""
    config = dict(optimizer="AdamW", learning_rate=3e-3, weight_decay=0.1, grad_clip_norm=0.05)
    tx, jschedule = joptim.make_optimizer(joptim.OptimizerConfig(**config))
    jparams = jax.tree.map(jnp.asarray, _params("image"))
    tx = jax_freeze_subtrees(tx, jparams, ["encoder"])
    jstep, _ = jax_classifier_steps(_jax_model("image", "xla"), jschedule, "image",
                                    frozen_encoder=True)
    jstep = jax.jit(jstep)
    jstate = JaxTrainState.create(jparams, tx, jax.random.key(2))
    model, state, schedule = _port_state("image", True, optim.OptimizerConfig(**config))
    step, _ = make_classifier_steps(model, schedule, "image", frozen_encoder=True)
    batch = _batch("image")
    for _ in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert np.float32(m["lr"]) == np.float32(jm["lr"])
    assert state.step == int(jstate.step) == 3


def test_frozen_steps_need_the_encoder_frozen_first():
    model = _port_model("image")
    with pytest.raises(ValueError, match="freeze_subtrees"):
        make_classifier_steps(model, input_kind="image", frozen_encoder=True)
    with pytest.raises(ValueError, match="input_kind"):
        make_classifier_steps(model, input_kind="audio")
    trainable = optim.freeze_subtrees(model, ["encoder"])
    assert trainable == list(model.decoder.parameters())
    with pytest.raises(ValueError, match="freeze_subtrees"):  # selected, not yet out
        make_classifier_steps(model, input_kind="image", frozen_encoder=True)
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), trainable)
    TrainState.create(model, optimizer, schedule, seed=0)
    assert not any(p.requires_grad for p in model.encoder.parameters())
    assert all(p.requires_grad for p in model.decoder.parameters())
    make_classifier_steps(model, input_kind="image", frozen_encoder=True)
