"""The port's ImageNet classifier and its train step against the JAX
package at a tiny depth with ImageNet's D = 1024 cross head, on the CPU
(the kernels' plain versions; the JAX side runs its Pallas kernels in
interpret mode), f32, weights carried from the JAX tree:

- the models both ``train_imagenet`` CLIs build from the same flags (8 × 8
  × 3 images, 4 bands, 4 latents × 1024 channels: the encoder's and the
  decoder's crosses one head of depth 1024; 2 encoder layers × 1 self layer
  of 8 heads of depth 128), the forward under ``'xla'`` and ``'pallas'``,
  2e-5;
- ``make_classifier_steps``: the loss 2e-5 and every gradient within 1e-4
  of its leaf's peak against ``jax.value_and_grad`` of the JAX loss (JAX
  ``'xla'`` and ``'pallas'``), 5 #1 / #2 / #3 calls a step under
  ``'pallas'`` (2 crosses, 2 self layers, the decoder), each cross at D =
  1024;
- three steps of the CLI's AdamW (4e-3, weight decay 0.1) against the JAX
  step, losses within 1e-4 relative.

The data: tests/test_torch_imagefolder.py; the CLI:
tests/test_torch_imagenet_cli.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import common as jcommon
from perceiver_io_tpu.cli import train_imagenet as jax_train_imagenet
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import losses as jlosses
from perceiver_io_tpu.training.steps import make_classifier_steps as jax_classifier_steps
from perceiver_io_torch.cli import common, train_imagenet
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.training.steps import make_classifier_steps
from perceiver_io_torch.training.train_state import TrainState

B, SIZE, CLASSES = 3, 8, 10
FLAGS = ["--image_size", str(SIZE), "--num_frequency_bands", "4", "--num_latents", "4",
         "--num_encoder_layers", "2", "--num_self_attention_layers_per_block", "1",
         "--dtype", "float32"]


def _args(module, impl: str):
    return module.build_parser().parse_args(FLAGS + ["--attn_impl", impl])


def _jax_model(impl: str):
    args = _args(jax_train_imagenet, impl)
    return jcommon.build_image_classifier(args, (SIZE, SIZE, 3), CLASSES,
                                          num_frequency_bands=args.num_frequency_bands)


def _port_model(impl: str):
    return from_jax_params(train_imagenet.build_model(_args(train_imagenet, impl), CLASSES,
                                                      "cpu"), _params())


def _batch(seed: int = 5):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, B).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX classifier's initial weights (numpy leaves)."""
    params = jax.jit(_jax_model("xla").init)({"params": jax.random.key(1)},
                                             jnp.asarray(_batch()["image"]))["params"]
    return jax.tree.map(np.asarray, params)


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_the_crosses_have_one_head_of_depth_1024():
    model = train_imagenet.build_model(_args(train_imagenet, "pallas"), CLASSES, "cpu")
    assert not model.encoder.remat  # image_size 8: under the CLI's remat line
    heads = {(m.num_heads, m.q_proj.kernel.shape[1] // m.num_heads)
             for name, m in model.named_modules() if name.endswith("cross_attention.attention")}
    assert heads == {(1, 1024)}
    assert model.encoder.input_adapter.num_input_channels == 3 + 2 * (2 * 4 + 1)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_imagenet_forward_matches_jax(impl):
    image = _batch()["image"]
    ref = np.asarray(jax.jit(_jax_model("xla").apply)({"params": _params()}, jnp.asarray(image)))
    model = _port_model(impl).eval()
    before = ak.counter.plain_calls
    with torch.no_grad():
        got = model(torch.from_numpy(image)).numpy()
    assert ak.counter.plain_calls - before == (5 if impl == "pallas" else 0)
    assert got.shape == ref.shape == (B, CLASSES)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(impl: str):
    batch = _batch()
    jmodel = _jax_model(impl)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(batch["image"]))
        return jlosses.classification_loss_and_accuracy(logits, jnp.asarray(batch["label"]))

    (val, acc), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, _params()))
    return float(val), float(acc), _flat(grads)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_imagenet_step_loss_and_gradients_match_jax(impl, jax_impl):
    jval, jacc, jflat = _jax_value_and_grad(jax_impl)
    model = _port_model(impl)
    args = _args(train_imagenet, impl)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=2)
    train_step, _ = make_classifier_steps(model, schedule, input_kind="image")
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter)
    before = [c.plain_calls for c in counters]
    _, metrics = train_step(state, _batch())
    assert [c.plain_calls - n for c, n in zip(counters, before)] == [5 * (impl == "pallas")] * 3
    np.testing.assert_allclose(float(metrics["loss"]), jval, rtol=2e-5, atol=2e-5)
    assert float(metrics["acc"]) == jacc
    peak_all = max(float(np.abs(g).max()) for g in jflat.values())
    for name, p in model.named_parameters():
        ref, got = jflat[name.replace(".", "/")], p.grad.numpy()
        if name.endswith("k_proj.bias"):  # zero by symmetry: noise on both sides
            assert max(np.abs(got).max(), np.abs(ref).max()) < 1e-5 * peak_all, name
            continue
        assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.abs(ref).max()), name


def test_three_adamw_steps_match_jax():
    """The CLI's AdamW (4e-3, weight decay 0.1) on both packages' steps,
    each on its own weights, three batches: losses within 1e-4 relative."""
    jargs = _args(jax_train_imagenet, "xla")
    tx, jschedule = jcommon.optimizer_from_args(jargs)
    jstep, _ = jax_classifier_steps(_jax_model("xla"), jschedule, "image")
    jstep = jax.jit(jstep)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, _params()), tx, jax.random.key(2))
    model = _port_model("pallas")
    args = _args(train_imagenet, "pallas")
    assert (args.optimizer, args.learning_rate, args.weight_decay) == ("AdamW", 4e-3, 0.1)
    optimizer, schedule = common.optimizer_from_args(args, model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=2)
    step, _ = make_classifier_steps(model, schedule, "image")
    losses = []
    for seed in range(3):
        batch = _batch(seed)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        losses.append(float(m["loss"]))
    assert state.step == int(jstate.step) == 3 and len(set(losses)) == 3
