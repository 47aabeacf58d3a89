"""The port's optical-flow model (``perceiver_io_torch/models/flow.py``) and
its train step against the JAX package, on the CPU (the kernels' plain
versions; the JAX side runs its Pallas kernels in interpret mode), f32,
weights carried from the JAX tree:

- ``extract_patches`` (its channel order, and its refusal of an even patch)
  and both adapters, 1e-6; a wrong frame shape raises as in JAX;
- the flow model at image 8 × 8 × 1, latents (16, 512) with one
  cross-attention head of depth 512 and one self-attention layer of 2
  heads (depth 256): the port's ``'xla'`` against the JAX ``'xla'``, and
  the port's ``'pallas'`` (the kernels' plain versions) against the JAX
  ``'pallas'`` (interpret mode), 2e-5; the flow tree carries by path;
- ``make_flow_steps``: the loss (2e-5) and every gradient (1e-4 of its
  leaf's peak; ``k_proj.bias``, zero by symmetry, against the other
  gradients' scale) against ``jax.value_and_grad`` of the JAX step's loss,
  both JAX routes, 3 #1 / #2 / #3 calls a step; the eval step;
- ``end_point_error`` against the JAX function, and its gradient where a
  pixel's error is exactly 0 (0 here, NaN in JAX: ROADMAP's trap).

The data: tests/test_torch_flow_data.py; the CLI: tests/test_torch_flow_cli.py.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.models import flow as jflow
from perceiver_io_tpu.training.steps import make_flow_steps as jax_flow_steps
from perceiver_io_torch.interop import from_jax_params, param_tree
from perceiver_io_torch.models import flow
from perceiver_io_torch.models.perceiver import init_params
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.training import optim
from perceiver_io_torch.training.steps import make_flow_steps
from perceiver_io_torch.training.train_state import TrainState

B, IMAGE, LATENTS, BANDS = 3, (8, 8, 1), (16, 512), 3


def _model_kwargs(impl: str) -> dict:
    return dict(image_shape=IMAGE, latent_shape=LATENTS, num_layers=1,
                num_self_attention_layers_per_block=1, num_cross_attention_heads=1,
                num_self_attention_heads=2, patch_size=3, num_frequency_bands=BANDS,
                attn_impl=impl)


def _batch():
    rng = np.random.default_rng(7)
    return {"frames": rng.uniform(-1, 1, (B, 2, *IMAGE)).astype(np.float32),
            "flow": rng.normal(0, 2, (B, *IMAGE[:2], 2)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX flow model's initial weights (numpy leaves)."""
    model = jflow.build_optical_flow_model(**_model_kwargs("xla"))
    params = jax.jit(model.init)({"params": jax.random.key(3)},
                                 jnp.asarray(_batch()["frames"][:1]))["params"]
    return jax.tree.map(np.asarray, params)


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_model(impl: str):
    return from_jax_params(flow.build_optical_flow_model(**_model_kwargs(impl)), _params())


# -- patches and adapters -------------------------------------------------------------


@pytest.mark.parametrize("shape,patch", [((2, 5, 7, 3), 3), ((3, 2, 6, 4, 2), 5),
                                         ((4, 4, 1), 1)])
def test_extract_patches_matches_jax(shape, patch):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = flow.extract_patches(torch.from_numpy(x), patch).numpy()
    ref = np.asarray(jflow.extract_patches(jnp.asarray(x), patch))
    assert got.shape == ref.shape == (*shape[:-1], patch * patch * shape[-1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="must be odd"):
        flow.extract_patches(torch.from_numpy(x), patch + 1)
    with pytest.raises(ValueError, match="must be odd"):
        jflow.extract_patches(jnp.asarray(x), patch + 1)


@pytest.mark.parametrize("image_shape,patch,bands", [((5, 7, 2), 3, 3), ((8, 8, 1), 3, 4),
                                                     ((6, 4, 3), 1, 2)])
def test_flow_input_adapter_matches_jax(image_shape, patch, bands):
    x = np.random.default_rng(2).uniform(-1, 1, (3, 2, *image_shape)).astype(np.float32)
    adapter = flow.OpticalFlowInputAdapter(image_shape, patch, bands)
    jadapter = jflow.OpticalFlowInputAdapter(image_shape=image_shape, patch_size=patch,
                                             num_frequency_bands=bands)
    ref = np.asarray(jadapter.apply({}, jnp.asarray(x)))
    got = adapter(torch.from_numpy(x)).numpy()
    assert adapter.num_input_channels == jadapter.num_input_channels == ref.shape[-1]
    assert got.shape == (3, image_shape[0] * image_shape[1], ref.shape[-1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert not list(adapter.parameters()) and not adapter.state_dict()  # a constant buffer
    # the paper's frame: 2·3²·3 patch channels and 2·(2·64 + 1) Fourier ones
    assert flow.OpticalFlowInputAdapter((3, 5, 3), 3, 64).num_input_channels == 54 + 258
    with pytest.raises(ValueError, match="required"):
        adapter(torch.zeros(3, 1, *image_shape))


def test_dense_output_adapter_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 20, 12)).astype(np.float32)
    jadapter = jflow.DenseSpatialOutputAdapter(spatial_shape=(4, 5), num_output_channels=12)
    params = jax.tree.map(np.asarray, jadapter.init(jax.random.key(0), jnp.asarray(x)))
    ref = np.asarray(jadapter.apply(params, jnp.asarray(x)))
    adapter = from_jax_params(flow.DenseSpatialOutputAdapter((4, 5), num_output_channels=12),
                              params["params"])
    got = adapter(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, 4, 5, 2)
    assert adapter.output_shape == jadapter.output_shape == (20, 12)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# -- the model ------------------------------------------------------------------------


def test_flow_tree_carries_by_path():
    """Every leaf of the JAX flow tree lands on the port's parameter of the
    same path, the adapter's ``linear`` and the decoder's (H·W, C) query
    array among them; a model of other widths refuses the tree."""
    flat = _flat(_params())
    model = _port_model("xla")
    tree = param_tree(model)
    assert sorted(tree) == sorted(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(tree[path].numpy(), leaf)
    assert tree["decoder/output"].shape == (64, 512)
    assert tree["decoder/output_adapter/linear/kernel"].shape == (512, 2)
    assert tree["encoder/latent"].shape == LATENTS
    other = flow.build_optical_flow_model(**{**_model_kwargs("xla"), "image_shape": (8, 6, 1)})
    with pytest.raises(ValueError, match="decoder.output"):
        from_jax_params(other, _params())
    # the port's own draw: every leaf finite and of the JAX tree's shapes
    mine = param_tree(init_params(flow.build_optical_flow_model(**_model_kwargs("xla")),
                                  torch.Generator().manual_seed(0)))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in flat.items()}
    assert all(bool(torch.isfinite(v).all()) for v in mine.values())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_flow_forward_matches_jax(impl):
    frames = _batch()["frames"]
    jmodel = jflow.build_optical_flow_model(**_model_kwargs(impl))
    ref = np.asarray(jax.jit(jmodel.apply)({"params": _params()}, jnp.asarray(frames)))
    model = _port_model(impl).eval()
    before = ak.counter.plain_calls
    with torch.no_grad():
        got = model(torch.from_numpy(frames)).numpy()
    # the encoder's cross (D=512), one self layer (D=256), the decoder's cross
    assert ak.counter.plain_calls - before == (3 if impl == "pallas" else 0)
    assert got.shape == ref.shape == (B, *IMAGE[:2], 2)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_end_point_error_matches_jax_where_finite():
    rng = np.random.default_rng(4)
    pred = rng.normal(size=(2, 4, 5, 2)).astype(np.float32)
    target = rng.normal(size=(2, 4, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        float(flow.end_point_error(torch.from_numpy(pred), torch.from_numpy(target))),
        float(jflow.end_point_error(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)
    target[0, 1, 2] = pred[0, 1, 2]  # one pixel predicted exactly
    jgrad = np.asarray(jax.grad(jflow.end_point_error)(jnp.asarray(pred), jnp.asarray(target)))
    tp = torch.from_numpy(pred).requires_grad_(True)
    flow.end_point_error(tp, torch.from_numpy(target)).backward()
    got = tp.grad.numpy()
    assert np.isnan(jgrad[0, 1, 2]).all() and (got[0, 1, 2] == 0).all()
    finite = np.isfinite(jgrad)
    assert finite.sum() == jgrad.size - 2
    np.testing.assert_allclose(got[finite], jgrad[finite], rtol=1e-6, atol=1e-7)


# -- the train step -------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(impl: str):
    batch = _batch()
    jmodel = jflow.build_optical_flow_model(**_model_kwargs(impl))

    def jloss(p):
        pred = jmodel.apply({"params": p}, jnp.asarray(batch["frames"]))
        return jflow.end_point_error(pred, jnp.asarray(batch["flow"]))

    val, grads = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, _params()))
    return float(val), _flat(grads)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_flow_step_loss_and_gradients_match_jax(jax_impl):
    """The port's train step (the kernels' plain versions) against
    ``jax.value_and_grad`` of the JAX step's loss: 2e-5, every gradient
    within 1e-4 of its leaf's peak; the eval step's loss carries no graph,
    and the JAX package's own eval step gives the same loss."""
    batch = _batch()
    jval, jflat = _jax_value_and_grad(jax_impl)
    model = _port_model("pallas")
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=2)
    train_step, eval_step = make_flow_steps(model, schedule)
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter)
    before = [c.plain_calls for c in counters]
    _, metrics = train_step(state, batch)  # the gradients stay on the parameters
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert [c.plain_calls - n for c, n in zip(counters, before)] == [3, 3, 3]
    assert set(metrics) == {"loss", "lr"}
    np.testing.assert_allclose(float(metrics["loss"]), jval, rtol=2e-5, atol=2e-5)
    peak_all = max(float(np.abs(g).max()) for g in jflat.values())
    for name, got in grads.items():
        ref, got = jflat[name.replace(".", "/")], got.numpy()
        if name.endswith("k_proj.bias"):  # zero by symmetry: rounding noise on both sides
            assert max(np.abs(got).max(), np.abs(ref).max()) < 1e-5 * peak_all, name
            continue
        assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.abs(ref).max()), name
    _, jeval = jax_flow_steps(jflow.build_optical_flow_model(**_model_kwargs(jax_impl)))
    jstate = SimpleNamespace(params=jax.tree.map(jnp.asarray, _params()))
    _, port_eval = make_flow_steps(_port_model("pallas"))
    metrics = port_eval(None, batch)
    assert set(metrics) == {"loss"} and metrics["loss"].grad_fn is None
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jeval(jstate, jax.tree.map(jnp.asarray, batch))["loss"]),
                               rtol=2e-5, atol=2e-5)
