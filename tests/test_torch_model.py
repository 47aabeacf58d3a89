"""The port's tiny PerceiverMLM against the JAX package's, weights carried
over (interop.from_jax_params): the fused forward (full decode and the
gathered decode at ``positions``) and ``decode(encode(x))`` at f32 within
2e-5; the quantized paths with the same quantized tree on both sides — f32
compute over int8 / int4 weights within 2e-5 of the peak (both are one
expression), and the int8w serving mode (bf16 compute) within the 0.05
rel-to-peak bound tests/test_quant.py holds the JAX int8w path to.

The JAX side runs both its kernels: ``attn_impl='pallas'`` and
``PIT_QMM_IMPL=pallas`` (interpret mode off the TPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu import quant as jquant
from perceiver_io_tpu.models.presets import tiny_mlm as jax_tiny_mlm
from perceiver_io_torch.inference.engine import prepare_param_tree
from perceiver_io_torch.interop import from_jax_params, load_param_tree, param_tree
from perceiver_io_torch.models.presets import tiny_mlm

B, L = 3, 40


@pytest.fixture(scope="module")
def twins():
    jmodel = jax_tiny_mlm(attn_impl="pallas")
    ids = jnp.zeros((1, 64), jnp.int32)
    # the tree does not depend on attn_impl; init through the einsum path
    params = jax_tiny_mlm(attn_impl="xla").init({"params": jax.random.key(0), "masking": jax.random.key(1)},
                         ids, ids == 1)["params"]
    tree = jax.tree.map(np.asarray, params)
    model = from_jax_params(tiny_mlm(device="cpu"), tree).eval()
    return jmodel, params, model


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 503, (B, L)).astype(np.int32)
    pad = np.zeros((B, L), bool)
    pad[1, 30:] = True
    positions = np.array([[0, 5, 9, 3], [1, 2, 29, 29], [39, 0, 0, 0]], np.int32)
    return ids, pad, positions


def _port(model, *arrays, **kwargs):
    with torch.inference_mode():
        return model(*[torch.from_numpy(a) for a in arrays], **kwargs)


def _jax(jmodel, params, ids, pad, positions=None):
    logits, _ = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(pad),
                             masking=False,
                             positions=None if positions is None else jnp.asarray(positions))
    return np.asarray(logits, np.float32)


def test_weights_carry_one_to_one(twins):
    _, params, model = twins
    flat = param_tree(model)
    jflat = {"/".join(str(k.key) for k in p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(flat) == set(jflat)
    for name, value in flat.items():
        np.testing.assert_array_equal(value.numpy(), jflat[name])


def test_fused_forward_matches_jax(twins, batch):
    jmodel, params, model = twins
    ids, pad, positions = batch
    full, _ = _port(model, ids, pad)
    np.testing.assert_allclose(full.numpy(), _jax(jmodel, params, ids, pad),
                               atol=2e-5, rtol=2e-5)
    gathered, _ = model(torch.from_numpy(ids), torch.from_numpy(pad),
                        positions=torch.from_numpy(positions))
    np.testing.assert_allclose(gathered.detach().numpy(),
                               _jax(jmodel, params, ids, pad, positions),
                               atol=2e-5, rtol=2e-5)


def test_encode_decode_matches_jax(twins, batch):
    jmodel, params, model = twins
    ids, pad, positions = batch
    with torch.inference_mode():
        latents = model.encode(torch.from_numpy(ids), torch.from_numpy(pad))
        split = model.decode(latents, torch.from_numpy(positions)).numpy()
    jlat = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(pad),
                        method="encode")
    np.testing.assert_allclose(latents.numpy(), np.asarray(jlat), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(split, _jax(jmodel, params, ids, pad, positions),
                               atol=2e-5, rtol=2e-5)


def test_rejects_training_masking(twins, batch):
    _, _, model = twins
    with pytest.raises(ValueError, match="training path"):
        model(torch.from_numpy(batch[0]), masking=True)


@pytest.mark.parametrize("mode,bits,bound", [
    ("float32", 8, 2e-5), ("float32", 4, 2e-5), ("bfloat16", 8, 0.05)])
def test_quantized_forward_matches_jax(twins, batch, monkeypatch, mode, bits, bound):
    monkeypatch.setenv("PIT_QMM_IMPL", "pallas")
    jmodel, params, _ = twins
    ids, pad, positions = batch
    jdtype = jnp.bfloat16 if mode == "bfloat16" else jnp.float32
    qp = jquant.quantize_tree(params, compute_dtype=mode, bits=bits)
    jmodel_dt = jax_tiny_mlm(attn_impl="pallas", dtype=jdtype)
    ref = np.asarray(jmodel_dt.apply(
        {"params": jquant.apply_operands(qp)}, jnp.asarray(ids), jnp.asarray(pad),
        masking=False, positions=jnp.asarray(positions))[0], np.float32)

    dtype = torch.bfloat16 if mode == "bfloat16" else torch.float32
    model = tiny_mlm(device="cpu", dtype=dtype)
    flat = {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tree = prepare_param_tree(flat, mode, "int8" if bits == 8 else "int4")
    load_param_tree(model, tree)
    got, _ = _port(model, ids, pad, positions=torch.from_numpy(positions))
    peak = float(np.abs(ref).max())
    assert float(np.abs(got.float().numpy() - ref).max()) <= bound * peak
