"""The port's tiny PerceiverMLM against the JAX package's, weights carried
over (interop.from_jax_params): the fused forward (full decode and the
gathered decode at ``positions``) and ``decode(encode(x))`` at f32 within
2e-5; the quantized paths with the same quantized tree on both sides — f32
compute over int8 / int4 weights within 2e-5 of the peak (both are one
expression), and the int8w serving mode (bf16 compute) within the 0.05
rel-to-peak bound tests/test_quant.py holds the JAX int8w path to.

The JAX side runs both its kernels: ``attn_impl='pallas'`` and
``PIT_QMM_IMPL=pallas`` (interpret mode off the TPU). With
``attn_impl='packed'`` on both sides (the packed-heads kernels #4 and #5)
the fused forward and ``decode(encode(x))`` agree at 2e-5 too, the port's
packed and pallas models agree with each other at 2e-5, ``decoder_attn_impl``
routes only the decoder; ``'auto'`` and ``'xla'`` give the JAX model's
``'xla'`` logits at 2e-5, and ``'pallas_sp'`` and unknown names raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu import quant as jquant
from perceiver_io_tpu.models.presets import tiny_mlm as jax_tiny_mlm
from perceiver_io_torch.inference.engine import prepare_param_tree
from perceiver_io_torch.interop import from_jax_params, load_param_tree, param_tree
from perceiver_io_torch.models.presets import flagship_mlm, tiny_mlm
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import packed_attention_kernel as pk
from perceiver_io_torch.ops.attention import MultiHeadAttention

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
    """The training forward masks and decodes at capacity K: (B, K, vocab)
    logits and (B, K) labels. It rejects a call without a generator and one
    with inference ``positions``."""
    _, _, model = twins
    ids, pad, positions = (torch.from_numpy(a) for a in batch)
    logits, labels = model(ids, pad, masking=True, generator=torch.Generator().manual_seed(0),
                           loss_gather_capacity=8)
    assert logits.shape == (B, 8, 503) and labels.shape == (B, 8)
    assert labels.dtype == torch.int64 and (labels != -100).any()
    full, full_labels = model(ids, pad, masking=True, generator=torch.Generator())
    assert full.shape == (B, L, 503) and full_labels.shape == (B, L)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(ids, masking=True)
    with pytest.raises(ValueError, match="inference-path"):
        model(ids, masking=True, generator=torch.Generator(), positions=positions)


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


# -- packed-heads attention (attn_impl='packed') --------------------------------


@pytest.fixture(scope="module")
def packed_twins(twins):
    """The same weights in the JAX and port models with attn_impl='packed'."""
    _, params, _ = twins
    tree = jax.tree.map(np.asarray, params)
    model = from_jax_params(tiny_mlm(device="cpu", attn_impl="packed"), tree).eval()
    return jax_tiny_mlm(attn_impl="packed"), params, model


def test_packed_fused_forward_matches_jax(packed_twins, batch):
    jmodel, params, model = packed_twins
    ids, pad, positions = batch
    before = (pk.fwd_counter.plain_calls, ak.counter.plain_calls)
    full, _ = _port(model, ids, pad)
    # 2 encoder cross + 2 self + 1 decoder, all packed
    assert (pk.fwd_counter.plain_calls, ak.counter.plain_calls) == (before[0] + 5, before[1])
    np.testing.assert_allclose(full.numpy(), _jax(jmodel, params, ids, pad),
                               atol=2e-5, rtol=2e-5)
    gathered, _ = _port(model, ids, pad, positions=torch.from_numpy(positions))
    np.testing.assert_allclose(gathered.numpy(), _jax(jmodel, params, ids, pad, positions),
                               atol=2e-5, rtol=2e-5)


def test_packed_encode_decode_matches_jax(packed_twins, batch):
    jmodel, params, model = packed_twins
    ids, pad, positions = batch
    with torch.inference_mode():
        latents = model.encode(torch.from_numpy(ids), torch.from_numpy(pad))
        split = model.decode(latents, torch.from_numpy(positions)).numpy()
    jlat = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(pad),
                        method="encode")
    np.testing.assert_allclose(latents.numpy(), np.asarray(jlat), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(split, _jax(jmodel, params, ids, pad, positions),
                               atol=2e-5, rtol=2e-5)


def test_packed_and_pallas_models_agree(twins, packed_twins, batch):
    """One function, two kernels: the port's packed and pallas models at f32."""
    ids, pad, _ = batch
    np.testing.assert_allclose(_port(packed_twins[2], ids, pad)[0].numpy(),
                               _port(twins[2], ids, pad)[0].numpy(), atol=2e-5, rtol=2e-5)


def test_decoder_attn_impl_routes_only_the_decoder(batch):
    ids, pad, _ = batch
    model = flagship_mlm(vocab_size=503, max_seq_len=64, num_latents=16, num_channels=32,
                         num_layers=2, num_self_attention_layers_per_block=1, device="cpu",
                         attn_impl="pallas", decoder_attn_impl="packed")
    impls = {name: m.attn_impl for name, m in model.named_modules()
             if isinstance(m, MultiHeadAttention)}
    assert {n for n, i in impls.items() if i == "packed"} == {
        "decoder.cross_attention_layer.cross_attention.attention"}
    assert len(impls) == 5
    before = (pk.fwd_counter.plain_calls, ak.counter.plain_calls)
    _port(model, ids, pad)
    assert (pk.fwd_counter.plain_calls, ak.counter.plain_calls) == (before[0] + 1, before[1] + 4)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas_sp", "einsum"])
def test_unported_attn_impls_raise(twins, batch, impl):
    """``'pallas_sp'`` (the distribution slice's) and unknown names raise;
    ``'auto'`` and ``'xla'`` are ported: the model under each gives the JAX
    model's ``'xla'`` logits within 2e-5 (at the tiny shapes ``'auto'``
    resolves every call to the einsum path, as the JAX rule off the TPU)."""
    if impl in ("auto", "xla"):
        _, params, _ = twins
        ids, pad, positions = batch
        jmodel = jax_tiny_mlm(attn_impl="xla")
        model = from_jax_params(tiny_mlm(device="cpu", attn_impl=impl),
                                jax.tree.map(np.asarray, params)).eval()
        full, _ = _port(model, ids, pad)
        np.testing.assert_allclose(full.numpy(), _jax(jmodel, params, ids, pad),
                                   atol=2e-5, rtol=2e-5)
        split, _ = _port(model, ids, pad, positions=torch.from_numpy(positions))
        np.testing.assert_allclose(split.numpy(), _jax(jmodel, params, ids, pad, positions),
                                   atol=2e-5, rtol=2e-5)
        return
    match = "unknown attn_impl" if impl == "einsum" else "not ported"
    with pytest.raises(ValueError, match=match):
        tiny_mlm(device="cpu", attn_impl=impl)
    with pytest.raises(ValueError, match=match):
        MultiHeadAttention(32, 32, 4, attn_impl=impl)
