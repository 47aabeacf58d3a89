"""Each layer of the port (perceiver_io_torch/ops/attention.py, the text
adapters of models/adapters.py) against its flax twin in the JAX package,
with the flax weights carried over by path (interop.load_param_tree). The
JAX side runs its Pallas attention kernel in interpret mode
(``attn_impl='pallas'``). f32, atol = rtol = 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.models import adapters as jad
from perceiver_io_tpu.ops import attention as jat
from perceiver_io_torch.interop import load_param_tree
from perceiver_io_torch.models import adapters as pad_
from perceiver_io_torch.ops import attention as pat

TOL = dict(atol=2e-5, rtol=2e-5)
B, T, S, C, KV, H = 2, 11, 19, 32, 24, 4


def _carry(jax_module, port_module, *inputs, **kwargs):
    """Init the flax twin, load its weights into the port module, and return
    both modules' call on the same inputs (numpy in, numpy out)."""
    params = jax_module.init(jax.random.key(0), *[jnp.asarray(x) for x in inputs],
                             **kwargs)["params"]
    load_param_tree(port_module, jax.tree.map(np.asarray, params))
    ref = jax_module.apply({"params": params}, *[jnp.asarray(x) for x in inputs], **kwargs)
    with torch.inference_mode():
        got = port_module(*[torch.from_numpy(np.asarray(x)) for x in inputs])
    return got, ref


def _first(x):
    return x[0] if isinstance(x, tuple) else x


def _data(seed):
    rng = np.random.default_rng(seed)
    x_q = rng.normal(size=(B, T, C)).astype(np.float32)
    x_kv = rng.normal(size=(B, S, KV)).astype(np.float32)
    latents = rng.normal(size=(B, S, C)).astype(np.float32)
    pad = rng.random((B, S)) < 0.3
    pad[-1] = True  # a fully masked example
    return x_q, x_kv, latents, pad


CASES = {
    "layer_norm": (lambda: jat.layer_norm(jnp.float32, "ln"),
                   lambda: pat.LayerNorm(C), lambda d: (d[0],)),
    "mha_cross": (lambda: jat.MultiHeadAttention(C, KV, H, attn_impl="pallas"),
                  lambda: pat.MultiHeadAttention(C, KV, H), lambda d: (d[0], d[1], d[3])),
    "mha_self": (lambda: jat.MultiHeadAttention(C, C, H, attn_impl="pallas"),
                 lambda: pat.MultiHeadAttention(C, C, H), lambda d: (d[2], d[2])),
    "cross_attention": (lambda: jat.CrossAttention(C, KV, H, attn_impl="pallas"),
                        lambda: pat.CrossAttention(C, KV, H), lambda d: (d[0], d[1], d[3])),
    "self_attention": (lambda: jat.SelfAttention(C, H, attn_impl="pallas"),
                       lambda: pat.SelfAttention(C, H), lambda d: (d[2],)),
    "mlp": (lambda: jat.MLP(C), lambda: pat.MLP(C), lambda d: (d[0],)),
    "cross_attention_layer": (
        lambda: jat.CrossAttentionLayer(C, KV, H, attn_impl="pallas"),
        lambda: pat.CrossAttentionLayer(C, KV, H), lambda d: (d[0], d[1], d[3])),
    "self_attention_layer": (lambda: jat.SelfAttentionLayer(C, H, attn_impl="pallas"),
                             lambda: pat.SelfAttentionLayer(C, H), lambda d: (d[2],)),
    "self_attention_block": (
        lambda: jat.SelfAttentionBlock(2, C, H, attn_impl="pallas"),
        lambda: pat.SelfAttentionBlock(2, C, H), lambda d: (d[2],)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax_twin(name):
    make_jax, make_port, pick = CASES[name]
    got, ref = _carry(make_jax(), make_port(), *pick(_data(len(name))))
    np.testing.assert_allclose(_first(got).numpy(), np.asarray(ref), **TOL)


def test_kv_reuse_is_exact():
    """The shared layer's cached (k, v) reproduce the recomputed call."""
    x_q, x_kv, _, pad = (torch.from_numpy(np.asarray(a)) for a in _data(7))
    layer = pat.CrossAttentionLayer(C, KV, H)
    torch.manual_seed(0)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.2)
    with torch.inference_mode():
        out, kv = layer(x_q, x_kv, pad)
        again, kv2 = layer(x_q, x_kv, pad, kv)
    assert kv2 is kv
    torch.testing.assert_close(again, out, atol=0, rtol=0)


def test_text_input_adapter_matches_flax():
    ids = np.random.default_rng(0).integers(0, 50, (B, T)).astype(np.int32)
    got, ref = _carry(jad.TextInputAdapter(vocab_size=50, max_seq_len=16, num_channels=C),
                      pad_.TextInputAdapter(50, 16, C), ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        pad_.TextInputAdapter(50, 4, C)(torch.from_numpy(ids))


@pytest.mark.parametrize("pad_to", [None, 8])
def test_text_output_adapter_matches_flax(pad_to):
    x = np.random.default_rng(1).normal(size=(B, 5, C)).astype(np.float32)
    got, ref = _carry(jad.TextOutputAdapter(13, 5, num_output_channels=C,
                                            pad_classes_to=pad_to),
                      pad_.TextOutputAdapter(13, 5, num_output_channels=C,
                                             pad_classes_to=pad_to), x)
    assert got.shape[-1] == (16 if pad_to else 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if pad_to:
        assert (got[..., 13:] == -1e30).all()
