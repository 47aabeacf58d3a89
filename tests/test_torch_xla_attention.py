"""The port's einsum attention (``attn_impl='xla'``), its ``'auto'``
dispatch and ``combine_attention_masks`` against the JAX package's, on the
CPU, from the same numpy-seeded inputs:

- ``dot_product_attention`` against the JAX ``_dot_product_attention``:
  f32 within 2e-5 of the peak, bf16 within 1e-2 of the peak, under no mask,
  a pad mask, a 2-D and a 3-D ``attn_mask``, the causal mask at an offset,
  and rows whose keys are all masked (both average every key: the einsum
  path writes ``finfo.min`` by ``where``, so a doubly masked key stays in);
- probability dropout with the JAX package's own keep mask (drawn with
  ``jax.random.bernoulli`` as the JAX function draws it) fed in: f32
  within 1e-6;
- ``combine_attention_masks``: equal;
- ``auto_attention_impl``: a routing table (head depths the kernel
  refuses never route to it; D=256 turns as the shallower heads do, D=512
  at ``AUTO_DEEP_MIN_LOGITS``) and, through
  ``MultiHeadAttention``, every causal call on the einsum path;
- ``MultiHeadAttention`` under ``'auto'`` and ``'xla'`` against the JAX
  module's (the stacked self-attention projection, a pad mask, an
  ``attn_mask``, a causal offset; dropout active): 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops import attention as jat
from perceiver_io_tpu.ops import masking as jmasking
from perceiver_io_torch.interop import load_param_tree
from perceiver_io_torch.ops import attention as pat
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import masking as pmasking

B, T, S, H, D = 3, 12, 20, 4, 8


def _inputs(seed, dtype=np.float32, t=T, s=S):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, n, H, D)).astype(np.float32) for n in (t, s, s))
    pad = rng.random((B, s)) < 0.3
    attn2 = rng.random((t, s)) < 0.2
    attn3 = rng.random((B, t, s)) < 0.2
    return q, k, v, pad, attn2, attn3


def _masks(case, pad, attn2, attn3, t=T, s=S):
    """(pad_mask, attn_mask) of a case."""
    if case == "none":
        return None, None
    if case == "pad":
        return pad, None
    if case == "attn2d":
        return pad, attn2
    if case == "attn3d":
        return None, attn3
    if case == "causal":
        return pad, np.asarray(jmasking.causal_mask(t, s, s - t))
    # all_masked: example 0 all padding; example 1's first row masked by
    # attn_mask at every key, and its padded keys masked twice
    pad = pad.copy()
    pad[0] = True
    attn3 = attn3.copy()
    attn3[1, 0] = True
    return pad, attn3


def _jax(q, k, v, pad, attn, dtype, rate=0.0, rng=None):
    cast = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    opt = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    return np.asarray(jat._dot_product_attention(
        cast(q), cast(k), cast(v), opt(pad), opt(attn), rate, rng, rng is None),
        np.float32)


def _port(q, k, v, pad, attn, dtype, rate=0.0, keep=None):
    cast = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    opt = lambda x: None if x is None else torch.from_numpy(np.asarray(x))  # noqa: E731
    return pat.dot_product_attention(cast(q), cast(k), cast(v), opt(pad), opt(attn), rate,
                                     opt(keep)).float().numpy()


@pytest.mark.parametrize("case", ["none", "pad", "attn2d", "attn3d", "causal", "all_masked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_product_attention_matches_jax(case, dtype):
    q, k, v, pad, attn2, attn3 = _inputs(0)
    pad_mask, attn_mask = _masks(case, pad, attn2, attn3)
    ref = _jax(q, k, v, pad_mask, attn_mask, getattr(jnp, dtype))
    got = _port(q, k, v, pad_mask, attn_mask, getattr(torch, dtype))
    assert got.shape == (B, T, H, D) and np.isfinite(got).all()
    tol = (2e-5 if dtype == "float32" else 1e-2) * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    if case == "all_masked" and dtype == "float32":
        # every key, masked once or twice, gets the same weight
        mean_v = v.mean(axis=1)
        np.testing.assert_allclose(got[0], np.broadcast_to(mean_v[0], got[0].shape),
                                   atol=2e-6, rtol=0)
        np.testing.assert_allclose(got[1, 0], mean_v[1], atol=2e-6, rtol=0)


def test_dropout_with_the_jax_keep_mask_matches_jax():
    """The JAX function's own draw (``bernoulli(rng, 1 - rate, probs.shape)``)
    fed to the port as its keep mask."""
    q, k, v, pad, attn2, _ = _inputs(1)
    rate, rng = 0.3, jax.random.key(7)
    keep = np.asarray(jax.random.bernoulli(rng, 1.0 - rate, (B, H, T, S)))
    assert 0.55 < keep.mean() < 0.85
    ref = _jax(q, k, v, pad, attn2, jnp.float32, rate, rng)
    got = _port(q, k, v, pad, attn2, torch.float32, rate, keep)
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)
    # the same without dropout differs: the mask took effect
    assert np.abs(_port(q, k, v, pad, attn2, torch.float32) - ref).max() > 1e-3


@pytest.mark.parametrize("case", ["none", "pad", "attn2d", "attn3d", "pad_queries"])
def test_combine_attention_masks_matches_jax(case):
    _, _, _, pad, attn2, attn3 = _inputs(2)
    pad_mask, attn_mask, nq = {"none": (None, None, None), "pad": (pad, None, None),
                               "attn2d": (pad, attn2, None), "attn3d": (None, attn3, None),
                               "pad_queries": (pad, None, T)}[case]
    ref = jmasking.combine_attention_masks(
        None if pad_mask is None else jnp.asarray(pad_mask),
        None if attn_mask is None else jnp.asarray(attn_mask), nq)
    got = pmasking.combine_attention_masks(
        None if pad_mask is None else torch.from_numpy(pad_mask),
        None if attn_mask is None else torch.from_numpy(attn_mask), nq)
    if ref is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# (B, T, S, H, D) -> the route, from phase 24's H100 sweep (PERF.md §6)
SWEEP_ROUTES = {
    (8, 256, 512, 4, 16): "pallas",        # mlm-cross
    (8, 256, 256, 4, 16): "pallas",        # mlm-self
    (2, 512, 50176, 1, 1024): "xla",       # in-cross: D > 512, the JAX rule's line
    (2, 512, 50176, 8, 128): "pallas",     # in-8h
    (1, 2048, 182528, 1, 512): "xla",      # flow-cross: 3.7e8 logits, einsum 12.3 vs 56.5
    (2, 2048, 2048, 8, 64): "pallas",      # flow-self
    (2, 182528, 2048, 1, 512): "xla",      # flow-dec-cross: 7.5e8, einsum 21.9 vs 90.9
    (16, 512, 512, 8, 128): "pallas",      # in-self-b16
    (2, 256, 32768, 4, 16): "xla",         # mlm-32k: 16 blocks
    (1, 256, 131072, 4, 16): "xla",        # mlm-131k: 8 blocks
    (64, 256, 512, 4, 16): "pallas",       # the C=64 encoder cross at batch 64
    (64, 160, 256, 4, 16): "pallas",       # its gathered decoder
    (64, 256, 512, 4, 128): "pallas",      # the C=512 encoder cross
    (64, 64, 512, 4, 16): "pallas",        # the reference preset: cross,
    (64, 64, 64, 4, 16): "pallas",         # self,
    (64, 160, 64, 4, 16): "pallas",        # decoder
    (64, 8, 256, 4, 128): "pallas",        # a serving decoder
    (2, 256, 512, 4, 16): "xla",           # mlm-cross-b2: 16 blocks
    (8, 64, 64, 4, 16): "pallas",          # tiny-self-b8: 32 blocks
    (8, 256, 256, 4, 8): "pallas",         # d8-self
    (2, 50176, 50176, 8, 256): "pallas",   # the deep designs: D=256 by the rule of
                                           # the shallower heads, D=512 where the
    (64, 4096, 4096, 8, 512): "pallas",    # logits reach AUTO_DEEP_MIN_LOGITS
    (8, 2048, 182528, 1, 512): "pallas",   # train_flow's crosses at its batch of 8:
    (8, 182528, 2048, 1, 512): "pallas",   # 3.0e9 logits, no room for the einsum path
    (4, 2048, 182528, 1, 512): "xla",      # at batch 4, 1.5e9: its step fits at 63.3 GB
    (4, 182528, 2048, 1, 512): "xla",
    (1, 182528, 2048, 1, 512): "xla",
    (2, 1024, 16384, 2, 256): "pallas",    # d256-cross: kernel 1.57 vs einsum 2.08
    (8, 1024, 1024, 4, 256): "pallas",     # d256-self-b8: kernel 0.56 vs 1.10
    (3, 16, 64, 4, 8): "xla",              # the tiny presets: 12 blocks
    (8, 1, 32768, 4, 128): "pallas",       # 32 blocks of one row over a long stream
    (1, 1, 32768, 4, 128): "xla",          # 4 blocks
}


@pytest.mark.parametrize("dims", sorted(SWEEP_ROUTES))
def test_auto_attention_impl_routing_table(dims):
    """The H100 rule on phase 24's shapes and around its thresholds; head
    depths the kernel refuses never route to it."""
    want = SWEEP_ROUTES[dims]
    assert pat.auto_attention_impl(*dims) == want
    if want == "pallas":
        assert dims[-1] in ak.SUPPORTED_HEAD_DIMS


# ImageNet's calls (T, S, H, D) at train_imagenet's defaults: the encoder and
# decoder crosses, one head of depth 1024
IMAGENET_CROSSES = ((512, 50176, 1, 1024), (1, 512, 1, 1024))


@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("call", IMAGENET_CROSSES)
def test_auto_attention_impl_routes_imagenet_crosses_as_jax(b, call):
    """The D = 1024 crosses at batch 1, 8 and the CLI's 64 route as the JAX
    rule routes them on a TPU (d > 512: the einsum path), though the
    kernels take D = 1024."""
    assert 1024 in ak.SUPPORTED_HEAD_DIMS
    want = jat.auto_attention_impl(b, *call, backend="tpu")
    assert pat.auto_attention_impl(b, *call) == want == "xla"


def test_auto_attention_impl_thresholds():
    """Each threshold is where the route turns."""
    area, kv, blocks = (pat.AUTO_PALLAS_MIN_LOGITS, pat.AUTO_PALLAS_MIN_KV,
                        pat.AUTO_PALLAS_MIN_BLOCKS)
    dmin = pat.AUTO_PALLAS_AREA_MIN_HEAD_DIM
    rows = pat.AUTO_KERNEL_ROWS
    t = blocks * rows                      # one head, one example: the block floor exactly
    s = -(-area // t)
    assert pat.auto_attention_impl(1, t, s, 1, dmin) == "pallas"
    assert pat.auto_attention_impl(1, t, s - 1, 1, dmin) == ("pallas" if s - 1 >= kv else "xla")
    assert pat.auto_attention_impl(1, t - rows, 2 * s, 1, dmin) == "xla"  # one block short
    assert pat.auto_attention_impl(1, t, kv, 1, 8) == "pallas"           # long KV, any D
    assert pat.auto_attention_impl(1, t, s, 1, dmin // 2) == "xla"       # D under the floor
    deep = pat.AUTO_DEEP_MIN_LOGITS        # D=512: the logits' floor alone
    for d in pat.AUTO_EINSUM_HEAD_DIMS:
        assert pat.auto_attention_impl(64, 4096, 65536, 8, d) == "pallas"
        assert pat.auto_attention_impl(1, t, deep // t, 1, d) == "pallas"
        assert pat.auto_attention_impl(1, t, deep // t - 1, 1, d) == "xla"  # long KV, too few
    # D=256 turns where the shallower heads do
    assert pat.auto_attention_impl(1, t, s, 1, 256) == "pallas"
    assert pat.auto_attention_impl(1, t, kv - 1, 1, 256) == ("pallas" if t * (kv - 1) >= area
                                                             else "xla")
    assert pat.auto_attention_impl(1, t - rows, 2 * s, 1, 256) == "xla"  # one block short
    for d in (1024, 24):  # past the JAX rule's D line; no kernel takes D=24
        assert pat.auto_attention_impl(64, 4096, 65536, 8, d) == "xla"


def _mha_pair(attn_impl, self_attention, dropout=0.0):
    jm = jat.MultiHeadAttention(32, 32 if self_attention else 24, H, dropout=dropout,
                                attn_impl="xla")
    pm = pat.MultiHeadAttention(32, 32 if self_attention else 24, H, attn_impl=attn_impl,
                                dropout=dropout)
    return jm, pm


@pytest.mark.parametrize("attn_impl", ["auto", "xla"])
@pytest.mark.parametrize("case", ["self", "cross_pad", "cross_attn_mask", "causal"])
def test_multi_head_attention_matches_jax(attn_impl, case):
    rng = np.random.default_rng(3)
    x_q = rng.normal(size=(B, T, 32)).astype(np.float32)
    x_kv = rng.normal(size=(B, S, 24)).astype(np.float32)
    pad = rng.random((B, S)) < 0.3
    attn = rng.random((B, T, S)) < 0.2
    self_attention = case == "self"
    jm, pm = _mha_pair(attn_impl, self_attention)
    jq = jnp.asarray(x_q)
    jkv = jq if self_attention else jnp.asarray(x_kv)
    kwargs = {"cross_pad": dict(pad_mask=pad), "cross_attn_mask": dict(pad_mask=pad,
                                                                     attn_mask=attn),
              "causal": dict(pad_mask=pad, causal_offset=S - T), "self": {}}[case]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}
    params = jm.init(jax.random.key(0), jq, jkv, **jkw)["params"]
    ref = np.asarray(jm.apply({"params": params}, jq, jkv, **jkw))
    load_param_tree(pm, jax.tree.map(np.asarray, params))
    tq = torch.from_numpy(x_q)
    tkv = tq if self_attention else torch.from_numpy(x_kv)
    pkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kwargs.items()}
    before = (pat.xla_counter.calls, ak.counter.plain_calls)
    with torch.inference_mode():
        got, _ = pm(tq, tkv, **pkw)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
    # these shapes are under every 'auto' threshold, an attn_mask forces
    # the einsum path, and 'auto' keeps causal calls there
    assert (pat.xla_counter.calls - before[0], ak.counter.plain_calls - before[1]) == (1, 0)


def test_dropout_routes_a_pallas_call_to_the_einsum_path():
    """Active probability dropout takes ``'pallas'`` to the einsum path, as
    the JAX rule does (``fusable``); deterministic calls keep the kernel."""
    _, pm = _mha_pair("pallas", True, dropout=0.1)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(B, T, 32)).astype(np.float32))
    for deterministic, key, counts in ((True, None, (0, 1)), (False, 5, (1, 0))):
        before = (pat.xla_counter.calls, ak.counter.plain_calls)
        with torch.inference_mode():
            pm(x, x, deterministic=deterministic, dropout_key=key)
        assert (pat.xla_counter.calls - before[0],
                ak.counter.plain_calls - before[1]) == counts
    with pytest.raises(ValueError, match="needs a dropout_key"):
        pm(x, x, deterministic=False)


def test_multi_head_attention_dropout_matches_jax_with_its_mask():
    """``'xla'`` with dropout active: the port with the JAX module's keep
    mask (its ``'dropout'`` rng drawn as flax draws it) equals the JAX
    module's output within 2e-5."""
    rng = np.random.default_rng(5)
    x_q = rng.normal(size=(B, T, 32)).astype(np.float32)
    x_kv = rng.normal(size=(B, S, 24)).astype(np.float32)
    jm, pm = _mha_pair("xla", False, dropout=0.2)
    params = jm.init(jax.random.key(0), jnp.asarray(x_q), jnp.asarray(x_kv))["params"]
    key = jax.random.key(11)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x_q), jnp.asarray(x_kv),
                              deterministic=False, rngs={"dropout": key}))
    # flax's make_rng("dropout") inside the module: fold the module path in
    jkeep, orig = {}, jax.random.bernoulli

    def spy(rng_, p, shape):
        jkeep["mask"] = np.asarray(orig(rng_, p, shape))
        return jnp.asarray(jkeep["mask"])

    jat.jax.random.bernoulli = spy
    try:
        again = np.asarray(jm.apply({"params": params}, jnp.asarray(x_q), jnp.asarray(x_kv),
                                    deterministic=False, rngs={"dropout": key}))
    finally:
        jat.jax.random.bernoulli = orig
    np.testing.assert_array_equal(again, ref)
    load_param_tree(pm, jax.tree.map(np.asarray, params))
    keep = torch.from_numpy(jkeep["mask"])
    pm_keep = pat.drop.keep_mask
    pat.drop.keep_mask = lambda key_, rate, shape, device: keep  # noqa: E731
    try:
        with torch.inference_mode():
            got, _ = pm(torch.from_numpy(x_q), torch.from_numpy(x_kv), deterministic=False,
                        dropout_key=1)
    finally:
        pat.drop.keep_mask = pm_keep
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
