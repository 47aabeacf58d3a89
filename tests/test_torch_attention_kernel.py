"""The port's attention kernel module (perceiver_io_torch/ops/attention_kernel.py)
against the JAX package's fused attention: the plain versions of the CUDA
kernels, which the wrappers run on CPU tensors, must compute what the Pallas
kernels (interpret mode) and the einsum path compute — masked, unmasked, with
a fully masked row, at T and S that are not multiples of the kernels'
64-row tiles. The forward, its (m, l) statistics and the backward (dq, dk,
dv) at f32, atol = rtol = 2e-5 (the golden bar); autograd through
``fused_attention`` against ``jax.grad`` at 1e-5.

The causal offset (the Perceiver-AR path's forward): the plain version
against the Pallas forward with ``causal_offset`` (interpret mode) at
offsets 0 and > 0, a one-row decode step, S not a multiple of 8, and rows
whose visible keys are all padding (they average the keys masked exactly
once), f32 at 1e-5; a causal call under autograd gives ``jax.grad``'s
gradients (tests/test_torch_ar_training.py holds the causal backward in
full).

The deep heads (D = 256 and 512, the optical-flow crosses' one head of
depth 512): the plain forward, its statistics and the plain backward
against the Pallas forward with_lse and the Pallas backward (interpret
mode) with padding, a fully masked example and a causal offset whose first
rows see only padding, f32 at 2e-5.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.ops.attention import _dot_product_attention
from perceiver_io_tpu.ops.masking import causal_mask as jax_causal_mask
from perceiver_io_tpu.ops.pallas_attention import (
    _fused_attention_bwd_impl,
    _fused_attention_fwd_impl,
)
from perceiver_io_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops.masking import causal_mask

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, t, s, h, d, mask):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pad = None
    if mask != "none":
        pad = rng.random((b, s)) < 0.3
        pad[:, 0] = False
        if mask == "full_row":
            pad[-1] = True  # one example with every key masked out
    return q, k, v, pad


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("mask", ["none", "pad", "full_row"])
@pytest.mark.parametrize("t,s,d", [(16, 24, 8), (70, 131, 16), (5, 200, 32)])
def test_plain_attention_matches_jax(mask, t, s, d):
    q, k, v, pad = _inputs(t + s + d, 2, t, s, 2, d, mask)
    got = ak.fused_attention(*_torch(q, k, v, pad)).numpy()
    kernel = np.asarray(jax_fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if pad is None else jnp.asarray(pad), interpret=True))
    einsum = np.asarray(_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if pad is None else jnp.asarray(pad), None, 0.0, None, True))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, einsum, **TOL)


def test_fully_masked_row_is_mean_of_values():
    q, k, v, pad = _inputs(0, 2, 9, 77, 2, 16, "full_row")
    got = ak.fused_attention(*_torch(q, k, v, pad)).numpy()
    assert np.isfinite(got).all()
    mean_v = v[-1].mean(axis=0)  # (H, D): uniform over all S keys
    np.testing.assert_allclose(got[-1], np.broadcast_to(mean_v, got[-1].shape), **TOL)


def test_bf16_rounds_probabilities_like_the_tpu_kernel():
    """bf16 inputs: f32 logits and softmax, probabilities rounded to bf16
    before P.V — within bf16 resolution of the JAX kernel."""
    q, k, v, pad = _inputs(1, 2, 33, 65, 2, 32, "pad")
    tq, tk, tv, tpad = _torch(q, k, v, pad)
    got = ak.fused_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), tpad)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jax_fused_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(pad), interpret=True), np.float32)
    peak = float(np.abs(ref).max())
    assert float(np.abs(got.float().numpy() - ref).max()) <= 2e-2 * peak


def test_wrapper_counts_plain_calls_and_validates():
    q, k, v, pad = _torch(*_inputs(2, 1, 4, 6, 2, 8, "pad"))
    before = (ak.counter.launches, ak.counter.plain_calls)
    out = ak.fused_attention(q, k, v, pad)
    assert out.shape == q.shape and out.is_contiguous()
    assert (ak.counter.launches, ak.counter.plain_calls) == (before[0], before[1] + 1)
    with pytest.raises(ValueError, match="do not match"):
        ak.fused_attention(q, k[:, :, :1], v, pad)
    with pytest.raises(ValueError, match="pad_mask shape"):
        ak.fused_attention(q, k, v, pad[:, :3])
    with pytest.raises(ValueError, match="mixed dtypes"):
        ak.fused_attention(q.double(), k, v, pad)


def test_pad_bias_is_the_tpu_kernels_bias():
    pad = torch.tensor([[False, True, False], [True, True, True]])
    bias = ak.pad_bias(pad, 2, 3, "cpu")
    assert bias.dtype == torch.float32
    np.testing.assert_array_equal(bias.numpy(), np.where(pad.numpy(), -1e30, 0.0).astype(np.float32))
    assert not ak.pad_bias(None, 2, 3, "cpu").any()



# -- forward statistics and the backward --------------------------------------


def _bhtd(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))


@pytest.mark.parametrize("mask", ["none", "pad", "full_row"])
@pytest.mark.parametrize("t,s,d,t_blk,s_blk", [(16, 24, 8, 8, 8), (70, 131, 16, 70, 131),
                                               (5, 200, 32, 5, 40)])
def test_plain_statistics_and_backward_match_jax(mask, t, s, d, t_blk, s_blk):
    """m, l and (dq, dk, dv) of the plain versions against the Pallas
    forward with_lse and the Pallas backward (interpret mode), each side
    from its own residuals; on a fully masked example dq and dk are exactly
    zero, as the TPU kernel's where-masking gives."""
    q, k, v, pad = _inputs(t * s + d, 2, t, s, 2, d, mask)
    g = np.random.default_rng(t + s).normal(size=q.shape).astype(np.float32)
    bias = jnp.zeros((2, s), jnp.float32) if pad is None else jnp.where(
        jnp.asarray(pad), ak.MASK_VALUE, 0.0).astype(jnp.float32)
    jq, jk, jv, jg = (_bhtd(x) for x in (q, k, v, g))
    jout, jm, jl = _fused_attention_fwd_impl(jq, jk, jv, bias, t_blk, s_blk, True,
                                             with_lse=True)
    jdq, jdk, jdv = _fused_attention_bwd_impl(jq, jk, jv, bias, jout, jm, jl, jg,
                                              t_blk, s_blk, True)
    tq, tk, tv, tpad, tg = _torch(q, k, v, pad, g)
    out, m, l = ak.attention_fwd_with_stats(tq, tk, tv, tpad)
    np.testing.assert_allclose(out.numpy(), np.asarray(_bhtd(jout)), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[..., 0], **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[..., 0], **TOL)
    grads = ak.attention_bwd(tq, tk, tv, tpad, out, m, l, tg)
    for got, ref in zip(grads, (jdq, jdk, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(_bhtd(ref)), **TOL)
    if mask == "full_row":
        assert not grads[0][-1].any() and not grads[1][-1].any()
        assert not np.asarray(jdq)[-1].any() and grads[2][-1].abs().max() > 0


@pytest.mark.parametrize("mask", ["pad", "full_row"])
def test_autograd_matches_jax_grad(mask):
    """torch.autograd through fused_attention (the plain versions on the
    CPU) against jax.grad through the Pallas fused_attention, interpret
    mode, at 1e-5."""
    q, k, v, pad = _inputs(5, 2, 33, 65, 2, 16, mask)
    w = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)

    def jloss(jq, jk, jv):
        out = jax_fused_attention(jq, jk, jv, jnp.asarray(pad), interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [x.requires_grad_(True) for x in _torch(q, k, v)]
    before = (ak.dq_counter.plain_calls, ak.dkv_counter.plain_calls)
    (ak.fused_attention(*leaves, torch.from_numpy(pad)) * torch.from_numpy(w)).sum().backward()
    assert (ak.dq_counter.plain_calls, ak.dkv_counter.plain_calls) == (before[0] + 1,
                                                                       before[1] + 1)
    for leaf, ref in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_fused_attention_gradcheck_f64():
    """FusedAttention's backward (the plain versions, f64 on the CPU)
    against finite differences, with padding and a fully masked example."""
    q, k, v, pad = _inputs(7, 2, 9, 13, 2, 8, "full_row")
    leaves = [torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v)]
    tpad = torch.from_numpy(pad)
    # fast mode: the Jacobian checked along random directions, not in full
    for fn in (ak.fused_attention, ak.plain_attention):
        assert torch.autograd.gradcheck(lambda *x: fn(*x, tpad), leaves, fast_mode=True)


def test_serving_calls_skip_the_statistics_and_the_backward():
    """No autograd recording: one forward call, no statistics saved, no
    backward counted."""
    q, k, v, pad = _torch(*_inputs(3, 1, 4, 6, 2, 8, "pad"))
    before = (ak.counter.plain_calls, ak.dq_counter.plain_calls)
    with torch.no_grad():
        out = ak.fused_attention(q.requires_grad_(True), k, v, pad)
    assert out.grad_fn is None
    assert (ak.counter.plain_calls, ak.dq_counter.plain_calls) == (before[0] + 1, before[1])


# -- the causal offset ----------------------------------------------------------


CAUSAL_CASES = {  # name: (b, t, s, d, offset, mask)
    "window_cross": (2, 5, 16, 8, 11, "pad"),
    "square_self": (2, 16, 16, 8, 0, "pad"),
    "decode_step": (2, 1, 19, 8, 18, "pad"),
    "ragged_s": (2, 7, 13, 16, 6, "none"),
    "visible_all_padding": (3, 12, 20, 8, 8, "head_padded"),
}


def _causal_inputs(name):
    b, t, s, d, off, mask = CAUSAL_CASES[name]
    q, k, v, pad = _inputs(t * s + off, b, t, s, 2, d, "none" if mask == "none" else "pad")
    if mask == "head_padded":
        # the last example's first 12 keys padded: rows 0..3 (offset 8) see
        # only padding, so they average the keys masked exactly once (their
        # visible padded keys and the unpadded future ones)
        pad[-1, :12] = True
        pad[-1, 12:] = False
    return q, k, v, pad, off


@pytest.mark.parametrize("name", sorted(CAUSAL_CASES))
def test_plain_causal_attention_matches_jax(name):
    """The plain forward with ``causal_offset`` (and its statistics) against
    the Pallas forward with the in-kernel causal bias, interpret mode."""
    q, k, v, pad, off = _causal_inputs(name)
    b, t, s = q.shape[0], q.shape[1], k.shape[1]
    tq, tk, tv, tpad = _torch(q, k, v, pad)
    got = ak.fused_attention(tq, tk, tv, tpad, causal_offset=off).numpy()
    jpad = None if pad is None else jnp.asarray(pad)
    ref = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jpad, interpret=True, causal_offset=off))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    bias = jnp.zeros((b, s), jnp.float32) if pad is None else jnp.where(
        jpad, ak.MASK_VALUE, 0.0).astype(jnp.float32)
    _, jm, jl = _fused_attention_fwd_impl(*(_bhtd(x) for x in (q, k, v)), bias, t, s, True,
                                          with_lse=True, causal_offset=off)
    out, m, l = ak.attention_fwd_with_stats(tq, tk, tv, tpad, causal_offset=off)
    np.testing.assert_allclose(out.numpy(), got, atol=0, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[..., 0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[..., 0], atol=1e-5, rtol=1e-5)


def test_rows_whose_visible_keys_are_all_padding():
    """Such a row averages v over the keys masked exactly once: its visible
    padded keys and its unpadded future keys (each scores -1e30); keys both
    padded and in the future score -2e30 and drop out. Skipping the key
    tiles past the diagonal would change exactly these rows."""
    q, k, v, pad, off = _causal_inputs("visible_all_padding")
    got = ak.fused_attention(*_torch(q, k, v, pad), causal_offset=off).numpy()
    future = causal_mask(q.shape[1], k.shape[1], off).numpy()
    for i in range(4):  # rows 0..3 of the last example see keys 0..i+8, all padded
        once = pad[-1] ^ future[i]
        assert pad[-1][: i + off + 1].all()
        assert once.sum() == k.shape[1] - (3 - i)  # keys i+9..11 are masked twice
        np.testing.assert_allclose(got[-1, i], v[-1][once].mean(axis=0), atol=1e-5, rtol=1e-5)


def test_causal_mask_matches_jax():
    for t, s, off in ((4, 6, 2), (5, 5, 0), (1, 9, 8)):
        np.testing.assert_array_equal(causal_mask(t, s, off).numpy(),
                                      np.asarray(jax_causal_mask(t, s, off)))
    bias = ak.causal_bias(3, 5, 1, "cpu")
    assert bias.dtype == torch.float32
    np.testing.assert_array_equal(bias.numpy() == ak.MASK_VALUE, causal_mask(3, 5, 1).numpy())


def test_causal_call_under_autograd_raises():
    """A causal call under autograd, which raised before the backward
    kernels took the causal offset: ``fused_attention`` and
    ``plain_attention`` give the gradients of ``jax.grad`` through the
    Pallas ``fused_attention`` with the same offset (interpret mode), 1e-5,
    ``fused_attention`` counting one causal dq and dk/dv call; under no_grad
    the call runs the forward alone."""
    q, k, v, pad, off = _causal_inputs("window_cross")
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)

    def jloss(jq, jk, jv):
        out = jax_fused_attention(jq, jk, jv, jnp.asarray(pad), interpret=True,
                                  causal_offset=off)
        return jnp.sum(out * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tpad = torch.from_numpy(pad)
    for fn in (ak.fused_attention, ak.plain_attention):
        leaves = [x.requires_grad_(True) for x in _torch(q, k, v)]
        before = (ak.dq_causal_counter.plain_calls, ak.dkv_causal_counter.plain_calls)
        (fn(*leaves, tpad, causal_offset=off) * torch.from_numpy(w)).sum().backward()
        calls = int(fn is ak.fused_attention)
        assert (ak.dq_causal_counter.plain_calls, ak.dkv_causal_counter.plain_calls) == (
            before[0] + calls, before[1] + calls)
        for leaf, ref in zip(leaves, jgrads):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        before = (ak.counter.plain_calls, ak.causal_counter.plain_calls)
        out = ak.fused_attention(*leaves, tpad, causal_offset=off)
        ak.fused_attention(*leaves, tpad)
    assert out.grad_fn is None
    assert (ak.counter.plain_calls, ak.causal_counter.plain_calls) == (before[0] + 2,
                                                                       before[1] + 1)


# name: (b, t, s, h, d, mask, causal offset, t_blk, s_blk)
DEEP_CASES = {
    "d256_full_row": (2, 21, 70, 2, 256, "full_row", None, 21, 70),
    "d512_full_row": (2, 9, 40, 1, 512, "full_row", None, 9, 8),
    "d256_causal": (3, 12, 20, 1, 256, "head_padded", 8, 12, 20),
    "d512_causal": (3, 12, 20, 1, 512, "head_padded", 8, 4, 20),
    "d1024_full_row": (2, 9, 40, 1, 1024, "full_row", None, 9, 8),
    "d1024_causal": (3, 12, 20, 1, 1024, "head_padded", 8, 4, 20),
}


@pytest.mark.parametrize("name", sorted(DEEP_CASES))
def test_deep_heads_plain_forward_and_backward_match_jax(name):
    """At D = 256, 512 and 1024: out, m, l and (dq, dk, dv) of the plain versions
    against the Pallas forward with_lse and backward (interpret mode, with
    blocks smaller than T or S where they divide), each side from its own
    residuals; a fully masked example gets dq = dk = 0 exactly, and causal
    rows that see only padding average the keys masked exactly once."""
    b, t, s, h, d, mask, off, t_blk, s_blk = DEEP_CASES[name]
    q, k, v, pad = _inputs(t * s + d, b, t, s, h, d, "full_row" if mask == "full_row" else "pad")
    if mask == "head_padded":  # rows 0..3 of the last example see only padding
        pad[-1, :12] = True
        pad[-1, 12:] = False
    g = np.random.default_rng(d + t).normal(size=q.shape).astype(np.float32)
    bias = jnp.where(jnp.asarray(pad), ak.MASK_VALUE, 0.0).astype(jnp.float32)
    jq, jk, jv, jg = (_bhtd(x) for x in (q, k, v, g))
    jout, jm, jl = _fused_attention_fwd_impl(jq, jk, jv, bias, t_blk, s_blk, True,
                                             with_lse=True, causal_offset=off)
    jgrads = _fused_attention_bwd_impl(jq, jk, jv, bias, jout, jm, jl, jg, t_blk, s_blk, True,
                                       causal_offset=off)
    tq, tk, tv, tpad, tg = _torch(q, k, v, pad, g)
    out, m, l = ak.attention_fwd_with_stats(tq, tk, tv, tpad, causal_offset=off)
    np.testing.assert_allclose(out.numpy(), np.asarray(_bhtd(jout)), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[..., 0], **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[..., 0], **TOL)
    grads = ak.attention_bwd(tq, tk, tv, tpad, out, m, l, tg, causal_offset=off)
    for got, ref in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(_bhtd(ref)), **TOL)
    if mask == "full_row":
        assert not grads[0][-1].any() and not grads[1][-1].any()
    else:
        future = causal_mask(t, s, off).numpy()
        for i in range(4):
            once = pad[-1] ^ future[i]
            np.testing.assert_allclose(out[-1, i].numpy(), v[-1][once].mean(axis=0), **TOL)

