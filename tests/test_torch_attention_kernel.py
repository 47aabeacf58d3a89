"""The port's attention kernel module (perceiver_io_torch/ops/attention_kernel.py)
against the JAX package's fused attention: the plain version of the CUDA
kernel, which the wrapper runs on CPU tensors, must compute what the Pallas
kernel (interpret mode) and the einsum path compute — masked, unmasked, with
a fully masked row, at T and S that are not multiples of the kernel's
64-row tiles. f32, atol = rtol = 2e-5 (the golden bar).

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against this plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.ops.attention import _dot_product_attention
from perceiver_io_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from perceiver_io_torch.ops import attention_kernel as ak

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

