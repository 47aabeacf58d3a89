"""The port's packed-heads attention (perceiver_io_torch/ops/packed_attention_kernel.py)
against the JAX package's ``packed_latent_attention`` (the Pallas kernels #4
and #5 in interpret mode, through ``jax.vjp`` with a random cotangent): the
plain versions of the CUDA kernels, which the wrappers run on CPU tensors,
must compute what the Pallas kernels compute, rounding where they round.

- out, dq, dk, dv within 2e-5 of each peak in f32 and within 1e-3 in bf16,
  at (B, T, S, H, D) = (3, 16, 24, 4, 8), (2, 20, 37, 2, 16), (2, 32, 64,
  4, 16), with no padding, ~30% of keys padded, and one fully masked example
  (its dq and dk exactly 0 on both sides, its dv not);
- the bar discriminates: the port's other backward order
  (``attention_kernel._plain_bwd``: delta from the rounded out, the scale
  after the product) misses the bf16 bar on dq or dk at every shape;
- ``gradcheck`` of ``PackedAttention`` in f64, the counters, the validation
  messages, and the JAX package's admission rule (``packed_fits_vmem``).

The CUDA kernels run only on the card: tests/test_torch_cuda.py holds them
against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.ops.pallas_attention import packed_fits_vmem as jax_packed_fits_vmem
from perceiver_io_tpu.ops.pallas_attention import packed_latent_attention as jax_packed
from perceiver_io_tpu.ops.pallas_attention import packed_vmem_bytes as jax_packed_vmem_bytes
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import packed_attention_kernel as pk
from perceiver_io_torch.ops.attention import MultiHeadAttention

SHAPES = [(3, 16, 24, 4, 8), (2, 20, 37, 2, 16), (2, 32, 64, 4, 16)]
BAR = {"float32": 2e-5, "bfloat16": 1e-3}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, mask, seed=0):
    b, t, s, h, d = shape
    rng = np.random.default_rng(seed + b * t * s + h * d)
    q, g = (rng.normal(size=(b, t, h * d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, h * d)).astype(np.float32) for _ in range(2))
    pad = None
    if mask != "none":
        pad = rng.random((b, s)) < 0.3
        pad[:, 0] = False
        if mask == "full_row":
            pad[-1] = True  # one example with every key masked out
    return q, k, v, g, pad


def _jax_side(q, k, v, g, pad, heads, dtype):
    """out and (dq, dk, dv) of the Pallas kernels (interpret mode) via jax.vjp."""
    jd = JAX_DTYPES[dtype]
    jpad = None if pad is None else jnp.asarray(pad)
    out, vjp = jax.vjp(lambda a, b, c: jax_packed(a, b, c, heads, pad_mask=jpad, interpret=True),
                       *(jnp.asarray(x, jd) for x in (q, k, v)))
    return [np.asarray(x, np.float32) for x in (out, *vjp(jnp.asarray(g, jd)))]


def _torch(dtype, *arrays):
    return [None if a is None else torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]


def _rel_err(got, ref):
    return float(np.abs(got.float().numpy().reshape(ref.shape) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("mask", ["none", "pad", "full_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_packed_matches_jax(shape, dtype, mask):
    heads = shape[3]
    q, k, v, g, pad = _inputs(shape, mask)
    refs = _jax_side(q, k, v, g, pad, heads, dtype)
    tq, tk, tv, tg = _torch(dtype, q, k, v, g)
    tpad = None if pad is None else torch.from_numpy(pad)
    out = pk.packed_attention_fwd(tq, tk, tv, heads, tpad)
    grads = pk.packed_attention_bwd(tq, tk, tv, heads, tpad, tg)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), refs):
        assert got.dtype == TORCH_DTYPES[dtype] and got.shape == ref.shape, name
        assert _rel_err(got, ref) <= BAR[dtype], (name, _rel_err(got, ref))
    if mask == "full_row":
        assert not grads[0][-1].any() and not grads[1][-1].any()
        assert not refs[1][-1].any() and not refs[2][-1].any()
        assert grads[2][-1].abs().max() > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_other_backward_order_misses_the_bf16_bar(shape):
    """The bar tells the orders apart: #2/#3's plain backward (delta = sum_d
    g * out from the rounded out, the scale applied after the product), on
    the same bf16 inputs, misses 1e-3 of the peak on dq or dk."""
    b, t, s, h, d = shape
    q, k, v, g, pad = _inputs(shape, "pad")
    refs = _jax_side(q, k, v, g, pad, h, "bfloat16")
    tq, tk, tv, tg = (x.view(b, -1, h, d) for x in _torch("bfloat16", q, k, v, g))
    bias = ak.pad_bias(torch.from_numpy(pad), b, s, "cpu")
    out, m, l = ak._plain_fwd(tq, tk, tv, bias)
    dq, dk, _ = ak._plain_bwd(tq, tk, tv, bias, out, m, l, tg)
    assert max(_rel_err(dq, refs[1]), _rel_err(dk, refs[2])) > BAR["bfloat16"]


def test_fully_masked_row_is_mean_of_values():
    q, k, v, _, pad = _inputs((2, 9, 77, 2, 16), "full_row")
    got = pk.packed_latent_attention(*_torch("float32", q, k, v), 2, torch.from_numpy(pad))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[-1].numpy(), np.broadcast_to(v[-1].mean(axis=0), (9, 32)),
                               atol=2e-5, rtol=2e-5)


def test_autograd_runs_the_backward_and_saves_no_statistics():
    """torch.autograd through packed_latent_attention against jax.vjp, f32;
    one forward and one backward of each kernel's plain version counted;
    the graph holds q, k, v and the bias only."""
    q, k, v, g, pad = _inputs(SHAPES[2], "full_row")
    refs = _jax_side(q, k, v, g, pad, 4, "float32")
    leaves = [x.requires_grad_(True) for x in _torch("float32", q, k, v)]
    counters = (pk.fwd_counter, pk.dq_counter, pk.dkv_counter)
    before = [c.plain_calls for c in counters]
    out = pk.packed_latent_attention(*leaves, 4, torch.from_numpy(pad))
    assert len(out.grad_fn.saved_tensors) == 4
    out.backward(torch.from_numpy(g))
    assert [c.plain_calls - n for c, n in zip(counters, before)] == [1, 1, 1]
    assert not any(c.launches for c in counters)
    for leaf, ref in zip(leaves, refs[1:]):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=2e-5 * np.abs(ref).max())


def test_packed_attention_gradcheck_f64():
    """PackedAttention's backward (the plain versions, f64 on the CPU)
    against finite differences, with padding and a fully masked example."""
    q, k, v, _, pad = _inputs((2, 7, 11, 2, 8), "full_row")
    leaves = [torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v)]
    tpad = torch.from_numpy(pad)
    for fn in (pk.packed_latent_attention, pk.plain_packed_attention):
        assert torch.autograd.gradcheck(lambda *x: fn(*x, 2, tpad), leaves, fast_mode=True)


def test_serving_calls_run_only_the_forward():
    q, k, v, _, pad = _inputs((1, 4, 6, 2, 8), "pad")
    tq, tk, tv = _torch("float32", q, k, v)
    before = (pk.fwd_counter.plain_calls, pk.dq_counter.plain_calls)
    with torch.no_grad():
        out = pk.packed_latent_attention(tq.requires_grad_(True), tk, tv, 2,
                                         torch.from_numpy(pad))
    assert out.grad_fn is None and out.shape == tq.shape and out.is_contiguous()
    assert (pk.fwd_counter.plain_calls, pk.dq_counter.plain_calls) == (before[0] + 1, before[1])
    plain = pk.plain_packed_attention(tq.detach(), tk, tv, 2, torch.from_numpy(pad))
    assert (pk.fwd_counter.plain_calls, pk.dq_counter.plain_calls) == (before[0] + 1, before[1])
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_validation_messages():
    q, k, v, _, pad = (None if x is None else torch.from_numpy(x)
                       for x in _inputs(SHAPES[0], "pad"))
    with pytest.raises(ValueError, match="divisible"):
        pk.packed_latent_attention(q, k, v, 5)
    with pytest.raises(ValueError, match="packed"):
        pk.packed_latent_attention(q[0], k, v, 4)
    with pytest.raises(ValueError, match="do not match"):
        pk.packed_latent_attention(q, k[:, :, :16], v, 4)
    with pytest.raises(ValueError, match="mixed dtypes"):
        pk.packed_latent_attention(q.double(), k, v, 4)
    with pytest.raises(ValueError, match="pad_mask shape"):
        pk.packed_latent_attention(q, k, v, 4, pad[:, :3])
    with pytest.raises(ValueError, match="no packed attention kernel"):
        pk.launch_fwd(q, k, v, ak.pad_bias(pad, 3, 24, "cpu"), 4)


@pytest.mark.parametrize("t,s,e,itemsize", [(256, 512, 64, 2), (1024, 1024, 512, 2),
                                            (256, 512, 512, 4), (160, 256, 64, 4),
                                            (2048, 2048, 32, 4)])
def test_admission_rule_is_the_jax_packages(t, s, e, itemsize):
    assert pk.packed_vmem_bytes(t, s, e, itemsize) == jax_packed_vmem_bytes(t, s, e, itemsize)
    assert pk.packed_fits_vmem(t, s, e, itemsize) == jax_packed_fits_vmem(t, s, e, itemsize)


def test_admission_rule_admits_the_repos_shapes():
    assert pk.packed_fits_vmem(256, 512, 64)          # the C=64 encoder cross
    assert pk.packed_fits_vmem(256, 512, 512)         # the flagship encoder cross
    assert pk.packed_fits_vmem(512, 256, 64, 4)       # the C=64 full decode, f32
    assert not pk.packed_fits_vmem(1024, 1024, 512)   # the TPU backward cannot hold it


def test_module_rejects_oversize():
    x = torch.zeros(1, 2048, 32)
    mha = MultiHeadAttention(32, 32, 4, attn_impl="packed")
    with pytest.raises(ValueError, match="packed"):
        mha(x, x)
