"""The port's quantization (perceiver_io_torch/quant/int8.py) and dequant-matmul
module (ops/qmatmul.py) against the JAX package: quantized values and scales
bit-identical for int8 and grouped int4 (and the per-channel int4 fallback),
the int4 nibble packing round-trips, and the plain version of the CUDA
dequant kernel — which the wrapper runs on CPU tensors — computes what the
Pallas kernel computes (interpret mode), per-channel and grouped, f32 within
2e-5 of the peak."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu import quant as jquant
from perceiver_io_tpu.models.presets import tiny_mlm as jax_tiny_mlm
from perceiver_io_tpu.ops.pallas_matmul import dequant_matmul as jax_dequant_matmul
from perceiver_io_tpu.utils.treepath import simple_keystr
from perceiver_io_torch.interop import flatten_tree
from perceiver_io_torch.ops import qmatmul as qm
from perceiver_io_torch.quant import int8 as pquant


@pytest.mark.parametrize("bits,group_size,shape", [
    (8, None, (64, 48)), (8, None, (37,)), (4, 128, (256, 40)),
    (4, 128, (96, 40)),  # fan-in 128 does not divide: per-channel fallback
    (4, 32, (64, 16)),
])
def test_quantize_array_bit_identical(bits, group_size, shape):
    rng = np.random.default_rng(len(shape) + bits)
    w = rng.normal(size=shape).astype(np.float32) * 3.0
    w[..., 0] = 0.0  # an all-zero channel takes scale 1.0
    q, scale = pquant.quantize_array(w, bits=bits, group_size=group_size)
    jq, jscale = jquant.quantize_array(w, bits=bits, group_size=group_size)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)


def test_int4_nibble_packing_round_trips():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, size=(64, 9)).astype(np.int8)
    packed = pquant.pack_int4(q)
    assert packed.dtype == np.uint8 and packed.shape == (32, 9)
    # low nibble = even row, high nibble = odd row
    byte = int(packed[3, 2])
    assert ((byte & 0xF) ^ 8) - 8 == q[6, 2]
    assert ((byte >> 4) ^ 8) - 8 == q[7, 2]
    np.testing.assert_array_equal(pquant.unpack_int4(torch.from_numpy(packed)).numpy(), q)
    with pytest.raises(ValueError, match="even rows"):
        pquant.pack_int4(q[:3])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_matches_jax_tree(bits):
    model = jax_tiny_mlm()
    ids = jnp.zeros((1, 64), jnp.int32)
    params = model.init({"params": jax.random.key(0), "masking": jax.random.key(1)},
                        ids, ids == 1)["params"]
    flat = flatten_tree(jax.tree.map(np.asarray, params))
    tree = pquant.quantize_tree(flat, bits=bits)
    jtree = jquant.quantize_tree(params, compute_dtype="float32", bits=bits)
    jvalues = {simple_keystr(p): np.asarray(leaf) for p, leaf
               in jax.tree_util.tree_flatten_with_path(jtree.values)[0]}
    assert set(tree) == set(jvalues)
    assert {k for k, v in tree.items() if isinstance(v, pquant.QKernel)} == set(jtree.scales)
    for name, leaf in tree.items():
        if isinstance(leaf, pquant.QKernel):
            assert leaf.bits == bits
            np.testing.assert_array_equal(leaf.int_values().numpy(),
                                          jvalues[name].astype(np.int8))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jtree.scales[name]))
        else:
            np.testing.assert_array_equal(leaf.numpy(), jvalues[name])


@pytest.mark.parametrize("bits,group_size", [(8, None), (4, 128), (4, None), (8, 32)])
def test_plain_dequant_matmul_matches_jax(bits, group_size):
    rng = np.random.default_rng(bits)
    m, k, n = 10, 256, 130
    w = rng.normal(size=(k, n)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, scale = pquant.quantize_array(w, bits=bits, group_size=group_size)
    gs = group_size if scale.ndim == 2 else None
    ref = np.asarray(jax_dequant_matmul(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), group_size=gs, interpret=True))
    stored = pquant.pack_int4(q) if bits == 4 else q
    before = qm.counter.plain_calls
    got = qm.dequant_matmul(torch.from_numpy(x), torch.from_numpy(stored),
                            torch.from_numpy(scale), bits, gs).numpy()
    assert qm.counter.plain_calls == before + 1
    peak = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= 2e-5 * peak


def test_linear_apply_routes_quantized_kernels():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 24)).astype(np.float32)
    b = torch.from_numpy(rng.normal(size=24).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32))
    q, scale = pquant.quantize_array(w, bits=4, group_size=32)
    qk = pquant.QKernel(torch.from_numpy(pquant.pack_int4(q)), torch.from_numpy(scale),
                        4, torch.float32)
    assert qk.shape == (64, 24) and qk.group_size == 32
    got = qm.linear_apply(x, qk, b, torch.float32)
    ref = x @ qk.dequantize() + b
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    dense = qm.linear_apply(x, torch.from_numpy(w), b, torch.float32)
    torch.testing.assert_close(dense, x @ torch.from_numpy(w) + b)


def test_dequant_matmul_validates_operands():
    x = torch.zeros(2, 8)
    q = torch.zeros(8, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="per-channel scale"):
        qm.dequant_matmul(x, q, torch.ones(3))
    with pytest.raises(ValueError, match="does not divide"):
        qm.dequant_matmul(x, q, torch.ones(2, 4), group_size=3)
    with pytest.raises(ValueError, match="packed uint8"):
        qm.dequant_matmul(x, q, torch.ones(4), bits=4)
