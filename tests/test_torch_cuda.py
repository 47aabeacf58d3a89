"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit (the JAX-side conftest is not needed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances against the plain version: f32 within 1e-4 of the reference's
peak magnitude (sums taken in another order), bf16 within 2e-2 (bf16
rounding of the probabilities / dequantized weights at other points).
"""

import numpy as np
import pytest
import torch

from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import qmatmul as qm
from perceiver_io_torch.quant.int8 import pack_int4, quantize_array

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


def _close(got, ref, dtype):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= _tol(dtype) * float(ref.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ak.SUPPORTED_HEAD_DIMS)
def test_attention_kernel_matches_plain(card, dtype, d):
    g = torch.Generator().manual_seed(d)
    b, t, s, h = 3, 70, 131, 2
    q, k, v = (torch.randn(b, n, h, d, generator=g).to(card, dtype) for n in (t, s, s))
    pad = torch.rand(b, s, generator=g) < 0.3
    pad[-1] = True  # a fully masked row: the mean of v
    pad = pad.to(card)
    before = ak.counter.launches
    got = ak.fused_attention(q, k, v, pad)
    assert ak.counter.launches == before + 1
    _close(got, ak.attention_reference(q, k, v, pad), dtype)


def test_attention_kernel_takes_strided_views(card):
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 65, 3, 4, 32, generator=g).to(card)  # (B, S, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _close(ak.fused_attention(q, k, v), ak.attention_reference(q, k, v), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,group_size", [(8, None), (4, 128), (4, None), (8, 64)])
@pytest.mark.parametrize("m,k,n", [(100, 256, 72), (33, 512, 1003)])
def test_dequant_kernel_matches_plain(card, dtype, bits, group_size, m, k, n):
    rng = np.random.default_rng(m + k + n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    qv, scale = quantize_array(w, bits=bits, group_size=group_size)
    q = torch.from_numpy(pack_int4(qv) if bits == 4 else qv).to(card)
    scale = torch.from_numpy(scale).to(card)
    gs = group_size if scale.ndim == 2 else None
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(card, dtype)
    before = qm.counter.launches
    got = qm.dequant_matmul(x, q, scale, bits, gs)
    assert qm.counter.launches == before + 1
    _close(got, qm.dequant_matmul_reference(x, q, scale, bits, gs), dtype)
