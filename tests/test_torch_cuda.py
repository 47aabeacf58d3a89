"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit (the JAX-side conftest is not needed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The attention forward (with and without its (m, l) statistics), the dq and
dk/dv backward kernels (every supported head dim, f32 and bf16, a fully
masked example whose dq and dk must be exactly zero), autograd through
``fused_attention`` against the plain versions, the dequant matmul, and the
fused CE kernels (forward, dx, dW/db at a small, a ragged and a C=512
shape; autograd through ``linear_ce_integer``; the tiny train step with
``fused_head='pallas'``; the bf16 wgmma design of dx and dW/db at every
width class, R and V below one tile and ragged, tiles of ignored rows
between live ones, a wholly ignored batch, a label at V - 1, layouts; the
bf16 wgmma forward at every width class, ragged R and V, labels at 0,
V - 1 and in the partial last tile, a row of equal logits, logits of ~1e3,
layouts, loss within 1e-4 of its peak and lse 1e-5 relative; one
round(W)^T a bf16 autograd step), and the packed-heads kernels (forward, dq, dk/dv
at small, ragged, wide, head-split and tail-padded shapes; autograd through
``packed_latent_attention``; the tiny train step with ``attn_impl='packed'``),
the forward's causal offset in both designs (the Perceiver-AR shapes: a
latent-window cross, square self-attention, a one-row step against 511
keys, rows whose visible keys are all padding; its statistics too), the
two backward kernels with the causal offset in both designs at the same
shapes (dq of rows that see only padding exactly 0, dk and dv of padded key
tiles exactly 0; autograd through ``fused_attention`` against the plain
versions; the tiny AR train step against the plain versions), the tiny AR
model's incremental steps against its dense forward and against the plain
versions on the card, #1 and #9 at the decode arena's batched shapes (64
one-row queries over 512 or 256 keys, each row live to its own length, zero
rings; M = 8, 16, 64 rows, int8 and int4) and the tiny AR model's continuous
batching (its launches; in f32 its streams equal the per-session engine's),
the classifiers' calls of #1-#3 (one query row in the decoders, 784
unpadded keys at D=32 in the MNIST cross, f32 and bf16) and a classifier
train step with the encoder frozen (#1 only in it) and not,
the einsum attention (``attn_impl='xla'``) against #1-#3 under autograd,
the deep designs of #1-#3 (D = 256, 512 and 1024, f32 and bf16, with and
without the causal offset) on their own counters, D = 1024's four-block
cluster giving bit for bit equal column quarters where v, k and g repeat
one quarter four times (the backward also over a walk of 301 key tiles
with a ragged tail and over 9 query tiles), and the bf16 deep
forward (with and without statistics; at D=1024 also over 101 and 301
key tiles with ragged tails and with one query row) and backward at
ragged, one-key and B=1 shapes, a second call bit for bit the first, and
at the multimodal
autoencoder's tails (784 query rows; 1025 rows over 784 keys, 13 key
tiles),
``'auto'`` routing by the rule's block floor, dropout from CUDA generators
and remat's recompute drawing the same masks,
the serving engines' programs as CUDA graphs (the tiny MLM server's three
families and the tiny AR model's decode, B=1 and batched with an ``active``
mask, graphed against eager bit for bit with the same launches; a
batcher's ``drop_programs`` before a swap to the plain versions; a capture
that fails raises),
and the bf16 wgmma designs of the forward, of the two backward kernels,
of the three packed kernels and of the dequant matmul at ragged and tiny
shapes (T, S, M down to 1, the
vocab head's N = 10003, K not a multiple of 64; for the backward a fully
masked example, trailing key tiles that are all padding, head-split views
and cotangents whose strides TMA refuses), each case advancing its
``wgmma`` launch counter.
Tolerances against the plain version: f32 within 1e-4 of the reference's
peak magnitude (sums taken in another order), bf16 within 2e-2 (bf16
rounding of the probabilities / dequantized weights at other points); the
statistics within 1e-5 (f32 on both sides); the bf16 backward's wgmma
cases add an absolute 1e-5 where dq and dk cancel to 0 in exact arithmetic
(one key), which leaves both sides only f32 rounding noise.
"""

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import ce_kernel as ck
from perceiver_io_torch.ops import packed_attention_kernel as pk
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


def _close(got, ref, dtype, atol=0.0):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= _tol(dtype) * float(ref.abs().max()) + atol, err


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


def _attention_inputs(card, dtype, d, b=3, t=70, s=131, h=2, seed=0):
    g = torch.Generator().manual_seed(seed + d)
    q, k, v, go = (torch.randn(b, n, h, d, generator=g).to(card, dtype) for n in (t, s, s, t))
    pad = torch.rand(b, s, generator=g) < 0.3
    pad[-1] = True  # a fully masked row
    return q, k, v, go, pad.to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ak.SUPPORTED_HEAD_DIMS)
def test_attention_statistics_match_plain(card, dtype, d):
    q, k, v, _, pad = _attention_inputs(card, dtype, d)
    before = ak.counter.launches
    out, m, l = ak.attention_fwd_with_stats(q, k, v, pad)
    assert ak.counter.launches == before + 1
    ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad)
    _close(out, ref_out, dtype)
    assert m.shape == l.shape == (3, 2, 70) and m.dtype == l.dtype == torch.float32
    # both take the statistics in f32 from the same rounded inputs
    torch.testing.assert_close(m, ref_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=1e-5)
    assert (m[-1] == ak.MASK_VALUE).all() and (l[-1] == 131).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ak.SUPPORTED_HEAD_DIMS)
def test_attention_backward_kernels_match_plain(card, dtype, d):
    q, k, v, go, pad = _attention_inputs(card, dtype, d)
    out, m, l = ak.attention_reference_with_stats(q, k, v, pad)
    m, l = m.float(), l.float()
    before = (ak.dq_counter.launches, ak.dkv_counter.launches)
    got = ak.attention_bwd(q, k, v, pad, out, m, l, go)
    assert (ak.dq_counter.launches, ak.dkv_counter.launches) == (before[0] + 1, before[1] + 1)
    ref = ak.attention_bwd_reference(q, k, v, pad, out, m, l, go)
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == dtype and x.is_contiguous()
        _close(x, r, dtype)
    # the fully masked example: dq and dk exactly zero, dv the uniform share
    assert not got[0][-1].any() and not got[1][-1].any()
    assert got[2][-1].abs().max() > 0


@pytest.mark.parametrize("causal", [None, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ak.DEEP_HEAD_DIMS)
def test_deep_attention_kernels_match_plain(card, d, dtype, causal):
    """The deep designs (D = 256, 512, 1024) of #1-#3, with and without the causal
    offset: out, m and l, dq, dk and dv against the plain versions at a T
    and S that are not multiples of their tiles; a fully masked example
    (dq = dk = 0 exactly) or, with the offset, rows whose visible keys are
    all padding; each call one launch of each kernel on its deep counter,
    and in bf16 on its wgmma one."""
    q, k, v, go, pad = _attention_inputs(card, dtype, d, t=130, s=200, h=1)
    if causal is not None:  # the last example's first 12 keys padded, the rest not
        pad[-1] = torch.arange(200, device=card) < 12
    counters = (ak.deep_counter, ak.dq_deep_counter, ak.dkv_deep_counter, ak.wgmma_counter,
                ak.dq_wgmma_counter, ak.dkv_wgmma_counter)
    before = [c.launches for c in counters]
    out, m, l = ak.attention_fwd_with_stats(q, k, v, pad, causal)
    ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad, causal)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(m, ref_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=1e-5)
    got = ak.attention_bwd(q, k, v, pad, ref_out, ref_m, ref_l, go, causal)
    ref = ak.attention_bwd_reference(q, k, v, pad, ref_out, ref_m, ref_l, go, causal)
    for x, r in zip(got, ref):
        _close(x, r, dtype)
    wgmma = int(dtype == torch.bfloat16)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1] + [wgmma] * 3
    if causal is None:
        assert not got[0][-1].any() and not got[1][-1].any()


@pytest.mark.parametrize("causal", [None, 8])
@pytest.mark.parametrize("b,t,s", [(1, 64, 64), (1, 1, 200), (2, 63, 65), (3, 130, 200),
                                   (2, 200, 1), (1, 512, 19217), (2, 513, 300), (8, 1, 512)])
@pytest.mark.parametrize("d", ak.DEEP_HEAD_DIMS)
def test_deep_wgmma_backward_cases(card, d, b, t, s, causal):
    """The bf16 deep backward (dq and dk/dv one launch each; at D=512 and
    1024 a cluster of two or four blocks that adds its shares of each logit
    tile): T and S off
    the 64-row tiles, B=1, one key, a walk of 301 key tiles with a 17-key
    tail, 9 query tiles, ImageNet's one-query decoder cross over 512 keys;
    with B > 1 the last example fully masked
    (dq and dk exactly 0, dv its uniform share) or, with the causal offset,
    its first 12 keys padded (dq of the rows that see only padding exactly
    0); a second call bit for bit the first."""
    g = torch.Generator().manual_seed(b * 10000 + t * 10 + s + d + (causal or 0))
    q, go = (torch.randn(b, t, 1, d, generator=g).to(card, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, s, 1, d, generator=g).to(card, torch.bfloat16) for _ in range(2))
    pad = torch.rand(b, s, generator=g) < 0.3
    if b > 1:
        pad[-1] = True if causal is None else torch.arange(s) < 12
    pad = pad.to(card)
    out, m, l = ak.attention_reference_with_stats(q, k, v, pad, causal)
    before = [c.launches for c in (ak.dq_deep_counter, ak.dkv_deep_counter)]
    got = ak.attention_bwd(q, k, v, pad, out, m, l, go, causal)
    assert [c.launches - n for c, n in zip((ak.dq_deep_counter, ak.dkv_deep_counter),
                                           before)] == [1, 1]
    again = ak.attention_bwd(q, k, v, pad, out, m, l, go, causal)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    ref = ak.attention_bwd_reference(q, k, v, pad, out, m, l, go, causal)
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == torch.bfloat16 and x.is_contiguous()
        _close(x, r, torch.bfloat16, BWD_ATOL * d / 128)
    if b > 1 and causal is None:
        assert not got[0][-1].any() and not got[1][-1].any()
        assert got[2][-1].abs().max() > 0
    if b > 1 and causal is not None:
        assert not got[0][-1, :max(0, 12 - causal)].any()


# every deep D at T and S off the tiles; D=1024's reduce and scatter also
# over walks of hundreds of key tiles (301 with a 17-key tail, 101 with a
# 1-key tail: odd counts), one query row (65 key tiles; ImageNet's decoder
# cross at B=8), B=1
DEEP_FWD_CASES = ([(d, b, t, s) for d in ak.DEEP_HEAD_DIMS
                   for b, t, s in ((1, 64, 64), (1, 1, 200), (2, 63, 65), (3, 130, 200),
                                   (2, 200, 1))]
                  + [(1024, b, t, s) for b, t, s in ((1, 512, 19217), (2, 200, 6401),
                                                     (2, 1, 4097), (8, 1, 512))])


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("causal", [None, 8])
@pytest.mark.parametrize("d,b,t,s", DEEP_FWD_CASES)
def test_deep_wgmma_forward_cases(card, d, b, t, s, causal, stats):
    """The bf16 deep forward (128 query rows a block; at D=512 and 1024 a
    cluster of two or four blocks that adds its shares of each logit tile,
    at D=1024 by one round of reduce and scatter, a trade of the rows'
    maxima and a gather of P's fragments):
    T and S off the 128-row and 64-key tiles, an odd number of key tiles,
    B=1, one key, one query row, hundreds of key tiles with a ragged tail;
    with B > 1 the last example fully masked (out the uniform average of
    its values) or, with the causal offset, its first 12 keys padded; out,
    and with ``stats`` m and l, against the plain version; one launch on
    the deep and the wgmma counters; a second call bit for bit the first."""
    g = torch.Generator().manual_seed(b * 10000 + t * 10 + s + d + (causal or 0))
    q = torch.randn(b, t, 1, d, generator=g).to(card, torch.bfloat16)
    k, v = (torch.randn(b, s, 1, d, generator=g).to(card, torch.bfloat16) for _ in range(2))
    pad = torch.rand(b, s, generator=g) < 0.3
    if b > 1:
        pad[-1] = True if causal is None else torch.arange(s) < 12
    pad = pad.to(card)
    counters = (ak.deep_counter, ak.wgmma_counter)
    before = [c.launches for c in counters]
    if stats:
        got = ak.attention_fwd_with_stats(q, k, v, pad, causal)
    else:
        got = (ak.fused_attention(q, k, v, pad, causal),)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1]
    again = (ak.attention_fwd_with_stats(q, k, v, pad, causal) if stats
             else (ak.fused_attention(q, k, v, pad, causal),))
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad, causal)
    assert got[0].shape == ref_out.shape and got[0].dtype == torch.bfloat16
    _close(got[0], ref_out, torch.bfloat16)
    if stats:
        torch.testing.assert_close(got[1], ref_m, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[2], ref_l, rtol=1e-5, atol=1e-5)
    if b > 1 and causal is None:  # every key of the masked example weighs alike
        uniform = v[-1].float().mean(dim=0, keepdim=True).expand(t, 1, d)
        _close(got[0][-1], uniform, torch.bfloat16)


@pytest.mark.parametrize("b,t,s", [(1, 130, 200), (2, 200, 65), (2, 1, 512), (1, 512, 19217),
                                   (2, 513, 300)])
def test_deep_1024_cluster_quarters_agree(card, b, t, s):
    """D=1024's four blocks add their shares of each logit tile in one fixed
    order ((s0 + s1) + (s2 + s3)), so all four form the same m, l, P and ds:
    with q random (each block's share of S differs) and k, v and g one
    random quarter repeated four times, out's, dq's and dv's four column
    quarters are bit for bit equal, ~30% of keys padded."""
    g = torch.Generator().manual_seed(b * 1000 + t + s)
    q = torch.randn(b, t, 1, 1024, generator=g).to(card, torch.bfloat16)
    k, v, go = (torch.randn(b, n, 1, 256, generator=g).repeat(1, 1, 1, 4).to(card, torch.bfloat16)
                for n in (s, s, t))
    pad = (torch.rand(b, s, generator=g) < 0.3).to(card)
    out, m, l = ak.attention_fwd_with_stats(q, k, v, pad)
    dq, _, dv = ak.attention_bwd(q, k, v, pad, out, m, l, go)
    for x in (out, dq, dv):
        quarters = x.reshape(*x.shape[:-1], 4, 256)
        for i in range(1, 4):
            assert torch.equal(quarters[..., 0, :], quarters[..., i, :])
    _close(out, ak.attention_reference(q, k, v, pad), torch.bfloat16)


# the multimodal crosses' tails at a small batch: the encoder cross's 784
# query rows (its last 128-row block 16 live rows, dq's last 64-row tile 16),
# and the decoder cross's one-row last block over 784 keys (12 full 64-key
# tiles and a 16-key tail: 13 tiles, an odd count)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s", [(2, 784, 4096), (2, 1025, 784)])
def test_deep_kernels_at_the_multimodal_tails(card, dtype, b, t, s):
    """#1-#3's D=512 designs at the multimodal autoencoder's tails, no pad
    mask: out, m and l, dq, dk and dv against the plain versions; each call
    one launch of each kernel on its deep counter; in bf16 a second
    forward and backward bit for bit the first."""
    g = torch.Generator().manual_seed(b * 10000 + t + s)
    q, go = (torch.randn(b, t, 1, 512, generator=g).to(card, dtype) for _ in range(2))
    k, v = (torch.randn(b, s, 1, 512, generator=g).to(card, dtype) for _ in range(2))
    counters = (ak.deep_counter, ak.dq_deep_counter, ak.dkv_deep_counter)
    before = [c.launches for c in counters]
    out, m, l = ak.attention_fwd_with_stats(q, k, v, None)
    ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, None)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(m, ref_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=1e-5)
    got = ak.attention_bwd(q, k, v, None, ref_out, ref_m, ref_l, go)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1]
    ref = ak.attention_bwd_reference(q, k, v, None, ref_out, ref_m, ref_l, go)
    for x, r in zip(got, ref):
        assert x.shape == r.shape
        _close(x, r, dtype)
    if dtype == torch.bfloat16:
        for x, y in zip((out, m, l), ak.attention_fwd_with_stats(q, k, v, None)):
            assert torch.equal(x, y)
        for x, y in zip(got, ak.attention_bwd(q, k, v, None, ref_out, ref_m, ref_l, go)):
            assert torch.equal(x, y)


def test_fused_attention_autograd_runs_the_kernels(card):
    q, k, v, go, pad = _attention_inputs(card, torch.float32, 32, t=64, s=256)
    grads = []
    for fn in (ak.fused_attention, ak.plain_attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = (ak.counter.launches, ak.dq_counter.launches, ak.dkv_counter.launches)
        fn(*leaves, pad).backward(go)
        after = (ak.counter.launches, ak.dq_counter.launches, ak.dkv_counter.launches)
        assert [a - b for a, b in zip(after, before)] == ([1, 1, 1] if fn is ak.fused_attention
                                                          else [0, 0, 0])
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        _close(got, ref, torch.float32)


def test_attention_kernel_takes_strided_views(card):
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 65, 3, 4, 32, generator=g).to(card)  # (B, S, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _close(ak.fused_attention(q, k, v), ak.attention_reference(q, k, v), torch.float32)
    out, m, l = ak.attention_fwd_with_stats(q, k, v)
    go = torch.randn(out.shape, generator=g).to(card)
    for x, r in zip(ak.attention_bwd(q, k, v, None, out, m, l, go),
                    ak.attention_bwd_reference(q, k, v, None, out, m, l, go)):
        _close(x, r, torch.float32)


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


@pytest.mark.parametrize("d", ak.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 509])
@pytest.mark.parametrize("t", [1, 63, 65, 250])
def test_wgmma_attention_matches_plain(card, t, s, d):
    """The bf16 forward's wgmma design at ragged and tiny T and S, every head
    dim, a fully masked example (its m pinned at -1e30, l = S exactly), with
    and without statistics."""
    g = torch.Generator().manual_seed(t * 1000 + s + d)
    b, h = 3, 2
    q, k, v = (torch.randn(b, n, h, d, generator=g).to(card, torch.bfloat16) for n in (t, s, s))
    pad = torch.rand(b, s, generator=g) < 0.3
    pad[-1] = True
    pad = pad.to(card)
    assert ak.forward_design(q, k, v) == "wgmma"
    before = (ak.counter.launches, ak.wgmma_counter.launches)
    got = ak.fused_attention(q, k, v, pad)
    out, m, l = ak.attention_fwd_with_stats(q, k, v, pad)
    assert (ak.counter.launches, ak.wgmma_counter.launches) == (before[0] + 2, before[1] + 2)
    ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad)
    _close(got, ref_out, torch.bfloat16)
    _close(out, ref_out, torch.bfloat16)
    torch.testing.assert_close(m, ref_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=1e-5)
    assert (m[-1] == ak.MASK_VALUE).all() and (l[-1] == s).all()


def test_wgmma_attention_takes_strided_views(card):
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn(2, 130, 3, 4, 64, generator=g).to(card, torch.bfloat16)  # (B, S, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = ak.wgmma_counter.launches
    _close(ak.fused_attention(q, k, v), ak.attention_reference(q, k, v), torch.bfloat16)
    assert ak.wgmma_counter.launches == before + 1
    # a view whose row stride is no multiple of 16 bytes: refused, not run
    flat = torch.randn(2 * 65 * 2 * 16 + 1, generator=g).to(card, torch.bfloat16)
    bad = flat[1:].view(2, 65, 2, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ak.fused_attention(bad, bad, bad)


BWD_ATOL = 1e-5


def _wgmma_bwd(q, k, v, pad, go):
    """The two bf16 backward kernels from the plain forward's residuals
    against the plain backward; each advances its wgmma counter once."""
    out, m, l = ak.attention_reference_with_stats(q, k, v, pad)
    assert ak.backward_design(q, k, v, go) == "wgmma"
    before = (ak.dq_wgmma_counter.launches, ak.dkv_wgmma_counter.launches)
    got = ak.attention_bwd(q, k, v, pad, out, m, l, go)
    assert (ak.dq_wgmma_counter.launches, ak.dkv_wgmma_counter.launches) == (
        before[0] + 1, before[1] + 1)
    ref = ak.attention_bwd_reference(q, k, v, pad, out, m, l, go)
    # BWD_ATOL: where ds = p (g.v - delta) cancels in exact arithmetic (one
    # key: the softmax has no gradient), both sides hold only the f32
    # rounding of g.v and delta, summed in another order. The kernels' part
    # is their tensor-core sum g.v, whose distance from float64 grows as D
    # (chip_smoke.py's one_key_sweep, one H100: 1.0e-5, 2.1e-5, 5.9e-5 at
    # D = 128, 256, 512 against the plain f32 einsum's 3.8e-6, 6.4e-6,
    # 7.4e-6; delta the same f32 sum on both sides); kernel minus plain
    # came to 7.7e-6, 1.4e-5, 3.1e-5 there, 7-8e-6 per 128 of D, so the
    # deep heads' bar is D/128 of BWD_ATOL
    atol = BWD_ATOL * max(1.0, q.shape[-1] / 128)
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == torch.bfloat16 and x.is_contiguous()
        _close(x, r, torch.bfloat16, atol)
    return got


@pytest.mark.parametrize("d", ak.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 509])
@pytest.mark.parametrize("t", [1, 63, 65, 160, 250])
def test_wgmma_attention_backward_matches_plain(card, t, s, d):
    """The bf16 backward's wgmma design at ragged and tiny T and S, every
    head dim: example 0 has trailing key tiles that are all padding (the
    skipped tiles), the last one every key masked (dq and dk exactly 0, dv
    the uniform share of g)."""
    g = torch.Generator().manual_seed(t * 1000 + s + d + 7)
    b, h = 3, 2
    q, k, v, go = (torch.randn(b, n, h, d, generator=g).to(card, torch.bfloat16)
                   for n in (t, s, s, t))
    pad = torch.rand(b, s, generator=g) < 0.3
    pad[0, max(1, s // 5):] = True
    pad[-1] = True
    dq, dk, dv = _wgmma_bwd(q, k, v, pad.to(card), go)
    assert not dq[-1].any() and not dk[-1].any() and dv[-1].abs().max() > 0
    keys = max(1, s // 5)
    assert not dk[0, keys:].any() and not dv[0, keys:].any()


def test_wgmma_attention_backward_takes_strided_views(card):
    """Head-split q, k, v views, and cotangents with strides TMA refuses (a
    row stride that is no multiple of 16 bytes, a broadcast with stride 0):
    g is copied, q, k and v are read in place; autograd through
    ``fused_attention`` runs the wgmma kernels from ``.sum()``'s broadcast g."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 130, 3, 4, 64, generator=g).to(card, torch.bfloat16)  # (B, S, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    pad = (torch.rand(2, 130, generator=g) < 0.3).to(card)
    wide = torch.randn(2, 130, 4, 68, generator=g).to(card, torch.bfloat16)[..., :64]
    broadcast = torch.full((), 0.5, dtype=torch.bfloat16, device=card).expand(q.shape)
    for go in (torch.randn(q.shape, generator=g).to(card, torch.bfloat16), wide, broadcast):
        _wgmma_bwd(q, k, v, pad, go)
    grads = []
    for fn in (ak.fused_attention, ak.plain_attention):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        before = ak.dq_wgmma_counter.launches
        fn(*leaves, pad).float().sum().backward()
        assert ak.dq_wgmma_counter.launches - before == (fn is ak.fused_attention)
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        _close(got, ref, torch.bfloat16)


@pytest.mark.parametrize("bits,group_size", [(8, None), (8, 64), (8, 128), (4, None), (4, 64),
                                             (4, 128)])
@pytest.mark.parametrize("n", [72, 144, 1003, 10003])
@pytest.mark.parametrize("m", [1, 63, 413])
def test_wgmma_dequant_matches_plain(card, m, n, bits, group_size):
    """N = 144 takes the 16-byte cp.async path for the int bytes (N a
    multiple of 16), the others the byte-load path; the vocab head's N =
    10003 leaves no row of q or of the output aligned."""
    rng = np.random.default_rng(m + n + bits + (group_size or 0))
    k = 512
    w = rng.normal(size=(k, n)).astype(np.float32)
    qv, scale = quantize_array(w, bits=bits, group_size=group_size)
    q = torch.from_numpy(pack_int4(qv) if bits == 4 else qv).to(card)
    scale = torch.from_numpy(scale).to(card)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(card, torch.bfloat16)
    before = (qm.counter.launches, qm.wgmma_counter.launches)
    got = qm.dequant_matmul(x, q, scale, bits, group_size)
    assert (qm.counter.launches, qm.wgmma_counter.launches) == (before[0] + 1, before[1] + 1)
    _close(got, qm.dequant_matmul_reference(x, q, scale, bits, group_size), torch.bfloat16)


@pytest.mark.parametrize("n", [130, 144])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [8, 40, 200])
def test_wgmma_dequant_ragged_depth(card, k, bits, n):
    """K not a multiple of the 64-deep step: x and the weight tile are
    zero-filled past K, on both load paths of the int bytes."""
    rng = np.random.default_rng(k + bits + n)
    w = rng.normal(size=(k, n)).astype(np.float32)
    qv, scale = quantize_array(w, bits=bits)
    q = torch.from_numpy(pack_int4(qv) if bits == 4 else qv).to(card)
    scale = torch.from_numpy(scale).to(card)
    x = torch.from_numpy(rng.normal(size=(150, k)).astype(np.float32)).to(card, torch.bfloat16)
    before = qm.wgmma_counter.launches
    _close(qm.dequant_matmul(x, q, scale, bits), qm.dequant_matmul_reference(x, q, scale, bits),
           torch.bfloat16)
    assert qm.wgmma_counter.launches == before + 1


def _ce_inputs(card, dtype, r, c, v, seed=0):
    g = torch.Generator().manual_seed(seed + r + c + v)
    x = torch.randn(r, c, generator=g).to(card, dtype)
    w = ((torch.rand(c, v, generator=g) * 2 - 1) * c**-0.5).to(card)
    b = (torch.randn(v, generator=g) * 0.1).to(card)
    labels = torch.randint(0, v, (r,), generator=g)
    valid = torch.rand(r, generator=g) >= 0.15
    cot = torch.where(valid, torch.rand(r, generator=g), 0.0)
    return x, w, b, torch.where(valid, labels, 0).to(card), cot.to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,v", [(128, 64, 1000), (37, 72, 259), (70, 512, 301),
                                   (33, 8, 5)])
def test_ce_kernels_match_plain(card, dtype, r, c, v):
    x, w, b, labels, g = _ce_inputs(card, dtype, r, c, v)
    counters = (ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)
    wgmma = (ck.ce_fwd_wgmma_counter, ck.ce_dx_wgmma_counter, ck.ce_dw_wgmma_counter)
    before = [n.launches for n in counters]
    wgmma_before = [n.launches for n in wgmma]
    loss, lse = ck.linear_ce_fwd(x, w, b, labels)
    ref_loss, ref_lse = ck.linear_ce_fwd_reference(x, w, b, labels)
    _close(loss, ref_loss, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    dx = ck.linear_ce_bwd_dx(x, w, b, labels, ref_lse, g)
    dw, db = ck.linear_ce_bwd_dw(x, w, b, labels, ref_lse, g)
    assert [n.launches - m for n, m in zip(counters, before)] == [1, 1, 1]
    design = ck.ce_backward_design(x, w)
    assert ck.ce_forward_design(x, w) == design
    expect = [1, 1, 1] if design == "wgmma" else [0, 0, 0]
    assert [n.launches - m for n, m in zip(wgmma, wgmma_before)] == expect
    assert expect == ([1, 1, 1] if dtype == torch.bfloat16 else [0, 0, 0])
    refs = ck.linear_ce_bwd_reference(x, w, b, labels, ref_lse, g)
    for got, ref in zip((dx, dw, db), refs):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        _close(got, ref, dtype)
    ignored = g == 0  # rows that carry no cotangent add exactly nothing
    assert not dx[ignored].any()


def test_ce_autograd_runs_the_kernels(card):
    x, w, b, labels, g = _ce_inputs(card, torch.float32, 100, 64, 777)
    counters = (ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)
    grads = []
    for fn in (ck.linear_ce_integer, ck.plain_linear_ce_integer):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        before = [n.launches for n in counters]
        fn(*leaves, labels).backward(g)
        expect = [1, 1, 1] if fn is ck.linear_ce_integer else [0, 0, 0]
        assert [n.launches - m for n, m in zip(counters, before)] == expect
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        _close(got, ref, torch.float32)
    with pytest.raises(ValueError, match="multiple of 8 up to 512"):
        ck.linear_ce_fwd(torch.zeros(4, 520, device=card), torch.zeros(520, 9, device=card),
                         torch.zeros(9, device=card), torch.zeros(4, dtype=torch.int64,
                                                                  device=card))


def _wgmma_ce_case(card, r, c, v, seed=0, live=0.85):
    """bf16 inputs for the wgmma CE backward: rows ignored at random (g = 0,
    label 0), every row of the 64-row tiles 1 and 3 ignored (tiles the dW/db
    kernel skips between live ones, whose dx the dx kernel writes as zeros),
    and the first live row labelled V - 1."""
    gen = torch.Generator().manual_seed(seed + r + c + v)
    x = torch.randn(r, c, generator=gen).to(card, torch.bfloat16)
    w = ((torch.rand(c, v, generator=gen) * 2 - 1) * c**-0.5).to(card)
    b = (torch.randn(v, generator=gen) * 0.1).to(card)
    labels = torch.randint(0, v, (r,), generator=gen)
    valid = torch.rand(r, generator=gen) < live
    for tile in (1, 3):
        valid[64 * tile:64 * (tile + 1)] = False
    labels[int(valid.nonzero()[0]) if valid.any() else 0] = v - 1
    g = torch.where(valid, torch.rand(r, generator=gen) + 0.5, 0.0) / max(int(valid.sum()), 1)
    return x, w, b, torch.where(valid, labels, 0).to(card), g.to(card)


def _wgmma_ce_check(card, x, w, b, labels, g):
    """dx, dW and db of the wgmma kernels against the plain backward (2e-2 of
    each peak), each kernel advancing its wgmma counter once; dx of every
    row whose g is 0 exactly 0."""
    assert ck.ce_backward_design(x, w) == "wgmma"
    _, lse = ck.linear_ce_fwd_reference(x, w, b, labels)
    counters = (ck.ce_dx_counter, ck.ce_dw_counter, ck.ce_dx_wgmma_counter,
                ck.ce_dw_wgmma_counter)
    before = [n.launches for n in counters]
    dx = ck.linear_ce_bwd_dx(x, w, b, labels, lse, g)
    dw, db = ck.linear_ce_bwd_dw(x, w, b, labels, lse, g)
    assert [n.launches - m for n, m in zip(counters, before)] == [1, 1, 1, 1]
    refs = ck.linear_ce_bwd_reference(x, w, b, labels, lse, g)
    for got, ref in zip((dx, dw, db), refs):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        _close(got, ref, torch.bfloat16)
    assert not dx[g == 0].any()
    return dx, dw, db


@pytest.mark.parametrize("c", [8, 16, 24, 64, 128, 256, 512])
@pytest.mark.parametrize("r,v", [(37, 50), (37, 10003), (10239, 50), (10239, 10003)])
def test_wgmma_ce_backward_matches_plain(card, r, v, c):
    """The bf16 wgmma design at every width class (C = 8 and 24 zero-padded
    by TMA, C = 512 split across two blocks), R below one tile and ragged
    at 10239, V below one tile and ragged at 10003."""
    _wgmma_ce_check(card, *_wgmma_ce_case(card, r, c, v))


@pytest.mark.parametrize("c", [8, 64, 512])
def test_wgmma_ce_backward_wholly_ignored_batch(card, c):
    """Every cotangent 0: dx, dW and db exactly 0 (no tile runs a product)."""
    x, w, b, labels, g = _wgmma_ce_case(card, 300, c, 777, live=0.0)
    dx, dw, db = _wgmma_ce_check(card, x, w, b, labels, g)
    assert not dx.any() and not dw.any() and not db.any()


def test_wgmma_ce_backward_takes_layouts(card):
    """A non-contiguous bf16 x is copied and taken; a misaligned contiguous
    one raises (no scalar fallback); a given Wt must be round_weight_t(w)."""
    x, w, b, labels, g = _wgmma_ce_case(card, 200, 64, 300)
    wide = torch.zeros(200, 72, dtype=torch.bfloat16, device=card)
    wide[:, :64] = x
    _wgmma_ce_check(card, wide[:, :64], w, b, labels, g)
    _, lse = ck.linear_ce_fwd_reference(x, w, b, labels)
    wt = ck.round_weight_t(w)
    assert torch.equal(wt, w.to(torch.bfloat16).t())
    torch.testing.assert_close(ck.launch_bwd_dx(x, w, b, labels, lse, g, wt),
                               ck.launch_bwd_dx(x, w, b, labels, lse, g), rtol=0, atol=0)
    flat = torch.zeros(1 + 200 * 64, dtype=torch.bfloat16, device=card)
    misaligned = flat[1:].view(200, 64)
    misaligned.copy_(x)
    before = ck.ce_dx_counter.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.linear_ce_bwd_dx(misaligned, w, b, labels, lse, g)
    with pytest.raises(ValueError, match="round_weight_t"):
        ck.launch_bwd_dw(x, w, b, labels, lse, g, wt.float())
    assert ck.ce_dx_counter.launches == before


@pytest.mark.parametrize("c", [16, 64, 512])
def test_wgmma_ce_autograd_runs_the_kernels(card, c, monkeypatch):
    """Autograd through ``linear_ce_integer`` in bf16 runs the three wgmma
    kernels once each, from one round_weight_t a step (made by the forward,
    read again by the backward), and matches the plain versions' gradients;
    a sum's broadcast cotangent is taken too."""
    x, w, b, labels, g = _wgmma_ce_case(card, 333, c, 1003)
    counters = (ck.ce_fwd_wgmma_counter, ck.ce_dx_wgmma_counter, ck.ce_dw_wgmma_counter)
    made = []
    round_weight_t = ck.round_weight_t
    monkeypatch.setattr(ck, "round_weight_t", lambda w: made.append(1) or round_weight_t(w))
    grads = []
    for fn in (ck.linear_ce_integer, ck.plain_linear_ce_integer):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        before = [n.launches for n in counters]
        made.clear()
        fn(*leaves, labels).backward(g)
        expect = [1, 1, 1] if fn is ck.linear_ce_integer else [0, 0, 0]
        assert [n.launches - m for n, m in zip(counters, before)] == expect
        assert len(made) == expect[0]
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        _close(got, ref, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ck.linear_ce_integer(*leaves, labels).sum().backward()
    assert all(torch.isfinite(t.grad.float()).all() for t in leaves)


def _wgmma_ce_fwd_check(x, w, b, labels):
    """loss and lse of the bf16 wgmma forward against the plain version (the
    same rounding points; only the order of the sums and ex2.approx differ):
    the loss within 1e-4 of its peak, lse within 1e-5 relative; the call
    advances the wgmma counter once."""
    assert ck.ce_forward_design(x, w) == "wgmma"
    counters = (ck.ce_fwd_counter, ck.ce_fwd_wgmma_counter)
    before = [n.launches for n in counters]
    loss, lse = ck.linear_ce_fwd(x, w, b, labels)
    assert [n.launches - m for n, m in zip(counters, before)] == [1, 1]
    ref_loss, ref_lse = ck.linear_ce_fwd_reference(x, w, b, labels)
    assert loss.shape == lse.shape == ref_lse.shape and loss.dtype == lse.dtype == torch.float32
    _close(loss, ref_loss, torch.float32)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=0.0)
    return loss, lse


def _label_edges(labels, v):
    """Rows 0, 1 and 2 labelled at column 0, V - 1 and inside the last vocab
    tile (partial unless 64 divides V)."""
    labels = labels.clone()
    last = v - 1 - (v - 1) % 64
    labels[:3] = torch.tensor([0, v - 1, last + (v - last) // 2])
    return labels


@pytest.mark.parametrize("c", [8, 16, 24, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("r,v", [(37, 50), (37, 10003), (10239, 50), (10239, 10003)])
def test_wgmma_ce_forward_matches_plain(card, r, v, c):
    """The bf16 wgmma forward at every width class (C = 8 and 24 zero-padded
    by TMA), R below one tile and ragged at 10239 (TMA's zero rows computed,
    not stored), V below one tile and ragged at 10003 (the pad bias on the
    last tile's 45 or 14 dead columns), labels at 0, V - 1 and in the
    partial last tile."""
    x, w, b, labels, _ = _wgmma_ce_case(card, r, c, v)
    _wgmma_ce_fwd_check(x, w, b, _label_edges(labels, v))


@pytest.mark.parametrize("c", [8, 64, 512])
@pytest.mark.parametrize("case", ["flat_row", "large_logits"])
def test_wgmma_ce_forward_edges(card, case, c):
    """A row whose logits are all equal (x = 0 and a constant bias: lse =
    b + log V, loss = log V exactly in real arithmetic), and logits of
    magnitude ~1e3 (x scaled up), where the online max carries the sum."""
    r, v = 300, 10003
    x, w, b, labels, _ = _wgmma_ce_case(card, r, c, v)
    labels = _label_edges(labels, v)
    if case == "flat_row":
        x[3] = 0
        b = torch.full_like(b, 0.25)
    else:
        x = (x.float() * 1e3 / 0.58).to(torch.bfloat16)
    loss, lse = _wgmma_ce_fwd_check(x, w, b, labels)
    if case == "flat_row":
        assert abs(float(lse[3]) - (0.25 + np.log(v))) <= 1e-5 * (0.25 + np.log(v))
        assert abs(float(loss[3]) - np.log(v)) <= 1e-5 * np.log(v)
    else:
        ref_lse = ck.linear_ce_fwd_reference(x, w, b, labels)[1]
        assert float(ref_lse.abs().max()) > 500


def test_wgmma_ce_forward_takes_layouts(card):
    """A non-contiguous bf16 x is copied and taken; a misaligned contiguous
    one raises (no scalar fallback); a given Wt must be round_weight_t(w),
    and one given gives the same outputs as one made by the wrapper."""
    x, w, b, labels, _ = _wgmma_ce_case(card, 200, 64, 300)
    wide = torch.zeros(200, 72, dtype=torch.bfloat16, device=card)
    wide[:, :64] = x
    _wgmma_ce_fwd_check(wide[:, :64], w, b, labels)
    wt = ck.round_weight_t(w)
    for got, ref in zip(ck.launch_fwd(x, w, b, labels, wt), ck.launch_fwd(x, w, b, labels)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    flat = torch.zeros(1 + 200 * 64, dtype=torch.bfloat16, device=card)
    misaligned = flat[1:].view(200, 64)
    misaligned.copy_(x)
    before = ck.ce_fwd_counter.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.linear_ce_fwd(misaligned, w, b, labels)
    with pytest.raises(ValueError, match="round_weight_t"):
        ck.launch_fwd(x, w, b, labels, wt.float())
    assert ck.ce_fwd_counter.launches == before


def test_train_step_on_the_card_matches_plain(card):
    """One f32 train step of the tiny model on the card, with the kernels and
    with the plain versions in their place: the same loss and gradients; 5
    forward, 5 dq and 5 dk/dv launches (2 encoder cross + 2 self + 1
    decoder), none in the plain run."""
    from perceiver_io_torch.models.presets import tiny_mlm
    from perceiver_io_torch.ops.attention import MultiHeadAttention
    from perceiver_io_torch.training.optim import OptimizerConfig, make_optimizer
    from perceiver_io_torch.training.steps import make_mlm_steps
    from perceiver_io_torch.training.train_state import TrainState

    rng = np.random.default_rng(0)
    pad = np.zeros((4, 64), bool)
    pad[1, 40:] = True
    batch = {"token_ids": rng.integers(3, 503, (4, 64)).astype(np.int32), "pad_mask": pad}
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter)
    runs = []
    for plain in (False, True):
        model = tiny_mlm(device=card, seed=1)
        if plain:
            for module in model.modules():
                if isinstance(module, MultiHeadAttention):
                    module.attention = ak.plain_attention
        optimizer, schedule = make_optimizer(OptimizerConfig(), model.parameters())
        state = TrainState.create(model, optimizer, schedule, seed=3)
        train_step, _, _ = make_mlm_steps(model, schedule, loss_gather_capacity=32)
        before = [c.launches for c in counters]
        _, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [0 if plain else 5] * 3
        runs.append((float(metrics["loss"]),
                     {n: p.grad.detach().clone() for n, p in model.named_parameters()}))
    (loss, grads), (ref_loss, ref_grads) = runs
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, ref in ref_grads.items():
        if not name.endswith("k_proj.bias"):  # zero in exact arithmetic: noise
            assert float((grads[name] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


def test_fused_head_train_step_on_the_card_matches_plain(card):
    """The same with ``fused_head='pallas'``: one CE forward, dx and dW
    launch with the kernels, none with the plain versions in their place."""
    from perceiver_io_torch.models.presets import tiny_mlm
    from perceiver_io_torch.ops.attention import MultiHeadAttention
    from perceiver_io_torch.training.optim import OptimizerConfig, make_optimizer
    from perceiver_io_torch.training.steps import make_mlm_steps
    from perceiver_io_torch.training.train_state import TrainState

    rng = np.random.default_rng(1)
    batch = {"token_ids": rng.integers(3, 503, (4, 64)).astype(np.int32),
             "pad_mask": np.zeros((4, 64), bool)}
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter,
                ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)
    runs = []
    for plain in (False, True):
        model = tiny_mlm(device=card, seed=1)
        if plain:
            for module in model.modules():
                if isinstance(module, MultiHeadAttention):
                    module.attention = ak.plain_attention
            model.decoder.output_adapter.linear_ce = ck.plain_linear_ce_integer
        optimizer, schedule = make_optimizer(OptimizerConfig(), model.parameters())
        state = TrainState.create(model, optimizer, schedule, seed=3)
        train_step, _, _ = make_mlm_steps(model, schedule, loss_gather_capacity=32,
                                          fused_head="pallas")
        before = [c.launches for c in counters]
        _, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        expect = [0] * 6 if plain else [5, 5, 5, 1, 1, 1]
        assert [c.launches - b for c, b in zip(counters, before)] == expect
        runs.append((float(metrics["loss"]),
                     {n: p.grad.detach().clone() for n, p in model.named_parameters()}))
    (loss, grads), (ref_loss, ref_grads) = runs
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, ref in ref_grads.items():
        if not name.endswith("k_proj.bias"):  # zero in exact arithmetic: noise
            assert float((grads[name] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


def _packed_inputs(card, dtype, b, t, s, h, d, seed=0, tail=False):
    """q, k, v, a cotangent and a pad mask: ~30% of keys at random, or with
    ``tail`` each example's keys valid up to a random length (the encoder's
    token rows); the last example masked whole."""
    g = torch.Generator().manual_seed(seed + t + s + h * d)
    q, k, v, go = (torch.randn(b, n, h * d, generator=g).to(card, dtype) for n in (t, s, s, t))
    if tail:
        pad = torch.arange(s)[None, :] >= torch.randint(1, s + 1, (b, 1), generator=g)
    else:
        pad = torch.rand(b, s, generator=g) < 0.3
    pad[-1] = True  # a fully masked example
    return q, k, v, go, pad.to(card)


# (B, T, S, H, D): the tiny model's width, a ragged C=64 shape, a flagship
# width (E=512), three heads of 32, and 32 heads of 16 (two head groups)
PACKED_SHAPES = [(3, 16, 24, 4, 8), (2, 70, 131, 4, 16), (2, 33, 65, 4, 128),
                 (2, 20, 37, 3, 32), (2, 9, 40, 32, 16)]
# tail padding, as the encoder's rows: whole key tiles of padding, skipped
PACKED_TAIL_SHAPE = (4, 130, 509, 4, 16)


def _packed_counters():
    return (pk.fwd_counter, pk.dq_counter, pk.dkv_counter, pk.fwd_wgmma_counter,
            pk.dq_wgmma_counter, pk.dkv_wgmma_counter)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PACKED_SHAPES + [PACKED_TAIL_SHAPE])
def test_packed_kernels_match_plain(card, dtype, shape):
    """Each kernel against its plain version; bf16 through the wgmma design,
    f32 through the scalar one (the wgmma counters say which)."""
    b, t, s, h, d = shape
    q, k, v, go, pad = _packed_inputs(card, dtype, *shape, tail=shape == PACKED_TAIL_SHAPE)
    design = "wgmma" if dtype == torch.bfloat16 else "scalar_f32"
    assert pk.packed_backward_design(q, k, v, go, h) == design
    before = [c.launches for c in _packed_counters()]
    out = pk.packed_attention_fwd(q, k, v, h, pad)
    grads = pk.packed_attention_bwd(q, k, v, h, pad, go)
    wgmma = int(design == "wgmma")
    assert [c.launches - n for c, n in zip(_packed_counters(), before)] == [1, 1, 1] + [wgmma] * 3
    _close(out, pk.packed_attention_reference(q, k, v, h, pad), dtype)
    bias = ak.pad_bias(pad, b, s, card)
    refs = pk.packed_attention_bwd_reference(q, k, v, bias, go, h)
    for got, ref in zip(grads, refs):
        assert got.shape == ref.shape and got.dtype == dtype and got.is_contiguous()
        _close(got, ref, dtype)
    # the fully masked example: dq and dk exactly zero, dv the uniform share
    assert not grads[0][-1].any() and not grads[1][-1].any()
    assert grads[2][-1].abs().max() > 0
    # the dq kernel's (m, l, delta) scratch: l of the masked example is S
    _, stats = pk.launch_bwd_dq(q, k, v, bias, go, h)
    torch.cuda.synchronize()
    assert (stats[-1, :, :, 0] == ak.MASK_VALUE).all() and (stats[-1, :, :, 1] == s).all()


def test_packed_autograd_runs_the_kernels(card):
    q, k, v, go, pad = _packed_inputs(card, torch.float32, 2, 64, 256, 4, 16)
    counters = (pk.fwd_counter, pk.dq_counter, pk.dkv_counter, ak.counter, ak.dq_counter)
    grads = []
    for fn in (pk.packed_latent_attention, pk.plain_packed_attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = [c.launches for c in counters]
        fn(*leaves, 4, pad).backward(go)
        expect = [1, 1, 1, 0, 0] if fn is pk.packed_latent_attention else [0] * 5
        assert [c.launches - n for c, n in zip(counters, before)] == expect
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        _close(got, ref, torch.float32)
    with pytest.raises(ValueError, match="head dim 24 unsupported"):
        pk.packed_attention_fwd(q[..., :48], k[..., :48], v[..., :48], 2)


def test_packed_kernels_take_strided_views(card):
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 65, 3, 64, generator=g).to(card)  # (B, S, 3, E)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _close(pk.packed_attention_fwd(q, k, v, 4), pk.packed_attention_reference(q, k, v, 4),
           torch.float32)
    go = torch.randn(2, 65, 64, generator=g).to(card)
    bias = ak.pad_bias(None, 2, 65, card)
    for x, r in zip(pk.packed_attention_bwd(q, k, v, 4, None, go),
                    pk.packed_attention_bwd_reference(q, k, v, bias, go, 4)):
        _close(x, r, torch.float32)


@pytest.mark.parametrize("d", pk.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("s", [1, 63, 509])
@pytest.mark.parametrize("t", [1, 63, 160, 250])
def test_wgmma_packed_kernels_match_plain(card, t, s, d):
    """The bf16 packed kernels at tiny and ragged T and S (neither a
    multiple of 64), every head dim: example 0 has trailing key tiles that
    are all padding (the skipped tiles), the last one every key masked (dq
    and dk exactly 0, dv the uniform share of g, l = S in the scratch)."""
    b, h = 3, 2
    q, k, v, go, pad = _packed_inputs(card, torch.bfloat16, b, t, s, h, d, seed=7)
    keys = max(1, s // 5)
    pad[0, keys:] = True
    before = [c.launches for c in _packed_counters()[3:]]
    out = pk.packed_attention_fwd(q, k, v, h, pad)
    dq, dk, dv = pk.packed_attention_bwd(q, k, v, h, pad, go)
    assert [c.launches - n for c, n in zip(_packed_counters()[3:], before)] == [1, 1, 1]
    _close(out, pk.packed_attention_reference(q, k, v, h, pad), torch.bfloat16)
    bias = ak.pad_bias(pad, b, s, card)
    for got, ref in zip((dq, dk, dv), pk.packed_attention_bwd_reference(q, k, v, bias, go, h)):
        _close(got, ref, torch.bfloat16, BWD_ATOL)
    assert not dq[-1].any() and not dk[-1].any() and dv[-1].abs().max() > 0
    assert not dk[0, keys:].any() and not dv[0, keys:].any()
    stats = pk.launch_bwd_dq(q, k, v, bias, go, h)[1]
    torch.cuda.synchronize()
    assert (stats[-1, :, :, 0] == ak.MASK_VALUE).all() and (stats[-1, :, :, 1] == s).all()


def test_wgmma_packed_kernels_take_views_and_cotangents(card):
    """q, k, v sliced out of one (B, S, 3, E) tensor are read in place;
    cotangents whose strides TMA refuses (a row stride no multiple of 16
    bytes, a stride-0 broadcast) are copied by the launch; autograd through
    ``packed_latent_attention`` runs the wgmma kernels from ``.sum()``'s
    broadcast g; a bf16 view TMA refuses raises."""
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn(2, 130, 3, 64, generator=g).to(card, torch.bfloat16)  # (B, S, 3, E)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    pad = (torch.rand(2, 130, generator=g) < 0.3).to(card)
    bias = ak.pad_bias(pad, 2, 130, card)
    _close(pk.packed_attention_fwd(q, k, v, 4, pad),
           pk.packed_attention_reference(q, k, v, 4, pad), torch.bfloat16)
    wide = torch.randn(2, 130, 68, generator=g).to(card, torch.bfloat16)[..., :64]
    broadcast = torch.full((), 0.5, dtype=torch.bfloat16, device=card).expand(q.shape)
    for go in (torch.randn(q.shape, generator=g).to(card, torch.bfloat16), wide, broadcast):
        assert pk.packed_backward_design(q, k, v, go, 4) == "wgmma"
        before = pk.dq_wgmma_counter.launches
        got = pk.packed_attention_bwd(q, k, v, 4, pad, go)
        assert pk.dq_wgmma_counter.launches == before + 1
        for x, r in zip(got, pk.packed_attention_bwd_reference(q, k, v, bias, go, 4)):
            _close(x, r, torch.bfloat16, BWD_ATOL)
    grads = []
    for fn in (pk.packed_latent_attention, pk.plain_packed_attention):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        before = pk.dq_wgmma_counter.launches
        fn(*leaves, 4, pad).float().sum().backward()
        assert pk.dq_wgmma_counter.launches - before == (fn is pk.packed_latent_attention)
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        _close(got, ref, torch.bfloat16)
    flat = torch.randn(2 * 65 * 64 + 1, generator=g).to(card, torch.bfloat16)
    bad = flat[1:].view(2, 65, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.packed_latent_attention(bad, bad, bad, 4)


def test_packed_train_step_on_the_card_matches_plain(card):
    """One f32 train step of the tiny model with ``attn_impl='packed'`` and
    the fused head, with the kernels and with the plain versions in their
    place: the same loss and gradients; 5 packed forward, dq and dk/dv
    launches, none of the fused attention kernels, none in the plain run."""
    from perceiver_io_torch.models.presets import tiny_mlm
    from perceiver_io_torch.ops.attention import MultiHeadAttention
    from perceiver_io_torch.training.optim import OptimizerConfig, make_optimizer
    from perceiver_io_torch.training.steps import make_mlm_steps
    from perceiver_io_torch.training.train_state import TrainState

    rng = np.random.default_rng(2)
    pad = np.zeros((4, 64), bool)
    pad[2, 30:] = True
    batch = {"token_ids": rng.integers(3, 503, (4, 64)).astype(np.int32), "pad_mask": pad}
    counters = (pk.fwd_counter, pk.dq_counter, pk.dkv_counter, ak.counter, ak.dq_counter,
                ak.dkv_counter, ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)
    runs = []
    for plain in (False, True):
        model = tiny_mlm(device=card, seed=1, attn_impl="packed")
        if plain:
            for module in model.modules():
                if isinstance(module, MultiHeadAttention):
                    module.packed_attention = pk.plain_packed_attention
            model.decoder.output_adapter.linear_ce = ck.plain_linear_ce_integer
        optimizer, schedule = make_optimizer(OptimizerConfig(), model.parameters())
        state = TrainState.create(model, optimizer, schedule, seed=3)
        train_step, _, _ = make_mlm_steps(model, schedule, loss_gather_capacity=32,
                                          fused_head="pallas")
        before = [c.launches for c in counters]
        _, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        expect = [0] * 9 if plain else [5, 5, 5, 0, 0, 0, 1, 1, 1]
        assert [c.launches - b for c, b in zip(counters, before)] == expect
        runs.append((float(metrics["loss"]),
                     {n: p.grad.detach().clone() for n, p in model.named_parameters()}))
    (loss, grads), (ref_loss, ref_grads) = runs
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, ref in ref_grads.items():
        if not name.endswith("k_proj.bias"):  # zero in exact arithmetic: noise
            assert float((grads[name] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


# (B, T, S, H, offset, padded key prefix of the last example): the AR path's
# causal calls, a ragged width and rows whose visible keys are all padding
CAUSAL_SHAPES = {
    "window_cross": (3, 70, 131, 2, 61, 0),
    "square_self": (3, 130, 130, 2, 0, 0),
    "window_511": (2, 256, 511, 2, 255, 0),
    "step_511": (3, 1, 511, 2, 510, 0),
    "visible_all_padding": (3, 64, 200, 2, 8, 80),
    "left_padded_self": (3, 130, 130, 2, 0, 70),
    # a bucketed batch narrower than the latents: the window is the batch
    "bucket_128_window": (4, 128, 128, 2, 0, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("shape", sorted(CAUSAL_SHAPES))
def test_causal_attention_matches_plain(card, dtype, d, shape):
    """The forward's causal offset (both designs: the f32 scalar kernel, the
    bf16 wgmma kernel) against the plain version, with ~30% of keys padded
    and, in ``visible_all_padding``, the last example's first 80 keys padded
    so that its rows 0..71 see only padding (they average the keys masked
    exactly once); out and the statistics, each call one causal launch."""
    b, t, s, h, off, head = CAUSAL_SHAPES[shape]
    g = torch.Generator().manual_seed(t * 1000 + s + d)
    q, k, v = (torch.randn(b, n, h, d, generator=g).to(card, dtype) for n in (t, s, s))
    pad = torch.rand(b, s, generator=g) < 0.3
    if head:
        pad[-1] = False
        pad[-1, :head] = True
    pad = pad.to(card)
    before = (ak.counter.launches, ak.causal_counter.launches, ak.wgmma_counter.launches)
    got = ak.fused_attention(q, k, v, pad, causal_offset=off)
    out, m, l = ak.attention_fwd_with_stats(q, k, v, pad, causal_offset=off)
    wgmma = 2 if dtype == torch.bfloat16 else 0
    assert (ak.counter.launches, ak.causal_counter.launches, ak.wgmma_counter.launches) == (
        before[0] + 2, before[1] + 2, before[2] + wgmma)
    ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad, off)
    _close(got, ref_out, dtype)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(m, ref_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=1e-5)
    if head:
        assert (m[-1, :, : head - off] == ak.MASK_VALUE).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [128, 256])
def test_bucket_width_cross_matches_plain(card, dtype, s):
    """The encoder cross at the bucket widths 128 and 256 (256 latents, D=128,
    ~30% of keys padded): the forward, its statistics and the backward
    kernels against the plain versions."""
    b, t, h, d = 4, 256, 2, 128
    g = torch.Generator().manual_seed(s + 7)
    q, k, v, go = (torch.randn(b, n, h, d, generator=g).to(card, dtype) for n in (t, s, s, t))
    pad = torch.rand(b, s, generator=g) < 0.3
    pad[:, 0] = False
    pad = pad.to(card)
    out, m, l = ak.attention_fwd_with_stats(q, k, v, pad)
    ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(m, ref_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=1e-5)
    got = ak.attention_bwd(q, k, v, pad, ref_out, ref_m, ref_l, go)
    ref = ak.attention_bwd_reference(q, k, v, pad, ref_out, ref_m, ref_l, go)
    for x, r in zip(got, ref):
        _close(x, r, dtype, BWD_ATOL)


def _causal_counters():
    return (ak.dq_causal_counter, ak.dkv_causal_counter, ak.dq_wgmma_counter,
            ak.dkv_wgmma_counter)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("shape", sorted(CAUSAL_SHAPES))
def test_causal_attention_backward_matches_plain(card, dtype, d, shape):
    """The dq and dk/dv kernels with the causal offset (both designs)
    against the plain backward with the same offset, from the plain
    forward's residuals. Example 0's keys are padded from S/3 on (whole key
    tiles of padding, which the bf16 design skips: every row sees key 0, so
    dk and dv there are exactly 0); in ``visible_all_padding`` the last
    example's rows 0..71 see only padding (their dq exactly 0, and a
    warpgroup of its padded keys runs the full path, as row 0 is dead).
    Each call is one causal launch a kernel, and in bf16 one wgmma launch."""
    b, t, s, h, off, head = CAUSAL_SHAPES[shape]
    g = torch.Generator().manual_seed(t * 1000 + s + d + 11)
    q, k, v, go = (torch.randn(b, n, h, d, generator=g).to(card, dtype) for n in (t, s, s, t))
    pad = torch.rand(b, s, generator=g) < 0.3
    pad[:, 0] = False
    pad[0, s // 3:] = True
    if head:
        pad[-1] = False
        pad[-1, :head] = True
    pad = pad.to(card)
    out, m, l = ak.attention_reference_with_stats(q, k, v, pad, off)
    before = [c.launches for c in _causal_counters()]
    got = ak.attention_bwd(q, k, v, pad, out, m, l, go, causal_offset=off)
    wgmma = int(dtype == torch.bfloat16)
    assert [c.launches - n for c, n in zip(_causal_counters(), before)] == [1, 1, wgmma, wgmma]
    ref = ak.attention_bwd_reference(q, k, v, pad, out, m, l, go, off)
    for x, r in zip(got, ref):
        assert x.shape == r.shape and x.dtype == dtype and x.is_contiguous()
        _close(x, r, dtype, BWD_ATOL)
    dq, dk, dv = got
    assert not dk[0, s // 3:].any() and not dv[0, s // 3:].any()
    if head:
        dead = min(t, head - off)  # the rows whose visible keys are all padding
        assert not dq[-1, :dead].any() and (dead == t or dq[-1, dead:].abs().max() > 0)
        assert dv[-1, :head].abs().max() > 0  # the dead rows' uniform share


def test_causal_attention_under_autograd_raises_on_the_card(card):
    """A causal call under autograd, which raised before the backward
    kernels took the causal offset: ``fused_attention`` launches one causal
    forward, dq and dk/dv (bf16: all wgmma) and gives the gradients of
    ``plain_attention``, which launches nothing, f32 and bf16."""
    counters = (ak.causal_counter, *_causal_counters())
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(5)
        q, k, v, go = (torch.randn(2, n, 2, 64, generator=g).to(card, dtype)
                       for n in (70, 131, 131, 70))
        pad = (torch.rand(2, 131, generator=g) < 0.3).to(card)
        grads = []
        for fn in (ak.fused_attention, ak.plain_attention):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            before = [c.launches for c in counters]
            fn(*leaves, pad, causal_offset=61).backward(go)
            kernel = int(fn is ak.fused_attention)
            wgmma = kernel * int(dtype == torch.bfloat16)
            assert [c.launches - n for c, n in zip(counters, before)] == [kernel] * 3 + [wgmma] * 2
            grads.append([x.grad for x in leaves])
        for got, ref in zip(*grads):
            _close(got, ref, dtype, BWD_ATOL)


def test_ar_train_step_on_the_card_matches_plain(card):
    """One f32 train step of the tiny AR model on the card, with the kernels
    and with the plain versions in their place: the same loss and gradients;
    5 causal forward, 5 causal dq and 5 causal dk/dv launches (2 cross + 2
    self + 1 decode), none in the plain run."""
    from perceiver_io_torch.models.presets import tiny_ar
    from perceiver_io_torch.ops.attention import MultiHeadAttention
    from perceiver_io_torch.training.optim import OptimizerConfig, make_optimizer
    from perceiver_io_torch.training.steps import make_ar_steps
    from perceiver_io_torch.training.train_state import TrainState

    rng = np.random.default_rng(0)
    pad = np.zeros((4, 64), bool)
    pad[1, 40:] = True
    batch = {"token_ids": rng.integers(3, 503, (4, 64)).astype(np.int32), "pad_mask": pad}
    counters = (ak.causal_counter, ak.dq_causal_counter, ak.dkv_causal_counter)
    runs = []
    for plain in (False, True):
        model = tiny_ar(device=card, seed=1)
        if plain:
            for module in model.modules():
                if isinstance(module, MultiHeadAttention):
                    module.attention = ak.plain_attention
        optimizer, schedule = make_optimizer(OptimizerConfig(), model.parameters())
        state = TrainState.create(model, optimizer, schedule, seed=3)
        train_step, _, _ = make_ar_steps(model, schedule)
        before = [c.launches for c in counters]
        _, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [0 if plain else 5] * 3
        runs.append((float(metrics["loss"]),
                     {n: p.grad.detach().clone() for n, p in model.named_parameters()}))
    (loss, grads), (ref_loss, ref_grads) = runs
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, ref in ref_grads.items():
        if not name.endswith("k_proj.bias"):  # zero in exact arithmetic: noise
            assert float((grads[name] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ar_generation_on_the_card(card, dtype):
    """The tiny AR model's generation on the card, across an episode
    boundary (widths 16, 31): every prefill launches 5 causal attention
    kernels, every step 5 non-causal ones (bf16: all wgmma); with the f32
    kernels every step's logits equal the dense forward's within 1e-4 of
    their peak, and the prefill's equal the plain versions' on the card."""
    from perceiver_io_torch.inference.generate import ARGenerator
    from perceiver_io_torch.models.presets import tiny_ar
    from perceiver_io_torch.ops.attention import MultiHeadAttention

    gen = ARGenerator(tiny_ar(device=card, seed=1, dtype=dtype), None, 64, chunk=4,
                      device=card)
    for c in (ak.counter, ak.causal_counter, ak.wgmma_counter):
        c.reset()
    tokens, _ = gen.generate([5, 6, 7, 8, 9, 10, 11, 12, 13, 14], 12)
    assert len(tokens) == 12 and gen.prefills == 2 and gen.steps == 12
    assert (ak.counter.launches, ak.causal_counter.launches) == (5 * 14, 5 * 2)
    assert ak.wgmma_counter.launches == (5 * 14 if dtype == torch.bfloat16 else 0)
    if dtype == torch.bfloat16:
        return
    model = gen.model
    ids = torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12, 13, 14] + [0] * 6], device=card)
    pad = torch.arange(16, device=card)[None, :] >= 10
    with torch.inference_mode():
        logits, cache = model.prefill(ids.clone(), pad, length=10)
        prefix = ids.clone()
        for t in range(6):
            tok = torch.tensor([[t + 20]], device=card)
            step, cache = model.step(cache, tok)
            ids[0, 10 + t] = t + 20
            dense = model(ids, torch.arange(16, device=card)[None, :] >= 11 + t)
            _close(step, dense[:, 10 + t], torch.float32)
        for module in model.modules():
            if isinstance(module, MultiHeadAttention):
                module.attention = ak.attention_reference
        plain, _ = model.prefill(prefix, pad, length=10)
    _close(logits, plain, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [512, 256])
def test_batched_decode_attention_matches_plain(card, dtype, s):
    """#1 at the decode arena's batched step, (64, 1, S, 4, 128) with no
    causal offset: rows 0-47 live up to their own lengths (1 to S keys),
    rows 48-63 zero rings with no padding (the arena's free slots)."""
    b, h, d = 64, 4, 128
    g = torch.Generator().manual_seed(s + 64)
    q = torch.randn(b, 1, h, d, generator=g)
    k = torch.randn(b, s, h, d, generator=g)
    v = torch.randn(b, s, h, d, generator=g)
    live = torch.randint(1, s + 1, (b,), generator=g)
    live[:2] = torch.tensor([1, s])
    pad = torch.arange(s)[None, :] >= live[:, None]
    k[48:], v[48:], pad[48:] = 0.0, 0.0, False
    q, k, v, pad = q.to(card, dtype), k.to(card, dtype), v.to(card, dtype), pad.to(card)
    counters = (ak.counter, ak.wgmma_counter, ak.causal_counter)
    before = [c.launches for c in counters]
    got = ak.fused_attention(q, k, v, pad)
    want = [1, int(dtype == torch.bfloat16), 0]
    assert [c.launches - n for c, n in zip(counters, before)] == want
    _close(got, ak.attention_reference(q, k, v, pad), dtype)
    assert not got[48:].any()  # the zero rings' rows average zero values


@pytest.mark.parametrize("bits,group_size", [(8, None), (4, 128)])
@pytest.mark.parametrize("n", [512, 10003])
@pytest.mark.parametrize("m", [8, 16, 64])
def test_batched_decode_dequant_matches_plain(card, m, n, bits, group_size):
    """#9 at the decode arena's batched step: M = the arena's slots (8, 16,
    64) rows through the K=N=512 projections and the vocab head, bf16."""
    rng = np.random.default_rng(m + n + bits)
    w = rng.normal(size=(512, n)).astype(np.float32)
    qv, scale = quantize_array(w, bits=bits, group_size=group_size)
    q = torch.from_numpy(pack_int4(qv) if bits == 4 else qv).to(card)
    scale = torch.from_numpy(scale).to(card)
    x = torch.from_numpy(rng.normal(size=(m, 512)).astype(np.float32)).to(card, torch.bfloat16)
    before = (qm.counter.launches, qm.wgmma_counter.launches)
    got = qm.dequant_matmul(x, q, scale, bits, group_size)
    assert (qm.counter.launches, qm.wgmma_counter.launches) == (before[0] + 1, before[1] + 1)
    _close(got, qm.dequant_matmul_reference(x, q, scale, bits, group_size), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_continuous_batching_on_the_card(card, dtype):
    """The tiny AR model's continuous batching on the card: 6 concurrent
    streams (greedy and sampled) over 2 slots growing to 4, across the
    16 -> 31 episode boundary, through the dispatcher thread; every batched
    step launches 5 attention kernels and every wave 5 causal ones (bf16:
    all wgmma), and no plain version runs; in f32 each stream equals the
    per-session engine's."""
    import threading

    from perceiver_io_torch.inference.batching import ContinuousBatcher
    from perceiver_io_torch.inference.generate import ARGenerator, SamplingConfig
    from perceiver_io_torch.models.presets import tiny_ar

    model = tiny_ar(device=card, seed=1, dtype=dtype)
    bat = ContinuousBatcher(model, None, 64, chunk=4, slots=2, max_slots=4, device=card)
    cases = [([5 + i, 6, 7, 8, 9][: 2 + i % 4], 8 + 2 * i,
              SamplingConfig(temperature=0.8 * (i % 2), top_k=16, seed=i)) for i in range(6)]
    got, errs = [None] * 6, []

    def one(i):
        try:
            got[i] = bat.generate(*cases[i])[0]
        except Exception as e:  # re-raised below
            errs.append(e)

    for c in (ak.counter, ak.causal_counter, ak.wgmma_counter):
        c.reset()
    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = bat.stats()
    finally:
        bat.close()
    if errs:
        raise errs[0]
    calls = stats["batched_steps"] + stats["waves"]
    assert (ak.counter.launches, ak.causal_counter.launches) == (5 * calls, 5 * stats["waves"])
    assert ak.wgmma_counter.launches == (5 * calls if dtype == torch.bfloat16 else 0)
    assert ak.counter.plain_calls == 0 and stats["slots"] > 4
    assert [len(x) for x in got] == [case[1] for case in cases]
    if dtype == torch.float32:
        gen = ARGenerator(model, None, 64, chunk=4, device=card)
        assert got == [gen.generate(*case)[0] for case in cases]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal_offset", [None, 61])
def test_einsum_attention_matches_kernels_on_the_card(card, dtype, causal_offset):
    """The einsum path (``attn_impl='xla'``) against kernels #1-#3 under
    autograd, every row with a live key (key 0 is never padding): output and
    the three gradients within the tolerance of the dtype (the einsum path
    stores bf16 logits, the kernels keep f32 ones); no kernel launch on the
    einsum side."""
    from perceiver_io_torch.ops import attention as pat
    from perceiver_io_torch.ops.masking import causal_mask

    g = torch.Generator().manual_seed(7)
    b, t, s, h, d = 3, 70, 131, 2, 64
    q, gout = (torch.randn(b, t, h, d, generator=g).to(card, dtype) for _ in range(2))
    k, v = (torch.randn(b, s, h, d, generator=g).to(card, dtype) for _ in range(2))
    pad = torch.rand(b, s, generator=g) < 0.3
    pad[:, 0] = False
    pad = pad.to(card)
    outs = []
    for einsum in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = (ak.counter.launches, ak.dq_counter.launches, pat.xla_counter.calls)
        if einsum:
            cmask = None if causal_offset is None else causal_mask(t, s, causal_offset, card)
            out = pat.dot_product_attention(*leaves, pad, cmask)
        else:
            out = ak.fused_attention(*leaves, pad, causal_offset=causal_offset)
        out.backward(gout)
        torch.cuda.synchronize()
        after = (ak.counter.launches, ak.dq_counter.launches, pat.xla_counter.calls)
        assert [a - b_ for a, b_ in zip(after, before)] == ([0, 0, 1] if einsum else [1, 1, 0])
        outs.append([out.detach()] + [x.grad for x in leaves])
    for kern, ein in zip(*outs):
        _close(ein, kern, dtype)


def test_auto_routes_by_the_rule_on_the_card(card):
    """``MultiHeadAttention`` under ``'auto'`` on the card: a call of 32
    kernel blocks launches #1 (the rule's floor), a call of 8 takes the
    einsum path, and both give the ``'xla'`` module's output."""
    from perceiver_io_torch.ops import attention as pat

    for b, want in ((8, 1), (2, 0)):
        x = torch.randn(b, 64, 64, generator=torch.Generator().manual_seed(b)).to(card)
        outs = {}
        for impl in ("auto", "xla"):
            module = pat.MultiHeadAttention(64, 64, 4, attn_impl=impl)
            for lin in (module.q_proj, module.k_proj, module.v_proj, module.out_proj):
                lin.reset_parameters(torch.Generator().manual_seed(3))
            module.to(card)
            before = ak.counter.launches
            with torch.inference_mode():
                outs[impl] = module(x, x)[0]
            assert ak.counter.launches - before == (want if impl == "auto" else 0)
        _close(outs["auto"], outs["xla"], torch.float32)


def test_dropout_and_remat_on_the_card(card):
    """The tiny MLM with dropout on the card: the masks come from explicit
    CUDA generators seeded by the key, so one key gives one loss twice, and
    remat (the encoder recomputed in the backward) gives the loss and
    gradients of the run without it."""
    from perceiver_io_torch.models.presets import tiny_mlm
    from perceiver_io_torch.training.losses import cross_entropy_with_ignore

    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(3, 503, (4, 64))).to(card)
    pad = torch.zeros(4, 64, dtype=torch.bool, device=card)
    runs = []
    for remat, key in ((False, 11), (False, 11), (True, 11), (False, 12)):
        model = tiny_mlm(device=card, dropout=0.1, remat=remat, num_layers=3)
        out, labels = model(ids, pad, masking=True,
                            generator=torch.Generator(device=card).manual_seed(2),
                            loss_gather_capacity=32, deterministic=False, dropout_key=key)
        loss = cross_entropy_with_ignore(out, labels)
        loss.backward()
        runs.append((float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0] != runs[3][0]
    assert abs(runs[2][0] - runs[0][0]) <= 1e-6 * abs(runs[0][0])
    for name, ref in runs[0][1].items():
        if not name.endswith("k_proj.bias"):  # zero in exact arithmetic: noise
            assert float((runs[2][1][name] - ref).abs().max()) <= 1e-6 * float(
                ref.abs().max()), name


# the classification slice's calls of #1-#3: (B, T, S, H, D), padding
CLASSIFIER_SHAPES = {
    "img_cross": ((128, 32, 784, 4, 32), None),        # MNIST pixels: 784 keys, no pad
    "img_self": ((128, 32, 32, 4, 32), None),
    "text_cross": ((128, 64, 512, 4, 16), "tail"),     # the reference-width text cross
    "decoder_t1_d16": ((128, 1, 64, 4, 16), None),     # one class query
    "decoder_t1_d128": ((128, 1, 256, 4, 128), None),  # the flagship-width transfer decoder
    "decoder_t1_d128_tail": ((128, 1, 256, 4, 128), "tail"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(CLASSIFIER_SHAPES))
def test_classifier_shapes_match_plain(card, dtype, shape):
    """#1 (with and without statistics) and #2/#3 under autograd at the
    classifiers' shapes (one query row in the decoders, 784 unpadded keys in
    the image cross), against the plain versions: one launch of each kernel
    (in bf16 each a wgmma launch); ``tail`` pads each example's keys from a
    random length on, the last example all but one key."""
    (b, t, s, h, d), padding = CLASSIFIER_SHAPES[shape]
    g = torch.Generator().manual_seed(b + t + s + d)
    q, k, v, go = (torch.randn(b, n, h, d, generator=g).to(card, dtype) for n in (t, s, s, t))
    pad = None
    if padding == "tail":
        pad = torch.arange(s)[None, :] >= torch.randint(1, s + 1, (b, 1), generator=g)
        pad[-1, 1:] = True
        pad = pad.to(card)
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter)
    wgmma = (ak.wgmma_counter, ak.dq_wgmma_counter, ak.dkv_wgmma_counter)
    before = [c.launches for c in counters + wgmma]
    _close(ak.fused_attention(q, k, v, pad), ak.attention_reference(q, k, v, pad), dtype)
    out, m, l = ak.attention_fwd_with_stats(q, k, v, pad)
    ref_out, ref_m, ref_l = ak.attention_reference_with_stats(q, k, v, pad)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(m, ref_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, ref_l, rtol=1e-5, atol=1e-5)
    grads = []
    for fn in (ak.fused_attention, ak.plain_attention):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fn(*leaves, pad).backward(go)
        grads.append([x.grad for x in leaves])
    for x, r in zip(*grads):
        assert x.shape == r.shape and x.dtype == dtype
        _close(x, r, dtype, BWD_ATOL)
    launched = [c.launches - n for c, n in zip(counters + wgmma, before)]
    bf16 = dtype == torch.bfloat16
    assert launched == [3, 1, 1] + ([3, 1, 1] if bf16 else [0, 0, 0])


@pytest.mark.parametrize("frozen", [False, True])
def test_classifier_step_on_the_card_matches_plain(card, frozen):
    """One f32 train step of a small image classifier (2 layers × (cross +
    1 self), C=32, 14×14 images) on the card, with the kernels and with the
    plain versions in their place: the same loss and gradients; 5 #1, 5 #2
    and 5 #3 launches, or with the encoder frozen 5 #1 and 1 #2/#3 (the
    decoder's: the encoder records no graph)."""
    import argparse

    from perceiver_io_torch.cli import common
    from perceiver_io_torch.ops.attention import MultiHeadAttention
    from perceiver_io_torch.training.optim import OptimizerConfig, freeze_subtrees, make_optimizer
    from perceiver_io_torch.training.steps import make_classifier_steps
    from perceiver_io_torch.training.train_state import TrainState

    args = argparse.Namespace(dtype="float32", num_latents=32, num_latent_channels=32,
                              num_encoder_layers=2, num_self_attention_layers_per_block=1,
                              num_cross_attention_heads=4, num_self_attention_heads=4,
                              dropout=0.0, attn_impl="pallas", remat=False, no_reuse_kv=False,
                              pad_vocab_multiple=None, seed=1)
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(-1, 1, (8, 14, 14, 1)).astype(np.float32),
             "label": rng.integers(0, 10, 8).astype(np.int32)}
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter)
    runs = []
    for plain in (False, True):
        model = common.build_image_classifier(args, (14, 14, 1), 10, card,
                                              num_frequency_bands=4)
        if plain:
            for module in model.modules():
                if isinstance(module, MultiHeadAttention):
                    module.attention = ak.plain_attention
        params = freeze_subtrees(model, ["encoder"]) if frozen else model.parameters()
        optimizer, schedule = make_optimizer(OptimizerConfig(), params)
        state = TrainState.create(model, optimizer, schedule, seed=3)
        train_step, _ = make_classifier_steps(model, schedule, "image", frozen_encoder=frozen)
        before = [c.launches for c in counters]
        _, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        want = [0, 0, 0] if plain else ([5, 1, 1] if frozen else [5, 5, 5])
        assert [c.launches - b for c, b in zip(counters, before)] == want
        runs.append((float(metrics["loss"]), {n: p.grad.detach().clone()
                                              for n, p in model.named_parameters()
                                              if p.grad is not None}))
    (loss, grads), (ref_loss, ref_grads) = runs
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert sorted(grads) == sorted(ref_grads)
    assert any(n.startswith("encoder.") for n in grads) != frozen
    for name, ref in ref_grads.items():
        if not name.endswith("k_proj.bias"):  # zero in exact arithmetic: noise
            assert float((grads[name] - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


# -- the serving engines' programs (CUDA graphs) --------------------------------


def _tokenizer():
    from perceiver_io_torch.data.imdb import synthetic_reviews
    from perceiver_io_torch.data.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer()
    tok.train_from_iterator(synthetic_reviews(120, seed=1)[0], 300)
    return tok


def _mlm_pass(server, texts):
    """Fills, decode logits and one fused forward's raw logits of ``texts``
    through ``server``; and the #1 / #9 launches and plain calls it made."""
    counters = (ak.counter, qm.counter)
    for c in counters:
        c.reset()
    fills = server.fill_masks(texts, k=3)
    cached = server.encode(texts)
    # K = 4, a warmed query bucket (another K is a program of its own)
    logits = server.decode(cached, np.tile(np.arange(4, dtype=np.int32), (len(texts), 1)))
    ids, pad, pos = server._prepare(texts[0])
    fused = server.engine.predict(ids, pad, server._positions_row(pos, ids.shape[1]))
    torch.cuda.synchronize()
    return (fills, logits, fused.float().cpu(), cached.latents.float().cpu(),
            [c.launches for c in counters], [c.plain_calls for c in counters])


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8w"])
def test_graphed_mlm_families_match_eager_bit_for_bit(card, mode):
    """The tiny MLM server's three families as CUDA graphs against the eager
    path on the same weights, in turns (eager, graphed, eager, graphed):
    fills, decode logits, latents and a fused forward's logits bit for bit,
    and the same #1 and #9 launches (replays add what their capture held);
    after ``warmup`` the passes capture nothing."""
    from perceiver_io_torch.inference.engine import MLMServer
    from perceiver_io_torch.models.presets import tiny_mlm

    from perceiver_io_torch.data.imdb import synthetic_reviews

    model = tiny_mlm(device=card, seed=1)
    tok = _tokenizer()
    texts = [t[: 30 + 11 * i] + " [MASK] " + t[40:60] + " [MASK]" * (1 + i % 3)
             for i, t in enumerate(synthetic_reviews(9, seed=2)[0])]
    kwargs = dict(bucket_widths=[32], max_batch=4, compute_dtype=mode, device=card)
    eager = MLMServer(model, None, tok, 64, graphs=False, **kwargs)
    graphed = MLMServer(model, None, tok, 64, **kwargs)
    n = graphed.warmup()
    assert n == graphed.num_programs() == graphed.programs.captures == 2 * 3 * 3 + 2 * 3 + 3 * 3
    assert graphed.programs.pool_bytes() > 0
    runs = [_mlm_pass(server, texts) for server in (eager, graphed, eager, graphed)]
    assert graphed.programs.captures == n
    for ref, got in ((runs[0], runs[1]), (runs[2], runs[3]), (runs[0], runs[2])):
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
        assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
        assert got[4] == ref[4] and got[5] == ref[5] == [0, 0]
    assert runs[1][4][0] > 0 and (runs[1][4][1] > 0) == (mode == "int8w")


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_decode_matches_eager_bit_for_bit(card, dtype, sampled):
    """``ARGenerator``'s B=1 decode program against the eager chunk, across
    the 16 -> 31 -> 46 episode boundaries: the same tokens, the same final
    logits and rings bit for bit, and the same #1 launches; after
    ``warmup`` (one program a width) the stream captures nothing."""
    from perceiver_io_torch.inference.generate import ARGenerator, SamplingConfig, tree_leaves
    from perceiver_io_torch.models.presets import tiny_ar

    model = tiny_ar(device=card, seed=1, dtype=dtype)
    sampling = SamplingConfig(temperature=0.8 if sampled else 0.0, top_k=16, seed=4)
    graphed = ARGenerator(model, None, 64, chunk=4, device=card)
    eager = ARGenerator(model, None, 64, chunk=4, device=card, graphs=False)
    assert graphed.warmup() == graphed.num_programs() == 5
    runs = []
    for gen in (eager, graphed, eager, graphed):
        for c in (ak.counter, ak.causal_counter):
            c.reset()
        prefills = gen.prefills
        tokens, session = gen.generate([5, 6, 7, 8, 9, 10, 11, 12, 13, 14], 40, sampling)
        torch.cuda.synchronize()
        prefills = gen.prefills - prefills
        runs.append((tokens, session.next_logits.clone(),
                     [x.clone() for x in tree_leaves(session.cache)],
                     ak.counter.launches, ak.causal_counter.launches, prefills))
    assert graphed.programs.captures == 5
    for ref, got in ((runs[0], runs[1]), (runs[2], runs[3])):
        assert got[0] == ref[0] and len(got[0]) == 40
        assert torch.equal(got[1], ref[1])
        assert all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))
        assert got[3:] == ref[3:] == (5 * (40 + ref[5]), 5 * ref[5], ref[5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_batched_step_with_active_matches_eager(card, dtype):
    """The arena's masked program (B=4, one row idle, rows stopping at their
    own step) against ``decode_rows`` over copies of one wave's cache, two
    chunks: tokens, logits and every ring bit for bit; the idle row's rings
    untouched; the replayed chunk's launches equal the eager chunk's."""
    from perceiver_io_torch.inference.generate import (
        DecodeProgram,
        decode_rows,
        tree_leaves,
        tree_map,
    )
    from perceiver_io_torch.inference.programs import ProgramCache
    from perceiver_io_torch.models.presets import tiny_ar

    model = tiny_ar(device=card, seed=1, dtype=dtype).eval()
    g = torch.Generator().manual_seed(3)
    lengths = torch.tensor([5, 9, 12, 7])
    ids = torch.randint(3, 503, (4, 16), generator=g)
    with torch.inference_mode():
        logits, cache = model.prefill(ids.to(card), (torch.arange(16)[None] >= lengths[:, None])
                                      .to(card), length=lengths.to(card))
        nxt = logits[torch.arange(4, device=card), (lengths - 1).to(card)].float()
        eager = (tree_map(torch.clone, cache), nxt.clone())
        static = (tree_map(torch.clone, cache), nxt.clone())
        idle = [x[2].clone() for x in tree_leaves(cache) if x.ndim > 1]
        dec = DecodeProgram(model, *static, 4, ProgramCache(card), ("decode", 16, 4, True),
                            masked=True)
        sampling = ([0.0, 0.8, 0.0, 0.8], [0, 16, 0, 16], [1, 2, 3, 4])
        pos = lengths.tolist()
        for steps in ([3, 2, 0, 1], [1, 3, 0, 2]):
            ak.counter.reset()
            want = decode_rows(model, *eager, steps, pos, *sampling)
            torch.cuda.synchronize()
            eager_launches = ak.counter.launches
            ak.counter.reset()
            got = dec.run(steps, pos, *sampling)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and (got[2] == -1).all()
            assert ak.counter.launches == eager_launches == 5 * max(steps)
            assert torch.equal(static[1], eager[1])
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(static[0]),
                                                         tree_leaves(eager[0])))
            pos = [p + k for p, k in zip(pos, steps)]
        assert all(torch.equal(x[2], ref) for x, ref in
                   zip([x for x in tree_leaves(static[0]) if x.ndim > 1], idle))
        assert dec.programs.captures == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_arena_matches_eager_arena(card, dtype):
    """``ContinuousBatcher``'s programs against its eager chunk: 6 concurrent
    streams (greedy and sampled) over 8 slots give the same tokens; after
    ``warmup`` the graphed run captures nothing, and its launches are 5 #1
    a batched step and 5 causal a wave."""
    import threading

    from perceiver_io_torch.inference.batching import ContinuousBatcher
    from perceiver_io_torch.inference.generate import SamplingConfig
    from perceiver_io_torch.models.presets import tiny_ar

    model = tiny_ar(device=card, seed=1, dtype=dtype)
    cases = [([5 + i, 6, 7, 8, 9][: 2 + i % 4], 8 + 2 * i,
              SamplingConfig(temperature=0.8 * (i % 2), top_k=16, seed=i)) for i in range(6)]
    runs = []
    for graphs in (False, True):
        bat = ContinuousBatcher(model, None, 64, chunk=4, slots=8, max_slots=8, device=card,
                                graphs=graphs)
        try:
            assert bat.warmup() == (5 if graphs else len(bat.widths))
            captures = bat.programs.captures if graphs else 0
            before = bat.stats()
            for c in (ak.counter, ak.causal_counter):
                c.reset()
            got, errs = [None] * 6, []

            def one(i):
                try:
                    got[i] = bat.generate(*cases[i])[0]
                except Exception as e:  # re-raised below
                    errs.append(e)

            threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errs:
                raise errs[0]
            after = bat.stats()
            calls = (after["batched_steps"] - before["batched_steps"]
                     + after["waves"] - before["waves"])
            assert ak.counter.launches == 5 * calls
            assert ak.causal_counter.launches == 5 * (after["waves"] - before["waves"])
            if graphs:
                assert bat.programs.captures == captures
            runs.append(got)
        finally:
            bat.close()
    assert runs[0] == runs[1] and [len(x) for x in runs[1]] == [case[1] for case in cases]


def test_arena_drop_programs_then_plain_kernels_launch_nothing(card):
    """A graphed batcher's ``drop_programs`` takes its arenas' programs with
    it: once the plain versions are in the kernels' place, the next chunk
    captures again and neither its capture nor its replays launch #1."""
    from perceiver_io_torch.inference.batching import ContinuousBatcher
    from perceiver_io_torch.inference.generate import SamplingConfig
    from perceiver_io_torch.models.presets import tiny_ar
    from perceiver_io_torch.ops.attention import MultiHeadAttention

    model = tiny_ar(device=card, seed=1, dtype=torch.float32)
    bat = ContinuousBatcher(model, None, 64, chunk=4, slots=2, max_slots=2, device=card)
    try:
        case = ([5, 6, 7], 8, SamplingConfig())
        ak.counter.reset()
        bat.generate(*case)
        assert bat.num_programs() == 1 and ak.counter.launches > 0
        for module in bat.model.modules():
            if isinstance(module, MultiHeadAttention):
                module.attention = ak.attention_reference
        assert bat.drop_programs() == 1 and bat.num_programs() == 0
        ak.counter.reset()
        assert len(bat.generate(*case)[0]) == 8
        assert bat.num_programs() == 1 and bat.programs.captures == 2
        assert ak.counter.launches == 0
    finally:
        bat.close()


def test_failed_capture_raises_and_keeps_nothing(card):
    """A function that reads the card back inside its capture makes the
    program's build raise on CUDA (no eager fallback) and leaves no
    program; the card and the cache go on working, also after every program
    was dropped (the cache then records into a new pool)."""
    from perceiver_io_torch.inference.programs import ProgramCache

    cache = ProgramCache(card)
    x = torch.ones(4, device=card)
    with pytest.raises(RuntimeError):
        cache.build("sync", lambda a: a * float(a.sum().item()), [x])
    assert cache.num_programs() == 0 and cache.captures == 0
    prog = cache.build("double", lambda a: a * 2, [x.clone()])
    assert torch.equal(prog.run(x + 1), (x + 1) * 2) and prog.graph is not None
    del prog
    assert cache.drop() == 1
    prog = cache.build("triple", lambda a: a * 3, [x.clone()])
    assert torch.equal(prog.run(x + 2), (x + 2) * 3) and cache.captures == 2
