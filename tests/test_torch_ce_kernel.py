"""The port's fused CE module (perceiver_io_torch/ops/ce_kernel.py) against the
JAX package's Pallas CE (ops/pallas_ce.py, interpret mode on the CPU): the
plain versions of the CUDA kernels, which the wrappers run on CPU tensors,
must compute what the Pallas kernels compute — loss and lse of the forward,
dx, dW and db of the backward through ``jax.vjp`` with a random cotangent —
with the JAX side padding rows (R = 37 at a 16-row block) and vocab (V = 503
at a 128-column block), some rows ignored (label 0, cotangent 0), and an
all-ignored batch (loss 0, zero gradients).

Tolerances: f32 within 2e-5; bf16 x with f32 W: the loss within 1e-3
relative and each gradient within 2e-2 of its peak (bf16 rounds the product's
operands and d at the same points on both sides, the sums run in another
order). Also: ``FusedLinearCE`` against finite differences in f64, the fused
head against the unfused f32 head, the padded head of ``masked_head``, the
chunked plain-PyTorch head against the JAX chunked head, the wrappers'
counting and validation, and the exactness the bf16 backward's skipping of
64-row tiles whose cotangents are all 0 relies on (rows with g = 0 add
exactly nothing, in the Pallas backward too), at random and in the training
path's gathered layout, and that a step makes the bf16 kernels' round(W)^T
once and hands it from the forward to the backward. The CUDA kernels
themselves run only on the card:
tests/test_torch_cuda.py holds them against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.ops import pallas_ce
from perceiver_io_tpu.training import losses as jlosses
from perceiver_io_torch.models.adapters import TextOutputAdapter
from perceiver_io_torch.ops import ce_kernel as ck
from perceiver_io_torch.ops.masking import IGNORE_LABEL
from perceiver_io_torch.training import losses

R, C, V = 37, 32, 503
R_BLOCK, V_BLOCK = 16, 128


def _inputs(seed, r=R, c=C, v=V, ignored=0.2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r, c)).astype(np.float32)
    w = rng.normal(0, 0.2, size=(c, v)).astype(np.float32)
    b = rng.normal(0, 0.1, size=v).astype(np.float32)
    labels = rng.integers(0, v, r).astype(np.int32)
    valid = rng.random(r) >= ignored
    g = np.where(valid, rng.normal(size=r), 0.0).astype(np.float32)
    return x, w, b, np.where(valid, labels, 0).astype(np.int32), g


def _jax_fwd(x, w, b, labels):
    """loss and lse of the Pallas forward, with the padding
    ``pallas_linear_ce_integer`` applies."""
    wp, bp = pallas_ce._pad_inputs(jnp.asarray(w), jnp.asarray(b), V_BLOCK)
    r_pad = -x.shape[0] % R_BLOCK
    xp = jnp.pad(jnp.asarray(x), ((0, r_pad), (0, 0)))
    lp = jnp.pad(jnp.asarray(labels), (0, r_pad))
    loss, lse = pallas_ce._fused_ce_fwd_impl(xp, wp, bp, lp, R_BLOCK, V_BLOCK, True)
    return np.asarray(loss)[:x.shape[0]], np.asarray(lse)[:x.shape[0], 0]


def _jax_grads(x, w, b, labels, g):
    def f(xj, wj, bj):
        return pallas_ce.pallas_linear_ce_integer(xj, wj, bj, jnp.asarray(labels),
                                                  r_block_size=R_BLOCK,
                                                  v_block_size=V_BLOCK, interpret=True)

    _, vjp = jax.vjp(f, x, jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(t, np.float32) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("ignored", [0.2, 1.0])
def test_plain_kernels_match_pallas_f32(ignored):
    x, w, b, labels, g = _inputs(0, ignored=ignored)
    tx, tw, tb, tl, tg = (torch.from_numpy(a) for a in (x, w, b, labels, g))
    loss, lse = ck.linear_ce_fwd(tx, tw, tb, tl)
    jloss, jlse = _jax_fwd(x, w, b, labels)
    assert loss.dtype == lse.dtype == torch.float32 and loss.shape == (R,)
    np.testing.assert_allclose(loss.numpy(), jloss, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=2e-5, rtol=2e-5)
    dx = ck.linear_ce_bwd_dx(tx, tw, tb, tl, lse, tg)
    dw, db = ck.linear_ce_bwd_dw(tx, tw, tb, tl, lse, tg)
    for got, ref in zip((dx, dw, db), _jax_grads(jnp.asarray(x), w, b, labels, g)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
    if ignored == 1.0:  # every cotangent 0: every gradient exactly 0
        assert not dx.any() and not dw.any() and not db.any()


def test_plain_kernels_match_pallas_bf16():
    """bf16 x over f32 W: W and d rounded to bf16 before each product on
    both sides; dx in bf16, dW and db in f32."""
    x, w, b, labels, g = _inputs(1)
    xb = torch.from_numpy(x).bfloat16()
    tw, tb, tl, tg = (torch.from_numpy(a) for a in (w, b, labels, g))
    jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    loss, lse = ck.linear_ce_fwd(xb, tw, tb, tl)
    jloss, jlse = _jax_fwd(jx, w, b, labels)
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=1e-3)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-3)
    dx = ck.linear_ce_bwd_dx(xb, tw, tb, tl, lse, tg)
    dw, db = ck.linear_ce_bwd_dw(xb, tw, tb, tl, lse, tg)
    assert dx.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    for got, ref in zip((dx, dw, db), _jax_grads(jx, w, b, labels, g)):
        peak = float(np.abs(ref).max())
        assert float(np.abs(got.float().numpy() - ref).max()) <= 2e-2 * peak


@pytest.mark.parametrize("ignored", ["some", "all"])
def test_mean_loss_with_ignore_matches_jax(ignored):
    """``pallas_linear_cross_entropy_with_ignore`` over (B, K, C) features,
    value and gradients by autograd against ``jax.value_and_grad``; an
    all-ignored batch gives 0 and zero gradients on both sides."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 13, C)).astype(np.float32)
    w = rng.normal(0, 0.2, size=(C, V)).astype(np.float32)
    b = rng.normal(0, 0.1, size=V).astype(np.float32)
    labels = rng.integers(0, V, (3, 13)).astype(np.int32)
    labels[rng.random((3, 13)) < (1.1 if ignored == "all" else 0.3)] = IGNORE_LABEL
    jval, jgrads = jax.value_and_grad(jlosses.pallas_linear_cross_entropy_with_ignore,
                                      argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(labels))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    before = [c.plain_calls for c in (ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)]
    loss = losses.pallas_linear_cross_entropy_with_ignore(*leaves, torch.from_numpy(labels))
    loss.backward()
    after = [c.plain_calls for c in (ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    np.testing.assert_allclose(loss.item(), float(jval), atol=2e-5, rtol=2e-5)
    for leaf, ref in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    if ignored == "all":
        assert loss.item() == 0.0 and not any(leaf.grad.any() for leaf in leaves)


def test_fused_linear_ce_gradcheck_f64():
    x, w, b, labels, _ = _inputs(3, r=6, c=8, v=11)
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (x, w, b)]
    tl = torch.from_numpy(labels)
    for plain in (False, True):
        assert torch.autograd.gradcheck(
            lambda *t: ck.FusedLinearCE.apply(*t, tl, plain), leaves, fast_mode=True)


def test_fused_head_equals_unfused_f32_head():
    """f32: the plain fused head and ``softmax_ce_integer`` of the
    materialized logits agree on values and on all three gradients."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, C)).astype(np.float32)
    w = rng.normal(0, 0.2, size=(C, V)).astype(np.float32)
    b = rng.normal(0, 0.1, size=V).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, V, (2, 9)))
    cot = torch.from_numpy(rng.normal(size=(2, 9)).astype(np.float32))
    results = []
    for fused in (True, False):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
        if fused:
            out = ck.linear_ce_integer(*leaves, labels)
        else:
            out = losses.softmax_ce_integer(leaves[0] @ leaves[1] + leaves[2], labels)
        assert out.shape == labels.shape and out.dtype == torch.float32
        out.backward(cot)
        results.append([out.detach()] + [t.grad for t in leaves])
    for got, ref in zip(*results):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)


def test_masked_head_pads_the_vocab_as_jax():
    """pad_classes_to=128: the padded columns carry bias -1e9, and the fused
    loss through ``masked_head`` equals the unfused loss of the adapter's
    -1e30-pinned logits, values and gradients."""
    adapter = TextOutputAdapter(200, 8, num_output_channels=16, pad_classes_to=128)
    adapter.linear.reset_parameters(torch.Generator().manual_seed(0))
    kernel, bias = adapter.masked_head()
    assert kernel.shape == (16, 256) and bias.shape == (256,)
    assert (bias[200:] == -1e9).all() and torch.equal(bias[:200], adapter.linear.bias[:200])
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 200, (2, 8)))
    labels[0, :3] = IGNORE_LABEL
    results = []
    for fused in (True, False):
        adapter.zero_grad()
        if fused:
            loss = losses.pallas_linear_cross_entropy_with_ignore(x, *adapter.masked_head(),
                                                                  labels)
        else:
            loss = losses.cross_entropy_with_ignore(adapter(x), labels)
        loss.backward()
        results.append([loss.detach(), adapter.linear.kernel.grad.clone(),
                        adapter.linear.bias.grad.clone()])
    for got, ref in zip(*results):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=2e-5)
    assert not results[0][2][200:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_head_matches_jax(dtype):
    """The chunked plain-PyTorch head (the JAX ``fused_head=True``) against
    ``fused_linear_ce_integer`` at chunk 128 (V = 503 padded with bias -1e9):
    values and gradients, f32 at 2e-5, bf16 features within 2e-2 of each
    gradient's peak."""
    x, w, b, labels, g = _inputs(6, r=20)
    x, labels, g = x.reshape(4, 5, C), labels.reshape(4, 5), g.reshape(4, 5)
    jx = jnp.asarray(x, dtype)
    jval, vjp = jax.vjp(lambda *a: jlosses.fused_linear_ce_integer(*a, jnp.asarray(labels),
                                                                    128),
                        jx, jnp.asarray(w), jnp.asarray(b))
    jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype)),
              torch.from_numpy(w), torch.from_numpy(b)]
    leaves = [t.requires_grad_(True) for t in leaves]
    val = losses.fused_linear_ce_integer(*leaves, torch.from_numpy(labels), chunk=128)
    val.backward(torch.from_numpy(g))
    assert val.dtype == torch.float32 and leaves[0].grad.dtype == leaves[0].dtype
    tol = 2e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), atol=tol, rtol=tol)
    for leaf, ref in zip(leaves, jgrads):
        ref = np.asarray(ref, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=2e-5, rtol=2e-5)
        else:
            peak = float(np.abs(ref).max())
            assert float(np.abs(leaf.grad.float().numpy() - ref).max()) <= 2e-2 * peak


def test_wrappers_count_plain_calls_and_validate():
    x, w, b, labels, g = (torch.from_numpy(a) for a in _inputs(7, r=5, c=8, v=11))
    counters = (ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)
    before = [(c.launches, c.plain_calls) for c in counters]
    _, lse = ck.linear_ce_fwd(x, w, b, labels)
    ck.linear_ce_bwd_dx(x, w, b, labels, lse, g)
    ck.linear_ce_bwd_dw(x, w, b, labels, lse, g)
    assert [(c.launches, c.plain_calls) for c in counters] == [(n, p + 1) for n, p in before]
    with torch.no_grad():  # no autograd recording: the forward alone
        ck.linear_ce_integer(x.requires_grad_(True), w, b, labels)
    assert [c.plain_calls for c in counters] == [before[0][1] + 2, before[1][1] + 1,
                                                 before[2][1] + 1]
    with pytest.raises(ValueError, match="do not match"):
        ck.linear_ce_fwd(x, w[:4], b, labels)
    with pytest.raises(ValueError, match="disagree"):
        ck.linear_ce_integer(x, w, b, labels[:3])
    # a tensor off the CPU takes the kernel path, which checks before it builds
    wide = torch.empty(4, 520, device="meta")
    with pytest.raises(ValueError, match="multiple of 8 up to 512"):
        ck.linear_ce_fwd(wide, torch.empty(520, 11, device="meta"),
                         torch.empty(11, device="meta"),
                         torch.zeros(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="no CE kernel for device meta"):
        ck.linear_ce_fwd(x.to("meta"), w.to("meta"), b.to("meta"), labels.to("meta"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_ce_makes_the_bf16_weight_once_a_step(monkeypatch, dtype):
    """A ``FusedLinearCE`` forward and backward through the kernels' path
    (meta tensors take it on the CPU; stand-in launches record the Wt each
    kernel is handed): in bf16 (the wgmma design) round(W)^T is made once, in
    the forward, and the forward, dx and dW/db launches all get that one
    tensor; in f32 (the scalar design) none is made and each gets None.
    Without autograd, the forward makes its own."""
    made, handed = [], {}
    round_weight_t = ck.round_weight_t

    def counted(w):
        made.append(round_weight_t(w))
        return made[-1]

    def fwd(x, w, b, labels, wt=None):
        handed["fwd"] = wt
        return torch.empty(x.shape[0], device=x.device), torch.empty(x.shape[0], device=x.device)

    def dx(x, w, b, labels, lse, g, wt=None):
        handed["dx"] = wt
        return torch.empty_like(x)

    def dw(x, w, b, labels, lse, g, wt=None):
        handed["dw"] = wt
        return torch.empty_like(w), torch.empty_like(b)

    for name, fn in (("round_weight_t", counted), ("launch_fwd", fwd), ("launch_bwd_dx", dx),
                     ("launch_bwd_dw", dw)):
        monkeypatch.setattr(ck, name, fn)
    x = torch.empty(37, 64, dtype=dtype, device="meta", requires_grad=True)
    w = torch.empty(64, 11, device="meta", requires_grad=True)
    b = torch.empty(11, device="meta", requires_grad=True)
    labels = torch.zeros(37, dtype=torch.int64, device="meta")
    ck.linear_ce_integer(x, w, b, labels).sum().backward()
    assert sorted(handed) == ["dw", "dx", "fwd"]
    if dtype == torch.bfloat16:
        assert len(made) == 1 and made[0].shape == (11, 64)
        assert all(wt is made[0] for wt in handed.values())
    else:
        assert not made and all(wt is None for wt in handed.values())
    assert x.grad.shape == x.shape and w.grad.shape == w.shape and b.grad.shape == b.shape
    with torch.no_grad():
        ck.linear_ce_integer(x, w, b, labels)
    assert len(made) == (2 if dtype == torch.bfloat16 else 0)
    assert handed["fwd"] is (made[-1] if made else None)


GATHERED_COUNTS = [40, 3, 0, 0, 0, 17, 0, 0, 1, 0]


def _gathered(counts, capacity, seed, c=C, v=V, dtype=torch.float32):
    """The fused head's inputs in the training path's layout: each example's
    ``counts[e]`` live rows first among its ``capacity`` (the gather's
    order), g = 1/live there and 0 on the rest, whose labels are 0."""
    rng = np.random.default_rng(seed)
    r = len(counts) * capacity
    live = (np.arange(capacity)[None, :] < np.asarray(counts)[:, None]).reshape(-1)
    x = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(0, 0.2, size=(c, v)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, size=v).astype(np.float32))
    labels = torch.from_numpy(np.where(live, rng.integers(0, v, r), 0).astype(np.int32))
    g = torch.from_numpy((live / max(live.sum(), 1)).astype(np.float32))
    return x, w, b, labels, g, torch.from_numpy(live)


@pytest.mark.parametrize("layout", ["random", "gathered"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_with_zero_cotangent_add_exactly_nothing(layout, dtype):
    """What the bf16 backward's skip relies on: the rows whose g is 0 alone
    give dx, dW and db exactly 0 (d = (p - onehot) * 0), so a 64-row tile
    of them may go unread; over the whole batch dW and db equal those of
    the live rows alone up to the order of the sums (f64: 1e-12 of each
    peak), and dx is exactly 0 on the dead rows and equals the live rows'
    own dx there. ``gathered``: 10 examples at capacity 40 with 40, 3, 0,
    0, 0, 17, 0, 0, 1 and 0 live rows, so 4 of the 7 64-row tiles hold no
    live row."""
    if layout == "random":
        x, w, b, labels, g = (torch.from_numpy(a) for a in _inputs(9, r=200, ignored=0.6))
        x = x.to(dtype)
        live = g != 0
    else:
        x, w, b, labels, g, live = _gathered(GATHERED_COUNTS, 40, 10, dtype=dtype)
    _, lse = ck.linear_ce_fwd_reference(x, w, b, labels)
    dx, dw, db = ck.linear_ce_bwd_reference(x, w, b, labels, lse, g)
    dead = ~live
    zero = ck.linear_ce_bwd_reference(x[dead], w, b, labels[dead], lse[dead], g[dead])
    assert all(not t.any() for t in zero)
    assert not dx[dead].any()
    alone = ck.linear_ce_bwd_reference(x[live], w, b, labels[live], lse[live], g[live])
    assert torch.equal(dx[live], alone[0])
    for got, ref in zip((dw, db), alone[1:]):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    x64 = x.double()  # f64: the same sums in another order agree to rounding
    _, lse64 = ck.linear_ce_fwd_reference(x64, w.double(), b.double(), labels)
    full = ck.linear_ce_bwd_reference(x64, w.double(), b.double(), labels, lse64, g.double())
    part = ck.linear_ce_bwd_reference(x64[live], w.double(), b.double(), labels[live],
                                      lse64[live], g[live].double())
    for got, ref in zip(full[1:], part[1:]):
        assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    if layout == "gathered":  # whole 64-row tiles without a live row
        tiles = torch.nn.functional.pad(live, (0, -len(live) % 64)).view(-1, 64)
        assert (~tiles.any(1)).tolist() == [False, True, True, False, True, False, True]


def test_zero_cotangent_rows_add_nothing_in_pallas():
    """The same on the JAX side: the Pallas backward over the dead rows
    alone (every g 0) gives exactly zero dx, dW and db."""
    x, w, b, labels, g, live = _gathered(GATHERED_COUNTS, 40, 11, c=32, v=503)
    dead = (~live).numpy()
    grads = _jax_grads(jnp.asarray(x.numpy()[dead]), w.numpy(), b.numpy(),
                       labels.numpy()[dead], g.numpy()[dead])
    assert all(not np.any(t) for t in grads)
