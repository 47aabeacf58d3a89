"""The port's Perceiver-AR training slice against the JAX package, on the CPU
(the kernels' plain versions; the JAX side runs its Pallas kernels in
interpret mode), f32:

- ``shift_ar_labels`` against the JAX function at offsets 0, 2 and L - N,
  with and without a pad mask;
- the causal backward: the plain statistics and (dq, dk, dv) with
  ``causal_offset`` against the Pallas forward with_lse and backward at
  blocks smaller than T and S (so the global-row index is exercised), offsets
  0, S - T and a ragged S - T - 1, masks none, padded, a fully padded
  example and left padding (early rows see only padding, later rows are
  live), 1e-5; autograd through ``fused_attention(causal_offset=o)`` against
  ``jax.grad`` of the Pallas ``fused_attention``, 1e-5; an f64 gradcheck;
- the AR train step: ``tiny_ar`` with the JAX weights carried over, a
  right-padded batch, ``latent_offset`` None and explicit, against
  ``jax.value_and_grad`` of the JAX package's composition (``model.apply``,
  ``shift_ar_labels``, ``cross_entropy_with_ignore``) with ``attn_impl``
  ``'xla'`` and ``'pallas'`` (interpret mode): loss 2e-5, every gradient
  leaf 1e-4 of its peak (``k_proj.bias``, zero by symmetry, against the
  other gradients' scale); three Adam steps of ``train_step`` against the
  JAX ``make_ar_steps``' within 1e-4 relative; the causal calls of one step
  at the flagship depth.

The CLI, ``cli/train_ar.py``, is in tests/test_torch_ar_cli.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.models import presets as jpresets
from perceiver_io_tpu.ops.masking import shift_ar_labels as jax_shift_ar_labels
from perceiver_io_tpu.ops.pallas_attention import (
    _fused_attention_bwd_impl,
    _fused_attention_fwd_impl,
)
from perceiver_io_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import losses as jlosses
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training.steps import make_ar_steps as jax_make_ar_steps
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.models import presets
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops.masking import IGNORE_LABEL, shift_ar_labels
from perceiver_io_torch.training import make_ar_steps, optim
from perceiver_io_torch.training.train_state import TrainState

TOL = dict(atol=1e-5, rtol=1e-5)
B, L, VOCAB = 4, 48, 503


# -- shift_ar_labels ----------------------------------------------------------------


@pytest.mark.parametrize("with_pad", [False, True])
@pytest.mark.parametrize("offset", [0, 2, L - 16])
def test_shift_ar_labels_matches_jax(offset, with_pad):
    rng = np.random.default_rng(offset)
    ids = rng.integers(3, VOCAB, (B, L)).astype(np.int32)
    pad = None
    if with_pad:
        pad = np.zeros((B, L), bool)
        pad[1, 30:] = True
        pad[2, 40:] = True
    got = shift_ar_labels(torch.from_numpy(ids), None if pad is None else torch.from_numpy(pad),
                          offset)
    ref = np.asarray(jax_shift_ar_labels(jnp.asarray(ids), None if pad is None else
                                         jnp.asarray(pad), offset))
    assert got.dtype == torch.int64 and got.shape == (B, L - offset)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got[:, -1] == IGNORE_LABEL).all()  # the last position has no successor
    np.testing.assert_array_equal(got[0, :-1].numpy(), ids[0, offset + 1:])


# -- the causal backward ------------------------------------------------------------


def _bhtd(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))


def _causal_inputs(seed, b, t, s, h, d, offset, mask):
    """q, k, v, g and the pad mask; ``left`` pads the last example's first
    offset + 4 keys, so its rows 0..3 see only padding and the rest are
    live; ``full`` pads every key of the last example."""
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(2))
    pad = None
    if mask != "none":
        pad = rng.random((b, s)) < 0.3
        pad[:, 0] = False
        if mask == "full":
            pad[-1] = True
        elif mask == "left":
            pad[-1] = False
            pad[-1, : offset + 4] = True
    return q, k, v, g, pad


def _jax_bias(pad, b, s):
    return jnp.zeros((b, s), jnp.float32) if pad is None else jnp.where(
        jnp.asarray(pad), ak.MASK_VALUE, 0.0).astype(jnp.float32)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("mask", ["none", "pad", "full", "left"])
@pytest.mark.parametrize("offset", ["zero", "s_minus_t", "ragged"])
@pytest.mark.parametrize("t,s,d,t_blk,s_blk", [(16, 24, 8, 8, 8), (12, 40, 16, 4, 8)])
def test_plain_causal_backward_matches_pallas(mask, offset, t, s, d, t_blk, s_blk):
    """m, l and (dq, dk, dv) of the plain versions with ``causal_offset``
    against the Pallas forward with_lse and the Pallas backward in interpret
    mode, each side from its own residuals, at blocks smaller than T and S.
    Rows that see only padding have dq exactly 0; a padded key that only
    such rows see has dk exactly 0 and dv their uniform share."""
    off = {"zero": 0, "s_minus_t": s - t, "ragged": s - t - 1}[offset]
    b = 3
    q, k, v, g, pad = _causal_inputs(t * s + off, b, t, s, 2, d, off, mask)
    bias = _jax_bias(pad, b, s)
    jq, jk, jv, jg = (_bhtd(x) for x in (q, k, v, g))
    jout, jm, jl = _fused_attention_fwd_impl(jq, jk, jv, bias, t_blk, s_blk, True,
                                             with_lse=True, causal_offset=off)
    jdq, jdk, jdv = _fused_attention_bwd_impl(jq, jk, jv, bias, jout, jm, jl, jg,
                                              t_blk, s_blk, True, causal_offset=off)
    tq, tk, tv, tpad, tg = _torch(q, k, v, pad, g)
    out, m, l = ak.attention_fwd_with_stats(tq, tk, tv, tpad, causal_offset=off)
    np.testing.assert_allclose(out.numpy(), np.asarray(_bhtd(jout)), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[..., 0], **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[..., 0], **TOL)
    before = (ak.dq_causal_counter.plain_calls, ak.dkv_causal_counter.plain_calls)
    grads = ak.attention_bwd(tq, tk, tv, tpad, out, m, l, tg, causal_offset=off)
    assert (ak.dq_causal_counter.plain_calls, ak.dkv_causal_counter.plain_calls) == (
        before[0] + 1, before[1] + 1)
    for got, ref in zip(grads, (jdq, jdk, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(_bhtd(ref)), **TOL)
    dq, dk, dv = grads
    if mask == "full":
        assert not dq[-1].any() and not dk[-1].any() and dv[-1].abs().max() > 0
    if mask == "left":
        assert (m[-1, :, :4] == ak.MASK_VALUE).all() and (m[-1, :, 4:] > -1e29).all()
        assert not dq[-1, :4].any() and dq[-1, 4:].abs().max() > 0
        # key 0 is padded: the live rows give it p = 0, the dead rows their share
        assert not dk[-1, 0].any() and dv[-1, 0].abs().max() > 0


CAUSAL_AUTOGRAD = {  # name: (b, t, s, d, offset, mask)
    "window_cross": (2, 5, 16, 8, 11, "pad"),
    "square_self": (2, 16, 16, 8, 0, "pad"),
    "ragged": (2, 7, 13, 16, 5, "none"),
    "left_padded": (3, 12, 20, 8, 8, "left"),
    "fully_padded": (3, 9, 20, 8, 11, "full"),
}


@pytest.mark.parametrize("name", sorted(CAUSAL_AUTOGRAD))
def test_causal_autograd_matches_jax_grad(name):
    """torch.autograd through ``fused_attention(causal_offset=o)`` (the plain
    versions on the CPU) against ``jax.grad`` through the Pallas
    ``fused_attention`` with the same offset, interpret mode, at 1e-5."""
    b, t, s, d, off, mask = CAUSAL_AUTOGRAD[name]
    q, k, v, w, pad = _causal_inputs(t * s + d, b, t, s, 2, d, off, mask)
    jpad = None if pad is None else jnp.asarray(pad)

    def jloss(jq, jk, jv):
        out = jax_fused_attention(jq, jk, jv, jpad, interpret=True, causal_offset=off)
        return jnp.sum(out * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [x.requires_grad_(True) for x in _torch(q, k, v)]
    tpad = None if pad is None else torch.from_numpy(pad)
    before = (ak.causal_counter.plain_calls, ak.dq_causal_counter.plain_calls,
              ak.dkv_causal_counter.plain_calls)
    (ak.fused_attention(*leaves, tpad, causal_offset=off) * torch.from_numpy(w)).sum().backward()
    assert (ak.causal_counter.plain_calls, ak.dq_causal_counter.plain_calls,
            ak.dkv_causal_counter.plain_calls) == tuple(n + 1 for n in before)
    for leaf, ref in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("offset", [0, 4])
def test_causal_fused_attention_gradcheck_f64(offset):
    """The causal plain backward against finite differences (f64), on
    inputs where every row sees a valid key (key 0 is never padded)."""
    q, k, v, _, pad = _causal_inputs(11 + offset, 2, 7, 11, 2, 8, offset, "pad")
    leaves = [torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v)]
    tpad = torch.from_numpy(pad)
    for fn in (ak.fused_attention, ak.plain_attention):
        assert torch.autograd.gradcheck(lambda *x: fn(*x, tpad, causal_offset=offset), leaves,
                                        fast_mode=True)


# -- the train step -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX ``tiny_ar``'s weights (numpy leaves)."""
    ids = np.zeros((1, 64), np.int32)
    params = jax.jit(jpresets.tiny_ar(dtype=jnp.float32, attn_impl="xla").init)(
        {"params": jax.random.key(0)}, ids, ids == 0)["params"]
    return jax.tree.map(np.asarray, params)


def _batch():
    """Right-padded token ids: example 1 from 30 on, example 3 from 20 on
    (its whole latent window is padding)."""
    rng = np.random.default_rng(3)
    ids = rng.integers(3, VOCAB, (B, L)).astype(np.int32)
    pad = np.zeros((B, L), bool)
    pad[1, 30:] = True
    pad[3, 20:] = True
    ids[pad] = 0
    return {"token_ids": ids, "pad_mask": pad}


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_state(config=None):
    model = from_jax_params(presets.tiny_ar(device="cpu"), _params())
    optimizer, schedule = optim.make_optimizer(config or optim.OptimizerConfig(),
                                               model.parameters())
    return model, TrainState.create(model, optimizer, schedule, seed=2), schedule


@pytest.mark.parametrize("latent_offset", [None, 36])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_ar_train_step_loss_and_gradients_match_jax(jax_impl, latent_offset):
    jmodel = jpresets.tiny_ar(dtype=jnp.float32, attn_impl=jax_impl)
    batch = _batch()
    ids, pad = jnp.asarray(batch["token_ids"]), jnp.asarray(batch["pad_mask"])

    def jloss(p):  # the JAX package's make_ar_steps loss, as a function of the params
        logits = jmodel.apply({"params": p}, ids, pad, latent_offset=latent_offset)
        o = L - logits.shape[1] if latent_offset is None else latent_offset
        return jlosses.cross_entropy_with_ignore(logits, jax_shift_ar_labels(ids, pad, o))

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, _params()))
    model, state, _ = _port_state()
    train_step, eval_step, predict_fn = make_ar_steps(model, latent_offset=latent_offset)
    _, metrics = train_step(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jval), rtol=2e-5, atol=2e-5)
    jflat = _flat(jgrads)
    peak_all = max(float(np.abs(g).max()) for g in jflat.values())
    for name, p in model.named_parameters():
        ref = jflat[name.replace(".", "/")]
        got = p.grad.numpy()
        if name.endswith("k_proj.bias"):
            # zero in exact arithmetic (softmax is shift-invariant per row):
            # rounding noise on both sides, far below every other gradient
            assert max(np.abs(got).max(), np.abs(ref).max()) < 1e-5 * peak_all, name
            continue
        peak = float(np.abs(ref).max())
        assert float(np.abs(got - ref).max()) <= 1e-4 * peak, name
    n = 16 if latent_offset is None else L - latent_offset  # tiny_ar: 16 latents
    assert predict_fn(model, torch.from_numpy(batch["token_ids"]),
                      torch.from_numpy(batch["pad_mask"])).shape == (B, n, VOCAB)
    # the eval step: the loss on the stepped weights, no gradient, the generator ignored
    loss = eval_step(state, batch, None)["loss"]
    assert loss.grad_fn is None and np.isfinite(float(loss))


def test_three_ar_steps_match_jax():
    """Three Adam steps (lr 1e-3) of the port's ``train_step`` against the
    JAX ``make_ar_steps``' on the same batch: losses within 1e-4 relative."""
    config = dict(learning_rate=1e-3)
    tx, jschedule = joptim.make_optimizer(joptim.OptimizerConfig(**config))
    jstep, _, _ = jax_make_ar_steps(jpresets.tiny_ar(dtype=jnp.float32, attn_impl="xla"),
                                    jschedule)
    jstep = jax.jit(jstep)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, _params()), tx, jax.random.key(2))
    model, state, schedule = _port_state(optim.OptimizerConfig(**config))
    step, _, _ = make_ar_steps(model, schedule)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 3


def test_ar_step_causal_calls_at_flagship_depth():
    """One train step of ``flagship_ar``'s structure (3 layers of a causal
    cross and 6 causal self-attention layers, the causal output decode),
    shrunk in width: 22 causal forward, 22 causal dq and 22 causal dk/dv
    calls, every one of the step's attention calls."""
    model = presets.flagship_ar(vocab_size=64, max_seq_len=32, num_latents=8, num_channels=32,
                                dtype=torch.float32, device="cpu")
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=0)
    rng = np.random.default_rng(0)
    batch = {"token_ids": rng.integers(3, 64, (2, 32)), "pad_mask": np.zeros((2, 32), bool)}
    counters = (ak.counter, ak.causal_counter, ak.dq_counter, ak.dq_causal_counter,
                ak.dkv_counter, ak.dkv_causal_counter)
    before = [c.plain_calls for c in counters]
    make_ar_steps(model, schedule)[0](state, batch)
    assert [c.plain_calls - n for c, n in zip(counters, before)] == [22] * 6
