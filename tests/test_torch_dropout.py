"""Dropout, remat and the stacked self-attention projection in the port,
on the CPU:

- with a dropout rate of 0.1 and ``deterministic=True``, the tiny MLM and
  the tiny AR model (built by both packages' CLI builders from one set of
  flags, the JAX weights carried over) give the JAX models' outputs at
  2e-5: evaluation runs without dropout;
- in training mode the keep share of a mask lies within binomial bounds,
  a kept value is scaled by 1 / (1 - rate), one dropout key gives one loss
  twice and another key another loss, and a missing key raises;
- remat (``torch.utils.checkpoint`` of each encoder layer application)
  with dropout on gives the loss and gradients of the same step without
  remat within 1e-6 (the recompute draws the same masks: each draw's
  generator is seeded from a key the recompute is handed again), while the
  einsum path is counted twice in the encoder, once for the recompute;
- the train step's gradients with the stacked q/k/v product equal those
  with three projections within 1e-6 of each leaf's peak (``k_proj.bias``,
  zero in exact arithmetic, under 1e-5 of the largest gradient).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.cli import common as jax_common
from perceiver_io_torch.cli import common
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.models.presets import tiny_ar, tiny_mlm
from perceiver_io_torch.ops import attention as pat
from perceiver_io_torch.ops import dropout as drop
from perceiver_io_torch.training import optim
from perceiver_io_torch.training.steps import make_ar_steps, make_mlm_steps
from perceiver_io_torch.training.train_state import TrainState

B, L, V = 3, 48, 211


def _args(attn_impl="xla"):
    return argparse.Namespace(
        num_latents=16, num_latent_channels=32, num_encoder_layers=3,
        num_self_attention_layers_per_block=2, num_cross_attention_heads=4,
        num_self_attention_heads=4, dropout=0.1, dtype="float32", attn_impl=attn_impl,
        remat=False, no_reuse_kv=False, pad_vocab_multiple=None, seed=0)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, V, (B, L)).astype(np.int32)
    pad = np.zeros((B, L), bool)
    pad[1, 30:] = True
    return ids, pad


@pytest.mark.parametrize("task", ["mlm", "ar"])
@pytest.mark.parametrize("attn_impl", ["xla", "auto"])
def test_deterministic_forward_with_dropout_matches_jax(task, attn_impl):
    args = _args(attn_impl)
    ids, pad = _batch()
    build = "build_mlm" if task == "mlm" else "build_ar"
    jmodel = getattr(jax_common, build)(args, V, L)
    rngs = {"params": jax.random.key(0), "masking": jax.random.key(1)}
    params = jmodel.init(rngs, jnp.asarray(ids[:1]), jnp.asarray(pad[:1]))["params"]
    model = from_jax_params(getattr(common, build)(args, V, L, "cpu"),
                            jax.tree.map(np.asarray, params)).eval()
    assert all(m.dropout == 0.1 for m in model.modules()
               if isinstance(m, pat.MultiHeadAttention))
    if task == "mlm":
        ref, _ = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(pad),
                              masking=False, deterministic=True)
        with torch.inference_mode():
            got, _ = model(torch.from_numpy(ids), torch.from_numpy(pad), deterministic=True)
    else:
        ref = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(pad),
                           deterministic=True)
        with torch.inference_mode():
            got = model(torch.from_numpy(ids), torch.from_numpy(pad), deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_keep_share_and_scale_are_binomial():
    rate, n = 0.1, 200_000
    x = torch.ones(n)
    y = drop.dropout(x, rate, 1234, deterministic=False)
    kept = y != 0
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    assert torch.equal(drop.dropout(x, rate, 1234, deterministic=True), x)
    assert torch.equal(y, drop.dropout(x, rate, 1234, deterministic=False))
    assert not torch.equal(y, drop.dropout(x, rate, drop.fold_in(1234, 0), deterministic=False))
    with pytest.raises(ValueError, match="needs a dropout_key"):
        drop.dropout(x, rate, None, deterministic=False)


def _assert_grads_close(got: dict, ref: dict, tol: float) -> None:
    """Each leaf within ``tol`` of its peak; ``k_proj.bias``, zero in exact
    arithmetic (softmax is shift-invariant), is rounding noise on both sides
    and is held under 1e-5 of the largest gradient instead."""
    peak_all = max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        if name.endswith("k_proj.bias"):
            assert max(float(got[name].abs().max()), float(g.abs().max())) < 1e-5 * peak_all
            continue
        torch.testing.assert_close(got[name], g, rtol=0, atol=tol * float(g.abs().max()))


def _mlm_loss_and_grads(model, ids, pad, key, capacity=16):
    model.zero_grad(set_to_none=True)
    x = torch.from_numpy(ids)
    out, labels = model(x, torch.from_numpy(pad), masking=True,
                        generator=torch.Generator().manual_seed(3),
                        loss_gather_capacity=capacity, deterministic=key is None,
                        dropout_key=key)
    from perceiver_io_torch.training.losses import cross_entropy_with_ignore

    loss = cross_entropy_with_ignore(out, labels)
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_one_key_one_loss():
    """Training mode: the same key twice gives the same loss; another key
    another one; the step's key comes from (seed, step)."""
    ids, pad = _batch(1)
    model = tiny_mlm(device="cpu", vocab_size=V, max_seq_len=L, dropout=0.1)
    a, _ = _mlm_loss_and_grads(model, ids, pad, 77)
    b, _ = _mlm_loss_and_grads(model, ids, pad, 77)
    c, _ = _mlm_loss_and_grads(model, ids, pad, 78)
    d, _ = _mlm_loss_and_grads(model, ids, pad, None)
    assert a == b and a != c and a != d
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=5)
    assert state.step_dropout_key() == state.step_dropout_key()
    key0 = state.step_dropout_key()
    state.step += 1
    assert state.step_dropout_key() != key0


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_remat_with_dropout_equals_no_remat(attn_impl):
    ids, pad = _batch(2)
    runs = {}
    for remat in (False, True):
        model = tiny_mlm(device="cpu", vocab_size=V, max_seq_len=L, dropout=0.1, remat=remat,
                         attn_impl=attn_impl, num_layers=3)
        pat.xla_counter.reset()
        runs[remat] = _mlm_loss_and_grads(model, ids, pad, 99) + (pat.xla_counter.calls,)
    (loss, grads, calls), (rloss, rgrads, rcalls) = runs[False], runs[True]
    np.testing.assert_allclose(rloss, loss, rtol=1e-6)
    _assert_grads_close(rgrads, grads, 1e-6)
    # 3 encoder applications x (cross + 1 self) + the decoder; the encoder's
    # 6 recomputed under remat
    assert (calls, rcalls) == (7, 13)


def test_remat_recompute_draws_the_same_masks():
    """A draw that read a stream advanced by earlier draws (as one shared
    generator would) could not be recomputed: the masks of two calls with
    one key are one mask."""
    key = drop.fold_in(drop.fold_in(5, 2), 1)
    first = drop.keep_mask(key, 0.1, (64, 64), "cpu")
    drop.keep_mask(drop.fold_in(key, 3), 0.1, (64, 64), "cpu")  # another draw between
    assert torch.equal(first, drop.keep_mask(key, 0.1, (64, 64), "cpu"))


def test_ar_train_step_drops_out_and_eval_does_not():
    """The AR step trains with dropout (two steps from one state and batch
    differ only through the step's key) and evaluates without it."""
    ids, pad = _batch(3)
    batch = {"token_ids": ids, "pad_mask": pad}
    model = tiny_ar(device="cpu", vocab_size=V, max_seq_len=L, dropout=0.1)
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(learning_rate=0.0),
                                               model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=5)
    train_step, eval_step, _ = make_ar_steps(model, schedule)
    first = float(train_step(state, batch)[1]["loss"])
    second = float(train_step(state, batch)[1]["loss"])
    assert first != second
    assert float(eval_step(state, batch)["loss"]) == float(eval_step(state, batch)["loss"])


def test_fused_qkv_step_matches_three_projections(monkeypatch):
    """One MLM train step's gradients with the self-attention q/k/v from
    one stacked product, and with three separate projections."""
    ids, pad = _batch(4)
    batch = {"token_ids": ids, "pad_mask": pad}
    grads = {}
    for mode in ("fused", "separate"):
        if mode == "separate":
            monkeypatch.setattr(pat.MultiHeadAttention, "_project_qkv",
                                lambda self, x: (self.q_proj(x),) + self.project_kv(x))
        model = tiny_mlm(device="cpu", vocab_size=V, max_seq_len=L, dropout=0.1)
        optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), model.parameters())
        state = TrainState.create(model, optimizer, schedule, seed=5)
        train_step, _, _ = make_mlm_steps(model, schedule, loss_gather_capacity=16)
        train_step(state, batch)
        grads[mode] = {n: p.grad.clone() for n, p in model.named_parameters()}
    _assert_grads_close(grads["separate"], grads["fused"], 1e-6)
