"""The port's MLM training slice against the JAX package's, on the CPU (the
kernels' plain versions; the JAX side runs its Pallas kernels in interpret
mode through ``attn_impl='pallas'``), at the tiny preset:

- the losses (``softmax_ce_integer``, ``cross_entropy_with_ignore``), values
  and gradients, an all-ignored batch included;
- ``TextMasking`` by its statistics (torch and threefry draw other bits);
- the gather decode's position order, with a row over the capacity;
- the f32 train step with the weights carried over and the JAX-drawn masked
  ids patched in on both sides: loss within 2e-5, every gradient leaf within
  1e-4 of its peak; a 3-step loss trajectory within 1e-4 relative; Adam's
  and AdamW's update given identical gradients; the OneCycle schedule;
- the bf16 train step's loss within 5e-4 relative (bf16 rounds at other
  points in the two frameworks; on this input the gap is an order of
  magnitude below the bound);
- the fused heads (``fused_head='pallas'``, the CE kernels' plain versions
  against the Pallas kernels in interpret mode, and ``True``, the chunked
  head): the f32 step at the same bars as the unfused one, the bf16 step's
  loss within 5e-4 relative;
- the attention and CE call counts of one step at the flagship depth;
- ``attn_impl='packed'`` on both sides (the packed-heads kernels #4 and #5)
  with ``fused_head='pallas'``: the f32 step's loss within 2e-5 and every
  gradient leaf within 1e-4 of its peak, the bf16 step's loss within 5e-4
  relative, and one step's calls at the flagship depth (22 packed forward,
  22 dq and 22 dk/dv, none of the fused attention kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.models.presets import tiny_mlm as jax_tiny_mlm
from perceiver_io_tpu.ops.masking import apply_text_masking as jax_masking
from perceiver_io_tpu.training import TrainState as JaxTrainState
from perceiver_io_tpu.training import losses as jlosses
from perceiver_io_tpu.training import optim as joptim
from perceiver_io_tpu.training.steps import make_mlm_steps as jax_make_mlm_steps
from perceiver_io_torch.interop import from_jax_params
from perceiver_io_torch.models.presets import tiny_mlm
from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import ce_kernel as ck
from perceiver_io_torch.ops import packed_attention_kernel as pk
from perceiver_io_torch.ops.masking import IGNORE_LABEL, TextMasking
from perceiver_io_torch.training import losses, optim
from perceiver_io_torch.training.steps import make_mlm_steps, mlm_gather_capacity
from perceiver_io_torch.training.train_state import TrainState

B, L, CAPACITY = 4, 48, 16


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- losses -----------------------------------------------------------------


@pytest.mark.parametrize("ignored", ["some", "all"])
def test_cross_entropy_with_ignore_matches_jax(ignored):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[rng.random((3, 7)) < (1.1 if ignored == "all" else 0.4)] = IGNORE_LABEL
    jloss, jgrad = jax.value_and_grad(jlosses.cross_entropy_with_ignore)(
        jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_(True)
    loss = losses.cross_entropy_with_ignore(t, torch.from_numpy(labels))
    loss.backward()
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    if ignored == "all":
        assert loss.item() == 0.0 and not t.grad.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_ce_integer_matches_jax(dtype):
    """Per-position values in f32, the gradient in the logits' dtype."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(5, 40)).astype(np.float32) * 2
    labels = rng.integers(0, 40, 5).astype(np.int32)
    g = rng.normal(size=5).astype(np.float32)
    jl = jnp.asarray(logits, dtype)
    jval, vjp = jax.vjp(lambda x: jlosses.softmax_ce_integer(x, jnp.asarray(labels)), jl)
    (jgrad,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    val = losses.softmax_ce_integer(t, torch.from_numpy(labels))
    val.backward(torch.from_numpy(g))
    assert val.dtype == torch.float32 and t.grad.dtype == t.dtype
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), rtol=1e-5, atol=1e-5)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(jgrad, np.float32),
                               rtol=tol, atol=tol)


# -- masking and the gather decode ---------------------------------------------


def test_text_masking_statistics():
    """15% of the candidates selected, 80/10/10 among them, labels only at
    the selection, [UNK] and padding never selected, random tokens never
    special; the same generator state gives the same masking."""
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(3, 1000, (256, 512)))
    ids[:, ::37] = 1  # [UNK]
    pad = torch.zeros_like(ids, dtype=torch.bool)
    pad[:, 400:] = True
    masking = TextMasking(1000, unk_token_id=1, mask_token_id=2, num_special_tokens=3)
    x, labels = masking(torch.Generator().manual_seed(0), ids, pad)
    again = masking(torch.Generator().manual_seed(0), ids, pad)
    assert torch.equal(x, again[0]) and torch.equal(labels, again[1])
    selected = labels != IGNORE_LABEL
    candidates = (ids != 1) & ~pad
    assert not (selected & ~candidates).any()
    assert torch.equal(labels[selected], ids[selected])
    assert torch.equal(x[~selected], ids[~selected])
    n = int(selected.sum())
    assert abs(n / int(candidates.sum()) - 0.15) < 0.005
    to_mask = (x == 2) & selected
    kept = (x == ids) & selected
    other = selected & ~to_mask & ~kept
    # a random token equal to the original counts as kept: 1/997 of 10%
    assert abs(int(to_mask.sum()) / n - 0.8) < 0.01
    assert abs(int(kept.sum()) / n - 0.1) < 0.01
    assert abs(int(other.sum()) / n - 0.1) < 0.01
    assert (x[other] >= 3).all() and (x[other] < 1000).all()


def test_gather_decode_positions_and_capacity_overflow():
    """The first K masked positions in index order, then the earliest
    unmasked ones; a row with more masked positions than K keeps its first
    K; the labels are gathered at the same positions."""
    model = tiny_mlm(device="cpu")
    labels = torch.full((3, 10), IGNORE_LABEL)
    labels[0, [7, 2, 5]] = torch.tensor([11, 12, 13])
    labels[1, :] = torch.arange(20, 30)        # 10 masked, capacity 4
    x = torch.randint(3, 503, (3, 10))
    model.masking = lambda generator, ids, pad: (ids, labels)
    seen = []
    decode = model.decoder.forward

    def spy(latents, positions=None):
        seen.append(positions)
        return decode(latents, positions)

    model.decoder.forward = spy
    logits, got = model(x, masking=True, generator=torch.Generator(),
                        loss_gather_capacity=4)
    assert logits.shape == (3, 4, 503)
    np.testing.assert_array_equal(seen[0].numpy(), [[2, 5, 7, 0], [0, 1, 2, 3],
                                                    [0, 1, 2, 3]])
    np.testing.assert_array_equal(got.numpy(), [[12, 13, 11, -100], [20, 21, 22, 23],
                                                [-100] * 4])
    assert model(x, masking=True, generator=torch.Generator(),
                 loss_gather_capacity=99)[0].shape == (3, 10, 503)  # clamped to L


# -- the train step against the JAX package ------------------------------------


class _Fixed:
    """A masking that returns the given (masked ids, labels), whatever the
    random stream: both packages train on the same corruption."""

    def __init__(self, x, labels):
        self.x, self.labels = x, labels

    def __call__(self, key, x, pad):
        return self.x, self.labels


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_tiny_mlm(attn_impl="pallas", max_seq_len=L)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 503, (B, L)).astype(np.int32)
    pad = np.zeros((B, L), bool)
    pad[1, 30:] = True
    pad[3, 20:] = True
    params = jax_tiny_mlm(attn_impl="xla", max_seq_len=L).init(
        {"params": jax.random.key(0), "masking": jax.random.key(1)},
        jnp.asarray(ids[:1]), jnp.asarray(pad[:1]))["params"]
    x_masked, labels = jax_masking(jax.random.key(5), jnp.asarray(ids), jnp.asarray(pad),
                                   vocab_size=503, unk_token_id=1, mask_token_id=2,
                                   num_special_tokens=3, mask_p=0.3)
    masked = (np.asarray(x_masked), np.asarray(labels))
    return jmodel, params, {"token_ids": ids, "pad_mask": pad}, masked


def _port_model(params, masked, dtype=torch.float32, attn_impl="pallas"):
    model = from_jax_params(tiny_mlm(device="cpu", max_seq_len=L, dtype=dtype,
                                     attn_impl=attn_impl),
                            jax.tree.map(np.asarray, params))
    x, labels = (torch.from_numpy(np.array(a)).long() for a in masked)
    model.masking = lambda generator, ids, pad: (x, labels)
    return model


def _jax_state(jmodel, params, masked, config):
    tx, schedule = joptim.make_optimizer(config)
    jmodel = jmodel.clone(masking=_Fixed(jnp.asarray(masked[0]), jnp.asarray(masked[1])))
    state = JaxTrainState.create(params, tx, jax.random.key(2))
    return jmodel, state, schedule


def _port_state(model, config):
    optimizer, schedule = optim.make_optimizer(config, model.parameters())
    return TrainState.create(model, optimizer, schedule, seed=2), schedule


def _jax_loss_fn(jmodel, batch, fused_head):
    """The loss of the JAX package's ``make_mlm_steps`` train step, as a
    function of the params (its ``loss_fn``)."""
    fused_ce = {"pallas": jlosses.pallas_linear_cross_entropy_with_ignore,
                True: jlosses.fused_linear_cross_entropy_with_ignore}.get(fused_head)

    def jloss(p):
        out, labels = jmodel.apply({"params": p}, jnp.asarray(batch["token_ids"]),
                                   jnp.asarray(batch["pad_mask"]),
                                   rngs={"masking": jax.random.key(0)},
                                   loss_gather_capacity=CAPACITY,
                                   return_features=bool(fused_head))
        if fused_ce is None:
            return jlosses.cross_entropy_with_ignore(out, labels)
        kernel, bias = jmodel.decoder.output_adapter.masked_head(p["decoder"]["output_adapter"])
        return fused_ce(out, kernel, bias, labels)

    return jloss


@pytest.mark.parametrize("fused_head", [False, "pallas", True])
def test_train_step_loss_and_gradients_match_jax(setup, fused_head):
    jmodel, params, batch, masked = setup
    jmodel, jstate, _ = _jax_state(jmodel, params, masked, joptim.OptimizerConfig())
    jval, jgrads = jax.value_and_grad(_jax_loss_fn(jmodel, batch, fused_head))(params)
    if fused_head:  # the JAX package's own step gives the same loss
        jstep, _, _ = jax_make_mlm_steps(jmodel, loss_gather_capacity=CAPACITY,
                                         fused_head=fused_head)
        _, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(jmetrics["loss"]), float(jval), rtol=1e-6)
    model = _port_model(params, masked)
    state, _ = _port_state(model, optim.OptimizerConfig())
    train_step, _, _ = make_mlm_steps(model, loss_gather_capacity=CAPACITY,
                                      fused_head=fused_head)
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


def test_three_step_loss_trajectory_matches_jax(setup):
    jmodel, params, batch, masked = setup
    config = dict(learning_rate=1e-3, one_cycle_lr=True, max_steps=3)
    jmodel, jstate, jschedule = _jax_state(jmodel, params, masked,
                                           joptim.OptimizerConfig(**config))
    jstep, _, _ = jax_make_mlm_steps(jmodel, jschedule, loss_gather_capacity=CAPACITY)
    model = _port_model(params, masked)
    state, schedule = _port_state(model, optim.OptimizerConfig(**config))
    step, _, _ = make_mlm_steps(model, schedule, loss_gather_capacity=CAPACITY)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-5)  # JAX: f32
    assert state.step == int(jstate.step) == 3
    assert float(m["loss"]) < float(jm["loss"]) + 1e-3


@pytest.mark.parametrize("name,weight_decay,clip", [("Adam", 0.0, None),
                                                    ("Adam", 0.01, 0.5),
                                                    ("AdamW", 0.05, None)])
def test_optimizer_update_matches_optax(name, weight_decay, clip):
    """Two updates from identical gradients: the port's torch optimizer
    (with clipping and the schedule set per step) moves the weights as the
    JAX package's optax chain does."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(2)]
    config = dict(optimizer=name, learning_rate=1e-2, weight_decay=weight_decay,
                  grad_clip_norm=clip, one_cycle_lr=True, max_steps=10)
    tx, _ = joptim.make_optimizer(joptim.OptimizerConfig(**config))
    jp, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    model = torch.nn.Module()
    model.w = w
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(**config), [w])
    state = TrainState.create(model, optimizer, schedule, seed=0)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        w.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_one_cycle_schedule_matches_jax():
    for total, pct in ((100, 0.1), (30, 0.3), (1, 0.1)):
        jsched = joptim.torch_one_cycle_schedule(total, 3e-3, pct)
        sched = optim.torch_one_cycle_schedule(total, 3e-3, pct)
        for step in range(total + 2):
            # the JAX schedule computes in f32
            np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6,
                                       atol=1e-7 * 3e-3)


def test_unported_optimizer_options_raise():
    """SGD is ported: with momentum 0.9 and coupled weight decay its three
    updates from identical gradients move the weights as the JAX package's
    optax chain does; an unknown optimizer name and an unknown
    ``fused_head`` still raise."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    config = dict(optimizer="SGD", learning_rate=1e-2, weight_decay=0.01, momentum=0.9)
    tx, _ = joptim.make_optimizer(joptim.OptimizerConfig(**config))
    jp, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    model = torch.nn.Module()
    model.w = w
    state = TrainState.create(model, *optim.make_optimizer(optim.OptimizerConfig(**config),
                                                           [w]), seed=0)
    for _ in range(3):
        g = rng.normal(size=(6, 5)).astype(np.float32)
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        w.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    params = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer(optim.OptimizerConfig(optimizer="LBFGS"), params)
    with pytest.raises(ValueError, match="fused_head must be False, True or 'pallas'"):
        make_mlm_steps(tiny_mlm(device="cpu"), fused_head="xla")


@pytest.mark.parametrize("fused_head", [False, "pallas"])
def test_bf16_train_step_loss_matches_jax(setup, fused_head):
    jmodel, params, batch, masked = setup
    jmodel = jax_tiny_mlm(attn_impl="pallas", max_seq_len=L, dtype=jnp.bfloat16).clone(
        masking=_Fixed(jnp.asarray(masked[0]), jnp.asarray(masked[1])))
    jval = float(_jax_loss_fn(jmodel, batch, fused_head)(params))
    model = _port_model(params, masked, dtype=torch.bfloat16)
    state, _ = _port_state(model, optim.OptimizerConfig())
    train_step, _, _ = make_mlm_steps(model, loss_gather_capacity=CAPACITY,
                                      fused_head=fused_head)
    _, metrics = train_step(state, batch)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters())
    rel = abs(float(metrics["loss"]) - jval) / abs(jval)
    assert rel <= 5e-4, rel


@pytest.mark.parametrize("fused_head", [False, "pallas"])
def test_attention_calls_per_train_step_at_flagship_depth(fused_head):
    """One train step at the flagship depth (3 layers x (cross + 6 self)):
    22 forward, 22 dq and 22 dk/dv attention calls, and with the fused head
    one CE forward, dx and dW call; an eval step one forward of each. On CPU
    tensors the wrappers count plain calls where the card counts launches."""
    model = tiny_mlm(num_layers=3, num_self_attention_layers_per_block=6, device="cpu")
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=0)
    train_step, eval_step, _ = make_mlm_steps(model, schedule, loss_gather_capacity=32,
                                              fused_head=fused_head)
    rng = np.random.default_rng(5)
    batch = {"token_ids": rng.integers(3, 503, (2, 64)).astype(np.int32),
             "pad_mask": np.zeros((2, 64), bool)}
    counters = (ak.counter, ak.dq_counter, ak.dkv_counter,
                ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)
    for c in counters:
        c.reset()
    _, metrics = train_step(state, batch)
    ce = 1 if fused_head else 0
    assert [c.plain_calls for c in counters] == [22, 22, 22, ce, ce, ce]
    assert [c.launches for c in counters] == [0] * 6
    assert np.isfinite(float(metrics["loss"])) and metrics["lr"] == 1e-3
    eval_step(state, batch, torch.Generator().manual_seed(0))
    assert [c.plain_calls for c in counters] == [44, 22, 22, 2 * ce, ce, ce]


def test_mlm_gather_capacity_matches_jax():
    from perceiver_io_tpu.training.steps import mlm_gather_capacity as jcap

    for n in (16, 64, 100, 512, 2048):
        assert mlm_gather_capacity(n) == jcap(n)
    assert mlm_gather_capacity(512) == 160


# -- packed-heads attention (attn_impl='packed') --------------------------------


def test_packed_train_step_loss_and_gradients_match_jax(setup):
    """The f32 step through the packed kernels' plain versions and the CE
    kernels' (``fused_head='pallas'``) against the JAX step with
    ``attn_impl='packed'`` (Pallas #4, #5 and #6-#8 in interpret mode)."""
    _, params, batch, masked = setup
    jmodel = jax_tiny_mlm(attn_impl="packed", max_seq_len=L)
    jmodel, _, _ = _jax_state(jmodel, params, masked, joptim.OptimizerConfig())
    jval, jgrads = jax.value_and_grad(_jax_loss_fn(jmodel, batch, "pallas"))(params)
    model = _port_model(params, masked, attn_impl="packed")
    state, _ = _port_state(model, optim.OptimizerConfig())
    train_step, _, _ = make_mlm_steps(model, loss_gather_capacity=CAPACITY, fused_head="pallas")
    before = (pk.dq_counter.plain_calls, ak.dq_counter.plain_calls)
    _, metrics = train_step(state, batch)
    assert (pk.dq_counter.plain_calls, ak.dq_counter.plain_calls) == (before[0] + 5, before[1])
    np.testing.assert_allclose(float(metrics["loss"]), float(jval), rtol=2e-5, atol=2e-5)
    jflat = _flat(jgrads)
    peak_all = max(float(np.abs(g).max()) for g in jflat.values())
    for name, p in model.named_parameters():
        ref = jflat[name.replace(".", "/")]
        got = p.grad.numpy()
        if name.endswith("k_proj.bias"):  # zero in exact arithmetic: noise on both sides
            assert max(np.abs(got).max(), np.abs(ref).max()) < 1e-5 * peak_all, name
            continue
        assert float(np.abs(got - ref).max()) <= 1e-4 * float(np.abs(ref).max()), name


def test_packed_bf16_train_step_loss_matches_jax(setup):
    _, params, batch, masked = setup
    jmodel = jax_tiny_mlm(attn_impl="packed", max_seq_len=L, dtype=jnp.bfloat16).clone(
        masking=_Fixed(jnp.asarray(masked[0]), jnp.asarray(masked[1])))
    jval = float(_jax_loss_fn(jmodel, batch, "pallas")(params))
    model = _port_model(params, masked, dtype=torch.bfloat16, attn_impl="packed")
    state, _ = _port_state(model, optim.OptimizerConfig())
    train_step, _, _ = make_mlm_steps(model, loss_gather_capacity=CAPACITY, fused_head="pallas")
    _, metrics = train_step(state, batch)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters())
    rel = abs(float(metrics["loss"]) - jval) / abs(jval)
    assert rel <= 5e-4, rel


def test_packed_calls_per_train_step_at_flagship_depth():
    """One packed train step at the flagship depth with the fused head: 22
    packed forward, dq and dk/dv calls, one CE forward, dx and dW call, no
    call of the fused attention wrappers; an eval step 22 packed forwards
    and one CE forward."""
    model = tiny_mlm(num_layers=3, num_self_attention_layers_per_block=6, device="cpu",
                     attn_impl="packed")
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(), model.parameters())
    state = TrainState.create(model, optimizer, schedule, seed=0)
    train_step, eval_step, _ = make_mlm_steps(model, schedule, loss_gather_capacity=32,
                                              fused_head="pallas")
    rng = np.random.default_rng(6)
    batch = {"token_ids": rng.integers(3, 503, (2, 64)).astype(np.int32),
             "pad_mask": np.zeros((2, 64), bool)}
    counters = (pk.fwd_counter, pk.dq_counter, pk.dkv_counter, ak.counter, ak.dq_counter,
                ak.dkv_counter, ck.ce_fwd_counter, ck.ce_dx_counter, ck.ce_dw_counter)
    for c in counters:
        c.reset()
    _, metrics = train_step(state, batch)
    assert [c.plain_calls for c in counters] == [22, 22, 22, 0, 0, 0, 1, 1, 1]
    assert np.isfinite(float(metrics["loss"]))
    eval_step(state, batch, torch.Generator().manual_seed(0))
    assert [c.plain_calls for c in counters] == [44, 22, 22, 0, 0, 0, 2, 1, 1]
    assert not any(c.launches for c in counters)
