"""The port's optimizers (``training/optim.py``) against the JAX package's
``make_optimizer``, on the CPU: the eight names, each with and without
coupled weight decay (SGD with momentum 0 and 0.9), three updates from the
same numpy-seeded gradients move the weights within 1e-6 of the weights'
peak (XLA's f32 Adam on the CPU sits up to ~30 ulp from the float64 update
on small weights, torch's within one);
``accumulate_steps=2`` against ``optax.MultiSteps`` (the weights only move
on every second call, by the mean gradient, and the optimizer's state
advances only then); the OneCycle schedule with ``one_cycle_pct_start``,
and its ``step // k`` reading under accumulation."""

import zlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_tpu.training import optim as joptim
from perceiver_io_torch.training import optim
from perceiver_io_torch.training.train_state import TrainState

CASES = [(name, wd, 0.0) for name in ("Adam", "AdamW", "RMSprop", "Adagrad", "Adamax",
                                      "NAdam", "RAdam") for wd in (0.0, 0.01)]
CASES += [("SGD", wd, m) for wd in (0.0, 0.01) for m in (0.0, 0.9)]


def _pair(config: dict, p0: np.ndarray):
    """The JAX transformation with its state and params, and the port's
    TrainState over one parameter, from the same config and weights."""
    tx, jschedule = joptim.make_optimizer(joptim.OptimizerConfig(**config))
    jp = jnp.asarray(p0)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    model = torch.nn.Module()
    model.w = w
    optimizer, schedule = optim.make_optimizer(optim.OptimizerConfig(**config), [w])
    return (tx, tx.init(jp), jp, jschedule), (TrainState.create(model, optimizer, schedule, 0),
                                              w, schedule)


def _close(w, jp, tol=1e-6):
    """Within ``tol`` of the JAX weights' peak magnitude."""
    ref = np.asarray(jp)
    np.testing.assert_allclose(w.detach().numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())


def _step(jax_side, port_side, g):
    tx, opt_state, jp, jschedule = jax_side
    state, w, _ = port_side
    updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
    jp = optax.apply_updates(jp, updates)
    w.grad = torch.from_numpy(g.copy())
    state.apply_gradients()
    return (tx, opt_state, jp, jschedule), port_side


@pytest.mark.parametrize("name,weight_decay,momentum", CASES)
def test_three_updates_match_jax(name, weight_decay, momentum):
    rng = np.random.default_rng(zlib.crc32(repr((name, weight_decay, momentum)).encode()))
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    config = dict(optimizer=name, learning_rate=1e-2, weight_decay=weight_decay,
                  momentum=momentum)
    jax_side, port_side = _pair(config, p0)
    for _ in range(3):
        g = rng.normal(size=p0.shape).astype(np.float32)
        g[0, 0] = 0.0  # a zero gradient: Adagrad's and RMSprop's eps at work
        jax_side, port_side = _step(jax_side, port_side, g)
        _close(port_side[1], jax_side[2])
    assert not np.allclose(port_side[1].detach().numpy(), p0)


@pytest.mark.parametrize("name", ["RAdam", "NAdam"])
def test_long_run_matches_jax(name):
    """Twelve updates: RAdam crosses its rectification threshold (rho_t > 5
    from the seventh step on), NAdam's momentum product keeps growing."""
    rng = np.random.default_rng(9)
    p0 = rng.normal(size=(4, 6)).astype(np.float32)
    jax_side, port_side = _pair(dict(optimizer=name, learning_rate=1e-2), p0)
    for _ in range(12):
        jax_side, port_side = _step(jax_side, port_side,
                                    rng.normal(size=p0.shape).astype(np.float32))
    _close(port_side[1], jax_side[2])


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_accumulate_steps_matches_multisteps(name):
    """``accumulate_steps=2`` (``optax.MultiSteps`` in the JAX package): the
    weights stand still on odd calls and move by the mean of the two
    gradients on even ones; the inner optimizer's state counts updates,
    not calls; the OneCycle schedule reads ``step // 2``."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    config = dict(optimizer=name, learning_rate=1e-2, momentum=0.9, accumulate_steps=2,
                  one_cycle_lr=True, max_steps=12, one_cycle_pct_start=0.3,
                  grad_clip_norm=1.5)
    jax_side, port_side = _pair(config, p0)
    previous = p0
    for i in range(8):
        g = (3 * rng.normal(size=p0.shape)).astype(np.float32)
        # the JAX schedule computes in f32
        np.testing.assert_allclose(port_side[2](i), float(jax_side[3](i)), rtol=1e-6,
                                   atol=1e-7 * 1e-2)
        jax_side, port_side = _step(jax_side, port_side, g)
        now = port_side[1].detach().numpy().copy()
        _close(port_side[1], jax_side[2])
        assert np.array_equal(now, previous) == (i % 2 == 0)
        previous = now
    inner = port_side[0].optimizer.optimizer
    if name == "Adam":
        assert int(inner.state[port_side[1]]["step"]) == 4
    with pytest.raises(ValueError, match="accumulate_steps must be >= 1"):
        optim.make_optimizer(optim.OptimizerConfig(accumulate_steps=0), [port_side[1]])


@pytest.mark.parametrize("total,pct", [(100, 0.1), (30, 0.3), (12, 0.5), (1, 0.3)])
def test_one_cycle_pct_start_matches_jax(total, pct):
    jsched = joptim.torch_one_cycle_schedule(total, 3e-3, pct)
    sched = optim.torch_one_cycle_schedule(total, 3e-3, pct)
    for step in range(total + 2):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6,
                                   atol=1e-7 * 3e-3)
    _, schedule = optim.make_optimizer(optim.OptimizerConfig(
        one_cycle_lr=True, max_steps=total, one_cycle_pct_start=pct, learning_rate=3e-3),
        [torch.nn.Parameter(torch.zeros(1))])
    peak = max(range(total), key=schedule)
    assert peak == max(int(round(pct * total)) - 1, 0)
