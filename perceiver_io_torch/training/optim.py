"""Optimizers and the LR schedule (the counterpart of
``perceiver_io_tpu/training/optim.py``).

The eight names of the JAX package, each with its torch-exact update:

- ``Adam(weight_decay=w)`` is coupled L2 (``grad += w * param`` before the
  moments), ``AdamW`` decouples the decay and scales it by the lr; SGD
  (with ``momentum``: ``buf = m·buf + grad``, the first buffer the
  gradient), RMSprop (α 0.99, eps 1e-8 outside the sqrt), Adagrad (a zero
  accumulator, eps 1e-10 outside the sqrt) and Adamax (``nu = max(b2·nu,
  |g| + eps)``) are ``torch.optim``'s, whose rules the JAX package
  reproduces; NAdam and RAdam are this module's copies of the JAX
  package's transformations (:class:`NAdam`, :class:`RAdam`): their
  momentum-decay product, bias corrections and rectification are taken in
  f32 as the JAX package takes them, where ``torch.optim`` takes them in
  Python doubles. Weight decay is coupled L2 for every name but AdamW.
- The schedule is a function of the step number, set on the optimizer
  before each update (``TrainState.apply_gradients``);
  ``torch_one_cycle_schedule`` is the port's copy of the JAX package's
  OneCycle with torch's phase boundaries and ``one_cycle_pct_start``.
- ``grad_clip_norm`` clips the global gradient norm before each update
  (``optax.clip_by_global_norm``).
- :func:`freeze_subtrees` (``optax.multi_transform`` with
  ``set_to_zero`` on the frozen subtrees, the JAX ``freeze_subtrees``):
  the frozen parameters leave the optimizer, so the global norm of
  ``grad_clip_norm``, the weight decay and the moments cover the trainable
  ones only, as the JAX inner chain runs on the trainable subtree only, and
  the frozen ones stay bit for bit as they were loaded.
- ``accumulate_steps`` k (:class:`MultiSteps`, ``optax.MultiSteps``):
  each call averages the gradients into a running mean, and every k-th
  call updates the weights with it and starts a new mean; the others leave
  the weights and the optimizer's state as they are. The OneCycle total is
  ``max_steps // k`` updates and the schedule reads ``step // k``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

SUPPORTED_OPTIMIZERS = ("Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adamax", "NAdam",
                        "RAdam")


def torch_one_cycle_schedule(total_steps: int, max_lr: float, pct_start: float = 0.1,
                             div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Callable[[int], float]:
    """Cosine OneCycle with torch's exact phase boundaries: initial =
    max_lr/div_factor, min = initial/final_div_factor; cosine from initial to
    max over steps [0, pct_start*total-1], then from max to min over
    [pct_start*total-1, total-1]."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    peak_step = max(pct_start * total_steps - 1.0, 1e-8)
    down_steps = max(total_steps - 1.0 - peak_step, 1e-8)

    def cos_anneal(start, end, frac):
        return end + (start - end) * (1.0 + math.cos(math.pi * frac)) / 2.0

    def schedule(step: int) -> float:
        s = float(step)
        if s <= peak_step:
            return cos_anneal(initial_lr, max_lr, min(max(s / peak_step, 0.0), 1.0))
        return cos_anneal(max_lr, min_lr, min(max((s - peak_step) / down_steps, 0.0), 1.0))

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The optimizer flags of the JAX package's ``OptimizerConfig``."""

    optimizer: str = "Adam"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    one_cycle_lr: bool = False
    one_cycle_pct_start: float = 0.1
    max_steps: Optional[int] = None
    momentum: float = 0.0  # SGD only
    grad_clip_norm: Optional[float] = None
    accumulate_steps: int = 1


def freeze_subtrees(model: torch.nn.Module, frozen_keys: Sequence[str]) -> list:
    """The parameters of ``model`` outside its top-level submodules named in
    ``frozen_keys``, in ``model.parameters()`` order: what the optimizer is
    built over. ``TrainState.create`` then freezes every parameter the
    optimizer leaves out."""
    frozen = set(frozen_keys)
    return [p for name, p in model.named_parameters() if name.split(".")[0] not in frozen]


def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """Scale the gradients in place by ``max_norm / norm`` when their global
    norm exceeds ``max_norm`` (``optax.clip_by_global_norm``), without a
    host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)


def _f32(x: float) -> float:
    """``x`` rounded to f32, as the JAX package's scalar math holds it."""
    return float(np.float32(x))


class NAdam(torch.optim.Optimizer):
    """torch ``NAdam``'s update (coupled L2 decay) with the JAX package's
    scalar arithmetic (``_scale_by_nadam_torch``): ``µ_t = b1·(1 −
    ½·0.96^(t·ψ))``, the running ``µ_product``, and the step mixing the
    gradient and the first moment over ``sqrt(nu/(1 − b2^t)) + eps``, the
    scalars in f32."""

    def __init__(self, params, lr: float = 2e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum_decay: float = 4e-3):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      momentum_decay=momentum_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            psi, eps, wd, lr = (group["momentum_decay"], group["eps"], group["weight_decay"],
                                group["lr"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not wd else p.grad.add(p, alpha=wd)
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu_product"] = 1.0  # an f32 value, kept as a Python float
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = np.float32(state["step"])
                mu_t = np.float32(b1) * (np.float32(1) - np.float32(0.5) * np.float32(0.96) ** (
                    t * np.float32(psi)))
                mu_next = np.float32(b1) * (np.float32(1) - np.float32(0.5) * np.float32(
                    0.96) ** ((t + np.float32(1)) * np.float32(psi)))
                mu_product = np.float32(state["mu_product"]) * mu_t
                state["mu_product"] = float(mu_product)  # exact: state_dict round-trips it
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                bc2 = np.float32(1) - np.float32(b2) ** t
                g_scale = float((np.float32(1) - mu_t) / (np.float32(1) - mu_product))
                m_scale = float(mu_next / (np.float32(1) - mu_product * mu_next))
                denom = (v / float(bc2)).sqrt_().add_(eps)
                p.sub_((g * g_scale + m * m_scale) / denom * lr)


class RAdam(torch.optim.Optimizer):
    """torch ``RAdam``'s update (coupled L2 decay) with the JAX package's
    scalar arithmetic (``_scale_by_radam_torch``): Adam moments; while the
    rectification term ``rho_t <= 5`` the step is the bias-corrected first
    moment alone, then the rectified adaptive step over ``sqrt(nu) + eps``
    scaled by ``sqrt(1 − b2^t)``; the bias corrections are
    ``-expm1(t·log b)`` in f32."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd, lr = group["eps"], group["weight_decay"], group["lr"]
            rho_inf = _f32(2.0 / (1.0 - b2) - 1.0)
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not wd else p.grad.add(p, alpha=wd)
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = np.float32(state["step"])
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1 = -np.expm1(t * np.log(np.float32(b1)))
                bc2 = -np.expm1(t * np.log(np.float32(b2)))
                rho_t = np.float32(rho_inf) - np.float32(2) * t * np.float32(b2) ** t / bc2
                m_hat = m / float(bc1)
                if rho_t > 5.0:
                    rect = np.sqrt(max(
                        (rho_t - 4) * (rho_t - 2) * np.float32(rho_inf)
                        / ((np.float32(rho_inf) - 4) * (np.float32(rho_inf) - 2) * rho_t),
                        np.float32(0)))
                    p.sub_(m_hat * float(rect) * float(np.sqrt(bc2)) / (v.sqrt() + eps) * lr)
                else:
                    p.sub_(m_hat * lr)


class MultiSteps:
    """``optax.MultiSteps(optimizer, every_k_schedule=k)`` over a torch
    optimizer: :meth:`step` folds the parameters' gradients into a running
    mean (``acc += (g − acc) / (n + 1)``); on the k-th call it sets the mean
    as the gradients, runs the inner optimizer's step (its state advances
    only then) and starts a new mean. ``param_groups`` are the inner
    optimizer's, so the lr set on them reaches it. :meth:`state_dict` holds
    the inner optimizer's with the running mean and its count, so a save
    inside an accumulation window resumes exactly."""

    def __init__(self, optimizer: torch.optim.Optimizer, k: int):
        self.optimizer = optimizer
        self.k = k
        self.mini_step = 0
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.acc = [torch.zeros_like(p) for p in self.params]

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "mini_step": self.mini_step,
                "acc": list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        if len(state_dict["acc"]) != len(self.acc):
            raise ValueError(f"MultiSteps state holds {len(state_dict['acc'])} running "
                             f"means for {len(self.acc)} parameters")
        self.optimizer.load_state_dict(state_dict["optimizer"])
        for acc, saved in zip(self.acc, state_dict["acc"]):
            acc.copy_(saved)
        self.mini_step = int(state_dict["mini_step"])

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, acc in zip(self.params, self.acc):
            # a parameter without a gradient adds a zero one, as in JAX
            acc.add_(((0.0 if p.grad is None else p.grad) - acc) / (n + 1))
        if n + 1 < self.k:
            self.mini_step = n + 1
            return
        for p, acc in zip(self.params, self.acc):
            p.grad = acc.clone()
        self.optimizer.step()
        for acc in self.acc:
            acc.zero_()
        self.mini_step = 0


def make_optimizer(config: OptimizerConfig, params):
    """(optimizer over ``params``, lr schedule on the step number)."""
    k = config.accumulate_steps
    if k < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {k}")
    if config.one_cycle_lr:
        if config.max_steps is None:
            raise ValueError("OneCycleLR requires a max_steps value")
        # max_steps counts trainer (micro) steps; the schedule advances once
        # per optimizer update, every k micro steps
        schedule = torch_one_cycle_schedule(max(config.max_steps // k, 1),
                                            config.learning_rate, config.one_cycle_pct_start)
    else:
        lr = config.learning_rate
        schedule = lambda step: lr  # noqa: E731
    params = list(params)
    lr0, wd = schedule(0), config.weight_decay
    name = config.optimizer
    if name == "Adam":
        optimizer = torch.optim.Adam(params, lr=lr0, weight_decay=wd)
    elif name == "AdamW":
        optimizer = torch.optim.AdamW(params, lr=lr0, weight_decay=wd)
    elif name == "SGD":
        optimizer = torch.optim.SGD(params, lr=lr0, momentum=config.momentum, weight_decay=wd)
    elif name == "RMSprop":
        optimizer = torch.optim.RMSprop(params, lr=lr0, alpha=0.99, eps=1e-8, weight_decay=wd)
    elif name == "Adagrad":
        optimizer = torch.optim.Adagrad(params, lr=lr0, eps=1e-10, weight_decay=wd)
    elif name == "Adamax":
        optimizer = torch.optim.Adamax(params, lr=lr0, weight_decay=wd)
    elif name == "NAdam":
        optimizer = NAdam(params, lr=lr0, weight_decay=wd)
    elif name == "RAdam":
        optimizer = RAdam(params, lr=lr0, weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {name!r}; the port has {SUPPORTED_OPTIMIZERS}")
    if config.grad_clip_norm is not None:
        if config.grad_clip_norm <= 0:
            raise ValueError(f"grad_clip_norm must be > 0, got {config.grad_clip_norm}")
        max_norm = config.grad_clip_norm
        optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: clip_by_global_norm(
                [p for group in opt.param_groups for p in group["params"]], max_norm))
    if k > 1:
        optimizer = MultiSteps(optimizer, k)
        micro_schedule = schedule
        schedule = lambda step: micro_schedule(step // k)  # noqa: E731
    return optimizer, schedule
