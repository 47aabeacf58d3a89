"""Optimizer and LR schedule (the port's subset of
``perceiver_io_tpu/training/optim.py``).

``torch.optim`` already has the update rules the JAX package reproduces
with optax: ``Adam(weight_decay=w)`` is coupled L2 (``grad += w * param``
before the moments), ``AdamW`` decouples the decay and scales it by the lr.
The schedule is a function of the step number, set on the optimizer before
each update (``TrainState.apply_gradients``); ``torch_one_cycle_schedule``
is the port's copy of the JAX package's OneCycle with torch's phase
boundaries. ``grad_clip_norm`` clips the global gradient norm before each
update (``optax.clip_by_global_norm``). The JAX package's other optimizer
names are not ported yet; they raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

SUPPORTED_OPTIMIZERS = ("Adam", "AdamW")


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
    max_steps: Optional[int] = None
    grad_clip_norm: Optional[float] = None


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


def make_optimizer(config: OptimizerConfig, params
                   ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """(optimizer over ``params``, lr schedule on the step number)."""
    if config.one_cycle_lr:
        if config.max_steps is None:
            raise ValueError("OneCycleLR requires a max_steps value")
        schedule = torch_one_cycle_schedule(max(config.max_steps, 1), config.learning_rate)
    else:
        lr = config.learning_rate
        schedule = lambda step: lr  # noqa: E731
    params = list(params)
    if config.optimizer == "Adam":
        optimizer = torch.optim.Adam(params, lr=schedule(0),
                                     weight_decay=config.weight_decay)
    elif config.optimizer == "AdamW":
        optimizer = torch.optim.AdamW(params, lr=schedule(0),
                                      weight_decay=config.weight_decay)
    else:
        raise ValueError(
            f"optimizer {config.optimizer!r} is not ported yet; the port has "
            f"{SUPPORTED_OPTIMIZERS} (the JAX package's SGD, RMSprop, Adagrad, "
            f"Adamax, NAdam and RAdam stand in ROADMAP Queue 1)")
    if config.grad_clip_norm is not None:
        if config.grad_clip_norm <= 0:
            raise ValueError(f"grad_clip_norm must be > 0, got {config.grad_clip_norm}")
        max_norm = config.grad_clip_norm
        optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: clip_by_global_norm(
                [p for group in opt.param_groups for p in group["params"]], max_norm))
    return optimizer, schedule
