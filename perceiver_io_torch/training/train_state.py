"""Train state: the model, its optimizer and schedule, the step number and
the base seed (the counterpart of ``perceiver_io_tpu/training/train_state.py``).

The JAX state is an immutable pytree threaded through jitted steps; here
the model and optimizer are updated in place, and the state carries the
step and the seed that every per-step random draw derives from.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    seed: int
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], seed: int) -> "TrainState":
        """The parameters ``optimizer`` updates train; every other parameter
        of ``model`` is frozen (``requires_grad`` False: a carried tree loads
        frozen, and ``optim.freeze_subtrees`` leaves a subtree out of the
        optimizer)."""
        trainable = {id(p) for group in optimizer.param_groups for p in group["params"]}
        for p in model.parameters():
            p.requires_grad_(id(p) in trainable)
        return cls(model=model, optimizer=optimizer, schedule=schedule, seed=seed)

    def lr(self) -> float:
        return self.schedule(self.step)

    def apply_gradients(self) -> None:
        """One optimizer update at the lr of the current step, then step += 1."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr()
        self.optimizer.step()
        self.step += 1

    def step_generator(self, device) -> torch.Generator:
        """The step's masking stream, deterministic in (seed, step) — the
        counterpart of ``step_rngs`` folding the step into the key."""
        seed = np.random.SeedSequence([self.seed, self.step]).generate_state(1)[0]
        return torch.Generator(device=device).manual_seed(int(seed))

    def step_dropout_key(self) -> int:
        """The step's dropout key (``ops/dropout.py``), deterministic in
        (seed, step) and apart from the masking stream — the ``'dropout'``
        key of ``step_rngs("masking", "dropout")``."""
        words = np.random.SeedSequence([self.seed, self.step, 1]).generate_state(2, np.uint64)
        return int(words[0])
