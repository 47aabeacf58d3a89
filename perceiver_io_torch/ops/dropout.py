"""Dropout drawn from explicit keys (the port's counterpart of flax
``nn.Dropout`` and of the ``'dropout'`` rng stream of the JAX modules).

A key is a host int. A module folds a fixed index into the key it is given
for each of its draws (:func:`fold_in`), and each draw seeds a fresh
``torch.Generator`` on the tensor's device from its own key. A mask then
depends only on the step's key and the draw's place in the model, never on
how many draws ran before it, and never on torch's global generators:
``torch.utils.checkpoint`` restores only those, so a layer whose forward is
recomputed under remat draws the same masks again because it is handed the
same key again.

Torch's generators draw other bits than JAX's threefry: the two packages
agree in distribution, not bit for bit. The masks apply as flax's do:
``where(keep, x / (1 - rate), 0)`` with ``keep ~ Bernoulli(1 - rate)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_MASK64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints that spreads every
    input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: Optional[int], data: int) -> Optional[int]:
    """The key of the ``data``-th draw under ``key`` (None stays None: a
    deterministic call has no key)."""
    if key is None:
        return None
    return _mix(_mix(key & _MASK64) ^ (data & _MASK64))


def keep_mask(key: int, rate: float, shape: Sequence[int], device) -> torch.Tensor:
    """Bool mask, True with probability ``1 - rate``, from a fresh generator
    seeded with ``key`` on ``device``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(key)
    return torch.rand(tuple(shape), generator=generator, device=device) < 1.0 - rate


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` in x's dtype."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def check_key(rate: float, deterministic: bool, key: Optional[int]) -> bool:
    """Whether dropout is active; raises when it is and no key was given
    (flax raises so when the ``'dropout'`` rng is missing)."""
    active = rate > 0.0 and not deterministic
    if active and key is None:
        raise ValueError(f"dropout {rate} with deterministic=False needs a dropout_key")
    return active


def dropout(x: torch.Tensor, rate: float, key: Optional[int],
            deterministic: bool) -> torch.Tensor:
    """Flax ``nn.Dropout(rate)(x, deterministic)`` on the key ``key``."""
    if not check_key(rate, deterministic, key):
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    return apply_keep(x, keep_mask(key, rate, x.shape, x.device), rate)
