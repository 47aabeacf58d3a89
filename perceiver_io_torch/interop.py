"""The weight carry between the JAX package's flax param trees and the port.

The port's modules keep the flax names and layouts (a projection's
``kernel`` is ``(in, out)``; LayerNorm has ``scale``/``bias``), so a param
tree maps onto ``model.named_parameters()`` one to one: the flax path
``encoder/layer_1/.../q_proj/kernel`` is the port's
``encoder.layer_1....q_proj.kernel``. No transposes, no renames.

Trees travel as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side) or flattened to ``/``-joined paths, as in an
``.npz`` file.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from perceiver_io_torch.quant.int8 import QKernel


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts → ``{'a/b/c': leaf}``; an already flat tree passes
    through unchanged."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = value
    return flat


def param_tree(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's floating weights as a flat ``{flax path: tensor}`` tree."""
    return {name.replace(".", "/"): p.detach()
            for name, p in model.named_parameters()}


def load_param_tree(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load a flat or nested tree into ``model`` in place, strictly: every
    parameter must be present with its shape and no extra path may appear.
    Each parameter takes the leaf's values AND dtype (a prepared bf16 tree
    makes a bf16 model) on the model's device; a :class:`QKernel` leaf
    replaces its projection's kernel. Returns ``model``."""
    given = {path.replace("/", "."): leaf
             for path, leaf in flatten_tree(tree).items()}
    params = dict(model.named_parameters())
    missing, unexpected = set(params) - set(given), set(given) - set(params)
    if missing or unexpected:
        raise KeyError(
            f"param tree does not match the model: missing {sorted(missing)[:5]}, "
            f"unexpected {sorted(unexpected)[:5]}")
    modules = dict(model.named_modules())
    for name, leaf in given.items():
        owner, _, attr = name.rpartition(".")
        module, current = modules[owner], params[name]
        if isinstance(leaf, QKernel):
            module.set_qkernel(leaf.to(current.device))
            continue
        value = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf))
        if tuple(value.shape) != tuple(current.shape):
            raise ValueError(
                f"{name}: shape {tuple(value.shape)} != {tuple(current.shape)}")
        setattr(module, attr, nn.Parameter(value.to(current.device).clone(),
                                           requires_grad=False))
    return model


# the carry of a flax param tree (nested dicts of numpy arrays, or flattened
# to ``/``-joined paths) is the same load
from_jax_params = load_param_tree


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a param tree saved flattened to ``/``-joined paths."""
    with np.load(path) as data:
        return {key: data[key] for key in data.files}

