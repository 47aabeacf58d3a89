"""The weight carry between the JAX package's flax param trees and the port,
and the import of the reference implementation's PyTorch-Lightning
checkpoints (``.ckpt``) into the same flax-named trees.

The port's modules keep the flax names and layouts (a projection's
``kernel`` is ``(in, out)``; LayerNorm has ``scale``/``bias``), so a param
tree maps onto ``model.named_parameters()`` one to one: the flax path
``encoder/layer_1/.../q_proj/kernel`` is the port's
``encoder.layer_1....q_proj.kernel``. No transposes, no renames.

Trees travel as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side) or flattened to ``/``-joined paths, as in an
``.npz`` file.

The reference's checkpoints (:func:`import_lightning_checkpoint`, the
port's copy of ``perceiver_io_tpu/interop.py``'s import half): a
``PerceiverMLM`` holds named children (``encoder.…``/``decoder.…``), a
``PerceiverIO`` is a ``Sequential`` (``0.…``/``1.…``), Lightning prefixes
``model.``; an attention layer is ``Sequential(Residual(attn),
Residual(mlp))``, so ``layer_1.0.0.module.q_norm.weight`` is the flax
``layer_1/cross_attention_layer/cross_attention/q_norm/scale``; torch's
``nn.MultiheadAttention`` keeps a merged ``in_proj_weight`` when q/k/v
widths agree and ``{q,k,v}_proj_weight`` otherwise, both split here into
``q_proj``/``k_proj``/``v_proj`` (``(out, in)`` weights transposed to
``(in, out)`` kernels). The files load with ``torch.load(weights_only=
True)`` first.
"""

from __future__ import annotations

import argparse
import pickle
import re
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

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




# -- the reference's Lightning checkpoints -----------------------------------


def _assign(tree: Dict[str, Any], path: List[str], value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    if path[-1] in node:
        raise ValueError(f"duplicate parameter at {'/'.join(path)}")
    node[path[-1]] = value


def _np(t) -> np.ndarray:
    """A tensor or array-like as a float32 numpy copy (params are f32)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.array(t, dtype=np.float32)


def _translate_linear(rest: List[str], name: str) -> Tuple[List[str], bool]:
    """torch Linear → the flax dense: weight (out, in) → kernel (in, out)."""
    if rest == ["weight"]:
        return [name, "kernel"], True
    if rest == ["bias"]:
        return [name, "bias"], False
    raise KeyError(f"unexpected Linear leaf {rest!r}")


def _translate_ln(rest: List[str], name: str) -> List[str]:
    if rest == ["weight"]:
        return [name, "scale"]
    if rest == ["bias"]:
        return [name, "bias"]
    raise KeyError(f"unexpected LayerNorm leaf {rest!r}")


def _translate_mlp(rest: List[str]) -> Tuple[List[str], bool]:
    """The reference MLP is Sequential(LN, Linear, GELU, Linear): children
    0/1/3 → norm/dense_1/dense_2."""
    idx, leaf = rest[0], rest[1:]
    if idx == "0":
        return ["mlp"] + _translate_ln(leaf, "norm"), False
    if idx in ("1", "3"):
        path, transpose = _translate_linear(leaf, "dense_1" if idx == "1" else "dense_2")
        return ["mlp"] + path, transpose
    raise KeyError(f"unexpected mlp child {rest!r}")


def _translate_attn_module(rest: List[str], kind: str) -> Tuple[List[str], bool, bool]:
    """A CrossAttention / SelfAttention body: ``(flax path, transpose,
    is_mha_leaf)``; an MHA leaf keeps its torch name last, for
    :func:`_finalize_mha`."""
    name = "cross_attention" if kind == "cross" else "self_attention"
    if rest[0] in ("q_norm", "kv_norm", "norm"):
        return [name] + _translate_ln(rest[1:], rest[0]), False, False
    if rest[:2] == ["attention", "attention"]:
        return [name, "attention", ".".join(rest[2:])], False, True
    raise KeyError(f"unexpected attention leaf {rest!r}")


def _translate_attn_layer(rest: List[str], kind: str) -> Tuple[List[str], bool, bool]:
    """Sequential(Residual(attn), Residual(mlp)): 0.module, 1.module."""
    if rest[:2] == ["0", "module"]:
        return _translate_attn_module(rest[2:], kind)
    if rest[:2] == ["1", "module"]:
        path, transpose = _translate_mlp(rest[2:])
        return path, transpose, False
    raise KeyError(f"unexpected attention-layer child {rest!r}")


def _translate_encoder(rest: List[str]) -> Optional[Tuple[List[str], bool, bool]]:
    head = rest[0]
    if head == "input_adapter":
        sub = rest[1:]
        if sub == ["text_embedding", "weight"]:
            return ["input_adapter", "text_embedding", "embedding"], False, False
        if sub == ["pos_encoding"]:
            return ["input_adapter", "pos_encoding"], False, False
        if sub == ["position_encoding"]:
            return None  # the image adapter's Fourier buffer: made, not stored
        raise KeyError(f"unexpected input_adapter leaf {sub!r}")
    if head == "latent":
        return ["latent"], False, False
    if head in ("layer_1", "layer_n"):
        idx, sub = rest[1], rest[2:]
        if idx == "0":
            path, transpose, is_mha = _translate_attn_layer(sub, "cross")
            return [head, "cross_attention_layer"] + path, transpose, is_mha
        if idx == "1":
            path, transpose, is_mha = _translate_attn_layer(sub[1:], "self")
            return ([head, "self_attention_block", f"layer_{int(sub[0])}"] + path,
                    transpose, is_mha)
        raise KeyError(f"unexpected perceiver-layer child {rest!r}")
    raise KeyError(f"unexpected encoder key {'.'.join(rest)!r}")


def _translate_decoder(rest: List[str]) -> Tuple[List[str], bool, bool]:
    head = rest[0]
    if head == "output":
        return ["output"], False, False
    if head == "cross_attention":
        path, transpose, is_mha = _translate_attn_layer(rest[1:], "cross")
        return ["cross_attention_layer"] + path, transpose, is_mha
    if head == "output_adapter":
        if rest[1] != "linear":
            raise KeyError(f"unexpected output_adapter leaf {rest[1:]!r}")
        path, transpose = _translate_linear(rest[2:], "linear")
        return ["output_adapter"] + path, transpose, False
    raise KeyError(f"unexpected decoder key {'.'.join(rest)!r}")


def _finalize_mha(group: Dict[str, np.ndarray], where: str) -> Dict[str, Any]:
    """torch ``nn.MultiheadAttention`` tensors → q/k/v/out projections: the
    merged ``in_proj_weight`` stacks q, k, v rows; the bias is always the
    stacked ``in_proj_bias``."""
    out_w = group.get("out_proj.weight")
    if out_w is None:
        raise ValueError(f"attention at {where} missing out_proj.weight")
    e = out_w.shape[0]
    if "in_proj_weight" in group:
        w = group["in_proj_weight"]
        qw, kw, vw = w[:e], w[e:2 * e], w[2 * e:]
    else:
        qw, kw, vw = group["q_proj_weight"], group["k_proj_weight"], group["v_proj_weight"]
    bias = group.get("in_proj_bias")
    if bias is None:
        raise ValueError(f"attention at {where} missing in_proj_bias (bias=False checkpoints "
                         f"are not the reference layout)")
    return {"q_proj": {"kernel": qw.T.copy(), "bias": bias[:e].copy()},
            "k_proj": {"kernel": kw.T.copy(), "bias": bias[e:2 * e].copy()},
            "v_proj": {"kernel": vw.T.copy(), "bias": bias[2 * e:].copy()},
            "out_proj": {"kernel": out_w.T.copy(), "bias": group["out_proj.bias"].copy()}}


# training bookkeeping with no parameter: torchmetrics' Accuracy state, the
# CE loss's buffers, the masking's counters
_SKIPPED_KEY_RE = re.compile(r"^(loss\.|acc\.|masking\.)")


def convert_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference torch ``state_dict`` → the nested flax-named tree (numpy
    f32): of a Lightning module (``model.`` prefix), a bare ``PerceiverMLM``
    (``encoder.…``/``decoder.…``), a bare ``PerceiverIO`` (``0.…``/``1.…``)
    or a bare ``PerceiverEncoder`` (returned under ``encoder``)."""
    params: Dict[str, Any] = {}
    mha_groups: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0] == "model":
            parts = parts[1:]
        if _SKIPPED_KEY_RE.match(".".join(parts)):
            continue
        if parts[0] in ("encoder", "0"):
            root, translated = "encoder", _translate_encoder(parts[1:])
        elif parts[0] in ("decoder", "1"):
            root, translated = "decoder", _translate_decoder(parts[1:])
        elif parts[0] in ("input_adapter", "latent", "layer_1", "layer_n"):
            root, translated = "encoder", _translate_encoder(parts)
        else:
            raise KeyError(f"unrecognized checkpoint key {key!r}")
        if translated is None:
            continue
        path, transpose, is_mha = translated
        arr = _np(value)
        if is_mha:
            *prefix, torch_name = path
            mha_groups.setdefault(tuple([root] + prefix), {})[torch_name] = arr
        else:
            _assign(params, [root] + path, arr.T.copy() if transpose else arr)
    for prefix, group in mha_groups.items():
        _assign(params, list(prefix), _finalize_mha(group, "/".join(prefix)))
    return params


def load_lightning_checkpoint(path: str, allow_unsafe_pickle: bool = False
                              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A Lightning ``.ckpt`` → ``(state_dict, hparams)``. It loads with
    ``weights_only=True`` first, ``argparse.Namespace`` (Lightning's
    ``hyper_parameters``) allowed; only a file that the safe unpickler
    refuses, and only with ``allow_unsafe_pickle`` (the CLIs'
    ``--unsafe_load``), loads unrestricted, with a warning: that executes
    code embedded in the file. A missing or corrupt file raises as it is."""
    try:
        with torch.serialization.safe_globals([argparse.Namespace]):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not allow_unsafe_pickle:
            raise ValueError(
                f"checkpoint {path!r} does not load under torch's safe weights-only "
                f"unpickler ({type(e).__name__}: {e}); if you trust its origin, retry with "
                f"allow_unsafe_pickle=True (CLI: --unsafe_load)") from e
        warnings.warn(f"loading {path!r} with the unrestricted pickle loader: this executes "
                      f"code embedded in the file; only do this for artifacts you trust",
                      stacklevel=2)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" not in ckpt:  # a bare state_dict file
        return ckpt, {}
    hparams = ckpt.get("hyper_parameters", {}) or {}
    if not isinstance(hparams, dict):  # an argparse Namespace
        hparams = dict(vars(hparams))
    return ckpt["state_dict"], hparams


# the reference's argparse names → the CLIs' (cli.common.MODEL_HPARAM_KEYS)
_HPARAM_RENAMES = {
    "num_encoder_cross_attention_heads": "num_cross_attention_heads",
    "num_encoder_self_attention_heads": "num_self_attention_heads",
    "num_encoder_self_attention_layers_per_block": "num_self_attention_layers_per_block",
}


def convert_hparams(hparams: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference hparams → the CLIs' names (the encoder-prefixed head counts
    renamed; the rest pass through)."""
    return {_HPARAM_RENAMES.get(k, k): v for k, v in hparams.items()}


def import_lightning_checkpoint(path: str, encoder_only: bool = False,
                                allow_unsafe_pickle: bool = False
                                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A Lightning ``.ckpt`` → ``(nested flax-named tree, converted
    hparams)``, the tree :func:`load_param_tree` takes; ``encoder_only``
    keeps the ``encoder`` subtree alone (the transfer entry)."""
    state_dict, hparams = load_lightning_checkpoint(path, allow_unsafe_pickle)
    params = convert_state_dict(state_dict)
    if encoder_only:
        params = {"encoder": params["encoder"]}
    return params, convert_hparams(hparams)
