"""Checkpoints: best-by-metric retention, the ``last/`` slot, digests, resume
(the port's counterpart of ``perceiver_io_tpu/training/checkpoint.py``).

The semantics are the JAX package's; the format on disk is the port's own
(Orbax cannot be read without JAX). Under a checkpoint directory:

- ``<step>/``: one saved train state, ranked by ``monitor`` under ``mode``
  (the best ``max_to_keep`` are kept; a tie keeps the newer step), holding
  ``params.pt`` (the flat ``{flax path: tensor}`` tree on the CPU),
  ``train_state.pt`` (the optimizer's ``state_dict``, ``step`` and ``seed``)
  and ``val_metrics.json``;
- ``last/<step>/``: the unconditional newest state (one kept), the
  preemption and rollback slot;
- ``hparams.json``: the run's hyperparameters, enough to rebuild its model;
- ``digests.json`` (and ``last/digests.json``): ``{step: sha256}`` of each
  saved params tree (``utils.treepath.tree_digest``), which a
  ``prefer_latest`` restore verifies before it trusts a step.

A step is written under a temporary name and moved into place with
``os.replace``, so a step directory is whole or absent; a process killed
mid-write leaves only a temporary directory, which is ignored. Files are
read back with ``torch.load(weights_only=True)``.

A restore copies into the live train state: ``copy_`` into the existing
parameters and ``load_state_dict`` into the existing optimizer, so the
optimizer's ``param_groups`` keep pointing at the tensors that train.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from perceiver_io_torch.interop import param_tree
from perceiver_io_torch.utils.treepath import tree_digest

HPARAMS_FILE = "hparams.json"
LAST_SUBDIR = "last"  # unconditional newest-state slot (preemption, rollback)
DIGESTS_FILE = "digests.json"
PARAMS_FILE = "params.pt"
STATE_FILE = "train_state.pt"
VAL_METRICS_FILE = "val_metrics.json"


# -- host copies and files ---------------------------------------------------


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor detached and copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def host_state(state) -> Dict[str, Any]:
    """The save payload of a ``TrainState``, copied to the CPU on the calling
    thread (so the next step cannot change it under an async write):
    ``params`` (flat flax paths), ``optimizer`` (its ``state_dict``), ``step``
    and ``seed``."""
    return {"params": _to_host(param_tree(state.model)),
            "optimizer": _to_host(state.optimizer.state_dict()),
            "step": int(state.step), "seed": int(state.seed)}


def _write_json(path: str, data) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _record_digest(directory: str, step: int, digest: str) -> None:
    """Add ``{step: digest}`` to the directory's sidecar."""
    path = os.path.join(directory, DIGESTS_FILE)
    try:
        data = _read_json(path)
    except (OSError, ValueError):
        data = {}
    data[str(int(step))] = digest
    _write_json(path, data)


def _expected_digest(directory: str, step: int) -> Optional[str]:
    try:
        return _read_json(os.path.join(directory, DIGESTS_FILE)).get(str(int(step)))
    except (OSError, ValueError):
        return None  # no sidecar: nothing to check


def _write_step(directory: str, step: int, payload: Dict[str, Any],
                metrics: Optional[Dict[str, float]]) -> None:
    """Write one step directory atomically: under a temporary name, then
    ``os.replace`` into ``<directory>/<step>`` (a step of that number already
    there is replaced)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(int(step)))
    tmp = os.path.join(directory, f".{int(step)}.tmp.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload["params"], os.path.join(tmp, PARAMS_FILE))
    torch.save({k: payload[k] for k in ("optimizer", "step", "seed")},
               os.path.join(tmp, STATE_FILE))
    if metrics is not None:
        _write_json(os.path.join(tmp, VAL_METRICS_FILE), metrics)
    if os.path.exists(final):
        old = f"{final}.old.{os.getpid()}"
        os.replace(final, old)
        shutil.rmtree(old, ignore_errors=True)
    os.replace(tmp, final)


def _saved_steps(directory: str) -> List[int]:
    """The whole step directories under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if re.fullmatch(r"\d+", name)
                  and os.path.isdir(os.path.join(directory, name)))


def _step_metrics(directory: str, step: int) -> Optional[Dict[str, float]]:
    try:
        return _read_json(os.path.join(directory, str(step), VAL_METRICS_FILE))
    except (OSError, ValueError):
        return None


def _rank_key(value: float, step: int, mode: str) -> Tuple[float, int]:
    """Larger is better; on a tie the newer step ranks higher (Orbax's)."""
    return (value if mode == "max" else -value, step)


def _best_step(directory: str, monitor: str, mode: str) -> Optional[int]:
    ranked = []
    for step in _saved_steps(directory):
        metrics = _step_metrics(directory, step)
        if metrics is not None and monitor in metrics and np.isfinite(metrics[monitor]):
            ranked.append(_rank_key(float(metrics[monitor]), step, mode))
    return max(ranked)[1] if ranked else None


def _resolve_step(directory: str, step: Optional[int], monitor: str, mode: str) -> int:
    """Explicit, else best by ``monitor``, else the newest."""
    if step is not None:
        return int(step)
    best = _best_step(directory, monitor, mode)
    if best is not None:
        return best
    steps = _saved_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return steps[-1]


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


# -- copying into a live train state ----------------------------------------


def _check_tree(saved: Mapping[str, torch.Tensor], like: Mapping[str, Any], what: str) -> None:
    missing, unexpected = set(like) - set(saved), set(saved) - set(like)
    if missing or unexpected:
        raise KeyError(f"{what} does not match: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(unexpected)[:5]}")
    for path, leaf in like.items():
        if tuple(saved[path].shape) != tuple(leaf.shape):
            raise ValueError(f"{what} {path}: shape {tuple(saved[path].shape)} != "
                             f"{tuple(leaf.shape)}")


def _restore_into(state, params: Mapping[str, torch.Tensor], train: Mapping[str, Any]):
    """Copy a loaded payload into ``state``: the optimizer's state first (its
    ``load_state_dict`` checks the groups before it changes anything), then
    the parameters in place, then the step and the seed."""
    live = param_tree(state.model)  # views of the parameters' storage
    _check_tree(params, live, "checkpoint params")
    state.optimizer.load_state_dict(train["optimizer"])
    with torch.no_grad():
        for path, p in live.items():
            p.copy_(params[path])
    state.step = int(train["step"])
    state.seed = int(train["seed"])
    return state


# -- the manager -------------------------------------------------------------


class CheckpointManager:
    """Top-k-by-metric checkpoints of a ``TrainState`` plus its hparams.

    ``monitor``/``mode``/``max_to_keep`` rank the saved steps (default: the
    lowest ``val_loss``, one kept); ``save_last`` writes the unconditional
    ``last/`` slot. With ``async_save`` the host copy is taken on the calling
    thread and the write runs on one background thread; :meth:`wait` joins
    it and raises what it raised."""

    def __init__(self, directory: str, max_to_keep: int = 1, monitor: str = "val_loss",
                 mode: str = "min", hparams: Optional[Dict[str, Any]] = None,
                 async_save: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.monitor = monitor
        self.mode = mode
        self.max_to_keep = max_to_keep
        self._hparams = _jsonable(hparams) if hparams is not None else None
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="checkpoint") \
            if async_save else None
        self._pending: List[Future] = []
        # the ranked steps already on disk (a resumed run keeps ranking them)
        self._ranked: Dict[int, float] = {}
        for step in _saved_steps(self.directory):
            metrics = _step_metrics(self.directory, step)
            if metrics is not None and monitor in metrics:
                self._ranked[step] = float(metrics[monitor])
        if self._hparams is not None:
            os.makedirs(self.directory, exist_ok=True)
            _write_json(os.path.join(self.directory, HPARAMS_FILE), self._hparams)

    def _submit(self, job) -> None:
        if self._pool is None:
            job()
            return
        self._pending.append(self._pool.submit(job))

    # -- save ---------------------------------------------------------------

    def save_last(self, step: int, state) -> None:
        """Save the current state to the ``last/`` slot, whatever its metric,
        and wait for the write: the preemption and rollback checkpoint."""
        payload = host_state(state)
        last = os.path.join(self.directory, LAST_SUBDIR)

        def job():
            _record_digest(last, step, tree_digest(payload["params"]))
            _write_step(last, step, payload, None)
            for old in _saved_steps(last):
                if old != int(step):
                    shutil.rmtree(os.path.join(last, str(old)), ignore_errors=True)

        self._submit(job)
        self.wait()

    def save(self, step: int, state, metrics: Dict[str, float]) -> bool:
        """Save if ``metrics[monitor]`` ranks among the best ``max_to_keep``
        (the steps it pushes out are removed). Returns whether it saved."""
        metrics = {k: float(v) for k, v in metrics.items()}
        if self.monitor not in metrics:
            raise KeyError(f"monitored metric {self.monitor!r} missing from metrics "
                           f"{sorted(metrics)}")
        step, value = int(step), metrics[self.monitor]
        ranked = dict(self._ranked)
        ranked[step] = value
        order = sorted(ranked, key=lambda s: _rank_key(ranked[s], s, self.mode), reverse=True)
        keep = set(order[: self.max_to_keep])
        if step not in keep:
            return False
        drop = [s for s in ranked if s not in keep]
        self._ranked = {s: ranked[s] for s in keep}
        payload = host_state(state)

        def job():
            _record_digest(self.directory, step, tree_digest(payload["params"]))
            _write_step(self.directory, step, payload, metrics)
            for s in drop:
                shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)

        self._submit(job)
        return True

    def wait(self) -> None:
        """Block until the saves issued so far are on disk."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    # -- introspection ------------------------------------------------------

    @property
    def all_steps(self) -> List[int]:
        self.wait()
        return _saved_steps(self.directory)

    @property
    def best_step(self) -> Optional[int]:
        self.wait()
        return _best_step(self.directory, self.monitor, self.mode)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps
        return steps[-1] if steps else None

    # -- restore ------------------------------------------------------------

    def restore_state(self, state, step: Optional[int] = None):
        """Restore a saved state into ``state`` (``step=None``: the best)."""
        self.wait()
        step = _resolve_step(self.directory, step, self.monitor, self.mode)
        return _restore_into(state, *_load_step(self.directory, step))

    def restore_metrics(self, step: Optional[int] = None) -> Dict[str, float]:
        self.wait()
        step = _resolve_step(self.directory, step, self.monitor, self.mode)
        return dict(_read_json(os.path.join(self.directory, str(step), VAL_METRICS_FILE)))

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _load_step(directory: str, step: int) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    path = os.path.join(directory, str(step))
    return _load(os.path.join(path, PARAMS_FILE)), _load(os.path.join(path, STATE_FILE))


# -- module-level readers (no manager) ---------------------------------------


def resolve_checkpoint_step(directory: str, step: Optional[int] = None,
                            monitor: str = "val_loss", mode: str = "min") -> int:
    """The step a params restore from ``directory`` would use (explicit,
    else best, else the newest), without reading any tensor."""
    return _resolve_step(os.path.abspath(directory), step, monitor, mode)


def load_hparams(directory: str) -> Dict[str, Any]:
    """The hparams embedded in a checkpoint directory."""
    return _read_json(os.path.join(os.path.abspath(directory), HPARAMS_FILE))


def restore_train_state(directory: str, state, step: Optional[int] = None,
                        monitor: str = "val_loss", mode: str = "min",
                        prefer_latest: bool = False):
    """Restore a saved train state into ``state`` (best step by default) and
    return it.

    ``prefer_latest=True`` is the resume mode: the candidates are the ranked
    steps and the ``last/`` slot, newest first (``last/`` wins a tie). A
    candidate that fails to load (a truncated step) or whose params do not
    match the digest recorded when it was saved is skipped with a warning;
    when every candidate fails, the last error is raised."""
    directory = os.path.abspath(directory)
    if not (prefer_latest and step is None):
        step = _resolve_step(directory, step, monitor, mode)
        return _restore_into(state, *_load_step(directory, step))
    last_dir = os.path.join(directory, LAST_SUBDIR)
    candidates = [(s, "last") for s in _saved_steps(last_dir)]
    candidates += [(s, "main") for s in _saved_steps(directory)]
    candidates.sort(key=lambda c: (c[0], c[1] == "last"), reverse=True)
    if not candidates:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    errors: List[BaseException] = []
    for cand_step, source in candidates:
        cand_dir = last_dir if source == "last" else directory
        try:
            params, train = _load_step(cand_dir, cand_step)
        except Exception as e:  # a truncated or partial step
            errors.append(e)
            warnings.warn(f"checkpoint step {cand_step} ({source} slot) failed to restore "
                          f"({type(e).__name__}: {e}); falling back to the previous "
                          f"checkpoint", stacklevel=2)
            continue
        expected = _expected_digest(cand_dir, cand_step)
        if expected is not None:
            got = tree_digest(params)
            if got != expected:
                err = ValueError(f"checkpoint step {cand_step} ({source} slot) restored but "
                                 f"its params digest {got[:12]} does not match the save-time "
                                 f"sidecar {expected[:12]}: silent corruption")
                errors.append(err)
                warnings.warn(f"{err}; falling back to the previous checkpoint",
                              stacklevel=2)
                continue
        return _restore_into(state, params, train)
    raise errors[-1]


def restore_params(directory: str, like_params: Optional[Mapping[str, Any]] = None,
                   step: Optional[int] = None, monitor: str = "val_loss",
                   mode: str = "min") -> Dict[str, torch.Tensor]:
    """The saved flat params tree of one step (best by default), on the CPU;
    given ``like_params`` (a flat tree), its paths and shapes are checked and
    its dtypes taken."""
    params, _ = restore_raw_params(directory, step, monitor, mode)
    if like_params is None:
        return params
    _check_tree(params, like_params, "checkpoint params")
    return {k: params[k].to(like_params[k].dtype) for k in like_params}


def restore_raw_params(directory: str, step: Optional[int] = None,
                       monitor: str = "val_loss",
                       mode: str = "min") -> Tuple[Dict[str, torch.Tensor], int]:
    """``(params, step)``: the saved flat params tree as written, and its
    step, without reading the optimizer's state."""
    directory = os.path.abspath(directory)
    step = _resolve_step(directory, step, monitor, mode)
    return _load(os.path.join(directory, str(step), PARAMS_FILE)), step


def restore_encoder_params(directory: str,
                           like_encoder_params: Optional[Mapping[str, Any]] = None,
                           step: Optional[int] = None, subtree: str = "encoder",
                           monitor: str = "val_loss",
                           mode: str = "min") -> Dict[str, torch.Tensor]:
    """One subtree of the saved params (the transfer path): the leaves under
    ``<subtree>/``, keyed by their paths below it, to load into another
    model's encoder (``interop.load_param_tree(model.encoder, ...)``)."""
    params, _ = restore_raw_params(directory, step, monitor, mode)
    prefix = f"{subtree}/"
    sub = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
    if not sub:
        raise KeyError(f"no {subtree!r} subtree in the checkpoint params")
    if like_encoder_params is None:
        return sub
    _check_tree(sub, like_encoder_params, f"checkpoint {subtree}")
    return {k: sub[k].to(like_encoder_params[k].dtype) for k in like_encoder_params}


def _jsonable(obj: Any) -> Any:
    """Best-effort JSON projection for hparams (dataclasses, argparse
    namespaces, numpy scalars)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if hasattr(obj, "__dict__") and not isinstance(obj, (dict, list, tuple, str)):
        try:
            return _jsonable(vars(obj))
        except TypeError:
            return str(obj)
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)
