"""MLM, Perceiver-AR, classifier, optical-flow and multimodal step
builders (the counterpart of ``perceiver_io_tpu/training/steps.py``:
``mlm_gather_capacity``, ``make_mlm_steps``, ``make_ar_steps``,
``make_classifier_steps``, ``make_flow_steps``, ``make_multimodal_steps``,
``make_guarded_step``).

Batches are dicts of numpy arrays or tensors, which the steps move to the
model's device:

- text: ``token_ids`` (B, L) int and ``pad_mask`` (B, L) bool (and, for a
  classifier, ``label`` (B,) int);
- image: ``image`` (B, *image_shape) float and ``label`` (B,) int;
- flow: ``frames`` (B, 2, H, W, C) float and ``flow`` (B, H, W, 2) float;
- audio-video: ``video`` (B, T, H, W, C) float, ``audio`` (B, S, C_a)
  float and ``label`` (B,) int.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from perceiver_io_torch.ops.masking import shift_ar_labels
from perceiver_io_torch.training.losses import (
    classification_loss_and_accuracy,
    cross_entropy_with_ignore,
    fused_linear_cross_entropy_with_ignore,
    pallas_linear_cross_entropy_with_ignore,
)
from perceiver_io_torch.training.train_state import TrainState

Metrics = Dict[str, object]


def mlm_gather_capacity(seq_len: int, mask_p: float = 0.15) -> int:
    """Default masked-decode capacity: 2·mask_p·L rounded up to a multiple of
    32, capped at L (160 at L = 512)."""
    cap = -(-int(2 * mask_p * seq_len) // 32) * 32
    return min(seq_len, max(cap, 32))


def _to(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device, dtype=dtype, non_blocking=True)


def _batch_to(batch, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token_ids, pad_mask) of a text batch on ``device``."""
    return _to(batch["token_ids"], device), _to(batch["pad_mask"], device, torch.bool)


def _update(state: TrainState, schedule, compute_loss,
            guard: bool = False) -> Tuple[TrainState, Metrics]:
    """One optimizer step on the loss ``compute_loss()`` returns (or on the
    first of its ``(loss, metrics)``, whose metrics join the step's);
    metrics ``loss`` (a device scalar, fetched by the caller when it logs)
    and, given ``schedule``, ``lr``. The gradients stay on the parameters
    until the next step.

    ``guard``: between the backward and the update, read on the host
    whether the loss and the gradients are finite (one sync a step); if
    not, skip the update, so the parameters, the optimizer's state (the
    ``MultiSteps`` accumulator included) and ``state.step`` stay as they
    were before the step. The metrics then gain ``bad_step`` (0 or 1)."""
    metrics = {} if schedule is None else {"lr": schedule(state.step)}
    state.optimizer.zero_grad(set_to_none=True)
    loss, extra = compute_loss(), {}
    if isinstance(loss, tuple):
        loss, extra = loss
    loss.backward()
    metrics = {"loss": loss.detach(), **extra, **metrics}
    if guard:
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        finite = torch.isfinite(loss.detach().float())
        if grads:
            finite &= torch.isfinite(torch.stack(torch._foreach_norm(grads)).float().sum())
        metrics["bad_step"] = int(not bool(finite))
        if metrics["bad_step"]:
            return state, metrics
    state.apply_gradients()
    return state, metrics


def make_guarded_step(train_step: Callable) -> Callable:
    """``train_step`` with the non-finite guard of :func:`_update` on: a step
    whose loss or gradients are not finite leaves the state as it was, and
    the metrics carry ``bad_step`` (the JAX package's ``make_guarded_step``;
    the port updates in place, so the guard sits inside the step, before
    the update, instead of selecting between two states after it)."""

    def guarded(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        return train_step(state, batch, guard=True)

    return guarded


def make_mlm_steps(model, schedule: Optional[Callable[[int], float]] = None,
                   loss_gather_capacity: Optional[int] = None, fused_head=False):
    """(train_step, eval_step, predict_fn) for a ``PerceiverMLM``.

    - ``train_step(state, batch) -> (state, metrics)``: masking drawn from
      the state's (seed, step) generator, dropout (``deterministic=False``)
      from its (seed, step) dropout key, CE over the selected positions,
      backward, one optimizer update (with ``accumulate_steps``, one
      micro-step of it); metrics ``loss`` (a device scalar, fetched by the
      caller when it logs) and, given ``schedule``, ``lr``. The gradients
      stay on the parameters until the next step. ``guard=True`` skips a
      non-finite step (:func:`make_guarded_step`).
    - ``eval_step(state, batch, generator) -> metrics``: the same loss on a
      masking drawn from ``generator``, without dropout or gradients.
    - ``predict_fn(model, token_ids, pad_mask, positions=None)``: the
      ``masking=False`` forward's logits.

    ``loss_gather_capacity`` decodes only the masked positions, up to that
    many per row. ``fused_head`` fuses the vocab projection into the CE, so
    the (B, K, V) logits never exist in train and eval: ``'pallas'`` through
    the CE kernels (``ops/ce_kernel.py``, the output adapter's
    ``linear_ce``), ``True`` through the chunked plain-PyTorch head
    (``fused_linear_cross_entropy_with_ignore``), ``False`` the unfused head.
    Both fused heads take the adapter's ``masked_head()``; predict is
    unaffected."""
    if fused_head not in (False, True, "pallas"):
        raise ValueError(f"fused_head must be False, True or 'pallas', got {fused_head!r}")
    device = next(model.parameters()).device

    def loss_fn(batch, generator, dropout_key=None):
        ids, pad = _batch_to(batch, device)
        out, labels = model(ids, pad, masking=True, generator=generator,
                            loss_gather_capacity=loss_gather_capacity,
                            return_features=bool(fused_head),
                            deterministic=dropout_key is None, dropout_key=dropout_key)
        if not fused_head:
            return cross_entropy_with_ignore(out, labels)
        adapter = model.decoder.output_adapter
        kernel, bias = adapter.masked_head()
        if fused_head == "pallas":
            return pallas_linear_cross_entropy_with_ignore(out, kernel, bias, labels,
                                                           linear_ce=adapter.linear_ce)
        return fused_linear_cross_entropy_with_ignore(out, kernel, bias, labels)

    def train_step(state: TrainState, batch, guard: bool = False
                   ) -> Tuple[TrainState, Metrics]:
        return _update(state, schedule, lambda: loss_fn(
            batch, state.step_generator(device), state.step_dropout_key()), guard)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator: torch.Generator) -> Metrics:
        return {"loss": loss_fn(batch, generator)}

    @torch.no_grad()
    def predict_fn(model_, token_ids, pad_mask, positions=None):
        logits, _ = model_(token_ids, pad_mask, masking=False, positions=positions)
        return logits

    return train_step, eval_step, predict_fn


def make_ar_steps(model, schedule: Optional[Callable[[int], float]] = None,
                  latent_offset: Optional[int] = None):
    """(train_step, eval_step, predict_fn) for a ``PerceiverARLM``, with the
    signatures of :func:`make_mlm_steps`.

    Next-token CE over the causal latent window: the dense forward's logits
    row i predicts the token at absolute position ``o + i + 1``
    (:func:`~perceiver_io_torch.ops.masking.shift_ar_labels`: the final
    position and pad targets carry ``IGNORE_LABEL``), through the unfused
    ``cross_entropy_with_ignore``; ``o`` is ``latent_offset``, or with None
    the model's default window (``L - logits.shape[1]``). There is no masking
    RNG: causality is structural; dropout is the only random stream, on in
    training from the state's (seed, step) dropout key and off in
    evaluation. ``eval_step`` takes the Trainer's generator slot and ignores
    it, as the JAX step ignores its key."""
    device = next(model.parameters()).device

    def loss_fn(batch, dropout_key=None):
        ids, pad = _batch_to(batch, device)
        logits = model(ids, pad, latent_offset=latent_offset,
                       deterministic=dropout_key is None, dropout_key=dropout_key)
        o = ids.shape[1] - logits.shape[1] if latent_offset is None else latent_offset
        return cross_entropy_with_ignore(logits, shift_ar_labels(ids, pad, o))

    def train_step(state: TrainState, batch, guard: bool = False
                   ) -> Tuple[TrainState, Metrics]:
        return _update(state, schedule, lambda: loss_fn(batch, state.step_dropout_key()),
                       guard)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator: Optional[torch.Generator] = None
                  ) -> Metrics:
        return {"loss": loss_fn(batch)}

    @torch.no_grad()
    def predict_fn(model_, token_ids, pad_mask):
        return model_(token_ids, pad_mask, latent_offset=latent_offset)

    return train_step, eval_step, predict_fn


def make_classifier_steps(model, schedule: Optional[Callable[[int], float]] = None,
                          input_kind: str = "image", frozen_encoder: bool = False):
    """(train_step, eval_step) for a ``PerceiverIO`` classifier, with the
    signatures of :func:`make_mlm_steps`: the mean CE and the top-1 accuracy
    of the logits against ``batch['label']``, metrics ``loss``, ``acc`` and,
    given ``schedule``, ``lr`` in training; dropout from the state's (seed,
    step) key in training, none in evaluation.

    ``input_kind``: ``'image'`` (``batch['image']``, no pad mask) or
    ``'text'`` (``token_ids`` under ``pad_mask``). ``frozen_encoder=True``
    runs the encoder deterministically and records no graph through it (no
    gradient, no attention statistics): the encoder must be out of the
    optimizer first (``TrainState.create`` over the parameters of
    ``training.optim.freeze_subtrees``), so its weights take no update.
    The JAX step computes the frozen encoder's gradients and throws them
    away; the function is the same."""
    if input_kind not in ("image", "text"):
        raise ValueError(f"input_kind must be 'image' or 'text', got {input_kind!r}")
    if frozen_encoder and any(p.requires_grad for p in model.encoder.parameters()):
        raise ValueError("frozen_encoder=True needs the encoder out of the optimizer first "
                         "(TrainState.create over training.optim.freeze_subtrees(model, "
                         "['encoder']))")
    device = next(model.parameters()).device

    def inputs(batch):
        if input_kind == "image":
            return _to(batch["image"], device), None
        return _batch_to(batch, device)

    def loss_fn(batch, dropout_key=None):
        x, pad = inputs(batch)
        deterministic = dropout_key is None
        if frozen_encoder:
            with torch.no_grad():
                latents = model.encode(x, pad)
            logits = model.decode(latents, deterministic=deterministic,
                                  dropout_key=dropout_key)
        else:
            logits = model(x, pad, deterministic=deterministic, dropout_key=dropout_key)
        loss, acc = classification_loss_and_accuracy(logits, _to(batch["label"], device))
        return loss, {"acc": acc.detach()}

    def train_step(state: TrainState, batch, guard: bool = False
                   ) -> Tuple[TrainState, Metrics]:
        return _update(state, schedule, lambda: loss_fn(batch, state.step_dropout_key()),
                       guard)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator: Optional[torch.Generator] = None
                  ) -> Metrics:
        loss, metrics = loss_fn(batch)
        return {"loss": loss, **metrics}

    return train_step, eval_step


def make_flow_steps(model, schedule: Optional[Callable[[int], float]] = None):
    """(train_step, eval_step) for an optical-flow ``PerceiverIO``
    (``models.flow.build_optical_flow_model``), with the signatures of
    :func:`make_classifier_steps`: the loss is the mean end-point error of
    the predicted (B, H, W, 2) flow against ``batch['flow']``; metrics
    ``loss`` and, given ``schedule``, ``lr`` in training; dropout from the
    state's (seed, step) key in training, none in evaluation."""
    from perceiver_io_torch.models.flow import end_point_error

    device = next(model.parameters()).device

    def loss_fn(batch, dropout_key=None):
        pred = model(_to(batch["frames"], device), deterministic=dropout_key is None,
                     dropout_key=dropout_key)
        return end_point_error(pred, _to(batch["flow"], device))

    def train_step(state: TrainState, batch, guard: bool = False
                   ) -> Tuple[TrainState, Metrics]:
        return _update(state, schedule, lambda: loss_fn(batch, state.step_dropout_key()),
                       guard)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator: Optional[torch.Generator] = None
                  ) -> Metrics:
        return {"loss": loss_fn(batch)}

    return train_step, eval_step


def make_multimodal_steps(model, schedule: Optional[Callable[[int], float]] = None,
                          video_weight: float = 1.0, audio_weight: float = 1.0,
                          label_weight: float = 1.0):
    """(train_step, eval_step) for the multimodal autoencoder
    (``models.multimodal.build_multimodal_autoencoder``), with the
    signatures of :func:`make_classifier_steps`: the loss is
    ``multimodal_autoencoding_loss`` (weighted MSE(video) + MSE(audio) +
    CE(label)); metrics ``loss``, ``video_loss``, ``audio_loss``,
    ``label_loss``, ``video_psnr``, ``acc`` and, given ``schedule``, ``lr``
    in training; dropout from the state's (seed, step) key in training,
    none in evaluation. When the model's video head runs in patch space
    (``VideoOutputAdapter.as_patches``), its patch geometry is read off the
    adapter here, never inferred from shapes, and the target is
    patchified."""
    from perceiver_io_torch.models.multimodal import (
        multimodal_autoencoding_loss,
        video_patch_info,
    )

    device = next(model.parameters()).device
    patch_info = video_patch_info(model)

    def loss_fn(batch, dropout_key=None):
        batch = {k: _to(batch[k], device) for k in ("video", "audio", "label")}
        outputs = model({"video": batch["video"], "audio": batch["audio"]},
                        deterministic=dropout_key is None, dropout_key=dropout_key)
        loss, metrics = multimodal_autoencoding_loss(
            outputs, batch, video_weight, audio_weight, label_weight,
            video_patch_info=patch_info)
        return loss, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch, guard: bool = False
                   ) -> Tuple[TrainState, Metrics]:
        return _update(state, schedule, lambda: loss_fn(batch, state.step_dropout_key()),
                       guard)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator: Optional[torch.Generator] = None
                  ) -> Metrics:
        loss, metrics = loss_fn(batch)
        return {"loss": loss, **metrics}

    return train_step, eval_step
