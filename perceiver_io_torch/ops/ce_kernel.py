"""Fused linear + cross-entropy head, forward and backward: the CUDA
kernels' wrappers, their plain versions, and the autograd function that
joins them.

The counterpart of ``perceiver_io_tpu/ops/pallas_ce.py::pallas_linear_ce_integer``:
the per-row CE of ``x @ W + b`` against integer labels, with the (rows,
vocab) logits never in device memory, forward or backward.

- forward: ``csrc/linear_ce_fwd.cu`` (``_fwd_kernel``): loss and the row
  log-sum-exp ``lse``, both (R,) f32; ``lse`` is the backward's residual.
- backward: ``csrc/linear_ce_bwd.cu``, one kernel for dx
  (``_bwd_dx_kernel``) and one for dW and db (``_bwd_dw_kernel``), each
  recomputing ``d = (softmax - onehot) * g`` from ``lse``.
- Each kernel has two designs chosen by x's dtype
  (:func:`ce_forward_design`, :func:`ce_backward_design`): exact scalar FMAs
  for float32, tensor-core ``wgmma`` for bfloat16 (``csrc/linear_ce_wgmma.cuh``,
  one tile-and-ring body for all three), which reads W as
  :func:`round_weight_t` (W rounded to bf16 and transposed); the bf16
  backward skips 64-row tiles whose cotangents are all 0.
- :class:`FusedLinearCE`: the ``torch.autograd.Function`` twin of the
  ``_fused_ce`` custom VJP, which makes round(W)^T once a step for the bf16
  forward and hands it to the backward; :func:`linear_ce_integer` is the
  counterpart of ``pallas_linear_ce_integer``.

Rounding points, as the TPU kernels: W is rounded to x's dtype before the
product, which accumulates in f32, and the f32 bias is added after; ``d`` is
formed in f32, ``db`` sums that f32 ``d``, while dx and dW take ``d`` rounded
to x's dtype (dx with W rounded again); dx leaves in x's dtype, dW and db in
f32. In bf16 this is not the unfused head's order (which adds the bias in
bf16 before the CE), so the kernels are held against these plain versions,
and the plain versions against the JAX package's Pallas path.

CUDA tensors launch the kernels (x f32 or bf16, C a multiple of 8 up to
``MAX_CHANNELS``); CPU tensors run the plain versions
(:func:`linear_ce_fwd_reference`, :func:`linear_ce_bwd_reference`). There is
no fallback between the two, nor between a kernel's two designs: a bf16
call the wgmma kernels cannot take raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perceiver_io_torch.ops import build

MAX_CHANNELS = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

ce_fwd_counter = build.LaunchCounter()   # linear_ce_fwd
ce_fwd_wgmma_counter = build.LaunchCounter()  # linear_ce_fwd, the bf16 wgmma design
ce_dx_counter = build.LaunchCounter()    # linear_ce_bwd_dx
ce_dw_counter = build.LaunchCounter()    # linear_ce_bwd_dw
ce_dx_wgmma_counter = build.LaunchCounter()  # linear_ce_bwd_dx, the bf16 wgmma design
ce_dw_wgmma_counter = build.LaunchCounter()  # linear_ce_bwd_dw, the bf16 wgmma design


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, labels: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2 or b.ndim != 1 or labels.ndim != 1:
        raise ValueError(
            f"expected x (R, C), w (C, V), b (V,), labels (R,); got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}, {tuple(labels.shape)}")
    if w.shape[0] != x.shape[1] or b.shape[0] != w.shape[1] or labels.shape[0] != x.shape[0]:
        raise ValueError(
            f"x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} and labels "
            f"{tuple(labels.shape)} do not match")
    if w.shape[1] == 0:
        raise ValueError("cross-entropy over zero classes")
    if not (x.device == w.device == b.device == labels.device):
        raise ValueError("x, w, b and labels must lie on one device")


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 math, as the kernels; f64 inputs keep f64 (gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _logits(x, w, b) -> torch.Tensor:
    """W rounded to x's dtype, the product in the accumulation dtype, the
    bias added after."""
    acc = _acc_dtype(x)
    return x.to(acc) @ w.to(x.dtype).to(acc) + b.to(acc)


def linear_ce_fwd_reference(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(loss, lse)``, (R,) f32 (f64
    for f64 inputs)."""
    _check(x, w, b, labels)
    logits = _logits(x, w, b)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse - picked, lse


def linear_ce_bwd_reference(x, w, b, labels, lse, g):
    """Plain version of the two backward kernels: ``(dx, dw, db)``, written
    as the TPU kernels' math (``_bwd_probs_grad``): p recomputed from the
    saved lse, ``d = (p - onehot) * g`` in f32, db the sum of that d, dx and
    dW from d rounded to x's dtype. dx in x's dtype, dW and db in f32."""
    _check(x, w, b, labels)
    acc = _acc_dtype(x)
    d = torch.exp(_logits(x, w, b) - lse.to(acc)[:, None])
    d.scatter_add_(1, labels.long()[:, None],
                   torch.full((x.shape[0], 1), -1.0, dtype=acc, device=x.device))
    d = d * g.to(acc)[:, None]
    rounded = d.to(x.dtype).to(acc)
    dx = rounded @ w.to(x.dtype).to(acc).t()
    return dx.to(x.dtype), x.to(acc).t() @ rounded, d.sum(dim=0)


def _kernel_inputs(x, w, b, labels):
    """The operands as the kernels take them, or a ValueError."""
    c = x.shape[1]
    if c % 8 or c > MAX_CHANNELS:
        raise ValueError(
            f"the CE kernels take a channel count that is a multiple of 8 up to "
            f"{MAX_CHANNELS}; got C={c}")
    if x.device.type != "cuda":
        raise ValueError(f"no CE kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CE kernels take float32 or bfloat16 x, got {x.dtype}")
    return (x.contiguous(), w.float().contiguous(), b.float().contiguous(),
            labels.to(torch.int32).contiguous())


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _design(x: torch.Tensor, w: torch.Tensor, kernel: str) -> str:
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"expected x (R, C) and w (C, V); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    c = x.shape[1]
    if c == 0 or c % 8 or c > MAX_CHANNELS:
        raise ValueError(
            f"the CE kernels take a channel count that is a multiple of 8 up to "
            f"{MAX_CHANNELS}; got C={c}")
    if x.dtype == torch.float32:
        return "scalar"
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CE kernels take float32 or bfloat16 x, got {x.dtype}")
    if x.is_contiguous() and x.data_ptr() % 16:
        raise ValueError(f"bf16 CE {kernel}: x is not 16-byte aligned, as its TMA loads need")
    return "wgmma"


def ce_forward_design(x: torch.Tensor, w: torch.Tensor) -> str:
    """The design of the forward kernel for x (R, C) and w (C, V):
    ``'scalar'`` for float32 x (exact f32 FMAs), ``'wgmma'`` for bfloat16 x
    (tensor cores; x is read by TMA, so a contiguous x needs a 16-byte
    aligned base, and any other layout is copied to contiguous first, as the
    scalar design copies it too). Raises ``ValueError`` on what neither
    takes. Checks shapes and layout only, so it answers for CPU tensors
    too."""
    return _design(x, w, "forward")


def ce_backward_design(x: torch.Tensor, w: torch.Tensor) -> str:
    """The design of the two backward kernels, by the rule of
    :func:`ce_forward_design`."""
    return _design(x, w, "backward")


def round_weight_t(w: torch.Tensor) -> torch.Tensor:
    """W (C, V) rounded to bf16 and transposed, (V, C) contiguous, in one
    copy: the bf16 kernels' view of W (the same rounding as the f32 W
    rounded inside the product)."""
    wt = torch.empty((w.shape[1], w.shape[0]), dtype=torch.bfloat16, device=w.device)
    return wt.copy_(w.t())


def _weight_t(design, x, w, wt):
    """The Wt a design reads: None for the scalar design; for the wgmma one
    ``wt`` checked, or :func:`round_weight_t` of w when it is None."""
    if design != "wgmma":
        return None
    if wt is None:
        return round_weight_t(w)
    if (wt.shape != w.t().shape or wt.dtype != torch.bfloat16 or wt.device != x.device
            or not wt.is_contiguous() or wt.data_ptr() % 16):
        raise ValueError(f"wt must be round_weight_t(w): (V, C) bf16, contiguous and "
                         f"16-byte aligned on {x.device}; got {tuple(wt.shape)} {wt.dtype}")
    return wt


def launch_fwd(x, w, b, labels, wt=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel alone: ``(loss, lse)``, (R,) f32. ``wt`` is
    :func:`round_weight_t` of w for the bf16 design, made here when not
    given."""
    design = ce_forward_design(x, w)
    x, w, b, labels = _kernel_inputs(x, w, b, labels)
    wt = _weight_t(design, x, w, wt)
    r, c = x.shape
    loss = torch.empty(r, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    if r:
        build.check_launch("linear_ce_fwd", build.library().linear_ce_fwd(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
            wt.data_ptr() if wt is not None else None, b.data_ptr(), labels.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), r, c, w.shape[1], _stream(x)))
        ce_fwd_counter.launches += 1
        if design == "wgmma":
            ce_fwd_wgmma_counter.launches += 1
    return loss, lse


def _bwd_inputs(x, w, b, labels, lse, g, wt):
    design = ce_backward_design(x, w)
    x, w, b, labels = _kernel_inputs(x, w, b, labels)
    lse, g = lse.float().contiguous(), g.float().contiguous()
    if lse.shape != labels.shape or g.shape != labels.shape:
        raise ValueError(f"lse {tuple(lse.shape)} and g {tuple(g.shape)} must be "
                         f"{tuple(labels.shape)}")
    return design, x, w, b, labels, lse, g, _weight_t(design, x, w, wt)


def launch_bwd_dx(x, w, b, labels, lse, g, wt=None) -> torch.Tensor:
    """The dx kernel alone: dx (R, C) in x's dtype. ``wt`` is
    :func:`round_weight_t` of w for the bf16 design, made here when not
    given."""
    design, x, w, b, labels, lse, g, wt = _bwd_inputs(x, w, b, labels, lse, g, wt)
    r, c = x.shape
    dx = torch.empty_like(x)
    if r:
        build.check_launch("linear_ce_bwd_dx", build.library().linear_ce_bwd_dx(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
            wt.data_ptr() if wt is not None else None, b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), g.data_ptr(), dx.data_ptr(), r, c, w.shape[1], _stream(x)))
        ce_dx_counter.launches += 1
        if design == "wgmma":
            ce_dx_wgmma_counter.launches += 1
    return dx


def launch_bwd_dw(x, w, b, labels, lse, g, wt=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dW/db kernel alone: dW (C, V) and db (V,), f32. ``wt`` as for
    :func:`launch_bwd_dx`. With no rows the bf16 design launches nothing:
    both are zeros."""
    design, x, w, b, labels, lse, g, wt = _bwd_inputs(x, w, b, labels, lse, g, wt)
    r, c = x.shape
    if design == "wgmma" and not r:
        return torch.zeros_like(w), torch.zeros_like(b)
    dw = torch.empty_like(w)
    db = torch.empty_like(b)
    build.check_launch("linear_ce_bwd_dw", build.library().linear_ce_bwd_dw(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        wt.data_ptr() if wt is not None else None, b.data_ptr(), labels.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dw.data_ptr(), db.data_ptr(), r, c, w.shape[1],
        _stream(x)))
    ce_dw_counter.launches += 1
    if design == "wgmma":
        ce_dw_wgmma_counter.launches += 1
    return dw, db


def _forward(x, w, b, labels):
    """``(loss, lse, wt)``: the forward kernel on CUDA tensors, with ``wt``
    the :func:`round_weight_t` its wgmma design read (None for the scalar
    design), for the backward to reuse; the plain version on CPU tensors
    (``wt`` None)."""
    _check(x, w, b, labels)
    if x.device.type == "cpu":
        ce_fwd_counter.plain_calls += 1
        return (*linear_ce_fwd_reference(x, w, b, labels), None)
    wt = round_weight_t(w) if ce_forward_design(x, w) == "wgmma" else None
    return (*launch_fwd(x, w, b, labels, wt), wt)


def linear_ce_fwd(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``: the forward kernel on CUDA tensors,
    :func:`linear_ce_fwd_reference` on CPU tensors."""
    return _forward(x, w, b, labels)[:2]


def linear_ce_bwd_dx(x, w, b, labels, lse, g) -> torch.Tensor:
    """dx: the dx kernel on CUDA tensors, the plain backward on CPU tensors."""
    _check(x, w, b, labels)
    if x.device.type == "cpu":
        ce_dx_counter.plain_calls += 1
        return linear_ce_bwd_reference(x, w, b, labels, lse, g)[0]
    return launch_bwd_dx(x, w, b, labels, lse, g)


def linear_ce_bwd_dw(x, w, b, labels, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW, db): the dW/db kernel on CUDA tensors, the plain backward on CPU
    tensors."""
    _check(x, w, b, labels)
    if x.device.type == "cpu":
        ce_dw_counter.plain_calls += 1
        return linear_ce_bwd_reference(x, w, b, labels, lse, g)[1:]
    return launch_bwd_dw(x, w, b, labels, lse, g)


def _backward(x, w, b, labels, lse, g, wt):
    """dx, dW, db from both backward kernels, reading the forward's ``wt``,
    or the plain backward on CPU tensors."""
    if x.device.type == "cpu":
        ce_dx_counter.plain_calls += 1
        ce_dw_counter.plain_calls += 1
        return linear_ce_bwd_reference(x, w, b, labels, lse, g)
    return (launch_bwd_dx(x, w, b, labels, lse, g, wt),
            *launch_bwd_dw(x, w, b, labels, lse, g, wt))


class FusedLinearCE(torch.autograd.Function):
    """Per-row CE of ``x @ w + b`` with the kernels' backward: the forward
    saves x, w, b, labels, lse and the bf16 design's round(W)^T, which the
    backward reads again (one copy of W a step, V.C.2 bytes); the backward
    returns dx, dW and db in the parameters' dtypes (labels get no
    gradient). ``plain=True`` runs the plain versions on any device (the
    kernels' stand-in in parity runs on the card)."""

    @staticmethod
    def forward(ctx, x, w, b, labels, plain: bool = False):
        if plain:
            loss, lse, wt = (*linear_ce_fwd_reference(x, w, b, labels), None)
        else:
            loss, lse, wt = _forward(x, w, b, labels)
        ctx.plain = plain
        ctx.save_for_backward(x, w, b, labels, lse, wt)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, lse, wt = ctx.saved_tensors
        if ctx.plain:
            dx, dw, db = linear_ce_bwd_reference(x, w, b, labels, lse, g.contiguous())
        else:
            dx, dw, db = _backward(x, w, b, labels, lse, g.contiguous(), wt)
        return dx, dw.to(w.dtype), db.to(b.dtype), None, None


def _linear_ce(features, kernel, bias, labels, plain: bool) -> torch.Tensor:
    if tuple(features.shape[:-1]) != tuple(labels.shape):
        raise ValueError(
            f"features {tuple(features.shape)} and labels {tuple(labels.shape)} disagree")
    if kernel.ndim != 2 or kernel.shape[0] != features.shape[-1] \
            or bias.shape != kernel.shape[1:]:
        raise ValueError(
            f"kernel {tuple(kernel.shape)} does not match features "
            f"{tuple(features.shape)} / bias {tuple(bias.shape)}")
    x = features.reshape(-1, features.shape[-1])
    lab = labels.reshape(-1)
    b = bias.float()  # the bias enters in f32, as pallas_linear_ce_integer casts it
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, b)):
        loss = FusedLinearCE.apply(x, kernel, b, lab, plain)
    else:
        fwd = linear_ce_fwd_reference if plain else linear_ce_fwd
        loss = fwd(x, kernel, b, lab)[0]
    return loss.reshape(labels.shape)


def linear_ce_integer(features: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE of ``features @ kernel + bias`` against integer
    ``labels``, the logits never in device memory.

    features: (..., C); kernel: (C, V); bias: (V,); labels: (...) int in
    [0, V). Returns f32 per-position losses shaped like ``labels``. When
    autograd records, gradients flow to features, kernel and bias through
    :class:`FusedLinearCE` (the backward kernels); otherwise only the
    forward runs. CUDA tensors launch the kernels, CPU tensors run the plain
    versions."""
    return _linear_ce(features, kernel, bias, labels, plain=False)


def plain_linear_ce_integer(features, kernel, bias, labels) -> torch.Tensor:
    """:func:`linear_ce_integer` through the plain versions on any device,
    differentiable the same way: what a parity run puts in the kernels'
    place. Counts no launch and no plain call."""
    return _linear_ce(features, kernel, bias, labels, plain=True)
