"""The port's kernel interface, checked on the CPU before any card sees it.

- Every ``extern "C"`` entry point of ``perceiver_io_torch/csrc/*.cu`` has a
  ``ctypes`` signature in ``build._SIGNATURES`` with the same number and
  kinds of arguments (pointer, ``int``, ``int64_t``): a mismatch would pass
  a cut pointer or a shifted argument at the first launch; the causal flag
  and offset of the attention forward and of both backward entry points
  stand where their wrappers pass them.
- The admission rule of the kernels with two designs: which dtype, head
  dim and strides reach the bf16 ``wgmma`` design, which the f32 scalar one,
  and which raise ``ValueError`` (``attention_kernel.forward_design`` and
  ``backward_design``, ``qmatmul.matmul_design``,
  ``ce_kernel.ce_forward_design`` and ``ce_backward_design``); which
  cotangent layouts the backward reads in place and which it copies first;
  the CE kernels' bf16 view of W (``ce_kernel.round_weight_t``). The rules read layouts only, so CPU
  tensors answer them.
- The deep head dims (256, 512 and 1024) reach the deep designs through
  the C entry points' dispatch.
"""

import ctypes
import re

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_torch.ops import attention_kernel as ak
from perceiver_io_torch.ops import build
from perceiver_io_torch.ops import ce_kernel as ck
from perceiver_io_torch.ops import qmatmul as qm

_PROTOTYPE = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_int64: "int64_t"}


def _prototypes() -> dict:
    found = {}
    for src in build.sources():
        for name, args in _PROTOTYPE.findall(src.read_text()):
            found[name] = ["pointer" if "*" in a else a.split()[0]
                           for a in (x.strip() for x in args.split(","))]
    return found


def test_every_entry_point_is_bound():
    assert sorted(_prototypes()) == sorted(build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_signature_matches_prototype(name):
    assert [_KINDS[t] for t in build._SIGNATURES[name]] == _prototypes()[name]


def _heads(dtype, b=2, n=5, h=2, d=16):
    return torch.zeros(b, n, h, d, dtype=dtype)


def _misaligned(dtype, shape):
    flat = torch.zeros(1 + torch.Size(shape).numel(), dtype=dtype)
    return flat[1:].view(shape)


@pytest.mark.parametrize("d", ak.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype,design", [(torch.float32, "scalar_f32"),
                                          (torch.bfloat16, "wgmma")])
def test_attention_design_by_dtype(dtype, design, d):
    q, k = _heads(dtype, d=d), _heads(dtype, n=7, d=d)
    assert ak.forward_design(q, k, k) == design


def test_attention_design_takes_head_split_views():
    for dtype, design in ((torch.float32, "scalar_f32"), (torch.bfloat16, "wgmma")):
        qkv = torch.zeros(2, 9, 3, 4, 32, dtype=dtype)  # (B, S, 3, H, D)
        assert ak.forward_design(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) == design


@pytest.mark.parametrize("case,match", [
    ("head_dim_24", "head dim 24 unsupported"),
    ("float16", "float32 or bfloat16"),
    ("strided_d", "unit stride along the head dim"),
    ("misaligned_base", "16-byte aligned"),
    ("row_stride_12", "multiples of 8 elements"),
])
def test_attention_design_refusals(case, match):
    bf = torch.bfloat16
    q = _heads(bf)
    if case == "head_dim_24":
        q = _heads(bf, d=24)
    elif case == "float16":
        q = _heads(torch.float16)
    elif case == "strided_d":
        q = _heads(bf, d=32)[..., ::2]
    elif case == "misaligned_base":
        q = _misaligned(bf, (2, 5, 2, 16))
    elif case == "row_stride_12":  # rows of 2 heads x 16 inside rows of 36 elements
        q = torch.zeros(2, 5, 36, dtype=bf)[:, :, :32].unflatten(2, (2, 16))
    k = _heads(q.dtype, n=7, d=q.shape[-1])
    if case == "strided_d":
        k = _heads(bf, n=7, d=32)[..., ::2]
    with pytest.raises(ValueError, match=match):
        ak.forward_design(q, k, k)


@pytest.mark.parametrize("d", ak.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype,design", [(torch.float32, "scalar_f32"),
                                          (torch.bfloat16, "wgmma")])
def test_attention_backward_design_by_dtype(dtype, design, d):
    q, k = _heads(dtype, d=d), _heads(dtype, n=7, d=d)
    assert ak.backward_design(q, k, k, torch.zeros_like(q)) == design
    qkv = torch.zeros(2, 9, 3, 4, d, dtype=dtype)  # head-split views
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert ak.backward_design(q, k, v, q) == design


@pytest.mark.parametrize("case,match", [
    ("head_dim_24", "head dim 24 unsupported"),
    ("float16", "float32 or bfloat16"),
    ("misaligned_q", "16-byte aligned"),
    ("row_stride_12_k", "multiples of 8 elements"),
    ("g_shape", "must match q"),
    ("g_dtype", "must match q"),
])
def test_attention_backward_design_refusals(case, match):
    bf = torch.bfloat16
    q, k = _heads(bf), _heads(bf, n=7)
    g = torch.zeros_like(q)
    if case == "head_dim_24":
        q, k, g = _heads(bf, d=24), _heads(bf, n=7, d=24), _heads(bf, d=24)
    elif case == "float16":
        q, k, g = q.half(), k.half(), g.half()
    elif case == "misaligned_q":
        q = _misaligned(bf, (2, 5, 2, 16))
    elif case == "row_stride_12_k":  # rows of 2 heads x 16 inside rows of 36 elements
        k = torch.zeros(2, 7, 36, dtype=bf)[:, :, :32].unflatten(2, (2, 16))
    elif case == "g_shape":
        g = _heads(bf, n=6)
    elif case == "g_dtype":
        g = g.float()
    with pytest.raises(ValueError, match=match):
        ak.backward_design(q, k, k, g)


@pytest.mark.parametrize("layout,copied", [
    ("contiguous", False),
    ("head_split", False),
    ("row_stride_12", True),
    ("broadcast", True),
    ("misaligned", True),
    ("strided_d", True),
])
def test_attention_backward_cotangent_layouts(layout, copied):
    """A cotangent TMA can load is read in place; one it refuses (as autograd
    may hand over: a broadcast has stride 0) is copied to contiguous first
    for the wgmma design. The f32 design copies only a g without unit
    stride along D."""
    bf = torch.bfloat16
    q = _heads(bf)
    g = {"contiguous": lambda: torch.zeros_like(q),
         "head_split": lambda: torch.zeros(2, 5, 3, 2, 16, dtype=bf)[:, :, 1],
         "row_stride_12": lambda: torch.zeros(2, 5, 36, dtype=bf)[:, :, :32].unflatten(2, (2, 16)),
         "broadcast": lambda: torch.zeros((), dtype=bf).expand(q.shape),
         "misaligned": lambda: _misaligned(bf, tuple(q.shape)),
         "strided_d": lambda: torch.zeros(2, 5, 2, 32, dtype=bf)[..., ::2]}[layout]()
    design = ak.backward_design(q, q, q, g)
    assert design == "wgmma"
    read = ak._kernel_grad(g, design)
    assert (read is not g) == copied
    assert read.stride(3) == 1 and torch.equal(read, g)
    if copied:
        assert read.is_contiguous()
    g32 = g.float() if layout != "strided_d" else torch.zeros(2, 5, 2, 32)[..., ::2]
    assert (ak._kernel_grad(g32, "scalar_f32") is not g32) == (layout == "strided_d")


def test_f32_attention_takes_any_base():
    q = _misaligned(torch.float32, (2, 5, 2, 16))
    assert ak.forward_design(q, q, q) == "scalar_f32"


@pytest.mark.parametrize("dtype,k,group_size,design", [
    (torch.float32, 512, None, "scalar_f32"),
    (torch.float32, 36, 12, "scalar_f32"),
    (torch.bfloat16, 512, None, "wgmma"),
    (torch.bfloat16, 512, 64, "wgmma"),
    (torch.bfloat16, 512, 128, "wgmma"),
    (torch.bfloat16, 40, None, "wgmma"),
])
def test_dequant_design(dtype, k, group_size, design):
    assert qm.matmul_design(torch.zeros(3, k, dtype=dtype), group_size) == design


@pytest.mark.parametrize("case,match", [
    ("float16", "float32 or bfloat16"),
    ("misaligned_base", "16-byte aligned"),
    ("depth_12", "multiple of 8"),
    ("group_12", "group_size 12"),
])
def test_dequant_design_refusals(case, match):
    x, group_size = torch.zeros(3, 48, dtype=torch.bfloat16), None
    if case == "float16":
        x = x.half()
    elif case == "misaligned_base":
        x = _misaligned(torch.bfloat16, (3, 48))
    elif case == "depth_12":
        x = torch.zeros(3, 12, dtype=torch.bfloat16)
    elif case == "group_12":
        group_size = 12
    with pytest.raises(ValueError, match=match):
        qm.matmul_design(x, group_size)


def _prototype_args(name: str) -> list:
    """The parameter names of one C entry point."""
    for src in build.sources():
        for found, args in _PROTOTYPE.findall(src.read_text()):
            if found == name:
                return [a.strip().split()[-1].lstrip("*") for a in args.split(",")]
    raise KeyError(name)


@pytest.mark.parametrize("name,outputs", [("linear_ce_bwd_dx", ["dx"]),
                                          ("linear_ce_bwd_dw", ["dw", "db"]),
                                          ("linear_ce_fwd", ["loss", "lse"])])
def test_ce_backward_prototypes_take_the_bf16_weight(name, outputs):
    """The CE entry points, the two backward ones and the forward, take W
    (f32, the scalar design) and Wt (round(W)^T in bf16, the wgmma design)
    beside each other, in the order the wrappers pass them."""
    inputs = [] if name == "linear_ce_fwd" else ["lse", "g"]
    assert _prototype_args(name) == (["dtype", "x", "w", "wt", "b", "labels"] + inputs
                                     + outputs + ["rows", "channels", "vocab", "stream"])


def test_attention_forward_prototype_takes_the_causal_offset():
    """The forward's entry point takes the causal flag and offset right
    after ``heads``, in the order ``attention_kernel._launch_fwd`` passes
    them (``int(causal_offset is not None), causal_offset or 0``)."""
    assert _prototype_args("attention_fwd") == (
        ["dtype", "head_dim", "q", "k", "v", "bias", "out", "m_out", "l_out", "batch",
         "t_len", "s_len", "heads", "causal", "causal_offset"]
        + [f"s{t}{d}" for t in "qkv" for d in ("b", "t" if t == "q" else "s", "h")]
        + ["stream"])


@pytest.mark.parametrize("name,outputs", [("attention_bwd_dq", ["dq"]),
                                          ("attention_bwd_dkv", ["dk", "dv"])])
def test_attention_backward_prototypes_take_the_causal_offset(name, outputs):
    """The two backward entry points take the causal flag and offset right
    after ``heads``, as the forward's does, in the order
    ``attention_kernel._bwd_args`` passes them."""
    assert _prototype_args(name) == (
        ["dtype", "head_dim", "q", "k", "v", "g", "bias", "m", "l", "delta"] + outputs
        + ["batch", "t_len", "s_len", "heads", "causal", "causal_offset"]
        + [f"s{t}{d}" for t in "qkvg" for d in ("b", "t" if t in "qg" else "s", "h")]
        + ["stream"])


def test_deep_head_dims_reach_the_deep_designs():
    """Every ``DEEP_HEAD_DIMS`` depth is dispatched on the C side, and no
    other: ``attention_fwd.cu``'s switch sends it to ``attn_deep::fwd``,
    ``attn_deep::takes`` admits it for ``attention_bwd.cu``, and
    ``attention_deep.cu`` has its case in ``fwd``, ``bwd_dq`` and
    ``bwd_dkv`` (both designs each). D = 1024 is ImageNet's cross head."""
    csrc = build.CSRC_DIR
    takes = re.search(r"bool takes\(int head_dim\) \{(.*?)\}",
                      (csrc / "attention_deep.cuh").read_text(), re.S).group(1)
    assert sorted(int(x) for x in re.findall(r"head_dim == (\d+)", takes)) == list(
        ak.DEEP_HEAD_DIMS)
    fwd = (csrc / "attention_fwd.cu").read_text()
    to_deep = re.search(r"case 128: return PIT_LAUNCH\(128\);(.*?)return attn_deep::fwd",
                        fwd, re.S).group(1)
    assert [int(x) for x in re.findall(r"case (\d+):", to_deep)] == list(ak.DEEP_HEAD_DIMS)
    deep = (csrc / "attention_deep.cu").read_text()
    cases = [int(x) for x in re.findall(r"case (\d+): return", deep)]
    assert cases == list(ak.DEEP_HEAD_DIMS) * 3
    for d in ak.DEEP_HEAD_DIMS:
        assert f"dq_scalar<{d}>(a) : bwd_wgmma<{d}, true>(a)" in deep
        assert f"dkv_scalar<{d}>(a) : bwd_wgmma<{d}, false>(a)" in deep
    assert max(ak.SUPPORTED_HEAD_DIMS) == max(ak.DEEP_HEAD_DIMS) == 1024


def _ce_design_by_dtype(design_of, dtype, design, c):
    x, w = torch.zeros(37, c, dtype=dtype), torch.zeros(c, 11)
    assert design_of(x, w) == design
    assert design_of(x, w.to(dtype)) == design  # any W dtype: the kernels round it


@pytest.mark.parametrize("c", [8, 16, 24, 64, 72, 128, 256, 512])
@pytest.mark.parametrize("dtype,design", [(torch.float32, "scalar"),
                                          (torch.bfloat16, "wgmma")])
def test_ce_backward_design_by_dtype(dtype, design, c):
    _ce_design_by_dtype(ck.ce_backward_design, dtype, design, c)


@pytest.mark.parametrize("c", [8, 16, 24, 64, 72, 128, 256, 512])
@pytest.mark.parametrize("dtype,design", [(torch.float32, "scalar"),
                                          (torch.bfloat16, "wgmma")])
def test_ce_forward_design_by_dtype(dtype, design, c):
    """The forward's designs follow the backward's rule: one round(W)^T
    serves both in bf16."""
    _ce_design_by_dtype(ck.ce_forward_design, dtype, design, c)


def _noncontiguous_x(layout):
    bf = torch.bfloat16
    x = {"column_slice": lambda: torch.zeros(37, 72, dtype=bf)[:, :64],
         "transposed": lambda: torch.zeros(64, 37, dtype=bf).t(),
         "broadcast": lambda: torch.zeros(64, dtype=bf).expand(37, 64),
         "one_row": lambda: torch.zeros(3, 128, dtype=bf)[1:2, :64]}[layout]()
    if layout == "one_row":
        assert x.is_contiguous() and x.data_ptr() % 16 == 0
    else:
        assert not x.is_contiguous()
    return x


@pytest.mark.parametrize("layout", ["column_slice", "transposed", "broadcast", "one_row"])
def test_ce_backward_design_takes_noncontiguous_x(layout):
    """A bf16 x that is not contiguous is copied to contiguous (aligned)
    memory by the wrapper, as the scalar design copies it: the wgmma design
    takes it; so does a single row whatever its stride."""
    assert ck.ce_backward_design(_noncontiguous_x(layout), torch.zeros(64, 11)) == "wgmma"


@pytest.mark.parametrize("layout", ["column_slice", "transposed", "broadcast", "one_row"])
def test_ce_forward_design_takes_noncontiguous_x(layout):
    """The same for the forward, whose wrapper copies x alike."""
    assert ck.ce_forward_design(_noncontiguous_x(layout), torch.zeros(64, 11)) == "wgmma"


_CE_REFUSALS = [
    ("channels_12", "multiple of 8 up to 512"),
    ("channels_520", "multiple of 8 up to 512"),
    ("channels_0", "multiple of 8 up to 512"),
    ("float16", "float32 or bfloat16"),
    ("misaligned_bf16", "16-byte aligned"),
    ("w_mismatch", "expected x"),
    ("x_3d", "expected x"),
]


def _ce_refusal(design_of, case, match):
    bf = torch.bfloat16
    x, w = torch.zeros(37, 64, dtype=bf), torch.zeros(64, 11)
    if case.startswith("channels_"):
        c = int(case.split("_")[1])
        x, w = torch.zeros(37, c, dtype=bf), torch.zeros(c, 11)
    elif case == "float16":
        x = x.half()
    elif case == "misaligned_bf16":
        x = _misaligned(bf, (37, 64))
    elif case == "w_mismatch":
        w = torch.zeros(32, 11)
    elif case == "x_3d":
        x = x.view(37, 8, 8)
    with pytest.raises(ValueError, match=match):
        design_of(x, w)


@pytest.mark.parametrize("case,match", _CE_REFUSALS)
def test_ce_backward_design_refusals(case, match):
    _ce_refusal(ck.ce_backward_design, case, match)


@pytest.mark.parametrize("case,match", _CE_REFUSALS)
def test_ce_forward_design_refusals(case, match):
    """The forward refuses what the backward refuses, with the same words."""
    _ce_refusal(ck.ce_forward_design, case, match)


def test_f32_ce_backward_takes_any_base():
    assert ck.ce_backward_design(_misaligned(torch.float32, (37, 64)),
                                 torch.zeros(64, 11)) == "scalar"


@pytest.mark.parametrize("c,v", [(8, 5), (64, 10003), (512, 77)])
def test_round_weight_t_is_w_in_bf16_transposed(c, v):
    """The bf16 design's Wt is W rounded to bf16 exactly as ``w.to(x.dtype)``
    rounds it (the plain backward's rounding), transposed to (V, C) and
    contiguous in fresh memory."""
    w = torch.from_numpy(np.random.default_rng(c + v).normal(size=(c, v)).astype(np.float32))
    wt = ck.round_weight_t(w)
    assert wt.shape == (v, c) and wt.dtype == torch.bfloat16 and wt.is_contiguous()
    assert wt.data_ptr() % 16 == 0
    assert torch.equal(wt, w.to(torch.bfloat16).t())
    assert torch.equal(wt.t().float(), ck.round_weight_t(w.t().contiguous().t()).t().float())
