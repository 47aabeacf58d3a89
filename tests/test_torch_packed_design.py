"""The packed-heads kernels' admission rule, checked on the CPU.

``packed_attention_kernel.packed_design`` and ``packed_backward_design``
pick the design of #4 and #5 by dtype: float32 the exact scalar kernels,
bfloat16 the tensor-core (``wgmma``) kernels fed by TMA, which need 16-byte
aligned bases and (batch, row) strides that are multiples of 8 elements;
anything else raises ``ValueError``. The cotangent is not held to TMA's
rules: one it refuses is copied to contiguous memory before the launch. The
rules read layouts only, so CPU tensors answer them. The C prototypes of
the three packed entry points are held against ``build._SIGNATURES``.
"""

import ctypes
import re

import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)
import torch

from perceiver_io_torch.ops import build
from perceiver_io_torch.ops import packed_attention_kernel as pk
from perceiver_io_torch.ops.attention_kernel import _kernel_grad

_PROTOTYPE = re.compile(r'extern "C" int (packed_\w+)\(([^)]*)\)', re.S)
_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_int64: "int64_t"}


def _packed(dtype, b=2, n=5, h=4, d=16):
    return torch.zeros(b, n, h * d, dtype=dtype)


def _misaligned(dtype, shape):
    flat = torch.zeros(1 + torch.Size(shape).numel(), dtype=dtype)
    return flat[1:].view(shape)


@pytest.mark.parametrize("name", ["packed_attention_fwd", "packed_attention_bwd_dq",
                                  "packed_attention_bwd_dkv"])
def test_packed_prototype_matches_signature(name):
    text = (build.CSRC_DIR / "packed_attention.cu").read_text()
    found = {n: ["pointer" if "*" in a else a.split()[0]
                 for a in (x.strip() for x in args.split(","))]
             for n, args in _PROTOTYPE.findall(text)}
    assert [_KINDS[t] for t in build._SIGNATURES[name]] == found[name]


@pytest.mark.parametrize("d", pk.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype,design", [(torch.float32, "scalar_f32"),
                                          (torch.bfloat16, "wgmma")])
def test_packed_design_by_dtype(dtype, design, d):
    q, k = _packed(dtype, d=d), _packed(dtype, n=7, d=d)
    assert pk.packed_design(q, k, k, 4) == design
    assert pk.packed_backward_design(q, k, k, torch.zeros_like(q), 4) == design


def test_packed_design_takes_views():
    """q, k and v sliced out of one (B, S, 3, E) tensor, and 32 heads of 16."""
    for dtype, design in ((torch.float32, "scalar_f32"), (torch.bfloat16, "wgmma")):
        qkv = torch.zeros(2, 9, 3, 64, dtype=dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        assert pk.packed_design(q, k, v, 4) == design
        assert pk.packed_backward_design(q, k, v, q, 4) == design
        wide = _packed(dtype, h=32, d=16)
        assert pk.packed_design(wide, wide, wide, 32) == design


@pytest.mark.parametrize("case,match", [
    ("head_dim_24", "head dim 24 unsupported"),
    ("float16", "float32 or bfloat16"),
    ("strided_e", "unit stride along E"),
    ("misaligned_base", "16-byte aligned"),
    ("row_stride_68", "multiples of 8 elements"),
    ("batch_stride_340", "multiples of 8 elements"),
])
def test_packed_design_refusals(case, match):
    bf = torch.bfloat16
    q = k = _packed(bf)
    heads = 4
    if case == "head_dim_24":
        q = k = _packed(bf, h=2, d=24)
        heads = 2
    elif case == "float16":
        q = k = _packed(torch.float16)
    elif case == "strided_e":
        q = k = torch.zeros(2, 5, 128, dtype=bf)[..., ::2]
    elif case == "misaligned_base":
        q = _misaligned(bf, (2, 5, 64))
    elif case == "row_stride_68":  # rows of 64 channels inside rows of 68
        q = torch.zeros(2, 5, 68, dtype=bf)[:, :, :64]
    elif case == "batch_stride_340":  # examples of 5 x 64 inside blocks of 340
        q = torch.zeros(2, 340, dtype=bf)[:, :320].view(2, 5, 64)
    with pytest.raises(ValueError, match=match):
        pk.packed_design(q, k, k, heads)
    with pytest.raises(ValueError, match=match):
        pk.packed_backward_design(q, k, k, torch.zeros(q.shape, dtype=q.dtype), heads)


def test_f32_packed_design_takes_any_base():
    q = _misaligned(torch.float32, (2, 5, 64))
    assert pk.packed_design(q, q, q, 4) == "scalar_f32"


@pytest.mark.parametrize("case", ["g_shape", "g_dtype"])
def test_packed_backward_design_refuses_a_foreign_cotangent(case):
    q = _packed(torch.bfloat16)
    g = _packed(torch.bfloat16, n=6) if case == "g_shape" else q.float()
    with pytest.raises(ValueError, match="must match q"):
        pk.packed_backward_design(q, q, q, g, 4)


@pytest.mark.parametrize("layout,copied", [
    ("contiguous", False),
    ("sliced", False),
    ("row_stride_68", True),
    ("broadcast", True),
    ("misaligned", True),
    ("strided_e", True),
])
def test_packed_cotangent_layouts(layout, copied):
    """A cotangent TMA can load is read in place; one it refuses (a stride-0
    broadcast, as ``.sum().backward()`` hands over) is accepted by
    ``packed_backward_design`` and copied to contiguous memory first. The
    f32 design copies only a g without unit stride along E."""
    bf = torch.bfloat16
    q = _packed(bf)
    g = {"contiguous": lambda: torch.zeros_like(q),
         "sliced": lambda: torch.zeros(2, 5, 3, 64, dtype=bf)[:, :, 1],
         "row_stride_68": lambda: torch.zeros(2, 5, 68, dtype=bf)[:, :, :64],
         "broadcast": lambda: torch.zeros((), dtype=bf).expand(q.shape),
         "misaligned": lambda: _misaligned(bf, tuple(q.shape)),
         "strided_e": lambda: torch.zeros(2, 5, 128, dtype=bf)[..., ::2]}[layout]()
    design = pk.packed_backward_design(q, q, q, g, 4)
    assert design == "wgmma"
    read = _kernel_grad(g, design)
    assert (read is not g) == copied
    assert read.stride(2) == 1 and torch.equal(read, g)
    if copied:
        assert read.is_contiguous()
    g32 = g.float() if layout != "strided_e" else torch.zeros(2, 5, 128)[..., ::2]
    assert (_kernel_grad(g32, "scalar_f32") is not g32) == (layout == "strided_e")


def test_packed_wrappers_refuse_cpu_tensors():
    """The launches take CUDA tensors only; the CPU runs the plain versions
    through the public entry points, which count no launch."""
    q = _packed(torch.bfloat16)
    bias = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="no packed attention kernel for device cpu"):
        pk.launch_fwd(q, q, q, bias, 4)
    counters = (pk.fwd_counter, pk.fwd_wgmma_counter, pk.dq_wgmma_counter,
                pk.dkv_wgmma_counter)
    before = [c.launches for c in counters]
    pk.packed_attention_fwd(q, q, q, 4)
    pk.packed_attention_bwd(q, q, q, 4, None, torch.zeros((), dtype=q.dtype).expand(q.shape))
    assert [c.launches for c in counters] == before
