"""Build the port's CUDA kernels with ``nvcc`` and load them through ``ctypes``.

Every ``csrc/*.cu`` source (with the ``*.cuh`` headers it includes) has a
plain C interface (pointers, ints and a stream; the return value is the
launch's ``cudaError_t``), so the build needs
no PyTorch headers: each source compiles to an object in parallel, and the
objects link into one shared library under ``perceiver_io_torch/_build/``,
named by a digest of the sources and flags so a changed source never loads a
stale build. The build runs at first use, never at import time, and only
where a kernel is launched (a machine with a CUDA card and the toolkit).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_int, _c_ptr, _c_i64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
# argtypes of every C entry point, in the order of its signature
_SIGNATURES = {
    "attention_fwd": [_c_int, _c_int] + [_c_ptr] * 7 + [_c_int] * 6
                     + [_c_i64] * 9 + [_c_ptr],
    "attention_bwd_dq": [_c_int, _c_int] + [_c_ptr] * 9 + [_c_int] * 6
                        + [_c_i64] * 12 + [_c_ptr],
    "attention_bwd_dkv": [_c_int, _c_int] + [_c_ptr] * 10 + [_c_int] * 6
                         + [_c_i64] * 12 + [_c_ptr],
    "dequant_matmul": [_c_int, _c_int, _c_int] + [_c_ptr] * 4 + [_c_int] * 3
                      + [_c_ptr],
    "linear_ce_fwd": [_c_int] + [_c_ptr] * 7 + [_c_int] * 3 + [_c_ptr],
    "linear_ce_bwd_dx": [_c_int] + [_c_ptr] * 8 + [_c_int] * 3 + [_c_ptr],
    "linear_ce_bwd_dw": [_c_int] + [_c_ptr] * 9 + [_c_int] * 3 + [_c_ptr],
    "packed_attention_fwd": [_c_int, _c_int] + [_c_ptr] * 5 + [_c_int] * 4
                            + [_c_i64] * 6 + [_c_ptr],
    "packed_attention_bwd_dq": [_c_int, _c_int] + [_c_ptr] * 7 + [_c_int] * 4
                               + [_c_i64] * 8 + [_c_ptr],
    "packed_attention_bwd_dkv": [_c_int, _c_int] + [_c_ptr] * 8 + [_c_int] * 4
                                + [_c_i64] * 8 + [_c_ptr],
}

_lock = threading.Lock()
_library = None


# the launch record of a CUDA graph capture running on this thread (capturing)
_capture = threading.local()


class LaunchCounter:
    """Counts one wrapper's work: ``launches`` where it launched its CUDA
    kernel, ``plain_calls`` where it ran the plain PyTorch version because
    its tensors lie on the CPU. A launch made on a thread that is capturing
    a CUDA graph (:func:`capturing`) runs nothing yet: it goes to the
    capture's record, which the graph adds at each replay
    (``inference/programs.py``), while other threads' launches count as
    ever."""

    def __init__(self):
        self._launches = 0
        self.plain_calls = 0

    @property
    def launches(self) -> int:
        return self._launches

    @launches.setter
    def launches(self, value: int) -> None:
        record = getattr(_capture, "record", None)
        if record is None:
            self._launches = value
        else:
            record[self] = record.get(self, 0) + value - self._launches

    def reset(self) -> None:
        self._launches = 0
        self.plain_calls = 0


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured on this thread: yields the record
    ``{counter: launches}`` that the thread's wrapper calls add to in place
    of their counters."""
    record: dict = {}
    _capture.record = record
    try:
        yield record
    finally:
        _capture.record = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of perceiver_io_torch need the CUDA toolkit to build")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # the sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libperceiver_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all started together)
    and link one shared library; returns its path. A library already built
    from the same sources is reused. The compiler's report (registers,
    shared memory, spills per kernel) is kept beside it as ``.log``."""
    target = library_path()
    if target.exists():
        return target
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objects = [], []
        for src, obj, proc in procs:
            output, _ = proc.communicate()
            logs.append(f"== {src.name}\n{output}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{output}")
            objects.append(str(obj))
        staged = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", *objects, "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        target.with_suffix(".log").write_text("\n".join(logs))
        os.replace(staged, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = lib
    return _library


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {err}")
