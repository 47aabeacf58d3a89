"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``. None means the CUDA card, and raises
    when there is none: the port's entry points run on the GPU unless the
    caller asks for the CPU (``device='cpu'``, which runs the kernels'
    plain PyTorch versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: perceiver_io_torch runs on the GPU "
                "by default; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)
