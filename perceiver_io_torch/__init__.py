"""perceiver_io_torch: the PyTorch / CUDA port of ``perceiver_io_tpu`` for an
NVIDIA H100 (sm_90a).

This slice serves the fill-mask MLM: ``models.presets`` builds the model,
``inference.engine.MLMServer`` serves it, ``cli.serve`` is the command line.
Attention and the weight-only dequantizing matmul run as CUDA kernels
written by hand (``csrc/``); on CPU tensors each runs its plain PyTorch
version. Entry points run on the CUDA card unless given ``device='cpu'``.
The package imports neither JAX nor ``perceiver_io_tpu``.
"""
