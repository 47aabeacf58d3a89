"""perceiver_io_torch: the PyTorch / CUDA port of ``perceiver_io_tpu`` for an
NVIDIA H100 (sm_90a).

It serves and trains the MLM: ``models.presets`` builds the model,
``inference.engine.MLMServer`` serves it (``cli.serve``), and
``training`` trains it (``cli.train_mlm``); Perceiver-AR generates and
trains (``cli.train_ar``), and the classifiers train on text, with an
encoder transferred from an MLM run, and on MNIST images
(``cli.train_seq_clf``, ``cli.train_img_clf``). Attention (forward and
backward) and the weight-only dequantizing matmul run as CUDA kernels
written by hand (``csrc/``); on CPU tensors each runs its plain PyTorch
version. Entry points run on the CUDA card unless given ``device='cpu'``.
The package imports neither JAX nor ``perceiver_io_tpu``.
"""
