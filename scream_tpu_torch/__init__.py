"""SCREAM-TPU's registration and ground-generation paths in PyTorch, with
hand-written Hopper kernels.

The PyTorch/CUDA port of :mod:`scream_tpu`: the protocol path
(``pipeline.register_batch``), the benchmark protocols (``eval``: 3DMatch,
3DLoMatch, 3DZeroMatch, KITTI, OpenGF; ``python -m scream_tpu_torch
evaluate``) and the throughput benchmark (``bench``, ``python -m
scream_tpu_torch bench``) with the shipped full-width checkpoints, GT-free serving (``register_pair``,
``register_pairs``, the robust search, ``python -m scream_tpu_torch
register``) with the shipped hint-free checkpoint under ``weights/``, and
training (the GAN steps, ``train.RegistrationTrainer``,
``train.DEMTrainer`` and ``python -m scream_tpu_torch train``), and the
tools (``selftest``, ``convert``, ``visualize``). It
mirrors the JAX package's layout and names (``scream_tpu_torch/geometry/icp.py``
is the port of ``scream_tpu/geometry/icp.py``), imports ``torch`` and never
``jax``, and keeps its own copies of what it needs from the JAX package.

Each Pallas kernel of the JAX package on a ported path becomes a CUDA C++
kernel for ``sm_90a`` under ``csrc/``, built at first use with ``nvcc`` and
loaded with ``ctypes`` (``ops/_build.py``). Each kernel wrapper launches its
kernel for CUDA tensors and takes its plain PyTorch version only for CPU
tensors.

The geometry is fp32 end to end: TF32 is off for matmuls and cuDNN, as the
JAX package forces "highest" matmul precision.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
