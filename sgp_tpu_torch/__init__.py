"""sgp_tpu_torch — the SGP model family in PyTorch, for an NVIDIA H100.

The port of :mod:`sgp_tpu` (JAX, TPU), which stays the reference: each
module here sits at the same relative path as its JAX counterpart and is
held against it by the ``tests/test_torch_port_*.py`` parity tests. Plain
tensor code is PyTorch; the one Pallas kernel on the ported path, the
block-sparse SpMM, is CUDA C++ for ``sm_90a`` (``csrc/bsr_spmm.cu``).

This package never imports ``jax`` or ``sgp_tpu``.
"""
import torch

__version__ = "0.1.0"

epsilon = 1e-8

# float32 products run in full f32 on the card, as the JAX package's
# precision="highest" does: no TF32 in matmuls or in cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
