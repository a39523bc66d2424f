"""astcenc_torch: the ASTC codec on PyTorch, with hand-written CUDA kernels.

A port of the JAX package ``astcenc_tpu`` (which stays the reference) to
PyTorch on an NVIDIA Hopper card. Plain tensor code is PyTorch; the trial
front end (mode search) and the refinement rounds of the encoder are CUDA
C++ kernels under ``csrc/``, built with nvcc at first use.

The package never imports jax nor anything of the JAX package: it keeps
its own copies of the host-side NumPy table builders (``config``,
``tables``, ``codec/decode_tables``).
"""

import torch as _torch

# The reference runs its float32 contractions at full precision; TF32 would
# round their operands to 10 mantissa bits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
