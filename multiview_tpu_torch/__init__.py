"""multiview_tpu_torch: the PyTorch / CUDA port of ``multiview_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``io/``, ``calib/``, ``geometry/``, ``sfm/``, ``solver/``, ``tools/``,
``utils/``) with PyTorch code that runs on an NVIDIA H100. Plain tensor
math is PyTorch; the one TPU (Pallas) kernel of the reference, the fused
descriptor distance + top-2 matcher, is a hand-written CUDA kernel for
Hopper (``csrc/knn2.cu``), built with nvcc at first use.

Numerics: on CUDA the port computes in float32 with TF32 disabled for
both matmuls and cuDNN convolutions (TF32 keeps about three decimal
digits, which flips near-ties in the matcher's ratio test and shifts
sub-pixel keypoints). On the CPU it runs in float64 for the parity tests
against the JAX package.

This package never imports ``jax`` or ``multiview_tpu``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
