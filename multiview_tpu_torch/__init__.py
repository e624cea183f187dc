"""multiview_tpu_torch: the PyTorch / CUDA port of ``multiview_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``io/``, ``calib/``, ``dense/``, ``geometry/``, ``sfm/``, ``solver/``,
``tools/``, ``utils/``) with PyTorch code that runs on an NVIDIA H100. Plain tensor
math is PyTorch; the one TPU (Pallas) kernel of the reference, the fused
descriptor distance + top-2 matcher, is a pair of hand-written CUDA kernels
for Hopper (``csrc/knn2_wgmma.cu`` for 64- and 128-wide descriptors,
``csrc/knn2.cu`` for any other width), built with nvcc at first use.

Ported: everything the JAX package does. The ``calibrate`` path (rig BA
with depth and mesh constraints, the dense LM and the RPC refit,
``fit-rpc``, SIFT and SURF features, out-of-core matching, match files,
registration to control points), the ``sfm-init`` path (two-view geometry,
global and incremental SfM, retrieval pair selection), the dense path
(``undistort``, ``fuse-mesh``: plane-sweep stereo, the cloud filter, TSDF
fusion, marching tetrahedra), texturing (``texture``, ``calibrate
--out_texture_dir``) and sharding (``parallel/``: the row-sharded Schur BA
behind ``calibrate --sharded``, the sharded front end, TSDF slabs,
multi-process start-up over ``torch.distributed``).

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
