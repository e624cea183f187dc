"""RPC distortion fitting: approximate any distortion model with a rational
polynomial, then fit its inverse. Port of ``multiview_tpu/geometry/rpc_fit.py``
(genUndistDistPairs / fitRpcDist / fitRpcUndist / evalRpcDistUndist,
rpc_distortion.cc:495-739): the sample grid is one batched conversion, each
per-degree fit is a dense LM solve with autograd Jacobians, and the
progressive degree-by-degree warm start is a small host loop.

The samples are converted in the camera's dtype on its device; the fits
themselves run in float64 on that device whatever the working dtype (their
normal equations hold monomials of pixel coordinates up to the RPC degree,
which float32 cannot carry), and the coefficients come back as float64
tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry import distortion as D
from multiview_tpu_torch.geometry.camera import CameraParams, UNDISTORTED, DISTORTED
from multiview_tpu_torch.solver.lm import levenberg_marquardt


def gen_undist_dist_pairs(cam: CameraParams, num_samples: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample the undistorted image uniformly; keep points whose distorted
    image lands inside the distorted crop window. Returns *centered* pixel
    pairs (undist_c, dist_c) (``genUndistDistPairs``,
    rpc_distortion.cc:499-557)."""
    uw, uh = cam.undistorted_size
    xs = cam._vec(np.linspace(0.0, uw - 1.0, num_samples))
    ys = cam._vec(np.linspace(0.0, uh - 1.0, num_samples))
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="ij"), dim=-1).reshape(-1, 2)
    dist = cam.convert(grid, UNDISTORTED, DISTORTED)
    keep = torch.all(torch.abs(dist - cam.distorted_half_size)
                     <= cam._vec(cam.distorted_crop_size) / 2.0, dim=-1)
    return (grid[keep] - cam.undistorted_half_size,
            dist[keep] - cam.distorted_half_size)


def _fit_fixed_degree(src, dst, coeffs0, num_iterations, parameter_tolerance):
    """LM fit of the RPC coefficients mapping src -> dst at one degree
    (``fitCurrDegRPC``, rpc_distortion.cc:559-620), no robust loss."""
    def residual(coeffs):
        return (D.compute_rpc(src, coeffs) - dst).reshape(-1)

    res = levenberg_marquardt(residual, coeffs0, max_iterations=num_iterations,
                              parameter_tolerance=parameter_tolerance,
                              function_tolerance=1e-16)
    return res.x, float(res.cost)


def fit_rpc_to_pairs(src, dst, rpc_degree: int, num_iterations: int = 100,
                     parameter_tolerance: float = 1e-12) -> torch.Tensor:
    """Progressively fit RPCs of increasing degree (1..rpc_degree) mapping
    src -> dst, each degree warm-started from the previous
    (rpc_distortion.cc:636-655)."""
    src = src.to(torch.float64)
    dst = dst.to(torch.float64)
    coeffs = D.rpc_identity_params(1)
    for deg in range(1, rpc_degree + 1):
        if deg >= 2:
            coeffs = D.rpc_increment_degree(coeffs)
        x0 = torch.as_tensor(coeffs, dtype=torch.float64, device=src.device)
        x, _ = _fit_fixed_degree(src, dst, x0, num_iterations, parameter_tolerance)
        coeffs = x.cpu().numpy()
    return x


def fit_rpc_dist(cam: CameraParams, rpc_degree: int, num_samples: int = 400,
                 num_iterations: int = 100, parameter_tolerance: float = 1e-12
                 ) -> torch.Tensor:
    """Fit RPC distortion coefficients to cam's distortion model
    (``fitRpcDist``, rpc_distortion.cc:622-656)."""
    undist_c, dist_c = gen_undist_dist_pairs(cam, num_samples)
    return fit_rpc_to_pairs(undist_c, dist_c, rpc_degree, num_iterations,
                            parameter_tolerance)


def fit_rpc_undist(rpc_dist_coeffs, cam: CameraParams, num_samples: int = 400,
                   num_iterations: int = 100, parameter_tolerance: float = 1e-12
                   ) -> torch.Tensor:
    """Fit the inverse RPC: coefficients mapping RPC-distorted pixels back to
    undistorted ones (``fitRpcUndist``, rpc_distortion.cc:658-721)."""
    undist_c, _ = gen_undist_dist_pairs(cam, num_samples)
    undist_c = undist_c.to(torch.float64)
    coeffs = torch.as_tensor(rpc_dist_coeffs, dtype=torch.float64, device=cam.device)
    dist_c = D.compute_rpc(undist_c, coeffs)
    deg = D.rpc_degree_from_num_params(coeffs.shape[0])
    return fit_rpc_to_pairs(dist_c, undist_c, deg, num_iterations, parameter_tolerance)


def eval_rpc_dist_undist(cam: CameraParams, dist_undist_coeffs,
                         num_samples: int = 400) -> float:
    """Largest distort->undistort round-trip error in pixels
    (``evalRpcDistUndist``, rpc_distortion.cc:723-739): the reference's
    printed quality metric."""
    undist_c, _ = gen_undist_dist_pairs(cam, num_samples)
    p = undist_c.to(torch.float64)
    c = torch.as_tensor(dist_undist_coeffs, dtype=torch.float64, device=cam.device)
    n = c.shape[0] // 2
    u = D.compute_rpc(D.compute_rpc(p, c[:n]), c[n:])
    return float(torch.max(torch.linalg.norm(u - p, dim=-1)))


def fit_rpc_dist_undist(cam: CameraParams, rpc_degree: int, num_samples: int = 400,
                        num_iterations: int = 100,
                        parameter_tolerance: float = 1e-12) -> torch.Tensor:
    """Full pipeline: fit the distortion RPC and its inverse; returns the
    concatenated [dist|undist] coefficient vector in the reference's storage
    convention (camera_params.cc:225-253)."""
    dist_coeffs = fit_rpc_dist(cam, rpc_degree, num_samples, num_iterations,
                               parameter_tolerance)
    undist_coeffs = fit_rpc_undist(dist_coeffs, cam, num_samples, num_iterations,
                                   parameter_tolerance)
    return torch.cat([dist_coeffs, undist_coeffs])
