"""Point-cloud filtering, the ASP ``pc_filter`` role of multi_stereo
(multi_stereo:191-224). Port of ``multiview_tpu/dense/pc_filter.py``:
distance gates and statistical outlier removal by the mean distance to the
k nearest neighbours, found by brute force over all pairs.

The reference forms squared distances as |x|^2 + |y|^2 - 2 x.y; in float32
that loses the neighbour distances of a cloud a few metres from its camera
(at |x|^2 = 4 m^2 the rounding is about 5e-7 m^2, the squared spacing of
millimetre-spaced points). The port sums the three squared coordinate
differences directly, one chunk of query rows at a time."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multiview_tpu_torch.utils.device import resolve_device, working_dtype


def knn_mean_distance(points: torch.Tensor, k: int = 8, chunk: int = 512) -> torch.Tensor:
    """Mean distance from each point of points [N,3] to its k nearest
    neighbours, itself excluded. Returns [N] in points' dtype. With k or
    fewer other points, the missing neighbours are rows at (1e15, 1e15,
    1e15), as the JAX package's padding makes them."""
    n = points.shape[0]
    if n <= k:
        pad = torch.full((k + 1 - n, 3), 1e15, dtype=points.dtype, device=points.device)
        return knn_mean_distance(torch.cat([points, pad]), k=k, chunk=chunk)[:n]
    cols = points.T.contiguous()                                     # [3,N]
    out = []
    for c0 in range(0, n, chunk):
        q = cols[:, c0:c0 + chunk, None]
        diff = q[0] - cols[0]
        d2 = diff * diff                                             # [C,N]
        for c in (1, 2):
            torch.sub(q[c], cols[c], out=diff)
            d2.addcmul_(diff, diff)
        # the k+1 smallest hold the point's own 0: the rest are its k nearest
        near = torch.topk(d2, k + 1, dim=1, largest=False).values[:, 1:]
        out.append(torch.sqrt(torch.clamp_min(near, 0.0)).mean(dim=1))
    return torch.cat(out)


def statistical_outlier_removal(points_cam: np.ndarray, k: int = 8,
                                std_ratio: float = 2.0, device=None) -> np.ndarray:
    """Keep-mask of the points whose k-NN mean distance is within
    mean + std_ratio * std of the cloud's (PCL StatisticalOutlierRemoval).
    Computed on ``device`` (the first CUDA card when None) in its working
    dtype."""
    if len(points_cam) <= k + 1:
        return np.ones(len(points_cam), bool)
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points_cam), dtype=working_dtype(device), device=device)
    md = knn_mean_distance(pts, k=k).cpu().numpy()
    return md <= md.mean() + std_ratio * md.std()


def pc_filter(points_cam: np.ndarray, max_distance_from_camera: float = 0.0,
              outlier_removal: bool = True, k: int = 8, std_ratio: float = 2.0,
              device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Filter a stereo cloud given in its left camera's frame. Returns
    (filtered points, keep mask). ``max_distance_from_camera`` <= 0 disables
    that gate (ASP's --max-distance-from-camera)."""
    keep = np.isfinite(points_cam).all(axis=1)
    if max_distance_from_camera > 0:
        keep &= np.linalg.norm(points_cam, axis=1) <= max_distance_from_camera
    if outlier_removal and keep.any():
        keep_idx = np.nonzero(keep)[0]
        keep2 = statistical_outlier_removal(points_cam[keep], k=k, std_ratio=std_ratio,
                                            device=device)
        keep = np.zeros(len(points_cam), bool)
        keep[keep_idx[keep2]] = True
    return points_cam[keep], keep
