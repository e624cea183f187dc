"""Plane utilities: azimuth/elevation normals, 45-degree snapping, best-fit
planes (dense_map_utils.cc:452-508). Port of
``multiview_tpu/geometry/plane.py``; all batched over leading axes."""

from __future__ import annotations

import math
from typing import Tuple

import torch


def normal_to_azimuth_elevation(normal: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normal [...,3] -> (azimuth, elevation), the degenerate x = y = 0 pole
    handled as the reference does (dense_map_utils.cc:452-463)."""
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    polar = (x == 0) & (y == 0)
    zero = torch.zeros_like(x)
    azimuth = torch.where(polar, zero, torch.arctan2(y, x))
    elev_gen = torch.arctan2(z, torch.hypot(x, y))
    elev_polar = torch.where(z >= 0, zero + math.pi / 2.0, zero - math.pi / 2.0)
    return azimuth, torch.where(polar, elev_polar, elev_gen)


def azimuth_elevation_to_normal(azimuth: torch.Tensor, elevation: torch.Tensor
                                ) -> torch.Tensor:
    """(azimuth, elevation) -> unit normal [...,3] (dense_map_utils.cc:466-470)."""
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    ce, se = torch.cos(elevation), torch.sin(elevation)
    return torch.stack([ca * ce, sa * ce, se], dim=-1)


def snap_plane_normal(normal: torch.Tensor) -> torch.Tensor:
    """Snap a normal so both its angles are multiples of 45 degrees
    (snapPlaneNormal, dense_map_utils.cc:474-484)."""
    a, e = normal_to_azimuth_elevation(normal)
    r45 = math.pi / 4.0
    return azimuth_elevation_to_normal(r45 * torch.round(a / r45), r45 * torch.round(e / r45))


def best_fit_plane(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares plane through points [N,3] -> (centroid [3], unit normal
    [3]): the left-singular vector of the centred coordinates with the
    smallest singular value (bestFitPlane, dense_map_utils.cc:487-508)."""
    centroid = torch.mean(points, dim=0)
    u, _, _ = torch.linalg.svd((points - centroid).T, full_matrices=False)
    return centroid, u[:, 2]
