"""TSDF fusion of depth data into a voxel volume (the voxblox role of
dense_map_utils.cc:1185-1291). Port of ``multiview_tpu/dense/tsdf.py``.

Integration is projective: every voxel centre projects into the frame's
depth image and updates itself. Unstructured point clouds are first
rasterized into a virtual depth image by a scatter-min z-buffer
(``scatter_reduce_`` with "amin"), whose holes are filled from their 3x3
neighbours (``torch.roll``, which wraps across the image border as the
reference's ``jnp.roll`` does).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TsdfGrid:
    """Dense truncated signed-distance volume: tsdf / weight / intensity
    [X,Y,Z]; origin [3] is the world position of voxel (0,0,0)'s corner
    (voxel centres sit at origin + (index + 0.5) * voxel_size)."""

    tsdf: torch.Tensor
    weight: torch.Tensor
    intensity: torch.Tensor
    origin: torch.Tensor
    voxel_size: float = 0.05
    truncation: float = 0.2

    @property
    def shape(self):
        return tuple(self.tsdf.shape)

    @staticmethod
    def from_numpy(tsdf, weight, intensity, origin, voxel_size: float, truncation: float,
                   dtype=torch.float64, device=None) -> "TsdfGrid":
        """A grid from arrays (the JAX package's, for instance) on ``device``
        (the first CUDA card when None)."""
        device = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.array(a), dtype=dtype, device=device)

        return TsdfGrid(t(tsdf), t(weight), t(intensity), t(origin),
                        float(voxel_size), float(truncation))


def make_grid(shape: Tuple[int, int, int], origin, voxel_size: float,
              truncation: Optional[float] = None, dtype=torch.float32,
              device=None) -> TsdfGrid:
    """An empty grid on ``device`` (the first CUDA card when None)."""
    device = resolve_device(device)
    if truncation is None:
        truncation = 4.0 * voxel_size
    z = torch.zeros(tuple(int(s) for s in shape), dtype=dtype, device=device)
    return TsdfGrid(tsdf=z, weight=z, intensity=z,
                    origin=torch.as_tensor(np.asarray(origin), dtype=dtype, device=device),
                    voxel_size=float(voxel_size), truncation=float(truncation))


def _axis_centres(grid: TsdfGrid, axis: int):
    n = grid.shape[axis]
    dt, dev = grid.tsdf.dtype, grid.tsdf.device
    return grid.origin[axis] + (torch.arange(n, dtype=dt, device=dev) + 0.5) * grid.voxel_size


def voxel_centers(grid: TsdfGrid) -> torch.Tensor:
    """[X,Y,Z,3] world coordinates of the voxel centres."""
    idx = torch.stack(torch.meshgrid(
        *(torch.arange(n, device=grid.tsdf.device) for n in grid.shape), indexing="ij"),
        dim=-1).to(grid.tsdf.dtype)
    return grid.origin + (idx + 0.5) * grid.voxel_size


def integrate_depth_image(grid: TsdfGrid, depth: torch.Tensor, focal, center,
                          cam_to_world_pose, max_range: float = 10.0,
                          max_weight: float = 100.0,
                          intensity_img: Optional[torch.Tensor] = None) -> TsdfGrid:
    """Projective TSDF update from one depth image.

    depth: [H,W] metric depth along +z (0 or inf = invalid); focal [2],
    center [2] pinhole intrinsics; cam_to_world_pose [7]. Voxels behind the
    surface beyond the truncation band are untouched; in front, the signed
    distance clamps to +truncation (free-space carving)."""
    H, W = depth.shape
    dtype, dev = grid.tsdf.dtype, grid.tsdf.device

    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    focal, center = vec(focal), vec(center)
    w2c = pose_mod.pose_inverse(vec(cam_to_world_pose))
    R = pose_mod.quat_to_matrix(pose_mod.pose_q(w2c))
    t = pose_mod.pose_t(w2c)
    xw = _axis_centres(grid, 0)[:, None, None]
    yw = _axis_centres(grid, 1)[None, :, None]
    zw = _axis_centres(grid, 2)[None, None, :]

    def cam_coord(i):
        return R[i, 0] * xw + R[i, 1] * yw + R[i, 2] * zw + t[i]

    z = cam_coord(2)
    zsafe = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = cam_coord(0) / zsafe * focal[0] + center[0]
    v = cam_coord(1) / zsafe * focal[1] + center[1]
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 1e-6)

    pix = vi * W + ui
    d_meas = depth.reshape(-1).to(dtype)[pix]
    valid_meas = (d_meas > 1e-6) & torch.isfinite(d_meas) & (d_meas < max_range)

    sdf = d_meas - z
    trunc = grid.truncation
    update = in_img & valid_meas & (sdf > -trunc)
    sdf = torch.clamp(sdf, -trunc, trunc) / trunc

    w_new = update.to(dtype)
    w_tot = grid.weight + w_new
    safe = torch.clamp_min(w_tot, 1e-12)
    seen = w_tot > 0
    tsdf = torch.where(seen, (grid.tsdf * grid.weight + sdf * w_new) / safe, grid.tsdf)
    inten = grid.intensity
    if intensity_img is not None:
        inten_meas = intensity_img.reshape(-1).to(dtype)[pix]
        inten = torch.where(seen, (grid.intensity * grid.weight + inten_meas * w_new) / safe,
                            grid.intensity)
    return dataclasses.replace(grid, tsdf=tsdf, weight=torch.clamp_max(w_tot, max_weight),
                               intensity=inten)


def _fill_depth_holes(depth: torch.Tensor, rounds: int = 2) -> torch.Tensor:
    """Fill empty z-buffer pixels from their valid 3x3 neighbours (the
    smallest depth wins). The neighbours are rolled copies, so the fill wraps
    across the image border, as the reference's does."""
    d = torch.where(depth > 0, depth, torch.full_like(depth, float("inf")))
    for _ in range(rounds):
        m = d
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    m = torch.minimum(m, torch.roll(d, (dy, dx), dims=(0, 1)))
        d = torch.where(torch.isfinite(d), d, m)
    return torch.where(torch.isfinite(d), d, torch.zeros_like(d))


def rasterize_cloud_to_depth(points_cam: torch.Tensor, focal, center,
                             image_size: Tuple[int, int],
                             intensities: Optional[torch.Tensor] = None,
                             fill_rounds: int = 2):
    """Camera-frame points [N,3] -> z-buffer depth image [H,W] (scatter-min)
    with hole filling; with intensities [N], also the intensity of the
    nearest point per pixel. Returns (depth, intensity or None)."""
    W, H = image_size
    dtype, dev = points_cam.dtype, points_cam.device
    focal = torch.as_tensor(focal, dtype=dtype, device=dev)
    center = torch.as_tensor(center, dtype=dtype, device=dev)
    z = points_cam[:, 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, torch.ones_like(z))
    u = torch.clamp(torch.round(points_cam[:, 0] / zs * focal[0] + center[0]).to(torch.int64),
                    0, W - 1)
    v = torch.clamp(torch.round(points_cam[:, 1] / zs * focal[1] + center[1]).to(torch.int64),
                    0, H - 1)
    flat = v * W + u
    zval = torch.where(ok, z, torch.full_like(z, float("inf")))
    zbuf = torch.full((H * W,), float("inf"), dtype=dtype, device=dev)
    zbuf.scatter_reduce_(0, flat, zval, "amin", include_self=True)
    depth = torch.where(torch.isfinite(zbuf), zbuf, torch.zeros_like(zbuf)).reshape(H, W)
    if fill_rounds > 0:
        depth = _fill_depth_holes(depth, fill_rounds)
    inten_img = None
    if intensities is not None:
        won = (zbuf[flat] == zval) & ok
        ibuf = torch.zeros(H * W, dtype=dtype, device=dev)
        ibuf.scatter_reduce_(0, flat, torch.where(won, intensities.to(dtype),
                                                  torch.zeros_like(zval)),
                             "amax", include_self=True)
        inten_img = ibuf.reshape(H, W)
    return depth, inten_img


def integrate_point_cloud(grid: TsdfGrid, points_cam: torch.Tensor, cam_to_world_pose,
                          focal=(300.0, 300.0), center=None,
                          image_size: Tuple[int, int] = (640, 480),
                          intensities: Optional[torch.Tensor] = None,
                          max_range: float = 10.0) -> TsdfGrid:
    """Integrate an unstructured camera-frame cloud (the voxblox_index.txt
    path): rasterize it into a virtual pinhole depth image, then run the
    projective update."""
    if center is None:
        center = (image_size[0] / 2.0, image_size[1] / 2.0)
    points_cam = points_cam.to(device=grid.tsdf.device, dtype=grid.tsdf.dtype)
    depth, inten = rasterize_cloud_to_depth(points_cam, focal, center, image_size,
                                            intensities)
    return integrate_depth_image(grid, depth, focal, center, cam_to_world_pose,
                                 max_range=max_range, intensity_img=inten)
