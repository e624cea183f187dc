"""Image undistortion (the ``undistort_image_texrecon`` role,
undistort_image_texrecon.cc:84-368). Port of
``multiview_tpu/utils/undistort.py``: build the full-image remap table,
tame out-of-range remap values near the border, resample bilinearly (taps
outside the image read 0), optionally crop a central window, and report the
undistorted intrinsics.

The remap table and the resampling run where the camera's tensors are, in
the camera's dtype; the result has the input image's dtype."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry.camera import DISTORTED, UNDISTORTED, CameraParams


def _bilinear_zero(img, x, y):
    """Bilinear samples of img [H,W] at (x, y) with every corner tap outside
    the image read as 0 (``map_coordinates(order=1, mode="constant")``: the
    taps are summed in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1))."""
    H, W = img.shape
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0f, y - y0f
    wx0, wy0 = 1 - wx1, 1 - wy1
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    flat = img.reshape(-1).to(x.dtype)
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            tap = flat[(yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))]
            term = wy * wx * torch.where(ok, tap, torch.zeros_like(tap))
            out = term if out is None else out + term
    return out


def _undistort_core(img, cam: CameraParams, tame_px: float, scale: float):
    """Remap grid + resample. ``scale`` follows GenerateRemapMaps
    (camera_params.cc:357-372): the grid spans round(scale * undistorted
    size), the conversion runs at the calibrated resolution (grid / scale),
    and the distorted coordinates are multiplied back by scale, so the input
    image must be at scale * distorted size."""
    W_us = int(round(scale * cam.undistorted_size[0]))
    H_us = int(round(scale * cam.undistorted_size[1]))
    W_ds = int(round(scale * cam.distorted_size[0]))
    H_ds = int(round(scale * cam.distorted_size[1]))
    xs = torch.arange(W_us, dtype=cam.dtype, device=cam.device)
    ys = torch.arange(H_us, dtype=cam.dtype, device=cam.device)
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    dist = scale * cam.convert(grid / scale, UNDISTORTED, DISTORTED)
    dist_x = torch.clamp(dist[..., 0], -tame_px, W_ds - 1 + tame_px)
    dist_y = torch.clamp(dist[..., 1], -tame_px, H_ds - 1 + tame_px)
    img = torch.as_tensor(img, device=cam.device)
    if img.dim() == 2:
        return _bilinear_zero(img, dist_x, dist_y).to(img.dtype)
    return torch.stack([_bilinear_zero(img[..., c], dist_x, dist_y)
                        for c in range(img.shape[-1])], -1).to(img.dtype)


def undistort_image(img, cam: CameraParams, crop_window: Optional[Tuple[int, int]] = None,
                    tame_px: float = 100.0, scale: float = 1.0):
    """Undistort an image through the camera model.

    img: [H,W] or [H,W,C] float (numpy or tensor) at scale * the calibrated
    distorted size. Returns (undistorted image at scale * undistorted size, or
    the cropped window, as a tensor on the camera's device; K [3,3] numpy of
    the output). Remap values more than ``tame_px`` beyond the image are
    clamped (undistort_image_texrecon.cc:217-260); the crop window applies
    unscaled to the scaled undistorted image (:253-285)."""
    W_us = int(round(scale * cam.undistorted_size[0]))
    H_us = int(round(scale * cam.undistorted_size[1]))
    out = _undistort_core(img, cam, tame_px, scale)
    K = cam.intrinsic_matrix(UNDISTORTED).double().cpu().numpy()
    K[0] *= scale
    K[1] *= scale
    if crop_window is not None:
        cw, ch = crop_window
        x0 = max((W_us - cw) // 2, 0)
        y0 = max((H_us - ch) // 2, 0)
        cw = min(cw, W_us - x0)
        ch = min(ch, H_us - y0)
        out = out[y0:y0 + ch, x0:x0 + cw]
        K[0, 2] -= x0
        K[1, 2] -= y0
    return out, K


def write_tsai_camera(path, K: np.ndarray, cam_to_world: np.ndarray):
    """ASP Pinhole .tsai camera file (write_asp_and_voxblox_cameras role,
    rig_utils.py:318-356)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    R = cam_to_world[:3, :3]
    c = cam_to_world[:3, 3]
    lines = [
        "VERSION_4",
        "PINHOLE",
        f"fu = {float(K[0, 0])!r}",
        f"fv = {float(K[1, 1])!r}",
        f"cu = {float(K[0, 2])!r}",
        f"cv = {float(K[1, 2])!r}",
        "u_direction = 1 0 0",
        "v_direction = 0 1 0",
        "w_direction = 0 0 1",
        "C = " + " ".join(repr(float(v)) for v in c),
        "R = " + " ".join(repr(float(v)) for v in R.ravel()),
        "pitch = 1",
        "NULL",
    ]
    path.write_text("\n".join(lines) + "\n")


def write_texrecon_cam(path, K: np.ndarray, world_to_cam: np.ndarray,
                       image_size: Tuple[int, int]):
    """mvs-texturing .cam file: 'tx ty tz R(9)' then normalized
    'f 0 0 paspect ppx ppy' (convert_intrinsics_to_texrecon,
    texrecon:90-131)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    R = world_to_cam[:3, :3]
    t = world_to_cam[:3, 3]
    W, H = image_size
    maxdim = max(W, H)
    f_norm = K[0, 0] / maxdim
    ppx = K[0, 2] / W
    ppy = K[1, 2] / H
    line1 = " ".join(repr(float(v)) for v in t) + " " + \
        " ".join(repr(float(v)) for v in R.ravel())
    line2 = f"{float(f_norm)!r} 0 0 1 {float(ppx)!r} {float(ppy)!r}"
    path.write_text(line1 + "\n" + line2 + "\n")
