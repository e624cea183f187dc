"""Camera intrinsics container + frame conversions + projection. Port of
``multiview_tpu/geometry/camera.py`` (``camera::CameraParameters``,
camera_model/camera_params.{h,cc}).

Tensor fields (focal, optical offset, distortion coefficients) plus plain
metadata (distortion model name, integer image sizes). Conversions among
the five reference frames RAW / DISTORTED / DISTORTED_C / UNDISTORTED /
UNDISTORTED_C (camera_params.h:42-57) are pure functions of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry import distortion as dist_mod
from multiview_tpu_torch.utils.device import resolve_device

RAW = "raw"
DISTORTED = "distorted"
DISTORTED_C = "distorted_c"
UNDISTORTED = "undistorted"
UNDISTORTED_C = "undistorted_c"


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Intrinsics of one sensor: ``focal`` [2], ``optical_offset`` [2] (in
    the DISTORTED frame), ``dist_coeffs`` [d] (for RPC: distort+undistort
    halves); ``model`` and image sizes are static metadata."""

    focal: torch.Tensor
    optical_offset: torch.Tensor
    dist_coeffs: torch.Tensor
    model: str = "none"
    distorted_size: Tuple[int, int] = (0, 0)
    undistorted_size: Tuple[int, int] = (0, 0)
    distorted_crop_size: Tuple[int, int] = (0, 0)
    crop_offset: Tuple[int, int] = (0, 0)

    @staticmethod
    def create(image_size, focal, optical_center, dist_coeffs=(),
               undistorted_size=None, distorted_crop_size=None, crop_offset=(0, 0),
               dtype=torch.float64, device=None):
        """Mirror of the array constructor (camera_params.cc:37-48): crop and
        undistorted sizes default to the image size. ``device=None`` means
        the first CUDA card (an error when there is none)."""
        device = resolve_device(device)
        dist_coeffs = torch.as_tensor(dist_coeffs, dtype=dtype, device=device)
        model = dist_mod.model_from_num_coeffs(int(dist_coeffs.shape[-1]))
        focal = torch.as_tensor(focal, dtype=dtype, device=device)
        if focal.dim() == 0:
            focal = torch.stack([focal, focal])
        return CameraParams(
            focal=focal,
            optical_offset=torch.as_tensor(optical_center, dtype=dtype, device=device),
            dist_coeffs=dist_coeffs,
            model=model,
            distorted_size=(int(image_size[0]), int(image_size[1])),
            undistorted_size=tuple(int(v) for v in (undistorted_size or image_size)),
            distorted_crop_size=tuple(int(v) for v in (distorted_crop_size or image_size)),
            crop_offset=(int(crop_offset[0]), int(crop_offset[1])),
        )

    def with_intrinsics(self, focal=None, optical_offset=None, dist_coeffs=None):
        return dataclasses.replace(
            self,
            focal=self.focal if focal is None else focal,
            optical_offset=self.optical_offset if optical_offset is None else optical_offset,
            dist_coeffs=self.dist_coeffs if dist_coeffs is None else dist_coeffs)

    @property
    def dtype(self):
        return self.focal.dtype

    @property
    def device(self):
        return self.focal.device

    def _vec(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    @property
    def distorted_half_size(self):
        return self._vec(self.distorted_size) / 2.0

    @property
    def undistorted_half_size(self):
        return self._vec(self.undistorted_size) / 2.0

    @property
    def mean_focal(self):
        """GetFocalLength(): mean of the two focal lengths."""
        return torch.mean(self.focal)

    def intrinsic_matrix(self, frame: str = DISTORTED):
        """K [3,3] for the given frame (camera_params.cc:420-449)."""
        if frame == RAW:
            c = self.optical_offset + self._vec(self.crop_offset)
        elif frame == DISTORTED:
            c = self.optical_offset
        elif frame == DISTORTED_C:
            c = self.optical_offset - self.distorted_half_size
        elif frame == UNDISTORTED:
            c = self.undistorted_half_size
        elif frame == UNDISTORTED_C:
            c = self._vec((0.0, 0.0))
        else:
            raise ValueError(f"Unknown frame {frame}")
        K = torch.eye(3, dtype=self.dtype, device=self.device)
        K[0, 0], K[1, 1] = self.focal[0], self.focal[1]
        K[0, 2], K[1, 2] = c[0], c[1]
        return K

    def distort_centered(self, undist_c):
        return dist_mod.distort_centered(
            self.model, self.dist_coeffs, undist_c, self.focal, self.optical_offset,
            self.distorted_half_size)

    def undistort_centered(self, dist_c):
        return dist_mod.undistort_centered(
            self.model, self.dist_coeffs, dist_c, self.focal, self.optical_offset,
            self.distorted_half_size)

    def convert(self, pix, src: str, dst: str):
        """Frame-to-frame conversion through the centered frames
        (Convert<> specializations, camera_params.cc:377-417)."""
        if src == dst:
            return pix
        if src == RAW:
            return self.convert(pix - self._vec(self.crop_offset), DISTORTED, dst)
        if dst == RAW:
            return self.convert(pix, src, DISTORTED) + self._vec(self.crop_offset)
        if src == DISTORTED:
            if dst == DISTORTED_C:
                return pix - self.distorted_half_size
            return self.convert(pix - self.distorted_half_size, DISTORTED_C, dst)
        if src == UNDISTORTED:
            if dst == UNDISTORTED_C:
                return pix - self.undistorted_half_size
            return self.convert(pix - self.undistorted_half_size, UNDISTORTED_C, dst)
        if src == DISTORTED_C:
            if dst == DISTORTED:
                return pix + self.distorted_half_size
            u = self.undistort_centered(pix)
            if dst == UNDISTORTED_C:
                return u
            if dst == UNDISTORTED:
                return u + self.undistorted_half_size
        if src == UNDISTORTED_C:
            if dst == UNDISTORTED:
                return pix + self.undistorted_half_size
            d = self.distort_centered(pix)
            if dst == DISTORTED_C:
                return d
            if dst == DISTORTED:
                return d + self.distorted_half_size
        raise ValueError(f"Unsupported conversion {src} -> {dst}")

    def project_cam_to_dist_pix(self, X_cam):
        """Camera-frame 3D point(s) -> DISTORTED pixel (the projection inside
        ``BracketedCamError``, rig_calibrator.cc:472-475)."""
        undist_c = self.focal * (X_cam[..., :2] / X_cam[..., 2:3])
        return self.convert(undist_c, UNDISTORTED_C, DISTORTED)

    def ray_from_dist_pix(self, dist_pix):
        """DISTORTED pixel -> unit ray in the camera frame."""
        undist_c = self.convert(dist_pix, DISTORTED, UNDISTORTED_C)
        d = torch.cat([undist_c / self.focal,
                       torch.ones(undist_c.shape[:-1] + (1,), dtype=self.dtype,
                                  device=self.device)], dim=-1)
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def undistortion_remap_grid(cam: CameraParams, scale: float = 1.0) -> np.ndarray:
    """Dense remap table: for every UNDISTORTED pixel the DISTORTED pixel it
    samples, [int(H_u * scale), int(W_u * scale), 2] in (x, y) order
    (``GenerateRemapMaps``, camera_params.cc:361-371). Computed where the
    camera's tensors are, in their dtype, and returned to the host."""
    w = int(cam.undistorted_size[0] * scale)
    h = int(cam.undistorted_size[1] * scale)
    xs = torch.arange(w, dtype=cam.dtype, device=cam.device)
    ys = torch.arange(h, dtype=cam.dtype, device=cam.device)
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    return (cam.convert(grid / scale, UNDISTORTED, DISTORTED) * scale).cpu().numpy()
