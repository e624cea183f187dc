"""Per-camera mesh forward projection, the calibrator's in-process texturing
path (``calibrate --out_texture_dir``). Port of
``multiview_tpu/texture/mesh_project.py`` (``projectTexture``'s UV variant,
``meshProject`` and ``meshProjectCameras``, texture_processing.cc:991-1163,
:1483-1561).

For every camera, each mesh face facing it within 75 degrees gets per-vertex
UVs into that camera's own (distorted) image, provided all three vertices
pass an occlusion ray test (the port's ``ray_mesh_intersect``) and project
inside the undistorted domain and the distorted crop window. The output is
one OBJ/MTL/PNG triple per camera whose texture is the camera image, named
``<%10.7f timestamp>_<sensor>`` like the reference's (:1550-1556). The
geometry runs on the cameras' device in their dtype; the PNG is written by
``utils.images.write_png`` (the reference uses PIL).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.geometry.camera import DISTORTED, UNDISTORTED_C, CameraParams
from multiview_tpu_torch.texture import raycast
from multiview_tpu_torch.texture.texturing import face_geometry
from multiview_tpu_torch.utils.images import write_png


def project_texture_uv(vertices, faces, cam: CameraParams, world_to_cam,
                       image_shape: Tuple[int, int], tri_soup=None,
                       max_angle_deg: float = 75.0):
    """Per-vertex UVs and per-face visibility for one camera, on the
    camera's device in its dtype (projectTexture's UV variant,
    texture_processing.cc:991-1163).

    vertices [Nv,3], faces [F,3]; world_to_cam is a 7-vector pose;
    image_shape is (rows, cols) of the raw image, an integer multiple of the
    calibrated size (:1007-1021; UVs are normalized by the calibrated size).
    Returns (face_ok [F] bool, uv [Nv,2], cost [F], +inf where not ok).
    """
    dev, dt = cam.device, cam.dtype
    verts = torch.as_tensor(vertices, device=dev).to(dt)
    faces_t = torch.as_tensor(faces, device=dev).long()
    w2c = torch.as_tensor(world_to_cam, device=dev).to(dt)

    calib_cols, calib_rows = cam.distorted_size
    raw_rows, raw_cols = int(image_shape[0]), int(image_shape[1])
    factor = raw_cols // max(calib_cols, 1)
    if (raw_cols != calib_cols * factor) or (raw_rows != calib_rows * factor):
        raise ValueError(
            f"Image size {raw_cols}x{raw_rows} must be an integer multiple of "
            f"the calibrated size {calib_cols}x{calib_rows} "
            "(texture_processing.cc:1014-1021)")
    if tri_soup is None:
        tri_soup = verts[faces_t]
    cam_ctr = pose_mod.pose_t(pose_mod.pose_inverse(w2c))

    # ---- per-face geometry gates (:1038-1065) ----
    ctr, n, _ = face_geometry(verts, faces_t)
    to_cam = cam_ctr[None, :] - ctr
    dist = torch.linalg.norm(to_cam, dim=-1)
    cosang = torch.sum(to_cam / torch.clamp_min(dist[:, None], 1e-30) * n, dim=-1)
    facing = cosang > 0.0
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    angle_ok = ang <= math.radians(max_angle_deg)
    cost = ang + dist                                              # :1063-1064

    # ---- per-vertex tests over the whole mesh ----
    # occlusion: the ray vertex -> camera centre must not hit the mesh first
    # (tmin = 1e-4 x the ray's length excludes the vertex's own faces)
    vdirs = cam_ctr[None, :] - verts
    vdist = torch.linalg.norm(vdirs, dim=-1)
    vdirs = vdirs / torch.clamp_min(vdist[:, None], 1e-30)
    t, _, hit = raycast.ray_mesh_intersect(verts, vdirs, tri_soup,
                                           min_dist=(1e-4 * vdist)[:, None])
    occluded = hit & (t < vdist)

    # projection chain (:1095-1137)
    Xc = pose_mod.pose_apply(w2c, verts)
    z_ok = Xc[:, 2] > 0.0
    safe = torch.where(z_ok[:, None], Xc, torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev))
    undist_c = cam.focal * (safe[:, :2] / safe[:, 2:3])
    in_undist = torch.all(torch.abs(undist_c) <= cam.undistorted_half_size, dim=-1)
    dist_pix = cam.convert(undist_c, UNDISTORTED_C, DISTORTED)
    half = torch.tensor(cam.distorted_size, dtype=dt, device=dev) / 2.0
    crop_half = torch.tensor(cam.distorted_crop_size, dtype=dt, device=dev) / 2.0
    in_crop = torch.all(torch.abs(dist_pix - half) <= crop_half, dim=-1)

    vert_ok = z_ok & in_undist & in_crop & ~occluded
    uv = torch.stack([dist_pix[:, 0] / calib_cols,
                      1.0 - dist_pix[:, 1] / calib_rows], dim=-1)    # :1139-1143
    face_ok = facing & angle_ok & torch.all(vert_ok[faces_t], dim=-1)
    return face_ok, uv, torch.where(face_ok, cost, torch.full_like(cost, float("inf")))


def write_obj_custom_uv(out_prefix, vertices: np.ndarray, faces: np.ndarray,
                        face_ok: np.ndarray, uv: np.ndarray, image: np.ndarray) -> Path:
    """OBJ with per-vertex UVs + MTL + the camera image as the PNG texture
    (formObjCustomUV / formMtl + meshProject's imwrite,
    texture_processing.cc:897-943, :1517-1527). A float image is written as
    ``(clip(image, 0, 1) * 255).astype(uint8)``."""
    out_prefix = Path(out_prefix)
    out_prefix.parent.mkdir(parents=True, exist_ok=True)
    # append, not with_suffix: the %10.7f timestamp contains a '.'
    obj_path = Path(str(out_prefix) + ".obj")
    mtl_path = Path(str(out_prefix) + ".mtl")
    png_path = Path(str(out_prefix) + ".png")

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    write_png(png_path, img)

    with open(mtl_path, "w") as m:
        m.write(f"newmtl textured\nmap_Kd {png_path.name}\n")
    sel = np.nonzero(np.asarray(face_ok))[0]
    with open(obj_path, "w") as o:
        o.write(f"mtllib {mtl_path.name}\nusemtl textured\n")
        for v in np.asarray(vertices):
            o.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(uv):
            o.write(f"vt {t[0]} {t[1]}\n")
        for f in sel:
            a, b, c = (int(i) + 1 for i in faces[f])
            o.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
    return obj_path


def mesh_project(vertices, faces, cam: CameraParams, world_to_cam, image: np.ndarray,
                 out_prefix, tri_soup=None) -> Path:
    """One camera: project and write the OBJ/MTL/PNG triple (meshProject,
    texture_processing.cc:1483-1528)."""
    face_ok, uv, _ = project_texture_uv(vertices, faces, cam, world_to_cam,
                                        np.asarray(image).shape[:2], tri_soup)
    return write_obj_custom_uv(out_prefix, np.asarray(vertices), np.asarray(faces),
                               face_ok.cpu().numpy(), uv.cpu().numpy(), image)


def mesh_project_cameras(sensor_names: Sequence[str], cams: Sequence[CameraParams],
                         images: Sequence[np.ndarray], timestamps: Sequence[float],
                         cam_types: Sequence[int], world_to_cam, vertices, faces,
                         out_dir) -> None:
    """All cameras -> ``<out_dir>/<timestamp>_<sensor>.{obj,mtl,png}``
    (meshProjectCameras, texture_processing.cc:1532-1561), on the device of
    ``cams``. world_to_cam: one 7-vector pose per image."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    vertices, faces = np.asarray(vertices), np.asarray(faces)
    tri_soup = torch.as_tensor(raycast.mesh_tri_verts(vertices, faces),
                               device=cams[0].device).to(cams[0].dtype)
    for cid in range(len(images)):
        s = int(cam_types[cid])
        prefix = out_dir / f"{timestamps[cid]:10.7f}_{sensor_names[s]}"
        print(f"Creating texture for: {prefix}")
        mesh_project(vertices, faces, cams[s], world_to_cam[cid], images[cid], prefix,
                     tri_soup=tri_soup)
