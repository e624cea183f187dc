"""Registration of the solution to user-measured control points (the role
of ``registrationTransform``, interest_point.cc:1041-1245). Port of
``multiview_tpu/calib/registration.py``: control points picked in image
pairs (Hugin .pto) with known world coordinates (an xyz file) are each
triangulated from the current cameras; a similarity (Kabsch + scale) maps
the triangulated set onto the measured one and is applied to the camera
poses, the points and the rig translations. The printed mean absolute error
against the control points is the reference's registration metric.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import registration as reg_mod
from multiview_tpu_torch.geometry import triangulation as tri_mod
from multiview_tpu_torch.geometry.camera import DISTORTED, UNDISTORTED_C, CameraParams
from multiview_tpu_torch.io import depth_io


def triangulate_control_points(control_images: List[str], control_rows: np.ndarray,
                               image_names: List[str], world_to_cam: np.ndarray,
                               cams_of_image: Sequence[int],
                               cam_params: Sequence[CameraParams]) -> np.ndarray:
    """Triangulate each Hugin control point from its two views: rows
    [left_idx, right_idx, lx, ly, rx, ry] of distorted pixels; world_to_cam
    [N,7] poses of the solution's images. Returns [M,3] float64."""
    name_to_cid = {}
    for cid, n in enumerate(image_names):
        name_to_cid[n] = cid
        # hugin projects often store basenames
        name_to_cid.setdefault(n.split("/")[-1], cid)

    out = []
    for row in control_rows:
        li, ri = int(row[0]), int(row[1])
        try:
            cidl = name_to_cid[control_images[li]]
            cidr = name_to_cid[control_images[ri]]
        except KeyError as e:
            raise ValueError(f"Control-point image not in the solution: {e}")
        cl = cam_params[cams_of_image[cidl]]
        cr = cam_params[cams_of_image[cidr]]

        def t(x, cam):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=cam.dtype, device=cam.device)

        ul = cl.convert(t(row[2:4], cl), DISTORTED, UNDISTORTED_C)
        ur = cr.convert(t(row[4:6], cr), DISTORTED, UNDISTORTED_C)
        xyz = tri_mod.triangulate_pair(float(cl.mean_focal), float(cr.mean_focal),
                                       t(world_to_cam[cidl], cl), t(world_to_cam[cidr], cr),
                                       ul, ur)
        out.append(xyz.double().cpu().numpy())
    return np.stack(out)


def register_state(state: prob.RigState, triangulated: np.ndarray, measured: np.ndarray,
                   verbose: bool = True) -> Tuple[prob.RigState, float, float]:
    """Similarity-align the solution to the measured control points and
    apply it to the world_to_ref poses, points and rig translations. Returns
    (new state, scale, mean absolute error in metres). The similarity is
    estimated in float64 on the host and applied in the state's dtype."""
    f64 = torch.float64
    scale, T = reg_mod.find_similarity_transform(torch.as_tensor(triangulated, dtype=f64),
                                                 torch.as_tensor(measured, dtype=f64))
    mapped = reg_mod.apply_similarity(scale, T, torch.as_tensor(triangulated, dtype=f64))
    err = float(np.mean(np.linalg.norm(mapped.numpy() - measured, axis=-1)))
    if verbose:
        print(f"Registration mean absolute error: {err:.6g} meters")
    dt, dev = state.world_to_ref.dtype, state.world_to_ref.device
    s, T = scale.to(dtype=dt, device=dev), T.to(dtype=dt, device=dev)
    new_state = dataclasses.replace(
        state, world_to_ref=reg_mod.transform_cameras(s, T, state.world_to_ref),
        points=reg_mod.transform_points(s, T, state.points),
        ref_to_cam=reg_mod.transform_rig(s, state.ref_to_cam))
    return new_state, float(scale), err


def register_from_files(state: prob.RigState, hugin_file, xyz_file,
                        image_names: List[str], world_to_cam: np.ndarray,
                        cams_of_image: Sequence[int], cam_params: Sequence[CameraParams],
                        verbose: bool = True):
    """File-level entry of the reference flags --hugin_file / --xyz_file
    (rig_calibrator.cc:242-251)."""
    control_images, rows = depth_io.parse_hugin_control_points(hugin_file)
    measured = depth_io.parse_xyz(xyz_file)
    if len(measured) != len(rows):
        raise ValueError("Must have as many control points as measured xyz rows.")
    triangulated = triangulate_control_points(
        control_images, rows, image_names, world_to_cam, cams_of_image, cam_params)
    return register_state(state, triangulated, measured, verbose=verbose)
