"""Mesh-based BA constraints: per-observation ray/mesh intersections. Port of
``multiview_tpu/calib/mesh_constraints.py`` (the role of
``meshTriangulations``, texture_processing.cc:1566-1625): for every inlier
pixel observation, cast the camera ray against the input mesh; per track,
average the per-view intersections into the mesh anchor point of the XYZ
mesh prior (mesh_tri), and keep the per-observation points for the
depth-vs-mesh constraint. One batched ray cast over all observations, on the
state's device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from multiview_tpu_torch.calib import calibrator as cal
from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.texture import raycast


def mesh_intersections(state: prob.RigState, observations: prob.Observations,
                       models: Sequence[str], tri_verts,
                       min_ray_dist: float = 0.0, max_ray_dist: float = 100.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-observation mesh hits and per-track averages.

    Returns (obs_mesh_xyz [N,3] with NaN where missed or masked,
    track_mesh_xyz [P,3] averaged over hitting inlier views with NaN where
    none: the reference's bad_xyz sentinel becomes NaN)."""
    w2c = cal._global_w2c(state, observations)
    und = cal._global_undist_pix(state, observations, models)
    mask = cal._global_mask(observations)

    # rays: origin = camera centre, direction = R^T [u/f, v/f, 1]
    c2w = pose_mod.pose_inverse(w2c)
    origins = pose_mod.pose_t(c2w)
    focal = cal._global_focal(state, observations)
    d_cam = torch.cat([und / focal[:, None], torch.ones_like(und[:, :1])], dim=-1)
    dirs = pose_mod.quat_rotate(pose_mod.pose_q(c2w), d_cam)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)

    t, _, hit = raycast.ray_mesh_intersect(
        origins, dirs, torch.as_tensor(tri_verts, dtype=und.dtype, device=und.device),
        min_dist=min_ray_dist, max_dist=max_ray_dist)
    pts = origins + t[:, None] * dirs
    hit = hit & mask
    nan = torch.full_like(pts, float("nan"))
    obs_xyz = torch.where(hit[:, None], pts, nan)

    # per-track mean over hits: no hit -> 0/0 = NaN
    pid = torch.cat([o.point_idx for o in observations.pixels])
    hitf = hit.to(pts.dtype)
    sums = torch.zeros_like(state.points).index_add_(0, pid, pts * hitf[:, None])
    counts = torch.zeros_like(state.points[:, 0]).index_add_(0, pid, hitf)
    return obs_xyz, sums / counts[:, None]


def xyz_prior_from_points(xyz: torch.Tensor) -> prob.XyzPriorObs:
    """XyzPriorObs over all points from [P,3] anchors with NaN where there is
    none: those are masked and zeroed."""
    valid = torch.isfinite(xyz).all(dim=-1)
    return prob.XyzPriorObs(
        ref_xyz=torch.where(valid[:, None], xyz, torch.zeros_like(xyz)),
        point_idx=torch.arange(xyz.shape[0], device=xyz.device), mask=valid)


def build_mesh_prior(state: prob.RigState, observations: prob.Observations,
                     models: Sequence[str], tri_verts,
                     min_ray_dist: float = 0.0, max_ray_dist: float = 100.0
                     ) -> prob.XyzPriorObs:
    """XyzPriorObs of the mesh-tri constraint (XYZError with
    mesh_tri_weight, rig_calibrator.cc:1865-1883)."""
    _, track_xyz = mesh_intersections(state, observations, models, tri_verts,
                                      min_ray_dist, max_ray_dist)
    return xyz_prior_from_points(track_xyz)
