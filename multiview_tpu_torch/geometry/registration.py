"""Similarity registration (rotation + translation + scale) of point sets.
Port of ``multiview_tpu/geometry/registration.py`` (``Find3DAffineTransform``,
interest_point.cc:831-887): the same Kabsch-with-scale estimate. The scale is
the ratio of sums of consecutive-point distances (not the Umeyama variance
ratio), as in the reference, so registration against the same control points
yields the same transform.
"""

from __future__ import annotations

import torch

from multiview_tpu_torch.geometry import pose as pose_mod


def find_similarity_transform(src, dst, weights=None):
    """Find scale * R @ x + t best mapping ``src`` points to ``dst``.

    src, dst: [N,3] tensors. Returns (scale, pose[7]) such that
    T(x) = scale * R x + t with (R, t) packed as a rigid pose
    (interest_point.cc:831-887):
    1. scale = sum |dst[i+1]-dst[i]| / sum |src[i+1]-src[i]|
    2. Kabsch on (src, dst/scale), centroids removed
    3. t = scale*(ctr_dst/scale - R ctr_src)
    """
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    wsum = torch.sum(weights)

    dist_in = torch.sum(torch.linalg.norm(src[1:] - src[:-1], dim=-1))
    dist_out = torch.sum(torch.linalg.norm(dst[1:] - dst[:-1], dim=-1))
    scale = dist_out / torch.clamp_min(dist_in, 1e-30)

    local_out = dst / scale
    in_ctr = torch.sum(src * weights[:, None], dim=0) / wsum
    out_ctr = torch.sum(local_out * weights[:, None], dim=0) / wsum
    a = (src - in_ctr) * weights[:, None]
    b = local_out - out_ctr

    U, _, Vt = torch.linalg.svd(a.T @ b)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = Vt.T @ D @ U.T

    t = scale * (out_ctr - R @ in_ctr)
    return scale, pose_mod.make_pose(t, pose_mod.matrix_to_quat(R))


def apply_similarity(scale, pose, points):
    """T(x) = scale * R x + t."""
    return scale * pose_mod.quat_rotate(pose_mod.pose_q(pose), points) + pose_mod.pose_t(pose)


def transform_cameras(scale, pose, world_to_cam_poses):
    """Apply a similarity world transform T(x) = s R x + t to world->cam
    poses (``TransformCameras``, interest_point.cc:997-1017): the rotation
    composes with R^T and the translation scales by s, so camera centres land
    at T(centre)."""
    R = pose_mod.quat_to_matrix(pose_mod.pose_q(pose))
    t = pose_mod.pose_t(pose)
    Rc = pose_mod.quat_to_matrix(pose_mod.pose_q(world_to_cam_poses))  # [N,3,3]
    tc = pose_mod.pose_t(world_to_cam_poses)                           # [N,3]
    new_R = torch.einsum("nij,kj->nik", Rc, R)
    new_t = scale * tc - torch.einsum("nij,j->ni", new_R, t)
    return pose_mod.make_pose(new_t, pose_mod.matrix_to_quat(new_R))


def transform_points(scale, pose, points):
    """Apply the similarity to triangulated points (``TransformPoints``)."""
    return apply_similarity(scale, pose, points)


def transform_rig(scale, ref_to_cam_poses):
    """Scale the translations of the rig extrinsics (``TransformRig``,
    interest_point.cc:1020-1023): rotations unchanged."""
    return pose_mod.make_pose(pose_mod.pose_t(ref_to_cam_poses) * scale,
                              pose_mod.pose_q(ref_to_cam_poses))
