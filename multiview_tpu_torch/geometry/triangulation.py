"""N-view triangulation as batched, mask-aware tensor functions. Port of
``multiview_tpu/geometry/triangulation.py`` (openMVG's iterated weighted
linear triangulation, triangulation_nview.cc:87-146, as used by the
calibrator, interest_point.cc:337-423,649-722).

Pixels are *undistorted centered*; the projection matrix is K [R|t] with
K = diag(f, f, 1) and [R|t] = world_to_cam. Every function takes a batch of
tracks as leading dims of padded [..., V] rows with a validity mask.
"""

from __future__ import annotations

import torch

from multiview_tpu_torch.geometry import pose as pose_mod


def projection_matrix(focal, world_to_cam_pose):
    """P = K [R|t], K = diag(f,f,1) (interest_point.cc:343-352).
    focal: [...] (mean focal), world_to_cam_pose: [...,7] -> [...,3,4]."""
    R = pose_mod.quat_to_matrix(pose_mod.pose_q(world_to_cam_pose))
    t = pose_mod.pose_t(world_to_cam_pose)
    Rt = torch.cat([R, t[..., None]], dim=-1)
    f = torch.as_tensor(focal, dtype=Rt.dtype, device=Rt.device)
    f = f.expand(Rt.shape[:-2])
    scale = torch.stack([f, f, torch.ones_like(f)], dim=-1)
    return Rt * scale[..., None]


def triangulate_track(P, pix, mask, iters: int = 3):
    """Iterated weighted linear triangulation of a batch of tracks.

    P [...,V,3,4], pix [...,V,2] (undistorted centered), mask [...,V].
    Returns (xyz [...,3], min_depth [...], valid [...]); ``valid`` is False
    for fewer than two masked views or a non-finite solve
    (``Triangulation::compute``: weights start at 1, then 1/z)."""
    dtype = P.dtype
    w0 = mask.to(dtype)
    eye = torch.eye(3, dtype=dtype, device=P.device)

    def solve(weights):
        v1 = weights[..., None] * (P[..., 0, :3] - pix[..., 0:1] * P[..., 2, :3])
        v2 = weights[..., None] * (P[..., 1, :3] - pix[..., 1:2] * P[..., 2, :3])
        b1 = weights * (pix[..., 0] * P[..., 2, 3] - P[..., 0, 3])
        b2 = weights * (pix[..., 1] * P[..., 2, 3] - P[..., 1, 3])
        AtA = (torch.einsum("...vi,...vj->...ij", v1, v1)
               + torch.einsum("...vi,...vj->...ij", v2, v2))
        Atb = (torch.einsum("...vi,...v->...i", v1, b1)
               + torch.einsum("...vi,...v->...i", v2, b2))
        AtA = AtA + 1e-30 * eye
        # solve_ex: a singular system yields non-finite values (flagged below)
        # instead of raising
        return torch.linalg.solve_ex(AtA, Atb[..., None]).result[..., 0]

    weights = w0
    X = torch.zeros(P.shape[:-3] + (3,), dtype=dtype, device=P.device)
    for _ in range(iters):
        X = solve(weights)
        z = torch.einsum("...vi,...i->...v", P[..., 2, :3], X) + P[..., 2, 3]
        safe_z = torch.where(torch.abs(z) > 1e-30, z, torch.full_like(z, 1e-30))
        weights = w0 / safe_z

    z = torch.einsum("...vi,...i->...v", P[..., 2, :3], X) + P[..., 2, 3]
    big = torch.finfo(dtype).max
    min_depth = torch.amin(torch.where(mask, z, torch.full_like(z, big)), dim=-1)
    nviews = torch.sum(mask, dim=-1)
    valid = (nviews >= 2) & torch.all(torch.isfinite(X), dim=-1)
    return X, min_depth, valid


def triangulate_pair(focal1, focal2, w2c1, w2c2, pix1, pix2, iters: int = 3):
    """Two-view convenience wrapper (``TriangulatePair``,
    interest_point.cc:374-397): the point [3] seen at undistorted centered
    pixels pix1 / pix2 by world->cam poses w2c1 / w2c2."""
    P = torch.stack([projection_matrix(focal1, w2c1), projection_matrix(focal2, w2c2)])
    mask = torch.ones(2, dtype=torch.bool, device=P.device)
    X, _, _ = triangulate_track(P, torch.stack([pix1, pix2]), mask, iters)
    return X


def triangulate_tracks(P, pix, mask, iters: int = 3):
    """``triangulate_track`` over a leading track axis: P [T,V,3,4], pix
    [T,V,2], mask [T,V]. The reference maps the single-track function over
    the tracks; here that function is batched already, so this is its name
    for callers that hold a padded track table."""
    return triangulate_track(P, pix, mask, iters)


def convergence_angles(w2c_poses, xyz, mask):
    """Max pairwise angle (degrees) between rays from cameras to each point
    (the min-triangulation-angle gate, rig_calibrator.cc:1045-1119).
    w2c_poses [...,V,7], xyz [...,3], mask [...,V] -> [...] (0 if <2 views)."""
    cam_ctr = pose_mod.pose_t(pose_mod.pose_inverse(w2c_poses))
    rays = xyz[..., None, :] - cam_ctr
    rays = rays / torch.clamp_min(torch.linalg.norm(rays, dim=-1, keepdim=True), 1e-30)
    cosang = torch.clamp(rays @ rays.transpose(-1, -2), -1.0, 1.0)
    ang = torch.rad2deg(torch.arccos(cosang))
    pair_ok = mask[..., :, None] & mask[..., None, :]
    ang = torch.where(pair_ok, ang, torch.zeros_like(ang))
    return torch.amax(ang, dim=(-1, -2))
