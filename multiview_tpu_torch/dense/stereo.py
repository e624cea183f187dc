"""Dense two-view stereo by plane sweep. Port of
``multiview_tpu/dense/stereo.py`` (the ASP ``parallel_stereo`` role of
multi_stereo:158-246).

For every fronto-parallel depth plane of the reference view the neighbour
image is warped by the induced homography and correlated with the reference
by ZNCC over a box window; the cost volume [D,H,W] reduces by
winner-take-all (optionally after 4-path semi-global aggregation) with
parabolic sub-plane refinement.

The planes are computed 16 at a time as one tensor (about 1.6 GB of float32
intermediates at 1280x960). Box means are exact window sums (``avg_pool2d``
over an edge-padded image), not the reference's differences of cumulative
sums, which lose several percent of a small local variance in float32 after
a thousand columns; in float64 the two agree to rounding. The SGM recurrence is sequential along each
path: one step per scanline, the two opposite paths of an axis stepped
together.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from multiview_tpu_torch.geometry import pose as pose_mod

_PLANE_BATCH = 16


class StereoResult(NamedTuple):
    depth: torch.Tensor       # [H,W] z-depth in the reference view (0 invalid)
    confidence: torch.Tensor  # [H,W] best ZNCC score
    valid: torch.Tensor       # [H,W] bool


def _box_filter(x, radius: int):
    """Mean over a (2r+1)^2 box of the last two dims of x [...,H,W], the
    image edge-padded."""
    k = 2 * radius + 1
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    xp = F.pad(x.reshape(-1, 1, H, W), (radius,) * 4, mode="replicate")
    return F.avg_pool2d(xp, k, stride=1).reshape(lead + (H, W))


def _bilinear_gray(img, x, y):
    """Bilinear samples of img [H,W] at (x, y). The top-left tap is clamped
    to [0, W-2] x [0, H-2] and the fractions to [0, 1], so a sample outside
    the image carries an edge value; ``inb`` says which samples were inside."""
    H, W = img.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    flat = img.reshape(-1)
    i00 = y0 * W + x0
    v = (flat[i00] * (1 - fx) * (1 - fy) + flat[i00 + 1] * fx * (1 - fy)
         + flat[i00 + W] * (1 - fx) * fy + flat[i00 + W + 1] * fx * fy)
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return v, inb


def _sgm_dir_scan(cost, p1, p2):
    """SGM aggregation along axis 1 of cost [B,X,Y,D]: each of the B
    volumes is one path, stepped line by line (L_r recurrence of
    Hirschmuller; the carry is a whole line [Y,D])."""
    out = torch.empty_like(cost)
    L = cost[:, 0]
    out[:, 0] = L
    for i in range(1, cost.shape[1]):
        m = torch.amin(L, dim=-1, keepdim=True)
        lm1 = torch.cat([L[..., :1], L[..., :-1]], dim=-1) + p1
        lp1 = torch.cat([L[..., 1:], L[..., -1:]], dim=-1) + p1
        L = cost[:, i] + torch.minimum(torch.minimum(L, m + p2), torch.minimum(lm1, lp1)) - m
        out[:, i] = L
    return out


def sgm_aggregate(cost_hwd, p1: float = 0.03, p2: float = 0.3):
    """4-path semi-global matching aggregation of a [H,W,D] matching-cost
    volume (lower is better): the sum of the down, up, right and left path
    costs."""
    vert = _sgm_dir_scan(torch.stack([cost_hwd, cost_hwd.flip(0)]), p1, p2)
    cwd = cost_hwd.transpose(0, 1)                                   # [W,H,D]
    horiz = _sgm_dir_scan(torch.stack([cwd, cwd.flip(0)]), p1, p2)
    down, up = vert[0], vert[1].flip(0)
    right, left = horiz[0].transpose(0, 1), horiz[1].flip(0).transpose(0, 1)
    return down + up + right + left


def _plane_costs(ref_zm, ref_var, nbr_img, rx, ry, R, t, focal, center, inv_d, radius):
    """ZNCC of the reference against the neighbour warped through each plane
    of inv_d [P]; -1 where the warped sample falls outside the neighbour or
    behind its camera. Returns [P,H,W]."""
    z = (1.0 / inv_d)[:, None, None]
    X = (rx * z, ry * z, z.expand_as(rx * z))
    Xn = [R[i, 0] * X[0] + R[i, 1] * X[1] + R[i, 2] * X[2] + t[i] for i in range(3)]
    zn = Xn[2]
    good_z = zn > 1e-6
    zs = torch.where(good_z, zn, torch.ones_like(zn))
    un = Xn[0] / zs * focal[0] + center[0]
    vn = Xn[1] / zs * focal[1] + center[1]
    warped, inb = _bilinear_gray(nbr_img, un, vn)
    inb = inb & good_z
    w_zm = warped - _box_filter(warped, radius)
    cov = _box_filter(ref_zm * w_zm, radius)
    w_var = _box_filter(w_zm * w_zm, radius)
    zncc = cov / torch.sqrt(torch.clamp_min(ref_var * w_var, 1e-16))
    return torch.where(inb, zncc, torch.full_like(zncc, -1.0))


def plane_sweep(ref_img, nbr_img, focal, center, ref_to_nbr_pose,
                min_depth: float, max_depth: float, num_planes: int = 64,
                radius: int = 3, min_confidence: float = 0.3,
                aggregate: str = "none", sgm_p1: float = 0.03,
                sgm_p2: float = 0.3) -> StereoResult:
    """Depth of the reference view by plane sweep against one neighbour.

    ref_img / nbr_img: [H,W] float tensors of undistorted images (their
    device and dtype are the computation's); focal [2], center [2] shared
    pinhole intrinsics; ref_to_nbr_pose [7] the camera transform
    ref -> neighbour. Planes are uniform in inverse depth. ``aggregate``:
    "none" (winner-take-all on the ZNCC) or "sgm"."""
    H, W = ref_img.shape
    dev, dtype = ref_img.device, ref_img.dtype

    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    focal, center, pose = vec(focal), vec(center), vec(ref_to_nbr_pose)
    nbr_img = nbr_img.to(device=dev, dtype=dtype)
    vs, us = torch.meshgrid(torch.arange(H, dtype=dtype, device=dev),
                            torch.arange(W, dtype=dtype, device=dev), indexing="ij")
    rx = (us - center[0]) / focal[0]
    ry = (vs - center[1]) / focal[1]
    R = pose_mod.quat_to_matrix(pose_mod.pose_q(pose))
    t = pose_mod.pose_t(pose)
    inv_depths = torch.linspace(1.0 / max_depth, 1.0 / min_depth, num_planes,
                                dtype=dtype, device=dev)

    ref_zm = ref_img - _box_filter(ref_img, radius)
    ref_var = _box_filter(ref_zm * ref_zm, radius)
    costs = torch.cat([
        _plane_costs(ref_zm, ref_var, nbr_img, rx, ry, R, t, focal, center,
                     inv_depths[p0:p0 + _PLANE_BATCH], radius)
        for p0 in range(0, num_planes, _PLANE_BATCH)])               # [D,H,W]

    if aggregate == "sgm":
        agg = sgm_aggregate((1.0 - costs).permute(1, 2, 0), sgm_p1, sgm_p2)
        scores = (-agg).permute(2, 0, 1)
    elif aggregate == "none":
        scores = costs
    else:
        raise ValueError(f"unknown aggregate {aggregate!r}")

    best = torch.argmax(scores, dim=0)                               # first maximum
    best_cost = torch.gather(costs, 0, best[None])[0]

    def at(d):
        return torch.gather(scores, 0, d[None])[0]

    c0 = at(torch.clamp(best - 1, 0, num_planes - 1))
    c1 = at(best)
    c2 = at(torch.clamp(best + 1, 0, num_planes - 1))
    denom = c0 - 2 * c1 + c2
    ok = torch.abs(denom) > 1e-9
    delta = torch.where(ok, 0.5 * (c0 - c2) / torch.where(ok, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    step = inv_depths[1] - inv_depths[0]
    depth = 1.0 / torch.clamp_min(inv_depths[best] + delta * step, 1e-9)

    textured = ref_var > 1e-9
    valid = (best_cost > min_confidence) & (best > 0) & (best < num_planes - 1) & textured
    depth = torch.where(valid, depth, torch.zeros_like(depth))
    return StereoResult(depth, best_cost, valid)


def stereo_pair_to_cloud(result: StereoResult, focal, center, subsample: int = 1):
    """Depth map -> camera-frame point cloud [N,3] numpy (valid pixels only,
    every ``subsample``-th row and column), on the host as the reference."""
    depth = result.depth.cpu().numpy()[::subsample, ::subsample]
    valid = result.valid.cpu().numpy()[::subsample, ::subsample]
    H, W = depth.shape
    us, vs = np.meshgrid(np.arange(W) * subsample, np.arange(H) * subsample)
    z = depth
    x = (us - float(center[0])) / float(focal[0]) * z
    y = (vs - float(center[1])) / float(focal[1]) * z
    return np.stack([x, y, z], -1)[valid]


def left_right_check(left: StereoResult, right: StereoResult, focal, center,
                     ref_to_nbr_pose, max_diff: float = 0.05) -> StereoResult:
    """Project each left depth into the right view and compare it with the
    right depth there; inconsistent pixels are invalidated."""
    H, W = left.depth.shape
    dev, dtype = left.depth.device, left.depth.dtype

    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    focal, center, pose = vec(focal), vec(center), vec(ref_to_nbr_pose)
    vs, us = torch.meshgrid(torch.arange(H, dtype=dtype, device=dev),
                            torch.arange(W, dtype=dtype, device=dev), indexing="ij")
    z = left.depth
    X = ((us - center[0]) / focal[0] * z, (vs - center[1]) / focal[1] * z, z)
    R = pose_mod.quat_to_matrix(pose_mod.pose_q(pose))
    t = pose_mod.pose_t(pose)
    Xn = [R[i, 0] * X[0] + R[i, 1] * X[1] + R[i, 2] * X[2] + t[i] for i in range(3)]
    zn = Xn[2]
    zs = torch.where(zn > 1e-6, zn, torch.ones_like(zn))
    un = Xn[0] / zs * focal[0] + center[0]
    vn = Xn[1] / zs * focal[1] + center[1]
    zr, inb = _bilinear_gray(right.depth, un, vn)
    consistent = inb & (torch.abs(zr - zn) < max_diff * zn) & left.valid
    return StereoResult(torch.where(consistent, left.depth, torch.zeros_like(left.depth)),
                        left.confidence, consistent)
