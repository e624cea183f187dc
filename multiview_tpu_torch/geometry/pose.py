"""Quaternion / rigid-pose algebra on tensors. Port of
``multiview_tpu/geometry/pose.py``.

Pose layout follows the reference parameter-array convention
(dense_map_utils.cc:159-178): a rigid pose is 7 numbers
``[tx, ty, tz, qx, qy, qz, qw]`` — translation first, then a
(not-necessarily-normalized) quaternion in xyzw order, normalized on
decode.

All functions broadcast over leading batch dimensions, branch on no tensor
value, and keep the where-NaN guards of the reference (every sqrt/arccos/
division near a branch point has its unselected branch clamped), so they
are safe under autograd.
"""

from __future__ import annotations

import torch


def _tiny(dtype):
    return torch.finfo(dtype).tiny


def _as(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ----------------------------------------------------------------------------
# Quaternions (xyzw layout)
# ----------------------------------------------------------------------------


def quat_normalize(q):
    """Normalize quaternion; guards against zero norm."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, _tiny(q.dtype))


def quat_mul(a, b):
    """Hamilton product a*b, xyzw layout. Rotation by (a*b) = rotate by b then a."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * _as([-1.0, -1.0, -1.0, 1.0], q)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion q. q: [...,4], v: [...,3]."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    # v' = v + 2*qw*(qv x v) + 2*qv x (qv x v)
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q):
    """Unit quaternion (xyzw) -> rotation matrix [...,3,3]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix [...,3,3] -> unit quaternion xyzw (branch-free
    Shepperd method: all four candidates, the best-conditioned selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw_w = torch.sqrt(torch.clamp_min(1.0 + tr, 0.0)) / 2
    qx_x = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)) / 2
    qy_y = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)) / 2
    qz_z = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)) / 2

    tiny = _tiny(m.dtype)

    def safe(x, d):
        return x / torch.clamp_min(4.0 * d, tiny)

    cand_w = torch.stack(
        [safe(m21 - m12, qw_w), safe(m02 - m20, qw_w), safe(m10 - m01, qw_w), qw_w], dim=-1)
    cand_x = torch.stack(
        [qx_x, safe(m01 + m10, qx_x), safe(m02 + m20, qx_x), safe(m21 - m12, qx_x)], dim=-1)
    cand_y = torch.stack(
        [safe(m01 + m10, qy_y), qy_y, safe(m12 + m21, qy_y), safe(m02 - m20, qy_y)], dim=-1)
    cand_z = torch.stack(
        [safe(m02 + m20, qz_z), safe(m12 + m21, qz_z), qz_z, safe(m10 - m01, qz_z)], dim=-1)

    pivots = torch.stack([qw_w, qx_x, qy_y, qz_z], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)   # [...,4cand,4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx).squeeze(-2)
    return quat_normalize(q)


def quat_slerp(q0, q1, alpha):
    """Spherical linear interpolation between unit quaternions (xyzw).

    Eigen's Quaternion::slerp semantics used by ``linearInterp``
    (dense_map_utils.cc:315-329): short path, lerp for nearly-parallel
    quaternions. The near-parallel guard feeds the unselected arccos branch
    a safe value and is representable in the working dtype."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), 0.0, 1.0)

    eps = 16.0 * torch.finfo(q0.dtype).eps
    near = dot > 1.0 - eps
    dot_safe = torch.where(near, torch.zeros_like(dot), dot)
    theta = torch.arccos(dot_safe)
    sin_theta = torch.sin(theta)
    safe_sin = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    a = torch.as_tensor(alpha, dtype=q0.dtype, device=q0.device)[..., None]
    w0 = torch.where(near, 1.0 - a, torch.sin((1.0 - a) * theta) / safe_sin)
    w1 = torch.where(near, a, torch.sin(a * theta) / safe_sin)
    return quat_normalize(w0 * q0 + w1 * q1)


# ----------------------------------------------------------------------------
# Rigid poses: [tx,ty,tz,qx,qy,qz,qw]
# ----------------------------------------------------------------------------


def pose_t(p):
    return p[..., :3]


def pose_q(p):
    """Quaternion part, normalized on read (array_to_rigid_transform)."""
    return quat_normalize(p[..., 3:7])


def make_pose(t, q):
    t, q = _broadcast_lead(t, q)
    return torch.cat([t, q], dim=-1)


def pose_apply(p, x):
    """Apply rigid transform to point(s): R x + t."""
    return quat_rotate(pose_q(p), x) + pose_t(p)


def pose_compose(a, b):
    """Compose: (a*b)(x) = a(b(x))."""
    qa, qb = pose_q(a), pose_q(b)
    t = quat_rotate(qa, pose_t(b)) + pose_t(a)
    q = quat_mul(qa, qb)
    t, q = _broadcast_lead(t, q)
    return torch.cat([t, q], dim=-1)


def _broadcast_lead(t, q):
    shape = torch.broadcast_shapes(t.shape[:-1], q.shape[:-1])
    return t.expand(shape + t.shape[-1:]), q.expand(shape + q.shape[-1:])


def pose_inverse(p):
    q = pose_q(p)
    qi = quat_conj(q)
    return torch.cat([-quat_rotate(qi, pose_t(p)), qi], dim=-1)


def pose_to_matrix(p):
    """[...,7] -> [...,4,4] homogeneous matrix."""
    R = quat_to_matrix(pose_q(p))
    t = pose_t(p)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = _as([0.0, 0.0, 0.0, 1.0], p).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose(m):
    """[...,3|4,4] homogeneous (or 3x4) matrix -> [...,7]."""
    return torch.cat([m[..., :3, 3], matrix_to_quat(m[..., :3, :3])], dim=-1)


def pose_interp(alpha, p0, p1):
    """slerp rotation + lerp translation (``linearInterp``,
    dense_map_utils.cc:315-329)."""
    a = torch.as_tensor(alpha, dtype=p0.dtype, device=p0.device)[..., None]
    t = (1.0 - a) * pose_t(p0) + a * pose_t(p1)
    q = quat_slerp(pose_q(p0), pose_q(p1), alpha)
    t, q = _broadcast_lead(t, q)
    return torch.cat([t, q], dim=-1)


# ----------------------------------------------------------------------------
# Bracketed-pose interpolation (the core of the rig BA residuals)
# ----------------------------------------------------------------------------


def interp_world_to_ref(beg_pose, end_pose, dt_cam, dt_bracket, ref_to_cam_offset):
    """Interpolated world->ref pose at a camera timestamp between two
    bracketing reference poses (``calc_interp_world_to_ref``,
    rig_calibrator.cc:322-353), on pre-differenced timestamps:
    alpha = (dt_cam - offset) / dt_bracket; dt_bracket == 0 returns
    beg_pose (the reference-camera convention)."""
    dt_bracket = torch.as_tensor(dt_bracket, dtype=beg_pose.dtype, device=beg_pose.device)
    degenerate = dt_bracket == 0.0
    safe_len = torch.where(degenerate, torch.ones_like(dt_bracket), dt_bracket)
    alpha = (dt_cam - ref_to_cam_offset) / safe_len
    alpha = torch.where(degenerate, torch.zeros_like(alpha), alpha)
    return pose_interp(alpha, beg_pose, end_pose)


def world_to_cam_from_bracket(beg_pose, end_pose, ref_to_cam, dt_cam, dt_bracket,
                              ref_to_cam_offset):
    """world->cam = ref_to_cam * interp(world->ref) (``calc_world_to_cam_trans``,
    rig_calibrator.cc:362-390); for dt_bracket == 0 the result is the
    interpolated (= beg) pose exactly, ignoring ref_to_cam."""
    interp = interp_world_to_ref(beg_pose, end_pose, dt_cam, dt_bracket, ref_to_cam_offset)
    composed = pose_compose(ref_to_cam, interp)
    degenerate = (torch.as_tensor(dt_bracket, device=beg_pose.device) == 0.0)[..., None]
    return torch.where(degenerate, interp, composed)


# ----------------------------------------------------------------------------
# Rotation utilities
# ----------------------------------------------------------------------------


def quat_log(q):
    """Log map of unit quaternion -> rotation vector (axis*angle, 3)."""
    q = quat_normalize(q)
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v = q[..., :3]
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    n = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.arctan2(n, w)
    scale = torch.where(n < 1e-12, 2.0 / torch.clamp_min(w, 1e-12),
                        angle / torch.clamp_min(n, 1e-12))
    return v * scale[..., None]


def quat_exp(rvec):
    """Exp map rotation vector -> unit quaternion (xyzw)."""
    angle = torch.linalg.norm(rvec, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-12
    k = torch.where(small, torch.full_like(angle, 0.5),
                    torch.sin(half) / torch.clamp_min(angle, 1e-30))
    w = torch.cos(half)
    return torch.cat([rvec * k, w], dim=-1)
