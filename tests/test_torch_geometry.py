"""Port parity: losses, pose algebra, distortion models, camera frame
conversions and triangulation of multiview_tpu_torch against the JAX
package, values and gradients in float64 at rtol 1e-10 (same formulas;
only the operation order of the two frameworks differs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.geometry import camera as JC, distortion as JD, pose as JP
from multiview_tpu.geometry import triangulation as JT
from multiview_tpu.solver import losses as JL
from multiview_tpu_torch.geometry import camera as TC, distortion as TD, pose as TP
from multiview_tpu_torch.geometry import triangulation as TT
from multiview_tpu_torch.solver import losses as TL

RTOL = 1e-10
ATOL = 1e-12


def close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours.detach() if torch.is_tensor(ours) else ours),
                               np.asarray(ref), rtol=rtol, atol=atol)


def check_fn(jfn, tfn, *arrays, rtol=RTOL, atol=ATOL):
    """Values and the gradient of sum(output * w) for a fixed random w,
    with respect to every input array."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    jout = jax.jit(jfn)(*jargs)
    tout = tfn(*targs)
    close(tout, jout, rtol, atol)
    w = np.random.default_rng(0).normal(size=np.shape(jout))
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                          argnums=tuple(range(len(arrays)))))(*jargs)
    tg = (torch.autograd.grad((tout * torch.as_tensor(w)).sum(), targs, allow_unused=True)
          if tout.requires_grad else [None] * len(targs))      # constant output
    for g_t, g_j in zip(tg, jg):
        close(torch.zeros(np.shape(g_j), dtype=torch.float64) if g_t is None else g_t, g_j,
              rtol, atol)


def rand_quat(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def rand_pose(rng, n):
    return np.concatenate([rng.normal(size=(n, 3)), rand_quat(rng, n)], axis=-1)


# ----------------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("loss", ["l2", "huber", "cauchy", "soft_l1"])
def test_losses(loss):
    s = np.random.default_rng(1).uniform(0.0, 30.0, size=64)
    check_fn(lambda x: JL.rho(loss, x, 3.0), lambda x: TL.rho(loss, x, 3.0), s)
    check_fn(lambda x: JL.rho_prime(loss, x, 3.0), lambda x: TL.rho_prime(loss, x, 3.0), s)
    blocks = np.random.default_rng(2).normal(size=(16, 2)) * 4
    check_fn(lambda x: JL.robust_weights(loss, x, 3.0),
             lambda x: TL.robust_weights(loss, x, 3.0), blocks)


# ----------------------------------------------------------------------------
# pose
# ----------------------------------------------------------------------------


def test_quaternion_and_pose_algebra():
    rng = np.random.default_rng(3)
    a, b = rand_pose(rng, 8), rand_pose(rng, 8)
    x = rng.normal(size=(8, 3))
    check_fn(JP.quat_mul, TP.quat_mul, a[:, 3:], b[:, 3:])
    check_fn(JP.quat_rotate, TP.quat_rotate, a[:, 3:], x)
    check_fn(JP.quat_to_matrix, TP.quat_to_matrix, a[:, 3:])
    check_fn(JP.pose_apply, TP.pose_apply, a, x)
    check_fn(JP.pose_compose, TP.pose_compose, a, b)
    check_fn(JP.pose_inverse, TP.pose_inverse, a)
    check_fn(JP.pose_to_matrix, TP.pose_to_matrix, a)
    check_fn(JP.quat_log, TP.quat_log, a[:, 3:])
    check_fn(JP.quat_exp, TP.quat_exp, 0.3 * x)


def test_matrix_to_quat_every_pivot_branch():
    # rotations by ~180 deg about x, y, z force the x/y/z pivots; small ones the w pivot
    rv = np.array([[0.1, 0.2, -0.1], [3.0, 0.1, 0.2], [0.1, 3.0, -0.2], [0.2, -0.1, 3.0]])
    R = np.asarray(JP.quat_to_matrix(JP.quat_exp(jnp.asarray(rv))))
    check_fn(JP.matrix_to_quat, TP.matrix_to_quat, R)
    M = np.asarray(JP.pose_to_matrix(jnp.asarray(rand_pose(np.random.default_rng(4), 5))))
    check_fn(JP.matrix_to_pose, TP.matrix_to_pose, M)


def test_slerp_at_its_branch_points():
    rng = np.random.default_rng(5)
    q0 = rand_quat(rng, 6)
    q1 = rand_quat(rng, 6)
    q1[0] = q0[0]                                   # parallel: lerp branch
    q1[1] = q0[1] + 1e-9                            # nearly parallel
    q1[1] /= np.linalg.norm(q1[1])
    q1[2] = -q0[2]                                  # antipodal: short-path flip
    alpha = np.array([0.0, 0.3, 0.5, 1.0, 0.7, 0.25])
    check_fn(JP.quat_slerp, TP.quat_slerp, q0, q1, alpha)
    p0, p1 = rand_pose(rng, 6), rand_pose(rng, 6)
    check_fn(JP.pose_interp, TP.pose_interp, alpha, p0, p1)


def test_bracketed_world_to_cam():
    rng = np.random.default_rng(6)
    beg, end, rig = rand_pose(rng, 6), rand_pose(rng, 6), rand_pose(rng, 6)
    dt_cam = rng.uniform(0, 1, 6)
    dt_bracket = np.array([1.0, 0.0, 1.3, 0.0, 2.0, 1.0])   # 0 = reference/degenerate
    offset = rng.uniform(-0.2, 0.2, 6)
    check_fn(JP.world_to_cam_from_bracket, TP.world_to_cam_from_bracket,
             beg, end, rig, dt_cam, dt_bracket, offset)
    check_fn(JP.interp_world_to_ref, TP.interp_world_to_ref, beg, end, dt_cam, dt_bracket,
             offset)


# ----------------------------------------------------------------------------
# distortion + camera
# ----------------------------------------------------------------------------

MODELS = {
    "none": np.zeros(0),
    "fov": np.array([0.9]),
    "tsai": np.array([-0.12, 0.03, 5e-4, -4e-4]),
    "tsai5": np.array([-0.12, 0.03, 5e-4, -4e-4, 0.002]),
    # degree-2 RPC (22 coefficients per half): identity plus a small warp
    "rpc": np.tile(JD.rpc_identity_params(2), 2)
    + 1e-7 * np.random.default_rng(11).normal(size=44),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_distortion_models(name):
    coeffs = MODELS[name]
    model = JD.model_from_num_coeffs(len(coeffs))
    assert TD.model_from_num_coeffs(len(coeffs)) == model
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.uniform(-300, 300, size=(20, 2)), np.zeros((1, 2))])
    focal = np.array([400.0, 400.0])
    ctr = np.array([322.0, 238.0])
    half = np.array([320.0, 240.0])
    check_fn(lambda c, p, f, o: JD.distort_centered(model, c, p, f, o, half),
             lambda c, p, f, o: TD.distort_centered(model, c, p, f, o,
                                                    torch.as_tensor(half)),
             coeffs, pts, focal, ctr)
    check_fn(lambda c, p, f, o: JD.undistort_centered(model, c, p, f, o, half),
             lambda c, p, f, o: TD.undistort_centered(model, c, p, f, o,
                                                      torch.as_tensor(half)),
             coeffs, pts, focal, ctr, rtol=1e-9)


@pytest.mark.parametrize("name", ["none", "fov", "tsai", "rpc"])
def test_camera_frame_conversions(name):
    coeffs = MODELS[name]
    jc = JC.CameraParams.create((640, 480), 400.0, (322.0, 238.0), coeffs,
                                undistorted_size=(700, 520))
    tc = TC.CameraParams.create((640, 480), 400.0, (322.0, 238.0), coeffs,
                                undistorted_size=(700, 520), device="cpu")
    pix = np.random.default_rng(8).uniform(20, 460, size=(32, 2))
    frames = [JC.RAW, JC.DISTORTED, JC.DISTORTED_C, JC.UNDISTORTED, JC.UNDISTORTED_C]
    for src in frames:
        for dst in frames:
            close(tc.convert(torch.as_tensor(pix), src, dst),
                  jax.jit(lambda p: jc.convert(p, src, dst))(jnp.asarray(pix)),
                  rtol=1e-9, atol=1e-9)
    X = np.concatenate([np.random.default_rng(9).normal(size=(16, 2)),
                        np.full((16, 1), 3.0)], axis=-1)
    close(tc.project_cam_to_dist_pix(torch.as_tensor(X)),
          jc.project_cam_to_dist_pix(jnp.asarray(X)), rtol=1e-10)
    close(tc.ray_from_dist_pix(torch.as_tensor(pix)), jc.ray_from_dist_pix(jnp.asarray(pix)),
          rtol=1e-9, atol=1e-12)


# ----------------------------------------------------------------------------
# triangulation
# ----------------------------------------------------------------------------


def test_triangulation_batched_and_masked():
    rng = np.random.default_rng(10)
    P_, V = 12, 4
    poses = rand_pose(rng, P_ * V).reshape(P_, V, 7)
    poses[..., 2] += 6.0
    focal = np.full((P_, V), 500.0)
    Pm = np.asarray(JT.projection_matrix(jnp.asarray(focal), jnp.asarray(poses)))
    close(TT.projection_matrix(torch.as_tensor(focal), torch.as_tensor(poses)), Pm)
    pix = rng.uniform(-200, 200, size=(P_, V, 2))
    mask = rng.uniform(size=(P_, V)) > 0.3
    mask[0] = [True, False, False, False]          # one view: invalid track
    jx, jd, jv = JT.triangulate_tracks(jnp.asarray(Pm), jnp.asarray(pix), jnp.asarray(mask), 3)
    tx, td, tv = TT.triangulate_track(torch.as_tensor(Pm.copy()), torch.as_tensor(pix),
                                      torch.as_tensor(mask), 3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = np.array(jv)
    close(tx[ok], np.asarray(jx)[ok], rtol=1e-9)
    close(td[ok], np.asarray(jd)[ok], rtol=1e-9)
    ang_j = jax.vmap(JT.convergence_angles)(jnp.asarray(poses), jx, jnp.asarray(mask))
    close(TT.convergence_angles(torch.as_tensor(poses), tx, torch.as_tensor(mask))[ok],
          np.asarray(ang_j)[ok], rtol=1e-9, atol=1e-9)


def test_affine_transforms():
    """The 12-vector affine algebra (9 row-major linear entries, then the
    translation), values and gradients."""
    rng = np.random.default_rng(11)
    a = np.concatenate([np.eye(3).reshape(9) + 0.2 * rng.normal(size=(4, 9)),
                        rng.normal(size=(4, 3))], axis=-1)
    b = np.concatenate([np.eye(3).reshape(9) + 0.2 * rng.normal(size=(4, 9)),
                        rng.normal(size=(4, 3))], axis=-1)
    x = rng.normal(size=(4, 3))
    pose = np.concatenate([rng.normal(size=(4, 3)), rng.normal(size=(4, 4))], axis=-1)
    check_fn(JP.affine_apply, TP.affine_apply, a, x)
    check_fn(JP.affine_compose, TP.affine_compose, a, b)
    check_fn(JP.affine_inverse, TP.affine_inverse, a, rtol=1e-9, atol=1e-10)
    check_fn(lambda p: JP.pose_to_affine(p, 1.03), lambda p: TP.pose_to_affine(p, 1.03), pose)
    check_fn(lambda v: JP.make_affine(JP.affine_linear(v), JP.affine_t(v)),
             lambda v: TP.make_affine(TP.affine_linear(v), TP.affine_t(v)), a)
    close(TP.affine_identity(), JP.affine_identity(jnp.float64))
    close(TP.pose_identity(), JP.pose_identity(jnp.float64))
    close(TP.affine_apply(TP.affine_compose(TP.affine_inverse(torch.as_tensor(a)),
                                            torch.as_tensor(a)), torch.as_tensor(x)),
          x, rtol=1e-9, atol=1e-9)


def test_similarity_registration():
    """``find_similarity_transform`` and the transforms that apply its result
    to cameras, points and the rig."""
    from multiview_tpu.geometry import registration as JR
    from multiview_tpu_torch.geometry import registration as TR
    rng = np.random.default_rng(12)
    src = rng.normal(size=(9, 3))
    q = rng.normal(size=4)
    true_pose = np.concatenate([[0.3, -0.2, 0.5], q / np.linalg.norm(q)])
    dst = np.asarray(JR.apply_similarity(1.7, jnp.asarray(true_pose), jnp.asarray(src))) \
        + 1e-3 * rng.normal(size=(9, 3))
    w = rng.uniform(0.5, 1.5, size=9)
    for weights in (None, w):
        js, jp = JR.find_similarity_transform(
            jnp.asarray(src), jnp.asarray(dst), None if weights is None else jnp.asarray(w))
        ts, tp = TR.find_similarity_transform(
            torch.as_tensor(src), torch.as_tensor(dst),
            None if weights is None else torch.as_tensor(w))
        close(ts, js)
        close(tp, jp, rtol=1e-9, atol=1e-10)
        assert abs(float(ts) - 1.7) < 0.01
    cams = np.concatenate([rng.normal(size=(5, 3)), rng.normal(size=(5, 4))], axis=-1)
    tpose, tcams, tsrc = torch.as_tensor(true_pose), torch.as_tensor(cams), torch.as_tensor(src)
    jpose, jcams, jsrc = jnp.asarray(true_pose), jnp.asarray(cams), jnp.asarray(src)
    close(TR.apply_similarity(1.7, tpose, tsrc), JR.apply_similarity(1.7, jpose, jsrc))
    close(TR.transform_points(1.7, tpose, tsrc), JR.transform_points(1.7, jpose, jsrc))
    close(TR.transform_cameras(1.7, tpose, tcams), JR.transform_cameras(1.7, jpose, jcams),
          rtol=1e-9, atol=1e-10)
    close(TR.transform_rig(1.7, tcams), JR.transform_rig(1.7, jcams))
