"""Shared inputs of the port parity tests (tests/test_torch_*.py): the
rendered textured-terrain frames and two-sensor rig workspace of
tests/test_cli_tools.py (written as binary PGM, which both packages read),
and a RANSAC hypothesis sampler that returns the JAX package's own draws."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

from multiview_tpu_torch.geometry import pose as P
from multiview_tpu_torch.io import nvm as nvm_io, rig_config as rc
from multiview_tpu_torch.utils import synthetic as syn
from multiview_tpu_torch.utils.images import write_pgm

SIZE = (200, 150)  # W,H
FOCAL = 180.0
RIG_POSE = P.make_pose(torch.tensor([0.12, -0.04, 0.02], dtype=torch.float64),
                       P.quat_exp(torch.tensor([0.03, -0.02, 0.05], dtype=torch.float64))
                       ).numpy()
_TEX_GRID = np.random.default_rng(42).uniform(size=(512, 512)).astype(np.float32)


def _terrain_height(x, y):
    return 0.25 * np.sin(1.7 * x) * np.cos(1.3 * y)


def render_plane_image(w2c):
    """Textured terrain z = h(x,y) seen by a pinhole camera at world->cam
    pose w2c, rendered by bisection along each ray, as 8-bit gray."""
    W, H = SIZE
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    d = np.stack([(us - W / 2.0) / FOCAL, (vs - H / 2.0) / FOCAL,
                  np.ones_like(us, float)], -1)
    M = P.pose_to_matrix(P.pose_inverse(torch.as_tensor(w2c))).numpy()
    o = M[:3, 3]
    dw = d @ M[:3, :3].T
    t_lo = np.full(us.shape, 0.2)
    t_hi = np.full(us.shape, 8.0)
    for _ in range(40):
        t_mid = 0.5 * (t_lo + t_hi)
        p = o + t_mid[..., None] * dw
        above = p[..., 2] > _terrain_height(p[..., 0], p[..., 1])
        t_lo = np.where(above, t_mid, t_lo)
        t_hi = np.where(above, t_hi, t_mid)
    pts = o + (0.5 * (t_lo + t_hi))[..., None] * dw
    gi = np.mod(np.floor(pts[..., 0] * 10).astype(int), 512)
    gj = np.mod(np.floor(pts[..., 1] * 10).astype(int), 512)
    return (np.clip(_TEX_GRID[gi, gj], 0, 1) * 255).astype(np.uint8)


def ref_pose(i):
    return syn.look_at_pose(np.array([0.4 * i, 0.1 * i, 2.0]),
                            np.array([0.4 * i + 0.15, 0.1 * i, 1.0]))


def write_rig_workspace(ws: Path, n_ref: int = 6):
    """The two-sensor rig workspace of tests/test_cli_tools.py (nav_cam
    reference + sci_cam 0.2 s later with a rig transform, identity rig
    guess in rig_config.txt), images as PGM."""
    sensors = [rc.SensorConfig(
        name=name, focal_length=FOCAL, optical_center=np.array([SIZE[0] / 2.0, SIZE[1] / 2.0]),
        distortion=np.array([]), image_size=SIZE, distorted_crop_size=SIZE,
        undistorted_image_size=SIZE, ref_to_sensor=np.eye(4), depth_to_image=np.eye(4),
        timestamp_offset=off) for name, off in (("nav_cam", 0.0), ("sci_cam", 0.2))]
    rc.write_rig_config(ws / "rig_config.txt", rc.RigConfig(sensors))
    names, mats = [], []
    for s, (sname, offset) in enumerate((("nav_cam", 0.0), ("sci_cam", 0.2))):
        d = ws / "images" / sname
        d.mkdir(parents=True)
        ts_list = ([10000.0 + i for i in range(n_ref)] if s == 0
                   else [10000.0 + i + 0.5 + offset for i in range(n_ref - 1)])
        for t in ts_list:
            t_ref = t - offset
            i0 = int(np.clip(np.floor(t_ref - 10000.0), 0, n_ref - 1))
            i1 = min(i0 + 1, n_ref - 1)
            alpha = np.clip(t_ref - 10000.0 - i0, 0.0, 1.0)
            w2ref = P.pose_interp(alpha, torch.as_tensor(ref_pose(i0)),
                                  torch.as_tensor(ref_pose(i1)))
            w2c = w2ref if s == 0 else P.pose_compose(torch.as_tensor(RIG_POSE), w2ref)
            path = d / f"{t:.2f}.pgm"
            write_pgm(path, render_plane_image(w2c.numpy()))
            names.append(str(path))
            mats.append(P.pose_to_matrix(w2c).numpy())
    nvm_io.write_camera_poses(ws / "cameras.txt", names, np.stack(mats))


def rig_error(M):
    """(rotation deg, translation m) of a ref_to_sensor matrix vs RIG_POSE."""
    est = P.matrix_to_pose(torch.as_tensor(M))
    rel = P.pose_compose(P.pose_inverse(est), torch.as_tensor(RIG_POSE))
    return (float(np.degrees(np.linalg.norm(P.quat_log(P.pose_q(rel)).numpy()))),
            float(np.linalg.norm(P.pose_t(rel).numpy())))


def jax_sampler(valid, num_hypotheses, seed):
    """Drop-in for multiview_tpu_torch.sfm.ransac.sample_hypotheses that
    returns exactly the draws of multiview_tpu.sfm.ransac.ransac_affine2d
    for PRNGKey(seed) (probabilities in float32, as there)."""
    vf = jnp.asarray(valid.cpu().numpy()).astype(jnp.float32)
    probs = vf / jnp.maximum(jnp.sum(vf), 1.0)
    s = jax.random.choice(jax.random.PRNGKey(seed), valid.shape[0],
                          shape=(num_hypotheses, 3), replace=True, p=probs)
    return torch.as_tensor(np.array(s), dtype=torch.int64, device=valid.device)
