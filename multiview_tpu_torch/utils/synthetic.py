"""Synthetic calibration scenes with known ground truth. Port of
``look_at_pose``, ``make_cube_scene`` and ``perturb_state`` from
``multiview_tpu/utils/synthetic.py`` (numpy RNG, so scenes are identical to
the reference's from the same seed), plus a numpy renderer of the
two-sensor rig workspace (textured terrain seen by a pinhole reference
camera and a radtan-distorted camera with a clock offset) written as
binary PGM images, rig_config.txt and cameras.txt.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import camera as cam_mod
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.geometry.distortion import model_from_num_coeffs


def _f64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def look_at_pose(cam_pos: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """world->cam pose (7,) with +z toward target (float64 numpy)."""
    cam_pos = np.asarray(cam_pos, float)
    z = np.asarray(target, float) - cam_pos
    z = z / np.linalg.norm(z)
    up = np.asarray(up, float)
    if abs(np.dot(up, z)) > 0.98:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R_w2c = np.stack([x, y, z], axis=1).T
    t = -R_w2c @ cam_pos
    return pose_mod.make_pose(_f64(t), pose_mod.matrix_to_quat(_f64(R_w2c))).numpy()


def cube_points(n_per_face: int = 4, half: float = 0.5, seed: int = 0) -> np.ndarray:
    """Points jittered on the faces of a cube centered at origin."""
    rng = np.random.default_rng(seed)
    pts = []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            uv = rng.uniform(-half, half, size=(n_per_face * n_per_face, 2))
            face = np.zeros((len(uv), 3))
            other = [a for a in range(3) if a != axis]
            face[:, other[0]] = uv[:, 0]
            face[:, other[1]] = uv[:, 1]
            face[:, axis] = sign * half
            pts.append(face)
    return np.concatenate(pts)


def ring_poses(n: int, radius: float = 3.0, height: float = 1.0,
               target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """n world->cam poses on a ring looking at the target."""
    poses = []
    for i in range(n):
        a = 2 * np.pi * i / n
        pos = np.array([radius * np.cos(a), radius * np.sin(a), height])
        poses.append(look_at_pose(pos, np.asarray(target)))
    return np.stack(poses)


@dataclasses.dataclass
class CubeScene:
    """A single-sensor no-rig BA scene."""

    true_state: prob.RigState
    observations: prob.Observations
    models: Tuple[str, ...]
    image_size: Tuple[int, int]
    n_images: int
    n_points: int


def make_cube_scene(n_images: int = 10, n_per_face: int = 4,
                    image_size: Tuple[int, int] = (1280, 960), focal: float = 600.0,
                    dist_coeffs: Sequence[float] = (), pix_noise: float = 0.0,
                    seed: int = 0, dtype=torch.float64, device=None) -> CubeScene:
    """A cube scene with every visible point observed in every image."""
    rng = np.random.default_rng(seed)
    pts = cube_points(n_per_face, seed=seed)
    P = len(pts)
    w2c = ring_poses(n_images)
    model = model_from_num_coeffs(len(dist_coeffs))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    state = prob.RigState(
        world_to_ref=t(w2c), ref_to_cam=t(np.tile([0, 0, 0, 0, 0, 0, 1.0], (1, 1))),
        timestamp_offsets=t(np.zeros(1)), focal=t([focal]),
        optical_center=t([[image_size[0] / 2.0, image_size[1] / 2.0]]),
        dist=(t(np.asarray(dist_coeffs, float)),),
        depth_to_image=t(np.tile([0, 0, 0, 0, 0, 0, 1.0], (1, 1))),
        depth_scale=t(np.ones(1)), points=t(pts))

    half = np.asarray(image_size, float) / 2.0
    opts = prob.BAOptions()
    beg_idx, point_idx, pix_list = [], [], []
    ar = torch.arange(P, device=device)
    for cid in range(n_images):
        obs_tmp = prob.PixelObs(
            pix=torch.zeros((P, 2), dtype=dtype, device=device),
            beg_idx=torch.full((P,), cid, device=device),
            end_idx=torch.full((P,), cid, device=device), point_idx=ar,
            dt_cam=torch.zeros(P, dtype=dtype, device=device),
            dt_bracket=torch.zeros(P, dtype=dtype, device=device),
            mask=torch.ones(P, dtype=torch.bool, device=device),
            dist_half_size=t(half), sensor=0)
        pred = prob.pixel_residuals(state, obs_tmp, model, opts, robust=False).cpu().numpy()
        Xc = pose_mod.pose_apply(state.world_to_ref[cid], state.points).cpu().numpy()
        vis = (Xc[:, 2] > 0.2) & np.all((pred >= 0) & (pred < image_size), axis=-1)
        ids = np.nonzero(vis)[0]
        beg_idx.append(np.full(len(ids), cid))
        point_idx.append(ids)
        pix_list.append(pred[ids] + pix_noise * rng.normal(size=(len(ids), 2)))

    beg = torch.as_tensor(np.concatenate(beg_idx).astype(np.int64), device=device)
    obs = prob.PixelObs(
        pix=t(np.concatenate(pix_list)), beg_idx=beg, end_idx=beg,
        point_idx=torch.as_tensor(np.concatenate(point_idx).astype(np.int64), device=device),
        dt_cam=torch.zeros(len(beg), dtype=dtype, device=device),
        dt_bracket=torch.zeros(len(beg), dtype=dtype, device=device),
        mask=torch.ones(len(beg), dtype=torch.bool, device=device),
        dist_half_size=t(half), sensor=0)
    return CubeScene(true_state=state, observations=prob.Observations(pixels=(obs,)),
                     models=(model,), image_size=image_size, n_images=n_images, n_points=P)


def perturb_state(state: prob.RigState, pose_rot: float = 0.01, pose_trans: float = 0.02,
                  point_sigma: float = 0.02, seed: int = 1) -> prob.RigState:
    """Random perturbation of poses and points (the optimizer's start)."""
    rng = np.random.default_rng(seed)
    n = state.world_to_ref.shape[0]
    dt_, dev = state.dtype, state.device
    dq = pose_mod.quat_exp(torch.as_tensor(rng.normal(size=(n, 3)) * pose_rot,
                                           dtype=dt_, device=dev))
    dtr = torch.as_tensor(rng.normal(size=(n, 3)) * pose_trans, dtype=dt_, device=dev)
    new_poses = pose_mod.pose_compose(pose_mod.make_pose(dtr, dq), state.world_to_ref)
    new_points = state.points + torch.as_tensor(
        rng.normal(size=tuple(state.points.shape)) * point_sigma, dtype=dt_, device=dev)
    return dataclasses.replace(state, world_to_ref=new_poses, points=new_points)


# ----------------------------------------------------------------------------
# Rendered two-sensor rig workspace
# ----------------------------------------------------------------------------

_TEX = np.random.default_rng(42).uniform(size=(512, 512)).astype(np.float32)


def terrain_height(x, y):
    return 0.25 * np.sin(1.7 * x) * np.cos(1.3 * y)


def _terrain_hit(origins, dirs):
    """March rays against the terrain by bisection; returns t [N]."""
    t_lo = np.full(len(dirs), 0.2)
    t_hi = np.full(len(dirs), 10.0)
    for _ in range(40):
        t_mid = 0.5 * (t_lo + t_hi)
        p = origins + t_mid[:, None] * dirs
        above = p[:, 2] > terrain_height(p[:, 0], p[:, 1])
        t_lo = np.where(above, t_mid, t_lo)
        t_hi = np.where(above, t_hi, t_mid)
    return 0.5 * (t_lo + t_hi)


def _texture_at(pts):
    """Bilinear two-octave texture lookup (view-stable appearance)."""
    def bilerp(u, v):
        i0 = np.floor(u).astype(int)
        j0 = np.floor(v).astype(int)
        fu = u - i0
        fv = v - j0
        i0m, j0m = np.mod(i0, 512), np.mod(j0, 512)
        i1m, j1m = np.mod(i0 + 1, 512), np.mod(j0 + 1, 512)
        return ((1 - fu) * (1 - fv) * _TEX[i0m, j0m] + fu * (1 - fv) * _TEX[i1m, j0m]
                + (1 - fu) * fv * _TEX[i0m, j1m] + fu * fv * _TEX[i1m, j1m])

    base = bilerp(pts[:, 0] * 10, pts[:, 1] * 10)
    detail = bilerp(pts[:, 0] * 33 + 100, pts[:, 1] * 33 + 100)
    return np.clip(0.7 * base + 0.3 * detail, 0, 1).astype(np.float32)


def render_terrain(cam: cam_mod.CameraParams, w2c_pose: np.ndarray) -> np.ndarray:
    """[H,W] float32 render of the textured terrain through ``cam``
    (distortion included: rays come from ``cam.ray_from_dist_pix``)."""
    W, H = cam.distorted_size
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    pix = _f64(np.stack([us, vs], -1).reshape(-1, 2))
    rays = cam.ray_from_dist_pix(pix).numpy()
    Rt = pose_mod.pose_to_matrix(pose_mod.pose_inverse(_f64(w2c_pose))).numpy()
    o = np.broadcast_to(Rt[:3, 3], rays.shape)
    d = rays @ Rt[:3, :3].T
    t = _terrain_hit(o, d)
    return _texture_at(o + t[:, None] * d).reshape(H, W)


def build_rig_workspace(ws, n_ref: int, size: Tuple[int, int], focal: float
                        ) -> Dict[str, np.ndarray]:
    """Two-sensor bracketed-rig workspace under ``ws``: nav_cam (reference,
    pinhole) at integer timestamps and sci_cam (radtan distortion, 0.13 s
    clock offset) between the brackets, on a lawnmower grid 2 m above the
    terrain. Writes rig_config.txt (with an identity rig guess), cameras.txt
    (true poses) and images/<sensor>/<timestamp>.pgm. Returns the true
    ref->sensor poses by sensor name."""
    from multiview_tpu_torch.io import nvm as nvm_io, rig_config as rc
    from multiview_tpu_torch.utils.images import write_pgm

    ws = Path(ws)
    ws.mkdir(parents=True, exist_ok=True)
    W, H = size
    sci_dist = np.array([-0.12, 0.03, 5e-4, -4e-4])
    sci_offset = 0.13
    rig_true = {
        "nav_cam": np.array([0, 0, 0, 0, 0, 0, 1.0]),
        "sci_cam": pose_mod.make_pose(_f64([0.10, -0.03, 0.02]),
                                      pose_mod.quat_exp(_f64([0.02, -0.015, 0.04]))).numpy(),
    }
    half = np.array([W / 2.0, H / 2.0])
    sensors = [rc.SensorConfig(
        name=name, focal_length=float(focal), optical_center=half.copy(),
        distortion=np.asarray(dist, float), image_size=tuple(size),
        distorted_crop_size=tuple(size), undistorted_image_size=tuple(size),
        ref_to_sensor=np.eye(4), depth_to_image=np.eye(4), timestamp_offset=off)
        for name, dist, off in (("nav_cam", [], 0.0), ("sci_cam", sci_dist, sci_offset))]
    rc.write_rig_config(ws / "rig_config.txt", rc.RigConfig(sensors))
    cams = {s.name: cam_mod.CameraParams.create(size, focal, half, dist_coeffs=s.distortion)
            for s in sensors}

    def knot(i):
        row, col = divmod(i, 8)
        pos = np.array([0.45 * col, 0.8 * row, 2.0])
        return look_at_pose(pos, pos + np.array([0.15, 0.02, -1.0]))

    def w2ref_at(t_ref):
        i0 = int(np.clip(np.floor(t_ref - 10000.0), 0, n_ref - 1))
        i1 = min(i0 + 1, n_ref - 1)
        alpha = float(np.clip(t_ref - 10000.0 - i0, 0.0, 1.0))
        return pose_mod.pose_interp(alpha, _f64(knot(i0)), _f64(knot(i1)))

    frames = ([("nav_cam", 10000.0 + i, 0.0) for i in range(n_ref)]
              + [("sci_cam", 10000.0 + i + 0.5 + sci_offset, sci_offset)
                 for i in range(n_ref - 1)])
    names, mats = [], []
    for sname, t, off in frames:
        d = ws / "images" / sname
        d.mkdir(parents=True, exist_ok=True)
        w2ref = w2ref_at(t - off)
        w2c = w2ref if sname == "nav_cam" else pose_mod.pose_compose(
            _f64(rig_true[sname]), w2ref)
        img = render_terrain(cams[sname], w2c.numpy())
        path = d / f"{t:.2f}.pgm"
        write_pgm(path, (img * 255).astype(np.uint8))
        names.append(str(path))
        mats.append(pose_mod.pose_to_matrix(w2c).numpy())
    nvm_io.write_camera_poses(ws / "cameras.txt", names, np.stack(mats))
    return rig_true
