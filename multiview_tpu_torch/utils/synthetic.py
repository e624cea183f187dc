"""Synthetic calibration scenes with known ground truth. Port of
``multiview_tpu/utils/synthetic.py`` (cube and rig scenes, perturbations,
synthetic depth observations; numpy RNG, so scenes are identical to the
reference's from the same seed), plus a numpy renderer of the rig workspace
(textured terrain seen by a pinhole reference camera, a radtan-distorted
camera with a clock offset and, optionally, a depth camera with one ``.pc``
cloud per frame) written as binary PGM images, rig_config.txt and
cameras.txt, and a tessellation of the terrain into a PLY triangle mesh.

Scene constructors take ``device``; ``None`` means the first CUDA card (an
error when there is none). The renderer is host numpy work and names the
CPU itself.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import camera as cam_mod
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.geometry import distortion as dist_mod
from multiview_tpu_torch.geometry.distortion import model_from_num_coeffs
from multiview_tpu_torch.utils.device import resolve_device


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
    device = resolve_device(device)
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


def dist_mod_name(n: int) -> str:
    """The distortion model of ``n`` coefficients (``model_from_num_coeffs``)."""
    return model_from_num_coeffs(n)


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
# Rig scenes: multi-sensor, bracketed timestamps
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class RigScene:
    """A multi-sensor rig BA scene with bracketed timestamps."""

    true_state: prob.RigState
    observations: prob.Observations
    models: Tuple[str, ...]
    image_sizes: Tuple[Tuple[int, int], ...]
    ref_timestamps: np.ndarray
    cams: list                   # List[CameraEntry]
    n_points: int


def smooth_ring_pose(t: float, period: float = 16.0, radius: float = 3.0,
                     height: float = 1.0) -> np.ndarray:
    """world->cam pose moving smoothly on a ring, looking at the origin."""
    a = 2.0 * np.pi * t / period
    pos = np.array([radius * np.cos(a), radius * np.sin(a), height + 0.3 * np.sin(a * 2)])
    return look_at_pose(pos, np.zeros(3))


def default_sensor_specs():
    """nav_cam (reference, pinhole), haz_cam (radtan, +0.3 s) and sci_cam
    (fov, -0.2 s) with their true rig transforms."""
    def rig(t, r):
        return pose_mod.make_pose(_f64(t), pose_mod.quat_exp(_f64(r))).numpy()
    return [
        dict(name="nav_cam", focal=600.0, size=(1280, 960), dist=(), offset=0.0,
             rig=np.array([0, 0, 0, 0, 0, 0, 1.0])),
        dict(name="haz_cam", focal=250.0, size=(640, 480), dist=(-0.15, 0.03, 1e-4, -1e-4),
             offset=0.3, rig=rig([0.1, 0.02, -0.05], [0.05, -0.03, 0.08])),
        dict(name="sci_cam", focal=900.0, size=(960, 720), dist=(0.9,), offset=-0.2,
             rig=rig([-0.08, 0.05, 0.03], [-0.04, 0.06, -0.02])),
    ]


def make_rig_scene(n_ref: int = 10, sensor_specs=None, n_per_face: int = 4,
                   pix_noise: float = 0.0, seed: int = 0, bracket_len: float = 1.5,
                   dtype=torch.float64, device=None) -> RigScene:
    """A rig scene: a reference sensor at integer timestamps plus non-ref
    sensors with true timestamp offsets and rig transforms; non-ref poses
    follow the model exactly (rig * slerp-interp of world_to_ref), so the
    calibrator can recover the rig to machine precision.

    sensor_specs: list of dicts with keys name, focal, size, dist, offset,
    rig (pose 7); index 0 is the reference sensor."""
    from multiview_tpu_torch.calib import bracketing as br

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if sensor_specs is None:
        sensor_specs = default_sensor_specs()
    S = len(sensor_specs)
    ref_ts = np.arange(n_ref, dtype=float)
    world_to_ref = np.stack([smooth_ring_pose(t) for t in ref_ts])

    # image streams: ref at ref_ts; sensor s at mid-bracket + offset
    image_data = [[br.ImageRecord(t, f"{sensor_specs[0]['name']}/{t:.1f}.jpg")
                   for t in ref_ts]]
    for s in range(1, S):
        ts = ref_ts[:-1] + 0.5 + sensor_specs[s]["offset"]
        image_data.append([br.ImageRecord(t, f"{sensor_specs[s]['name']}/{t:.1f}.jpg")
                           for t in ts])
    offsets = np.array([spec["offset"] for spec in sensor_specs])
    cams, _, _ = br.lookup_images(False, ref_ts, image_data, [], offsets,
                                  bracket_len=bracket_len)

    def t_(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    pts = cube_points(n_per_face, seed=seed)
    identity = np.tile([0, 0, 0, 0, 0, 0, 1.0], (S, 1))
    state = prob.RigState(
        world_to_ref=t_(world_to_ref),
        ref_to_cam=t_(np.stack([np.asarray(spec["rig"]) for spec in sensor_specs])),
        timestamp_offsets=t_(offsets),
        focal=t_([spec["focal"] for spec in sensor_specs]),
        optical_center=t_([[spec["size"][0] / 2.0, spec["size"][1] / 2.0]
                           for spec in sensor_specs]),
        dist=tuple(t_(np.asarray(spec["dist"], float)) for spec in sensor_specs),
        depth_to_image=t_(identity), depth_scale=t_(np.ones(S)), points=t_(pts))
    models = tuple(model_from_num_coeffs(len(spec["dist"])) for spec in sensor_specs)

    # per-sensor observation rows from the bracketed camera entries
    rows = {s: dict(pix=[], beg=[], end=[], pid=[], dtc=[], dtb=[]) for s in range(S)}
    for cam in cams:
        s = cam.camera_type
        beg, end = cam.beg_ref_index, cam.end_ref_index
        dt_cam = cam.timestamp - ref_ts[beg]
        dt_bracket = ref_ts[end] - ref_ts[beg]
        w2c = pose_mod.world_to_cam_from_bracket(
            state.world_to_ref[beg], state.world_to_ref[end], state.ref_to_cam[s],
            t_(dt_cam), t_(dt_bracket), state.timestamp_offsets[s])
        Xc = pose_mod.pose_apply(w2c, state.points)
        size = sensor_specs[s]["size"]
        half = np.asarray(size, float) / 2.0
        focal2 = torch.stack([state.focal[s], state.focal[s]])
        und = focal2 * (Xc[:, :2] / Xc[:, 2:3])
        pred_c = dist_mod.distort_centered(models[s], state.dist[s], und, focal2,
                                           state.optical_center[s], t_(half))
        pred = pred_c.cpu().numpy() + half
        vis = (Xc[:, 2].cpu().numpy() > 0.2) & np.all((pred >= 0) & (pred < size), axis=-1)
        ids = np.nonzero(vis)[0]
        rows[s]["pix"].append(pred[ids] + pix_noise * rng.normal(size=(len(ids), 2)))
        rows[s]["beg"].append(np.full(len(ids), beg))
        rows[s]["end"].append(np.full(len(ids), end))
        rows[s]["pid"].append(ids)
        rows[s]["dtc"].append(np.full(len(ids), dt_cam))
        rows[s]["dtb"].append(np.full(len(ids), dt_bracket))

    def i_(x):
        return torch.as_tensor(np.concatenate(x).astype(np.int64), device=device)

    pixel_obs = []
    for s in range(S):
        r = rows[s]
        if not r["pix"]:
            continue
        pix = np.concatenate(r["pix"])
        pixel_obs.append(prob.PixelObs(
            pix=t_(pix), beg_idx=i_(r["beg"]), end_idx=i_(r["end"]), point_idx=i_(r["pid"]),
            dt_cam=t_(np.concatenate(r["dtc"])), dt_bracket=t_(np.concatenate(r["dtb"])),
            mask=torch.ones(len(pix), dtype=torch.bool, device=device),
            dist_half_size=t_(np.asarray(sensor_specs[s]["size"], float) / 2.0), sensor=s))
    return RigScene(
        true_state=state, observations=prob.Observations(pixels=tuple(pixel_obs)),
        models=models, image_sizes=tuple(spec["size"] for spec in sensor_specs),
        ref_timestamps=ref_ts, cams=cams, n_points=len(pts))


def perturb_rig_state(state: prob.RigState, rig_rot: float = 0.02,
                      rig_trans: float = 0.03, seed: int = 1, **kw) -> prob.RigState:
    """Perturb the rig transforms of the non-ref sensors on top of
    ``perturb_state``; sensor 0 stays identity."""
    out = perturb_state(state, seed=seed, **kw)
    rng = np.random.default_rng(seed + 100)
    S = state.ref_to_cam.shape[0]
    dt_, dev = state.dtype, state.device
    dq = pose_mod.quat_exp(torch.as_tensor(rng.normal(size=(S, 3)) * rig_rot,
                                           dtype=dt_, device=dev))
    dtr = torch.as_tensor(rng.normal(size=(S, 3)) * rig_trans, dtype=dt_, device=dev)
    new_rig = pose_mod.pose_compose(pose_mod.make_pose(dtr, dq), state.ref_to_cam).clone()
    new_rig[0] = pose_mod.pose_identity(dt_, dev)
    return dataclasses.replace(out, ref_to_cam=new_rig)


def add_depth_observations(scene: RigScene, sensors=(1,), subsample: int = 2,
                           depth_noise: float = 0.0, depth_to_image=None,
                           depth_scale=None, seed: int = 7) -> RigScene:
    """Attach synthetic depth-cloud observations to a rig scene, on the
    scene's device.

    For each pixel observation of the chosen sensors (subsampled), the depth
    measurement is the true point in depth-cloud coordinates:
    depth_xyz = (scale*R)^-1 (X_cam - t) with the sensor's depth_to_image
    transform, consistent with BracketedDepthError's model
    (rig_calibrator.cc:557-572)."""
    rng = np.random.default_rng(seed)
    st = scene.true_state
    dt_, dev = st.dtype, st.device
    if depth_to_image is not None or depth_scale is not None:
        st = dataclasses.replace(
            st,
            depth_to_image=(st.depth_to_image if depth_to_image is None
                            else torch.as_tensor(np.asarray(depth_to_image, np.float64),
                                                 dtype=dt_, device=dev)),
            depth_scale=(st.depth_scale if depth_scale is None
                         else torch.as_tensor(np.asarray(depth_scale, np.float64),
                                              dtype=dt_, device=dev)))

    depth_obs = []
    pix_offsets = {}
    acc = 0
    for obs in scene.observations.pixels:
        pix_offsets[obs.sensor] = acc
        acc += len(obs)
    for obs in scene.observations.pixels:
        s = obs.sensor
        if s not in sensors:
            continue
        rows = torch.arange(0, len(obs), subsample, device=dev)
        dob = prob.DepthObs(
            depth_xyz=torch.zeros((len(rows), 3), dtype=dt_, device=dev),
            beg_idx=obs.beg_idx[rows], end_idx=obs.end_idx[rows],
            point_idx=obs.point_idx[rows], dt_cam=obs.dt_cam[rows],
            dt_bracket=obs.dt_bracket[rows],
            mask=torch.ones(len(rows), dtype=torch.bool, device=dev),
            pix_row=rows + pix_offsets[s], sensor=s)
        Xc = pose_mod.pose_apply(prob.world_to_cam_rows(st, dob), st.points[dob.point_idx])
        L = pose_mod.quat_to_matrix(pose_mod.pose_q(st.depth_to_image[s])) * st.depth_scale[s]
        t = pose_mod.pose_t(st.depth_to_image[s])
        depth_xyz = torch.einsum("ij,nj->ni", torch.linalg.inv(L), Xc - t)
        depth_xyz = depth_xyz + torch.as_tensor(
            rng.normal(size=tuple(depth_xyz.shape)) * depth_noise, dtype=dt_, device=dev)
        depth_obs.append(dataclasses.replace(dob, depth_xyz=depth_xyz))

    new_obs = dataclasses.replace(scene.observations, depths=tuple(depth_obs))
    return dataclasses.replace(scene, true_state=st, observations=new_obs)


# ----------------------------------------------------------------------------
# Rendered rig workspace
# ----------------------------------------------------------------------------

TEXTURE_SEED = 42          # the seed of the terrain's albedo when none is given


@functools.lru_cache(maxsize=4)
def terrain_texture(seed: int = TEXTURE_SEED) -> np.ndarray:
    """The 512x512 albedo tile of the terrain drawn from ``seed``."""
    return np.random.default_rng(seed).uniform(size=(512, 512)).astype(np.float32)


_TEX = terrain_texture()


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


def _texture_at(pts, tex=_TEX):
    """Bilinear two-octave texture lookup (view-stable appearance) in the
    albedo tile ``tex``."""
    def bilerp(u, v):
        i0 = np.floor(u).astype(int)
        j0 = np.floor(v).astype(int)
        fu = u - i0
        fv = v - j0
        i0m, j0m = np.mod(i0, 512), np.mod(j0, 512)
        i1m, j1m = np.mod(i0 + 1, 512), np.mod(j0 + 1, 512)
        return ((1 - fu) * (1 - fv) * tex[i0m, j0m] + fu * (1 - fv) * tex[i1m, j0m]
                + (1 - fu) * fv * tex[i0m, j1m] + fu * fv * tex[i1m, j1m])

    base = bilerp(pts[:, 0] * 10, pts[:, 1] * 10)
    detail = bilerp(pts[:, 0] * 33 + 100, pts[:, 1] * 33 + 100)
    return np.clip(0.7 * base + 0.3 * detail, 0, 1).astype(np.float32)


def render_terrain(cam: cam_mod.CameraParams, w2c_pose: np.ndarray,
                   want_depth: bool = False, seed: int = TEXTURE_SEED):
    """[H,W] float32 render of the textured terrain through ``cam``, a
    CameraParams on the CPU (distortion included: rays come from
    ``cam.ray_from_dist_pix``), with the albedo drawn from ``seed``. With
    ``want_depth`` also the camera-frame xyz image [H,W,3] float32 (the
    payload of a depth camera's ``.pc`` file): returns (image, xyz)."""
    W, H = cam.distorted_size
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    pix = _f64(np.stack([us, vs], -1).reshape(-1, 2))
    rays = cam.ray_from_dist_pix(pix).numpy()
    Rt = pose_mod.pose_to_matrix(pose_mod.pose_inverse(_f64(w2c_pose))).numpy()
    o = np.broadcast_to(Rt[:3, 3], rays.shape)
    d = rays @ Rt[:3, :3].T
    t = _terrain_hit(o, d)
    img = _texture_at(o + t[:, None] * d, terrain_texture(seed)).reshape(H, W)
    if not want_depth:
        return img
    return img, (rays * t[:, None]).reshape(H, W, 3).astype(np.float32)


def _render_frame(job):
    """Render one frame of the workspace and write it (a pool worker)."""
    from multiview_tpu_torch.io import depth_io
    from multiview_tpu_torch.utils.images import write_pgm

    size, focal, dist, w2c, path, want_depth, seed = job
    torch.set_num_threads(1)
    cam = cam_mod.CameraParams.create(size, focal, np.asarray(size, float) / 2.0,
                                      dist_coeffs=dist, device="cpu")
    out = render_terrain(cam, w2c, want_depth, seed)
    img, xyz = out if want_depth else (out, None)
    write_pgm(path, (img * 255).astype(np.uint8))
    if xyz is not None:
        depth_io.write_xyz_image(Path(path).with_suffix(".pc"), xyz)


def terrain_mesh(lo=(-3.0, -3.0), hi=(7.0, 5.0), step: float = 0.05
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``terrain_height`` tessellated over [lo, hi] on a grid of the given
    step: (vertices [V,3] float64, faces [F,3] int32), two triangles per
    cell."""
    nx = int(round((hi[0] - lo[0]) / step)) + 1
    ny = int(round((hi[1] - lo[1]) / step)) + 1
    xs = np.linspace(lo[0], hi[0], nx)
    ys = np.linspace(lo[1], hi[1], ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X, Y, terrain_height(X, Y)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (i * ny + j).reshape(-1)
    b, c, d = a + ny, a + ny + 1, a + 1
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)])
    return verts, faces.astype(np.int32)


def write_terrain_mesh(path, lo=(-3.0, -3.0), hi=(7.0, 5.0), step: float = 0.05) -> int:
    """Write ``terrain_mesh`` as a binary PLY; returns the triangle count."""
    from multiview_tpu_torch.io import ply as ply_io

    verts, faces = terrain_mesh(lo, hi, step)
    ply_io.write_ply(path, verts, faces)
    return len(faces)


def build_rig_workspace(ws, n_ref: int, size: Tuple[int, int], focal: float,
                        depth: bool = False, depth_to_image_guess=None,
                        frames_from=None, workers: int = 1,
                        seed: int = TEXTURE_SEED,
                        sensor_sizes=None) -> Dict[str, np.ndarray]:
    """Bracketed-rig workspace under ``ws``: nav_cam (reference, pinhole) at
    integer timestamps and sci_cam (radtan distortion, 0.13 s clock offset)
    between the brackets, on a lawnmower grid 2 m above the terrain. Writes
    rig_config.txt (with an identity rig guess), cameras.txt (true poses) and
    images/<sensor>/<timestamp>.pgm. Returns the true ref->sensor poses by
    sensor name.

    ``depth`` adds a third sensor, haz_cam (a pinhole depth camera at
    ``10000 + i + 0.25``): an intensity image and a ``.pc`` camera-frame xyz
    image per frame, so its true depth_to_image is the identity;
    ``depth_to_image_guess`` (4x4) is what rig_config.txt says instead.
    ``frames_from`` names a workspace rendered earlier with the same
    arguments: frames found there are copied, not rendered again.
    ``workers`` > 1 renders the frames in that many processes. ``seed``
    draws the terrain's albedo (``terrain_texture``); the geometry, the poses
    and the rig do not depend on it. ``sensor_sizes`` maps a sensor's name to
    its own ``((width, height), focal)``; the others take ``size`` and
    ``focal``."""
    import shutil

    from multiview_tpu_torch.io import nvm as nvm_io, rig_config as rc

    ws = Path(ws)
    ws.mkdir(parents=True, exist_ok=True)
    sizes = {name: (tuple(size), float(focal)) for name in ("nav_cam", "sci_cam", "haz_cam")}
    sizes.update({name: (tuple(sz), float(f)) for name, (sz, f) in (sensor_sizes or {}).items()})
    sci_dist = np.array([-0.12, 0.03, 5e-4, -4e-4])
    sci_offset = 0.13

    def rig(t, r):
        return pose_mod.make_pose(_f64(t), pose_mod.quat_exp(_f64(r))).numpy()

    rig_true = {"nav_cam": np.array([0, 0, 0, 0, 0, 0, 1.0]),
                "sci_cam": rig([0.10, -0.03, 0.02], [0.02, -0.015, 0.04])}
    specs = [("nav_cam", [], 0.0), ("sci_cam", sci_dist, sci_offset)]
    if depth:
        rig_true["haz_cam"] = rig([-0.05, 0.06, 0.01], [-0.03, 0.01, 0.02])
        specs.append(("haz_cam", [], 0.0))
    sensors = [rc.SensorConfig(
        name=name, focal_length=sizes[name][1],
        optical_center=np.asarray(sizes[name][0], float) / 2.0,
        distortion=np.asarray(dist, float), image_size=sizes[name][0],
        distorted_crop_size=sizes[name][0], undistorted_image_size=sizes[name][0],
        ref_to_sensor=np.eye(4), depth_to_image=np.eye(4), timestamp_offset=off)
        for name, dist, off in specs]
    if depth and depth_to_image_guess is not None:
        sensors[2].depth_to_image = np.asarray(depth_to_image_guess, float)
    rc.write_rig_config(ws / "rig_config.txt", rc.RigConfig(sensors))
    dists = {s.name: s.distortion for s in sensors}

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
    if depth:
        frames += [("haz_cam", 10000.0 + i + 0.25, 0.0) for i in range(n_ref - 1)]
    names, mats, jobs = [], [], []
    for sname, t, off in frames:
        d = ws / "images" / sname
        d.mkdir(parents=True, exist_ok=True)
        w2ref = w2ref_at(t - off)
        w2c = w2ref if sname == "nav_cam" else pose_mod.pose_compose(
            _f64(rig_true[sname]), w2ref)
        path = d / f"{t:.2f}.pgm"
        names.append(str(path))
        mats.append(pose_mod.pose_to_matrix(w2c).numpy())
        want_depth = sname == "haz_cam"
        have = None if frames_from is None else Path(frames_from) / "images" / sname / path.name
        if have is not None and have.is_file() and (
                not want_depth or have.with_suffix(".pc").is_file()):
            shutil.copyfile(have, path)
            if want_depth:
                shutil.copyfile(have.with_suffix(".pc"), path.with_suffix(".pc"))
        else:
            jobs.append((*sizes[sname], dists[sname], w2c.numpy(), str(path), want_depth,
                         seed))
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
            pool.map(_render_frame, jobs, chunksize=1)
    else:
        for job in jobs:
            _render_frame(job)
    nvm_io.write_camera_poses(ws / "cameras.txt", names, np.stack(mats))
    return rig_true


def compute_ate(est_names, est_mats, gt_file) -> Dict[str, float]:
    """Absolute trajectory error of estimated world->cam matrices
    (``est_names`` [N] image names, ``est_mats`` [N,4,4]) against the true
    poses of a workspace's cameras.txt, after a similarity alignment of the
    camera centres (scale from the path lengths, rotation by Kabsch, as
    ``geometry/registration.py``): {n_poses, ate_rmse_m, rot_mean_deg,
    rot_max_deg}. The rotation errors are read after the same world transform
    is applied to the estimated poses. Images are paired by file name."""
    from multiview_tpu_torch.geometry import registration as reg
    from multiview_tpu_torch.io import nvm as nvm_io

    gnames, gmats = nvm_io.read_camera_poses(gt_file)
    gm = {Path(n).name: M for n, M in zip(gnames, gmats)}
    est, gt = [], []
    for n, M in zip(est_names, est_mats):
        if Path(n).name in gm:
            est.append(M)
            gt.append(gm[Path(n).name])
    E, G = _f64(np.stack(est)), _f64(np.stack(gt))

    def centres(M):
        return -torch.einsum("nji,nj->ni", M[:, :3, :3], M[:, :3, 3])

    ce, cg = centres(E), centres(G)
    scale, spose = reg.find_similarity_transform(ce, cg)
    ce_al = reg.apply_similarity(scale, spose, ce)
    ate_rmse = float(torch.sqrt(torch.mean(torch.sum((ce_al - cg) ** 2, dim=-1))))
    est_al = reg.transform_cameras(scale, spose, pose_mod.matrix_to_pose(E))
    Re = pose_mod.quat_to_matrix(pose_mod.pose_q(est_al))
    cosang = (torch.einsum("nij,nij->n", Re, G[:, :3, :3]) - 1.0) / 2.0
    rots = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    return {"n_poses": int(len(E)), "ate_rmse_m": ate_rmse,
            "rot_mean_deg": float(rots.mean()), "rot_max_deg": float(rots.max())}


def write_control_points(pto_path, xyz_path, image_names, w2c_mats, cams, n: int = 8,
                         seed: int = 0) -> np.ndarray:
    """Registration control points from the truth: ``n`` terrain points seen
    by both images of ``image_names`` (two paths, with world->cam matrices
    ``w2c_mats`` [2,4,4] and CameraParams ``cams`` on the CPU), found by
    casting rays through random pixels of the first image's middle half,
    projected into distorted pixels of both. Writes a Hugin ``.pto`` (``i``
    and ``c`` lines) and an ``.xyz`` of the true world coordinates; returns
    them [n,3]."""
    rng = np.random.default_rng(seed)
    pix, world = [], []
    W, H = cams[0].distorted_size
    while len(world) < n:
        p = np.array([rng.uniform(0.25, 0.75) * W, rng.uniform(0.25, 0.75) * H])
        ray = cams[0].ray_from_dist_pix(_f64(p)).numpy()
        M = np.linalg.inv(w2c_mats[0])
        d = M[:3, :3] @ ray
        X = M[:3, 3] + _terrain_hit(M[:3, 3][None], d[None])[0] * d
        Xc = w2c_mats[1][:3, :3] @ X + w2c_mats[1][:3, 3]
        q = cams[1].project_cam_to_dist_pix(_f64(Xc)).numpy()
        W1, H1 = cams[1].distorted_size
        if Xc[2] > 0 and 0 <= q[0] < W1 and 0 <= q[1] < H1:
            pix.append((p, q))
            world.append(X)
    lines = [f'i w{c.distorted_size[0]} h{c.distorted_size[1]} n"{name}"'
             for name, c in zip(image_names, cams)]
    lines += [f"c n0 N1 x{float(p[0])!r} y{float(p[1])!r} X{float(q[0])!r} Y{float(q[1])!r} t0"
              for p, q in pix]
    Path(pto_path).write_text("\n".join(lines) + "\n")
    world = np.stack(world)
    Path(xyz_path).write_text("".join(f"{float(x)!r} {float(y)!r} {float(z)!r}\n"
                                      for x, y, z in world))
    return world
