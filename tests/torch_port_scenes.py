"""Shared inputs of the port parity tests (tests/test_torch_*.py): the
rendered textured-terrain frames and two-sensor rig workspace of
tests/test_cli_tools.py (written as binary PGM, which both packages read),
a RANSAC hypothesis sampler that returns the JAX package's own draws, the
carrier of a JAX problem into the port and the shared rig+depth scene."""

import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
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


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tests with one intra-op thread in PyTorch. The port's
    CPU tests are thousands of tiny tensor operations; several test
    processes with a thread pool each, on one machine, spend their time
    waiting at the pools' barriers (a file of these tests took six times its
    single-core time that way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def jax_sampler(valid, num_hypotheses, seed, size=3):
    """Drop-in for multiview_tpu_torch.sfm.ransac.sample_hypotheses that
    returns exactly the draws of the JAX package's RANSACs for
    PRNGKey(seed), for each point set of ``valid`` [...,N]. The JAX functions
    form the probabilities in the dtype of their points: float32 in the front
    end's affine RANSAC (size 3), float64 in the two-view and PnP RANSACs."""
    dt = jnp.float32 if size == 3 else jnp.float64
    v = valid.cpu().numpy()
    flat = v.reshape(-1, v.shape[-1])
    out = []
    for row in flat:
        vf = jnp.asarray(row).astype(dt)
        probs = vf / jnp.maximum(jnp.sum(vf), 1.0)
        out.append(np.array(jax.random.choice(
            jax.random.PRNGKey(seed), row.shape[0], shape=(num_hypotheses, size),
            replace=True, p=probs)))
    s = np.stack(out).reshape(v.shape[:-1] + (num_hypotheses, size))
    return torch.as_tensor(s, dtype=torch.int64, device=valid.device)


def _np_leaf(x):
    return tuple(np.asarray(v) for v in x) if isinstance(x, tuple) else np.asarray(x)


def _obs_fields(o):
    return {f.name: (o.sensor if f.name == "sensor" else
                     None if getattr(o, f.name) is None else np.asarray(getattr(o, f.name)))
            for f in dataclasses.fields(o)}


def port_problem(state, observations):
    """JAX RigState/Observations (every family, depths included) -> the
    port's on the CPU in float64, by field name through ``from_numpy``."""
    from multiview_tpu_torch.calib import problem as TPr
    sa = {k: _np_leaf(v) for k, v in dataclasses.asdict(state).items()}
    oa = {"pixels": [_obs_fields(o) for o in observations.pixels],
          "depths": [_obs_fields(o) for o in observations.depths]}
    for name in ("tri_prior", "mesh_tri"):
        pr = getattr(observations, name)
        if pr is not None:
            oa[name] = _obs_fields(pr)
    return TPr.from_numpy(sa, oa, device="cpu", dtype=torch.float64)


# depth_to_image and scale of sensor 1 in the rig+depth scene
DEPTH_D2I = np.tile([0, 0, 0, 0, 0, 0, 1.0], (3, 1))
DEPTH_D2I[1] = P.make_pose(torch.tensor([0.01, -0.02, 0.005], dtype=torch.float64),
                           P.quat_exp(torch.tensor([0.02, 0.01, -0.015], dtype=torch.float64))
                           ).numpy()
DEPTH_SCALE = np.array([1.0, 1.02, 1.0])


def make_depth_scene(syn_mod, n_ref=6, n_per_face=3, pix_noise=0.0, depth_noise=0.0, **kw):
    """The rig+depth scene of tests/test_depth_ba.py at a small size, from
    either package's synthetic module (``kw``: the port's ``device``)."""
    scene = syn_mod.make_rig_scene(n_ref=n_ref, n_per_face=n_per_face, pix_noise=pix_noise,
                                   **kw)
    return syn_mod.add_depth_observations(scene, sensors=(1,), subsample=2,
                                          depth_noise=depth_noise, depth_to_image=DEPTH_D2I,
                                          depth_scale=DEPTH_SCALE)


def two_view_scene(seed, n=160, noise=3e-4, outlier_frac=0.2, planar=False, n_invalid=12):
    """Unit-plane correspondences of two views with gross outliers in the
    second image and ``n_invalid`` trailing rows marked invalid: (x1 [n,2],
    x2 [n,2], valid [n]). ``planar`` puts the points on the plane z = 2 in
    the first camera's frame (the scene of tests/test_pipeline_ate.py)."""
    rng = np.random.default_rng(seed)
    if planar:
        pts = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.full((n, 1), 2.0)], 1)
    else:
        pts = rng.uniform(-1, 1, (n, 3)) + np.array([0.0, 0.0, 4.0])
    R = P.quat_to_matrix(P.quat_exp(torch.as_tensor(rng.normal(0, 0.1, 3)))).numpy()
    t = rng.normal(0, 0.3, 3)
    p2 = pts @ R.T + t
    x1 = pts[:, :2] / pts[:, 2:] + rng.normal(0, noise, (n, 2))
    x2 = p2[:, :2] / p2[:, 2:] + rng.normal(0, noise, (n, 2))
    out = rng.random(n) < outlier_frac
    x2[out] += rng.uniform(0.05, 0.3, (int(out.sum()), 2)) * rng.choice([-1, 1], (int(out.sum()), 2))
    valid = np.ones(n, bool)
    valid[n - n_invalid:] = False
    return x1, x2, valid


def torch_view_graph(graph):
    """A JAX ViewGraph as the port's, on the CPU in float64."""
    from multiview_tpu_torch.sfm import global_sfm as TG
    return TG.make_view_graph(np.array(graph.edges), np.array(graph.rel_rot),
                              np.array(graph.rel_dir), np.array(graph.weight), device="cpu")
