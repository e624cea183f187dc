"""Inputs of the per-row block Jacobian tests (``solver/row_blocks.py``),
without JAX, so that the card's tests (``tests/test_torch_cuda.py``) and
``chip_smoke.py`` phase 3d build them as the CPU parity tests
(``tests/test_torch_row_blocks.py``) do.

``planted_rows(seed, dtype, device)`` returns one small case per family and
variant (pixel rows with each distortion model: none, fov, tsai with 4 and 5
coefficients, rpc of degrees 2 and 3; depth rows
against the point and against the mesh with a pose or affine
depth_to_image, xyz priors with and without a robust threshold). Each case
plants, on its own rows, the branches and ties of the residual:
``dt_bracket == 0``, ``beg == end``, a stored end quaternion on the other
hemisphere (``dot < 0``), nearly parallel bracket quaternions (slerp's lerp
branch), unnormalised stored quaternions (rig and poses), a point on the
camera plane (``|z| < 1e-8``), points on and 1e-4 off the optical axis (fov
at the principal point, and on each side of its ``ru > 1e-5`` branch),
residuals exactly zero (``s <= 1e-20``), masked rows, residuals deep in the
Cauchy tail, mesh misses (NaN mesh points) and alpha outside [0, 1]. The
family's sensor is sensor 1 of two, so the per-sensor blocks are read at an
offset.

``every_family_scene(dtype, device, rig_rot, rig_trans)``: the rig of
``tests/test_torch_schur_matvec.py`` (three pixel sensors, depth against
the point and against the mesh with misses, an xyz prior), its rig
perturbed by ``rig_rot`` / ``rig_trans`` (the defaults of
``perturb_rig_state``: 0.02 rad / 3 cm)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import distortion as dist_mod, pose as P
from multiview_tpu_torch.utils import synthetic as syn

FOCAL, CTR, HALF = 500.0, (320.5, 240.25), (320.0, 240.0)


def rpc_coeffs(deg: int) -> tuple:
    """Both halves of an rpc of degree ``deg``: the identity moved to the
    optical centre (constant terms CTR - HALF, so the optical axis lands on
    CTR as with the other models), each monomial of degree g >= 1 given about
    1 px at 100 px from the centre in a numerator and about 1e-2 of the value
    in a denominator, with signs that differ between terms and between x and
    y; the undistort half, which the residual never reads, the identity."""
    n = dist_mod.rpc_num_params_from_degree(deg)
    nl = (n + 2) // 4
    exps = [(g - i, i) for g in range(deg + 1) for i in range(g + 1)]
    sign = np.array([(-1.0) ** j for j in range(nl)])
    scale = np.array([0.01 / 100.0 ** (a + b - 1) if a + b else 0.0 for a, b in exps])
    num_x, num_y = sign * scale, -0.7 * sign * scale
    num_x[0], num_y[0] = CTR[0] - HALF[0], CTR[1] - HALF[1]
    num_x[1] += 1.0
    num_y[2] += 1.0
    den_x, den_y = 0.01 * (sign * scale)[1:], -0.013 * (sign * scale)[1:]
    return tuple(np.concatenate([num_x, den_x, num_y, den_y,
                                 dist_mod.rpc_identity_params(deg)]))


MODELS = {"none": (), "fov": (0.9,), "tsai4": (-0.1, 0.02, 1e-4, -1e-4),
          "tsai5": (-0.1, 0.02, 1e-4, -1e-4, 0.003), "rpc2": rpc_coeffs(2),
          "rpc3": rpc_coeffs(3)}
IDENTITY = 8          # the index of the identity pose
RIG_SCALE = 1.3       # the stored rig quaternion's norm


@dataclasses.dataclass
class PlantedCase:
    """One family's planted rows: ``kind`` is "pixel", "depth" or "prior";
    ``model`` the pixel family's distortion model; ``obs`` its PixelObs,
    DepthObs or XyzPriorObs; ``opts`` the BAOptions of pixel and depth rows;
    ``weight`` / ``th`` the prior's."""

    kind: str
    state: prob.RigState
    obs: object
    model: str = "none"
    opts: Optional[prob.BAOptions] = None
    mesh_variant: bool = False
    weight: float = 0.0
    th: float = 0.0


def _poses(rng) -> np.ndarray:
    """Nine world->ref poses: 0-4 random, 5 = 1 on the other hemisphere,
    6 = 1 turned by 1e-9 rad, 7 = 2 with its quaternion scaled by 1.7, and
    the identity; pose 3's quaternion is stored at norm 0.6."""
    out = np.zeros((9, 7))
    for i in range(5):
        q = P.quat_exp(torch.as_tensor(rng.normal(0.0, 0.15, 3))).numpy()
        out[i] = np.concatenate([rng.normal(0.0, 0.2, 3), q])
    out[3, 3:] *= 0.6
    out[5] = out[1]
    out[5, 3:] = -out[1, 3:]
    turn = P.quat_exp(torch.as_tensor([1e-9, 0.0, 0.0], dtype=torch.float64))
    out[6, :3] = out[1, :3] + 1e-3
    out[6, 3:] = P.quat_mul(turn, torch.as_tensor(out[1, 3:])).numpy()
    out[7] = out[2]
    out[7, 3:] *= 1.7
    out[IDENTITY] = [0, 0, 0, 0, 0, 0, 1.0]
    return out


# (beg, end, dt_cam, dt_bracket) of each bracket row; the sensor offset is 0.05
_BRACKETS = [
    (0, 1, 0.45, 1.0),      # generic, alpha 0.4
    (2, 3, 0.3, 0.0),       # dt_bracket == 0: alpha 0, the rig ignored
    (4, 4, 0.6, 1.0),       # beg == end
    (0, 5, 0.5, 1.0),       # dot < 0 (end on the other hemisphere)
    (1, 6, 0.55, 1.0),      # nearly parallel: slerp's lerp branch
    (7, 3, 0.35, 1.0),      # unnormalised stored quaternions (1.7, 0.6)
    (1, 2, 1.45, 1.0),      # alpha 1.4, outside the bracket
    (2, 0, 0.35, 1.0),      # masked
    (0, 1, 0.25, 1.0),      # deep in the Cauchy tail (pixel: +60 px)
]
_MASKED, _TAIL = 7, 8


def _state(rng, dist, dtype, device, affine: bool, points) -> prob.RigState:
    rig = np.stack([[0, 0, 0, 0, 0, 0, 1.0],
                    np.concatenate([[0.05, -0.02, 0.01],
                                    RIG_SCALE * P.quat_exp(torch.as_tensor(
                                        [0.03, -0.02, 0.04], dtype=torch.float64)).numpy()])])
    d2i = P.make_pose(torch.tensor([0.01, -0.02, 0.005], dtype=torch.float64),
                      P.quat_exp(torch.tensor([0.02, 0.01, -0.015], dtype=torch.float64)))
    d2i = (P.pose_to_affine(d2i, 1.0) if affine else d2i).numpy()
    if not affine:
        d2i[3:] *= 1.1          # unnormalised, read through pose_q
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    return prob.RigState(
        world_to_ref=t(_poses(rng)), ref_to_cam=t(rig), timestamp_offsets=t([0.0, 0.05]),
        focal=t([300.0, FOCAL]), optical_center=t([[100.0, 80.0], list(CTR)]),
        dist=(t(np.zeros(0)), t(dist)), depth_to_image=t(np.stack([np.zeros_like(d2i), d2i])),
        depth_scale=t([1.0, 1.03]), points=t(points))


def _pixel_case(model: str, seed: int, dtype, device) -> PlantedCase:
    rng = np.random.default_rng(seed)
    brackets = list(_BRACKETS)
    n_b = len(brackets)
    pts = [rng.normal(0.0, 0.4, 3) + [0.0, 0.0, 4.0] for _ in range(n_b)]
    # on the identity pose (dt_bracket 0): 1e-4 off the axis (fov's ru between
    # its 1e-5 branch and the rows above), the camera plane (z clamped, 150 px
    # off the centre), the optical axis twice
    pts += [[2e-4, 0.0, 2.0], [3e-9, -2e-9, 0.0], [0.0, 0.0, 2.0], [0.0, 0.0, 2.5]]
    brackets += [(IDENTITY, IDENTITY, 0.2, 0.0)] * 4
    n = len(brackets)
    st = _state(rng, MODELS[model], torch.float64, "cpu", False, np.array(pts))
    obs = prob.PixelObs(
        pix=torch.zeros((n, 2), dtype=torch.float64),
        beg_idx=torch.as_tensor([b[0] for b in brackets]),
        end_idx=torch.as_tensor([b[1] for b in brackets]),
        point_idx=torch.arange(n), dt_cam=torch.as_tensor([b[2] for b in brackets]),
        dt_bracket=torch.as_tensor([b[3] for b in brackets]),
        mask=torch.as_tensor([i != _MASKED for i in range(n)]),
        dist_half_size=torch.as_tensor(HALF), sensor=1)
    name = model.rstrip("2345")
    pred = prob.pixel_residuals(st, obs, name, prob.BAOptions(), robust=False)
    pix = pred.numpy() + rng.normal(0.0, 0.7, (n, 2))
    pix[_TAIL] += 60.0
    pix[n - 2] = np.array(CTR) + [3.0, -2.0]           # the axis: 3 px off
    pix[n - 1] = CTR                                    # the axis, exact: residual 0
    obs = dataclasses.replace(obs, pix=torch.as_tensor(pix))
    st, obs = _to(st, dtype, device), _to(obs, dtype, device)
    return PlantedCase("pixel", st, obs, model=name, opts=prob.BAOptions())


def _depth_case(affine: bool, mesh: bool, seed: int, dtype, device) -> PlantedCase:
    rng = np.random.default_rng(seed)
    brackets = list(_BRACKETS) + [(IDENTITY, IDENTITY, 0.2, 0.0)]
    n = len(brackets)
    xyz = rng.normal(0.0, 0.3, (n, 3)) + [0.0, 0.0, 2.0]
    xyz[n - 1] = 0.0          # the depth point at the camera: its world point is t(d2i)
    st = _state(rng, (), torch.float64, "cpu", affine, np.zeros((n, 3)))
    opts = prob.BAOptions(depth_tri_weight=25.0, depth_mesh_weight=7.0,
                          affine_depth_to_image=affine)
    obs = prob.DepthObs(
        depth_xyz=torch.as_tensor(xyz), beg_idx=torch.as_tensor([b[0] for b in brackets]),
        end_idx=torch.as_tensor([b[1] for b in brackets]), point_idx=torch.arange(n),
        dt_cam=torch.as_tensor([b[2] for b in brackets]),
        dt_bracket=torch.as_tensor([b[3] for b in brackets]),
        mask=torch.as_tensor([i != _MASKED for i in range(n)]), sensor=1)
    world = prob.depth_world_points(prob.world_to_cam_rows(st, obs), st.depth_to_image[1],
                                    st.depth_scale[1], obs.depth_xyz, affine).numpy()
    target = world + rng.normal(0.0, 0.01, (n, 3))
    target[_TAIL] += 0.5
    t_idx = slice(9, 12) if affine else slice(0, 3)
    target[n - 1] = st.depth_to_image[1, t_idx].numpy()      # residual exactly 0
    if mesh:
        hit = np.ones(n, bool)
        hit[[2, 5]] = False
        mesh_xyz = target.copy()
        mesh_xyz[~hit] = np.nan
        obs = dataclasses.replace(obs, mesh_xyz=torch.as_tensor(mesh_xyz),
                                  mesh_mask=torch.as_tensor(hit))
    else:
        st = dataclasses.replace(st, points=torch.as_tensor(target))
    st, obs = _to(st, dtype, device), _to(obs, dtype, device)
    return PlantedCase("depth", st, obs, opts=opts, mesh_variant=mesh)


def _prior_case(robust: bool, seed: int, dtype, device) -> PlantedCase:
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 1.0, (6, 3))
    st = _state(rng, (), torch.float64, "cpu", False, pts)
    pidx = np.array([0, 1, 2, 3, 4, 5, 1])
    ref = pts[pidx] + rng.normal(0.0, 0.05, (7, 3))
    ref[2] = pts[2]            # residual exactly 0
    ref[3] += 2.0              # deep in the tail
    prior = prob.XyzPriorObs(ref_xyz=torch.as_tensor(ref), point_idx=torch.as_tensor(pidx),
                             mask=torch.as_tensor([True, True, True, True, False, True, True]))
    st, prior = _to(st, dtype, device), _to(prior, dtype, device)
    return PlantedCase("prior", st, prior, weight=0.5, th=0.1 if robust else 0.0)


def _to(x, dtype, device):
    """A RigState or observation dataclass with its float tensors in
    ``dtype`` and every tensor on ``device``."""
    kw = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, tuple):
            kw[f.name] = tuple(d.to(device=device, dtype=dtype) for d in v)
        elif isinstance(v, torch.Tensor):
            kw[f.name] = v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
    return dataclasses.replace(x, **kw)


def in_float64(args):
    """An entry point's arguments (state, observations, ...) with every
    float tensor in float64: the same values, the plain version's reference
    for the kernel's float32 outputs."""
    state, obs = args[0], args[1]
    return (_to(state, torch.float64, state.device), _to(obs, torch.float64, state.device)) + \
        tuple(args[2:])


def args_of(case: PlantedCase):
    """The arguments of the case's entry point."""
    if case.kind == "pixel":
        return case.state, case.obs, case.model, case.opts
    if case.kind == "depth":
        return case.state, case.obs, case.opts, case.mesh_variant
    return case.state, case.obs, case.weight, case.th


CASES = (["pixel-" + m for m in MODELS]
         + [f"depth-{t}-{d}" for t in ("tri", "mesh") for d in ("pose", "affine")]
         + ["prior-l2", "prior-cauchy"])


def planted_rows(seed: int = 0, dtype=torch.float64, device="cpu") -> Dict[str, PlantedCase]:
    """Every case of ``CASES`` by name (see the module's docstring)."""
    out = {}
    for i, name in enumerate(CASES):
        parts = name.split("-")
        if parts[0] == "pixel":
            out[name] = _pixel_case(parts[1], seed + i, dtype, device)
        elif parts[0] == "depth":
            out[name] = _depth_case(parts[2] == "affine", parts[1] == "mesh", seed + i, dtype,
                                    device)
        else:
            out[name] = _prior_case(parts[1] == "cauchy", seed + i, dtype, device)
    return out


def row_blocks_of(case: PlantedCase, fn, float64: bool = False):
    """(J_cam or None, J_pt or None, res) of a case through ``fn`` (the
    entry points as a dict by kind: "pixel", "depth", "prior"); with
    ``float64`` on the case's inputs in float64."""
    args = args_of(case)
    out = fn[case.kind](*(in_float64(args) if float64 else args))
    return (None,) + tuple(out) if case.kind == "prior" else tuple(out)


def every_family_scene(dtype=torch.float64, device="cpu", rig_rot: float = 0.02,
                       rig_trans: float = 0.03):
    """(state0, observations, models, opts, cam_mask) of the rig of
    tests/test_torch_schur_matvec.py with its rig perturbed by ``rig_rot`` /
    ``rig_trans``."""
    scene = syn.make_rig_scene(n_ref=6, n_per_face=3, device="cpu")
    d2i = np.tile([0, 0, 0, 0, 0, 0, 1.0], (3, 1))
    d2i[1] = P.make_pose(torch.tensor([0.01, -0.02, 0.005], dtype=torch.float64),
                         P.quat_exp(torch.tensor([0.02, 0.01, -0.015], dtype=torch.float64))
                         ).numpy()
    scene = syn.add_depth_observations(scene, sensors=(1,), subsample=2, depth_to_image=d2i,
                                       depth_scale=np.array([1.0, 1.02, 1.0]))
    rng = np.random.default_rng(3)
    st = scene.true_state
    depths = []
    for o in scene.observations.depths:
        n = len(o)
        mesh_xyz = st.points[o.point_idx].numpy() + 0.01 * rng.normal(size=(n, 3))
        hit = rng.uniform(size=n) > 0.3
        mesh_xyz[~hit] = np.nan
        depths.append(dataclasses.replace(o, mesh_xyz=torch.as_tensor(mesh_xyz),
                                          mesh_mask=torch.as_tensor(hit)))
    n_pts = st.points.shape[0]
    pidx = np.sort(rng.choice(n_pts, size=n_pts // 3, replace=False))
    prior = prob.XyzPriorObs(
        ref_xyz=st.points[pidx] + torch.as_tensor(0.02 * rng.normal(size=(len(pidx), 3))),
        point_idx=torch.as_tensor(pidx), mask=torch.ones(len(pidx), dtype=torch.bool))
    obs = dataclasses.replace(scene.observations, depths=tuple(depths), tri_prior=prior)
    state0 = syn.perturb_rig_state(st, rig_rot=rig_rot, rig_trans=rig_trans, pose_rot=0.003,
                                    pose_trans=0.005, point_sigma=0.01)
    opts = prob.BAOptions(depth_tri_weight=25.0, depth_mesh_weight=7.0, tri_weight=0.5)
    spec = prob.FloatSpec(cam_poses=True, rig_transforms=True, focal=(1,),
                          depth_to_image=(1,), depth_scale=True)
    mask = prob.build_mask(state0, spec, include_points=False)
    obs = dataclasses.replace(
        obs, pixels=tuple(_to(o, dtype, device) for o in obs.pixels),
        depths=tuple(_to(o, dtype, device) for o in obs.depths),
        tri_prior=_to(obs.tri_prior, dtype, device))
    return _to(state0, dtype, device), obs, scene.models, opts, mask
