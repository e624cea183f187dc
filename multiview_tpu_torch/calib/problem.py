"""Rig bundle-adjustment problem: state and observation containers,
parameter packing/masking, and batched residuals. Port of
``multiview_tpu/calib/problem.py`` (the Ceres problem of
rig_calibrator.cc:1610-1904 as dense tensors with index arrays).

Robustness is the square-root-of-rho form of the Cauchy loss the reference
attaches to every block. Ported residual families: pixel reprojection
(BracketedCamError, rig_calibrator.cc:419-514) and xyz priors (XYZError,
:709-751). The depth families wait; ``Observations.depths`` stays empty.

``from_numpy``/``to_numpy`` carry a problem across from the JAX package by
its dataclass field names, so both packages can solve the identical one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.geometry import distortion as dist_mod
from multiview_tpu_torch.solver import losses


# ----------------------------------------------------------------------------
# State
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RigState:
    """All optimizable state of a rig BA problem. In rig mode
    ``world_to_ref`` holds one pose per reference-sensor keyframe; in no-rig
    mode one pose per camera image."""

    world_to_ref: torch.Tensor       # [R,7]
    ref_to_cam: torch.Tensor         # [S,7] (identity for the ref sensor)
    timestamp_offsets: torch.Tensor  # [S]
    focal: torch.Tensor              # [S]
    optical_center: torch.Tensor     # [S,2]
    dist: Tuple[torch.Tensor, ...]   # per-sensor coefficient vectors
    depth_to_image: torch.Tensor     # [S,7] rigid or [S,12] affine
    depth_scale: torch.Tensor        # [S]
    points: torch.Tensor             # [P,3]

    @property
    def num_sensors(self) -> int:
        return self.focal.shape[0]

    @property
    def dtype(self):
        return self.world_to_ref.dtype

    @property
    def device(self):
        return self.world_to_ref.device


@dataclasses.dataclass(frozen=True)
class PixelObs:
    """Pixel reprojection observations of ONE sensor. Timestamps are
    pre-differenced on the host: dt_cam = cam_stamp - beg_ref_stamp,
    dt_bracket = end_ref_stamp - beg_ref_stamp (0 => ref/no-rig)."""

    pix: torch.Tensor             # [N,2] measured DISTORTED pixels
    beg_idx: torch.Tensor         # [N] int64 into world_to_ref
    end_idx: torch.Tensor         # [N]
    point_idx: torch.Tensor       # [N] int64 into points
    dt_cam: torch.Tensor          # [N]
    dt_bracket: torch.Tensor      # [N]
    mask: torch.Tensor            # [N] bool inlier mask
    dist_half_size: torch.Tensor  # [2]
    sensor: int = 0

    def __len__(self):
        return self.pix.shape[0]


@dataclasses.dataclass(frozen=True)
class XyzPriorObs:
    """Per-point positional priors (XYZError)."""

    ref_xyz: torch.Tensor     # [M,3]
    point_idx: torch.Tensor   # [M]
    mask: torch.Tensor        # [M]


@dataclasses.dataclass(frozen=True)
class BAOptions:
    robust_threshold: float = 3.0
    depth_tri_weight: float = 0.0
    depth_mesh_weight: float = 0.0
    mesh_tri_weight: float = 0.0
    tri_weight: float = 0.0
    tri_robust_threshold: float = 0.1
    affine_depth_to_image: bool = False
    no_rig: bool = False


@dataclasses.dataclass(frozen=True)
class Observations:
    """All observation tensors of a problem (tuples are per-sensor). The
    depth families are not ported: ``depths`` stays empty."""

    pixels: Tuple[PixelObs, ...]
    depths: Tuple = ()
    mesh_tri: Optional[XyzPriorObs] = None
    tri_prior: Optional[XyzPriorObs] = None


@dataclasses.dataclass(frozen=True)
class FloatSpec:
    """Which parameter groups to optimize (rig_calibrator.cc:150-180,
    1702-1752). Points are always free."""

    cam_poses: bool = False
    rig_transforms: object = False      # bool (all non-ref) or sensor-index list
    focal: Sequence[int] = ()
    optical_center: Sequence[int] = ()
    distortion: Sequence[int] = ()
    timestamp_offsets: bool = False
    depth_to_image: Sequence[int] = ()
    depth_scale: bool = False
    cam_pose_sensors: Optional[Sequence[int]] = None


# ----------------------------------------------------------------------------
# Carrying a problem across from the JAX package
# ----------------------------------------------------------------------------


_OBS_INT = ("beg_idx", "end_idx", "point_idx")


def _t(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def from_numpy(state_arrays: Dict, obs_arrays: Dict, device=None,
               dtype=torch.float64) -> Tuple[RigState, Observations]:
    """RigState + Observations from dicts of numpy arrays keyed by the JAX
    dataclass field names (``RigState``; ``Observations`` with ``pixels`` a
    sequence of ``PixelObs`` field dicts and optional ``tri_prior`` /
    ``mesh_tri`` ``XyzPriorObs`` field dicts)."""
    st = RigState(
        world_to_ref=_t(state_arrays["world_to_ref"], dtype, device),
        ref_to_cam=_t(state_arrays["ref_to_cam"], dtype, device),
        timestamp_offsets=_t(state_arrays["timestamp_offsets"], dtype, device),
        focal=_t(state_arrays["focal"], dtype, device),
        optical_center=_t(state_arrays["optical_center"], dtype, device),
        dist=tuple(_t(d, dtype, device) for d in state_arrays["dist"]),
        depth_to_image=_t(state_arrays["depth_to_image"], dtype, device),
        depth_scale=_t(state_arrays["depth_scale"], dtype, device),
        points=_t(state_arrays["points"], dtype, device))
    pixels = []
    for o in obs_arrays["pixels"]:
        kw = {}
        for f in dataclasses.fields(PixelObs):
            if f.name == "sensor":
                kw[f.name] = int(o.get("sensor", 0))
            elif f.name in _OBS_INT:
                kw[f.name] = _t(o[f.name], torch.int64, device)
            elif f.name == "mask":
                kw[f.name] = _t(o[f.name], torch.bool, device)
            else:
                kw[f.name] = _t(o[f.name], dtype, device)
        pixels.append(PixelObs(**kw))

    def prior(d):
        if d is None:
            return None
        return XyzPriorObs(ref_xyz=_t(d["ref_xyz"], dtype, device),
                           point_idx=_t(d["point_idx"], torch.int64, device),
                           mask=_t(d["mask"], torch.bool, device))
    if obs_arrays.get("depths"):
        raise NotImplementedError("depth observations are not ported yet")
    return st, Observations(pixels=tuple(pixels),
                            mesh_tri=prior(obs_arrays.get("mesh_tri")),
                            tri_prior=prior(obs_arrays.get("tri_prior")))


def to_numpy(state: RigState) -> Dict:
    """RigState -> dict of numpy arrays keyed by field name (``dist`` a tuple)."""
    out = {}
    for f in dataclasses.fields(RigState):
        v = getattr(state, f.name)
        out[f.name] = (tuple(d.detach().cpu().numpy() for d in v) if f.name == "dist"
                       else v.detach().cpu().numpy())
    return out


# ----------------------------------------------------------------------------
# Residuals
# ----------------------------------------------------------------------------


def robust_weight(s, loss_scale):
    """sqrt(rho(s)/s) of the Cauchy loss, 1 at s=0 (both the ratio and the
    sqrt argument guarded so the unselected branch has finite gradients)."""
    tiny = 1e-20
    ratio = losses.rho("cauchy", s, loss_scale) / torch.clamp_min(s, tiny)
    return torch.sqrt(torch.where(s > tiny, ratio, torch.ones_like(ratio)))


def _robustify(res_blocks, mask, loss_scale):
    """Scale each residual block so its squared norm equals rho(|r|^2);
    masked blocks go to zero."""
    s = torch.sum(res_blocks * res_blocks, dim=-1)
    return res_blocks * (robust_weight(s, loss_scale) * mask.to(res_blocks.dtype))[..., None]


def world_to_cam_rows(state: RigState, obs: PixelObs):
    """Bracketed world->cam pose of every observation row [N,7]."""
    s = obs.sensor
    return pose_mod.world_to_cam_from_bracket(
        state.world_to_ref[obs.beg_idx], state.world_to_ref[obs.end_idx],
        state.ref_to_cam[s], obs.dt_cam, obs.dt_bracket, state.timestamp_offsets[s])


def project_rows(w2c, X, focal, ctr, dist, dist_half, model: str):
    """Predicted DISTORTED pixels of camera-frame points (the projection
    chain of BracketedCamError, rig_calibrator.cc:447-480): points at the
    camera plane are clamped to z=1e-8 so residuals stay finite."""
    Xc = pose_mod.pose_apply(w2c, X)
    z = Xc[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    focal2 = torch.stack([focal, focal], dim=-1)
    undist_c = focal2 * (Xc[..., :2] / z)
    return dist_mod.distort_centered(model, dist, undist_c, focal2, ctr, dist_half) + dist_half


def pixel_residuals(state: RigState, obs: PixelObs, model: str,
                    opts: BAOptions, robust: bool = True):
    """BracketedCamError for all observations of one sensor -> [N,2]."""
    s = obs.sensor
    w2c = world_to_cam_rows(state, obs)
    pred = project_rows(w2c, state.points[obs.point_idx], state.focal[s],
                        state.optical_center[s], state.dist[s], obs.dist_half_size, model)
    res = pred - obs.pix
    if not robust:
        return res * obs.mask.to(res.dtype)[..., None]
    return _robustify(res, obs.mask, opts.robust_threshold)


def xyz_prior_residuals(state: RigState, obs: XyzPriorObs, weight: float,
                        robust_threshold: float, robust: bool = True):
    """XYZError -> [M,3]: weight * (point - ref_xyz); Cauchy when
    robust_threshold>0, plain l2 otherwise."""
    res = weight * (state.points[obs.point_idx] - obs.ref_xyz)
    if not robust or robust_threshold <= 0.0:
        return res * obs.mask.to(res.dtype)[..., None]
    return _robustify(res, obs.mask, robust_threshold)


def static_priors(observations: Observations, opts: BAOptions):
    """Prior families present in the problem: (obs, weight, threshold)."""
    out = []
    if observations.mesh_tri is not None and opts.mesh_tri_weight > 0:
        out.append((observations.mesh_tri, opts.mesh_tri_weight, opts.robust_threshold))
    if observations.tri_prior is not None and opts.tri_weight > 0:
        out.append((observations.tri_prior, opts.tri_weight, opts.tri_robust_threshold))
    return out


def all_residuals(state: RigState, observations: Observations, models: Sequence[str],
                  opts: BAOptions, robust: bool = True) -> torch.Tensor:
    """Concatenated flat residual vector over every family and sensor."""
    if observations.depths:
        raise NotImplementedError("depth residual families are not ported yet")
    parts = [pixel_residuals(state, obs, models[obs.sensor], opts, robust).reshape(-1)
             for obs in observations.pixels]
    for prior, weight, th in static_priors(observations, opts):
        parts.append(xyz_prior_residuals(state, prior, weight, th, robust).reshape(-1))
    return torch.cat(parts)


# ----------------------------------------------------------------------------
# Packing + masks (SetParameterBlockConstant -> boolean mask)
# ----------------------------------------------------------------------------


def pack_state(state: RigState, include_points: bool = True) -> torch.Tensor:
    parts = [state.world_to_ref.reshape(-1), state.ref_to_cam.reshape(-1),
             state.timestamp_offsets, state.focal, state.optical_center.reshape(-1)]
    parts += list(state.dist)
    parts += [state.depth_to_image.reshape(-1), state.depth_scale]
    if include_points:
        parts.append(state.points.reshape(-1))
    return torch.cat(parts)


def unpack_state(vec: torch.Tensor, template: RigState,
                 include_points: bool = True) -> RigState:
    idx = 0

    def take(shape):
        nonlocal idx
        n = int(np.prod(shape))
        out = vec[idx:idx + n].reshape(shape)
        idx += n
        return out

    world_to_ref = take(template.world_to_ref.shape)
    ref_to_cam = take(template.ref_to_cam.shape)
    offsets = take(template.timestamp_offsets.shape)
    focal = take(template.focal.shape)
    ctr = take(template.optical_center.shape)
    dist = tuple(take(d.shape) for d in template.dist)
    d2i = take(template.depth_to_image.shape)
    dscale = take(template.depth_scale.shape)
    points = take(template.points.shape) if include_points else template.points
    return RigState(world_to_ref, ref_to_cam, offsets, focal, ctr, dist, d2i,
                    dscale, points)


def build_mask(state: RigState, spec: FloatSpec, ref_sensor: int = 0,
               no_rig: bool = False, include_points: bool = True,
               entry_sensors: Optional[np.ndarray] = None,
               models: Optional[Sequence[str]] = None) -> np.ndarray:
    """Boolean free-parameter mask aligned with pack_state order (host
    numpy). For an ``rpc`` sensor only the forward half of the coefficient
    vector floats."""
    S = state.num_sensors
    if no_rig and spec.cam_pose_sensors is not None and entry_sensors is not None:
        per_entry = np.isin(np.asarray(entry_sensors), list(spec.cam_pose_sensors))
        m_poses = np.repeat(per_entry[:, None], state.world_to_ref.shape[1], axis=1)
    else:
        m_poses = np.full(tuple(state.world_to_ref.shape), spec.cam_poses)
    m_rig = np.zeros(tuple(state.ref_to_cam.shape), bool)
    if not no_rig:
        if spec.rig_transforms is True:
            m_rig[:] = True
        elif spec.rig_transforms:
            m_rig[list(spec.rig_transforms)] = True
        m_rig[ref_sensor] = False
    m_off = np.zeros(S, bool)
    if spec.timestamp_offsets and not no_rig:
        m_off[:] = True
        m_off[ref_sensor] = False
    m_focal = np.zeros(S, bool)
    m_focal[list(spec.focal)] = True
    m_ctr = np.zeros((S, 2), bool)
    m_ctr[list(spec.optical_center)] = True
    m_dist = [np.zeros(tuple(d.shape), bool) for d in state.dist]
    for s in spec.distortion:
        if models is not None and models[s] == "rpc":
            m_dist[s][:len(m_dist[s]) // 2] = True
        else:
            m_dist[s][:] = True
    m_d2i = np.zeros(tuple(state.depth_to_image.shape), bool)
    m_d2i[list(spec.depth_to_image)] = True
    m_dscale = np.full(S, spec.depth_scale)

    parts = [m_poses.ravel(), m_rig.ravel(), m_off, m_focal, m_ctr.ravel()]
    parts += [m.ravel() for m in m_dist]
    parts += [m_d2i.ravel(), m_dscale]
    if include_points:
        parts.append(np.ones(tuple(state.points.shape), bool).ravel())
    return np.concatenate(parts)
