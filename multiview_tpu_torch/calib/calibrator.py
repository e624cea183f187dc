"""Multi-pass rig calibration driver: triangulate -> optimize -> filter
outliers, repeated. Port of ``multiview_tpu/calib/calibrator.py`` (the
reference program's loop, rig_calibrator.cc:1550-1990):

  for pass in range(num_passes):
      points   = multiViewTriangulation(...)         -> batched triangulation
      mesh     = meshTriangulations(...)             -> batched ray cast (optional)
      solve    = ceres ITERATIVE_SCHUR               -> LM (Schur CG or dense)
      refit    = updateRpcUndistortion               -> RPC inverse refit
      outliers = flagOutliersByTriAngleAndReprojErr  -> vectorized gates

Outlier state is a monotone boolean mask on the observation tensors
(inliers never return, rig_calibrator.cc:1528-1532); a depth row dies with
its pixel feature. Each pass can be checkpointed and a run resumed.

Observations sharded over a mesh (``parallel/sharding.py``) stay sharded
through every pass: the host-side bookkeeping below gathers each sharded
pixel family without its padding, and puts mask updates back onto the same
shards (the JAX package's ``_host_mask`` / ``_resharded_like``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multiview_tpu_torch.calib import checkpoint as ckpt_mod
from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import distortion as dist_mod
from multiview_tpu_torch.geometry import triangulation as tri_mod
from multiview_tpu_torch.parallel import sharding as sh
from multiview_tpu_torch.solver import schur as schur_mod
from multiview_tpu_torch.solver.lm import levenberg_marquardt
from multiview_tpu_torch.utils.padding import group_ranks


# ----------------------------------------------------------------------------
# Track table: padded [P, V] view of the flat observation tensors
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrackTable:
    """Maps each track (pid) to its rows in the concatenated global
    observation order (pixel obs of sensor 0, then sensor 1, ...).
    track_obs [P,V] (-1 = pad), track_valid [P,V]; host numpy."""

    track_obs: np.ndarray
    track_valid: np.ndarray

    @property
    def num_points(self) -> int:
        return self.track_obs.shape[0]

    @property
    def max_views(self) -> int:
        return self.track_obs.shape[1]


def build_track_table(observations: prob.Observations, num_points: int) -> TrackTable:
    """Group global observation rows by point id into a padded table (host)."""
    pid = np.concatenate([o.point_idx.cpu().numpy()
                          for o in sh.gathered_pixels(observations)])
    rows, spid, rank = group_ranks(pid)             # global rows, ascending per point
    track_obs = np.full((num_points, max(1, int(rank.max(initial=-1)) + 1)), -1, np.int64)
    track_obs[spid, rank] = rows
    return TrackTable(track_obs, track_obs >= 0)


# ----------------------------------------------------------------------------
# Global (concatenated) per-observation quantities
# ----------------------------------------------------------------------------


def _global_w2c(state: prob.RigState, observations: prob.Observations):
    return torch.cat([prob.world_to_cam_rows(state, obs)
                      for obs in sh.gathered_pixels(observations)])


def _global_undist_pix(state: prob.RigState, observations: prob.Observations,
                       models: Sequence[str]):
    """Measured pixels DISTORTED -> UNDISTORTED_C under the current
    intrinsics (multiViewTriangulation's per-ray prep)."""
    parts = []
    for obs in sh.gathered_pixels(observations):
        s = obs.sensor
        focal2 = torch.stack([state.focal[s], state.focal[s]])
        parts.append(dist_mod.undistort_centered(
            models[s], state.dist[s], obs.pix - obs.dist_half_size,
            focal2, state.optical_center[s], obs.dist_half_size))
    return torch.cat(parts)


def _global_mask(observations: prob.Observations) -> torch.Tensor:
    return torch.cat([obs.mask for obs in sh.gathered_pixels(observations)])


def _global_focal(state: prob.RigState, observations: prob.Observations):
    return torch.cat([state.focal[obs.sensor].expand(len(obs))
                      for obs in sh.gathered_pixels(observations)])


def _scatter_mask_updates(observations: prob.Observations,
                          new_global_mask: np.ndarray) -> prob.Observations:
    """Split a global host mask back into the per-sensor masks (monotone AND)
    and release the depth observations of features that just died.

    The reference re-adds BracketedDepthError blocks each pass only for
    features still flagged inlier (rig_calibrator.cc:1759-1794, gate at
    :1620-1621). Here each DepthObs row's mask is ANDed with the surviving
    pixel mask at its ``pix_row``; rows without that bookkeeping die when
    their whole track has no surviving pixel inlier, and a row whose point
    id is negative or beyond every indexed point reads dead. Sharded pixel
    families keep their shards."""
    new_global_mask = np.asarray(new_global_mask, bool)
    pixels = sh.gathered_pixels(observations)
    out = []
    off = 0
    for obs, whole in zip(observations.pixels, pixels):
        n = len(obs)
        upd = torch.as_tensor(new_global_mask[off:off + n], device=whole.mask.device)
        out.append(sh.with_mask(obs, whole.mask & upd))
        off += n

    new_depths = []
    alive_pid = None
    for dob in observations.depths:
        if dob.pix_row is not None:
            feat_alive = new_global_mask[dob.pix_row.cpu().numpy()]
        else:
            if alive_pid is None:
                # sized over BOTH pixel and depth point ids
                npts = max(1, 1 + max(
                    int(o.point_idx.max()) if len(o) else -1
                    for o in pixels + observations.depths))
                alive_pid = np.zeros(npts, bool)
                o2 = 0
                for o in pixels:
                    pidx = o.point_idx.cpu().numpy()
                    alive_pid[pidx[new_global_mask[o2:o2 + len(o)]]] = True
                    o2 += len(o)
            dpid = dob.point_idx.cpu().numpy()
            feat_alive = (dpid >= 0) & alive_pid[np.clip(dpid, 0, len(alive_pid) - 1)]
        upd = torch.as_tensor(feat_alive, device=dob.mask.device)
        new_depths.append(dataclasses.replace(dob, mask=dob.mask & upd))
    return dataclasses.replace(observations, pixels=tuple(out), depths=tuple(new_depths))


# ----------------------------------------------------------------------------
# Triangulation pass and outlier gates
# ----------------------------------------------------------------------------


def retriangulate(state: prob.RigState, observations: prob.Observations,
                  models: Sequence[str], table: TrackTable, tri_iters: int = 3):
    """Triangulate every track from its inlier observations. Returns
    (points [P,3], track_ok [P]); tracks with <2 inliers or a non-finite
    solve get track_ok=False (multiViewTriangulation semantics,
    interest_point.cc:688-716)."""
    dev = state.device
    idx = torch.as_tensor(np.maximum(table.track_obs, 0), device=dev)
    tvalid = torch.as_tensor(table.track_valid, device=dev)
    w2c = _global_w2c(state, observations)
    und = _global_undist_pix(state, observations, models)
    mask = _global_mask(observations)
    P = tri_mod.projection_matrix(_global_focal(state, observations), w2c)
    valid = tvalid & mask[idx]
    xyz, _, ok = tri_mod.triangulate_track(P[idx], und[idx], valid, tri_iters)
    return xyz, ok


def flag_outliers(state: prob.RigState, observations: prob.Observations,
                  models: Sequence[str], table: TrackTable, opts: prob.BAOptions,
                  min_triangulation_angle: float, max_reprojection_error: float,
                  verbose: bool = True) -> prob.Observations:
    """Triangulation-angle gate (whole track) then reprojection gate (per
    feature), in that order (flagOutliersByTriAngleAndReprojErr,
    rig_calibrator.cc:1045-1154)."""
    dev = state.device
    pixels = sh.gathered_pixels(observations)
    n_obs = sum(len(o) for o in pixels)
    track_of_obs = np.full(n_obs, -1, np.int64)
    flat_idx = table.track_obs.ravel()
    flat_pid = np.repeat(np.arange(table.num_points), table.max_views)
    sel = flat_idx >= 0
    track_of_obs[flat_idx[sel]] = flat_pid[sel]
    track_of_obs = torch.as_tensor(track_of_obs, device=dev)

    idx = torch.as_tensor(np.maximum(table.track_obs, 0), device=dev)
    tvalid = torch.as_tensor(table.track_valid, device=dev)
    w2c = _global_w2c(state, observations)
    mask = _global_mask(observations)
    valid = tvalid & mask[idx]
    angles = tri_mod.convergence_angles(w2c[idx], state.points, valid)
    bad_track = angles < min_triangulation_angle
    angle_kill = bad_track[torch.clamp_min(track_of_obs, 0)] & (track_of_obs >= 0)
    mask_after_angle = mask & ~angle_kill
    errs = torch.cat([torch.linalg.norm(
        prob.pixel_residuals(state, obs, models[obs.sensor], opts, robust=False), dim=-1)
        for obs in pixels])
    new_mask = mask_after_angle & (errs <= max_reprojection_error)
    counts = torch.stack([mask.sum(), mask_after_angle.sum(), new_mask.sum()]).cpu().numpy()
    n_before, n_after_angle, n_after = (int(c) for c in counts)
    n_angle = n_before - n_after_angle
    n_reproj = n_after_angle - n_after
    if verbose and n_before > 0:
        print(f"Removed {n_angle} outlier features with small angle of convergence, "
              f"out of {n_before} ({100.0 * n_angle / max(n_before, 1):.4g} %)")
        print(f"Removed {n_reproj} outlier features using reprojection error, out of "
              f"{n_after_angle} "
              f"({100.0 * n_reproj / max(n_after_angle, 1):.4g} %)")
    return _scatter_mask_updates(observations, new_mask.cpu().numpy())


# ----------------------------------------------------------------------------
# Residual statistics (the reference's printed regression signal)
# ----------------------------------------------------------------------------


def residual_stats(state: prob.RigState, observations: prob.Observations,
                   models: Sequence[str], opts: prob.BAOptions,
                   sensor_names: Optional[Sequence[str]] = None,
                   tag: str = "") -> Dict[str, np.ndarray]:
    """25/50/75/100th percentile |residual| per residual class, inliers only
    (calc_residuals_stats, rig_calibrator.cc:753-789). Depth, mesh and prior
    residuals are reported divided by their weight; the depth groups merge
    across sensors under one name."""
    if sensor_names is None:
        sensor_names = [f"cam{i}" for i in range(state.num_sensors)]
    merged: Dict[str, list] = {}

    def add(name, vals, mask):
        merged.setdefault(name, []).append((torch.abs(vals).reshape(-1), mask.reshape(-1)))

    for obs in sh.gathered_pixels(observations):
        r = prob.pixel_residuals(state, obs, models[obs.sensor], opts, robust=False)
        add(f"{sensor_names[obs.sensor]}_pix_x", r[:, 0], obs.mask)
        add(f"{sensor_names[obs.sensor]}_pix_y", r[:, 1], obs.mask)
    for obs, mesh_variant in prob.depth_families(observations, opts):
        if mesh_variant:
            r = prob.depth_mesh_residuals(state, obs, opts, robust=False) \
                / opts.depth_mesh_weight
            kind, m = "depth_mesh", prob.mesh_target(obs)[0]
        else:
            r = prob.depth_tri_residuals(state, obs, opts, robust=False) \
                / opts.depth_tri_weight
            kind, m = "depth_tri", obs.mask
        for i, ax in enumerate("xyz"):
            add(f"{kind}_{ax}_m", r[:, i], m)
    for prior, weight, th in prob.static_priors(observations, opts):
        kind = "mesh_tri" if prior is observations.mesh_tri else "tri"
        r = prob.xyz_prior_residuals(state, prior, weight, th, robust=False) / weight
        for i, ax in enumerate("xyz"):
            add(f"{kind}_{ax}_m", r[:, i], prior.mask)

    names = sorted(merged)
    qs, ns = [], []
    for name in names:
        vals = torch.cat([v for v, _ in merged[name]])
        mask = torch.cat([m for _, m in merged[name]])
        v = torch.sort(torch.where(mask, vals, torch.full_like(vals, float("inf")))).values
        n = mask.sum()
        idx = torch.stack([(0.25 * n).to(torch.int64), (0.50 * n).to(torch.int64),
                           (0.75 * n).to(torch.int64), torch.clamp_min(n - 1, 0)])
        q = v[torch.clamp(idx, 0, v.shape[0] - 1)]
        qs.append(torch.where(n > 0, q, torch.full_like(q, float("nan"))))
        ns.append(n)
    qs = torch.stack(qs).cpu().numpy()
    ns = torch.stack(ns).cpu().numpy()
    stats = {name: qs[i] for i, name in enumerate(names)}
    if tag:
        print(f"The 25, 50, 75, and 100th percentile residual stats {tag}")
        for i, name in enumerate(names):
            q = qs[i]
            print(f"{name}: {q[0]:.5g} {q[1]:.5g} {q[2]:.5g} {q[3]:.5g} "
                  f"({int(ns[i])} residuals)")
    return stats


# ----------------------------------------------------------------------------
# Solver cache
# ----------------------------------------------------------------------------


class SchurSolverCache:
    """Schur solvers keyed by problem STRUCTURE (shapes, dtypes, devices,
    models, options, iteration budgets, free mask and bounds), so repeated
    ``optimize_rig`` calls on one structure reuse one built solver;
    observations stay runtime arguments, so a cached solver sees every mask
    update; sharded observations pass through as they are."""

    def __init__(self):
        self._solvers: Dict[tuple, object] = {}

    @staticmethod
    def _sig(state: prob.RigState, obs: prob.Observations):
        def t(x):
            return (tuple(x.shape), str(x.dtype), str(x.device))
        return (tuple(t(getattr(state, f.name)) if f.name != "dist"
                      else tuple(t(d) for d in state.dist)
                      for f in dataclasses.fields(state)),
                tuple((o.sensor, len(o)) for o in obs.pixels),
                tuple((o.sensor, len(o), o.mesh_xyz is not None) for o in obs.depths),
                obs.mesh_tri is not None, obs.tri_prior is not None)

    def get(self, template, obs, models, opts, cam_mask_vec, num_iterations,
            cg_iterations, lo_c, up_c):
        key = (tuple(models), opts, num_iterations, cg_iterations,
               None if lo_c is None else (lo_c.cpu().numpy().tobytes(),
                                          up_c.cpu().numpy().tobytes()),
               np.asarray(cam_mask_vec).tobytes(), self._sig(template, obs))
        fn = self._solvers.get(key)
        if fn is None:
            fn = schur_mod.make_schur_solver(
                template, obs, models, opts, cam_mask_vec,
                max_iterations=num_iterations, cg_iterations=cg_iterations,
                lower=lo_c, upper=up_c)
            self._solvers[key] = fn
        return fn


_SOLVERS = SchurSolverCache()


# ----------------------------------------------------------------------------
# The multi-pass driver
# ----------------------------------------------------------------------------


# ----------------------------------------------------------------------------
# RPC inverse refit (updateRpcUndistortion)
# ----------------------------------------------------------------------------


def refit_rpc_undistortion(state: prob.RigState, models: Sequence[str],
                           float_spec: prob.FloatSpec, cam_params: Optional[Sequence],
                           num_samples: int = 100, verbose: bool = False) -> prob.RigState:
    """Refit the inverse (undistort) half of every floated RPC sensor's
    coefficient vector against the optimized forward half
    (``updateRpcUndistortion`` -> ``fitRpcUndist``, camera_params.cc:214-254,
    rpc_distortion.cc:658-721). The forward half is what BA optimizes (it
    alone enters ``distort_centered``); the inverse is a fitted approximation
    that must track it. No-op for non-RPC sensors or when ``cam_params`` is
    not given (there is then no image geometry to sample with)."""
    if cam_params is None:
        return state
    from multiview_tpu_torch.geometry import rpc_fit

    new_dist = list(state.dist)
    changed = False
    for s in getattr(float_spec, "distortion", ()):
        if models[s] != "rpc":
            continue
        cp = cam_params[s]
        coeffs = state.dist[s].detach().to(cp.dtype).to(cp.device)
        n = coeffs.shape[0] // 2
        cam = cp.with_intrinsics(
            focal=torch.stack([state.focal[s], state.focal[s]]).to(cp.dtype).to(cp.device),
            optical_offset=state.optical_center[s].to(cp.dtype).to(cp.device),
            dist_coeffs=coeffs)
        undist = rpc_fit.fit_rpc_undist(coeffs[:n], cam, num_samples=num_samples)
        full = torch.cat([coeffs[:n], undist.to(cp.dtype).to(cp.device)])
        new_dist[s] = full.to(state.dtype).to(state.device)
        changed = True
        if verbose:
            err = rpc_fit.eval_rpc_dist_undist(cam.with_intrinsics(dist_coeffs=full), full,
                                               num_samples=num_samples)
            print(f"Sensor {s}: max distort_undistort error after RPC "
                  f"inverse refit: {err:.6g} pixels")
    if not changed:
        return state
    return dataclasses.replace(state, dist=tuple(new_dist))


@dataclasses.dataclass
class CalibratorResult:
    state: prob.RigState
    observations: prob.Observations
    stats_before: Dict[str, np.ndarray]
    stats_after: Dict[str, np.ndarray]
    lm_results: List


def optimize_rig(
    state: prob.RigState,
    observations: prob.Observations,
    models: Sequence[str],
    float_spec: prob.FloatSpec,
    opts: prob.BAOptions = prob.BAOptions(),
    num_passes: int = 2,
    num_iterations: int = 20,
    min_triangulation_angle: float = 0.5,
    max_reprojection_error: float = 25.0,
    parameter_tolerance: float = 1e-12,
    timestamp_offset_bounds: Optional[np.ndarray] = None,  # [S,2] lo/hi
    sensor_names: Optional[Sequence[str]] = None,
    backend: str = "auto",   # "schur" | "dense" | "auto"
    cg_iterations: int = 60,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    mesh_tri_verts=None,     # [T,3,3] for the mesh constraints
    min_ray_dist: float = 0.0,
    max_ray_dist: float = 100.0,
    cam_params: Optional[Sequence] = None,  # per-sensor CameraParams (RPC refit)
    rpc_refit_samples: int = 100,
    verbose: bool = False,
    profile: bool = False,
) -> CalibratorResult:
    """The reference's per-pass loop (rig_calibrator.cc:1550-1990). Points
    are re-triangulated at the start of each pass; the tri prior
    (tri_weight>0) anchors to the fresh triangulation; with
    ``mesh_tri_verts`` the pixel rays are cast against the mesh each pass
    for the mesh-tri prior and the depth-vs-mesh rows. Backend "schur" (the
    default) is the Schur-complement LM, "dense" the full-Jacobian LM.
    ``checkpoint_dir`` saves state and masks after every pass; ``resume``
    continues after the last finished one."""
    if backend == "auto":
        backend = "schur"
    if backend not in ("schur", "dense"):
        raise ValueError(f"unknown backend {backend!r}")
    dev, dt = state.device, state.dtype

    table = build_track_table(observations, state.points.shape[0])
    entry_sensors = None
    if opts.no_rig and float_spec.cam_pose_sensors is not None:
        entry_sensors = np.zeros(state.world_to_ref.shape[0], np.int64)
        for ob in sh.gathered_pixels(observations):
            entry_sensors[ob.beg_idx.cpu().numpy()] = ob.sensor
    mask_vec = prob.build_mask(state, float_spec, no_rig=opts.no_rig,
                               entry_sensors=entry_sensors, models=models)
    nc = prob.pack_state(state, include_points=False).shape[0]
    cam_mask_vec = mask_vec[:nc]

    lower = upper = lo_c = up_c = None
    if timestamp_offset_bounds is not None and float_spec.timestamp_offsets:
        lo = np.full(len(mask_vec), -np.inf)
        up = np.full(len(mask_vec), np.inf)
        off0 = state.world_to_ref.numel() + state.ref_to_cam.numel()
        S = state.num_sensors
        lo[off0:off0 + S] = timestamp_offset_bounds[:, 0]
        up[off0:off0 + S] = timestamp_offset_bounds[:, 1]
        lower = torch.as_tensor(lo, dtype=dt, device=dev)
        upper = torch.as_tensor(up, dtype=dt, device=dev)
        lo_c, up_c = lower[:nc], upper[:nc]

    stats_before = None
    lm_results = []

    start_pass = 0
    if resume and checkpoint_dir is not None:
        done = ckpt_mod.latest_pass(checkpoint_dir)
        if done is not None:
            state, observations, done = ckpt_mod.load_checkpoint(
                checkpoint_dir, state, observations)
            start_pass = done + 1
            if verbose:
                print(f"Resumed from checkpoint after pass {done + 1}")

    def _tick(phases, name, t0):
        if profile and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        phases[name] = phases.get(name, 0.0) + (t1 - t0)
        return t1

    obs_now = observations
    for pass_i in range(start_pass, num_passes):
        if verbose:
            print(f"\nOptimization pass {pass_i + 1} / {num_passes}")
        _ph: Dict[str, float] = {}
        _t = time.perf_counter()

        # triangulate with current cameras; dead tracks keep their previous
        # (finite) point and lose all their features
        xyz, ok = retriangulate(state, observations, models, table)
        ok = ok & torch.isfinite(xyz).all(dim=-1)
        prev = torch.where(torch.isfinite(state.points), state.points,
                           torch.zeros_like(state.points))
        xyz = torch.where(ok[:, None], xyz, prev).to(dt)
        state = dataclasses.replace(state, points=xyz)
        bad = ~ok.cpu().numpy()
        if bad.any():
            gmask = _global_mask(observations).cpu().numpy().copy()
            track_rows = table.track_obs[bad]
            gmask[track_rows[track_rows >= 0]] = False
            observations = _scatter_mask_updates(observations, gmask)
        _t = _tick(_ph, "triangulate", _t)

        obs_now = observations
        if opts.tri_weight > 0.0:
            obs_now = dataclasses.replace(obs_now, tri_prior=prob.XyzPriorObs(
                ref_xyz=xyz, point_idx=torch.arange(xyz.shape[0], device=dev), mask=ok))
        want_mesh_tri = mesh_tri_verts is not None and opts.mesh_tri_weight > 0.0
        want_depth_mesh = (mesh_tri_verts is not None and opts.depth_mesh_weight > 0.0
                           and len(observations.depths) > 0
                           and all(d.pix_row is not None for d in observations.depths))
        if want_mesh_tri or want_depth_mesh:
            # per-pass ray/mesh intersections (the meshTriangulations role)
            from multiview_tpu_torch.calib import mesh_constraints
            obs_xyz, track_xyz = mesh_constraints.mesh_intersections(
                state, observations, models, mesh_tri_verts,
                min_ray_dist=min_ray_dist, max_ray_dist=max_ray_dist)
            if want_mesh_tri:
                obs_now = dataclasses.replace(
                    obs_now, mesh_tri=mesh_constraints.xyz_prior_from_points(track_xyz))
            if want_depth_mesh:
                # BracketedDepthMeshError: the pixel ray's mesh hit against
                # the depth measurement (rig_calibrator.cc:1797-1843)
                new_depths = []
                for dob in obs_now.depths:
                    hit_xyz = obs_xyz[dob.pix_row]
                    hit = torch.isfinite(hit_xyz).all(dim=-1)
                    new_depths.append(dataclasses.replace(
                        dob, mesh_mask=hit,
                        mesh_xyz=torch.where(hit[:, None], hit_xyz,
                                             torch.zeros_like(hit_xyz))))
                obs_now = dataclasses.replace(obs_now, depths=tuple(new_depths))
            _t = _tick(_ph, "mesh_intersections", _t)

        if pass_i == 0:
            stats_before = residual_stats(state, obs_now, models, opts, sensor_names,
                                          tag="before opt" if verbose else "")
        elif verbose:
            residual_stats(state, obs_now, models, opts, sensor_names,
                           tag=f"before opt (pass {pass_i + 1})")
        _t = _tick(_ph, "residual_stats", _t)

        if backend == "schur":
            solver = _SOLVERS.get(state, obs_now, models, opts, cam_mask_vec,
                                  num_iterations, cg_iterations, lo_c, up_c)
            res = solver(prob.pack_state(state, include_points=False), state.points,
                         obs_now)
            state = dataclasses.replace(
                prob.unpack_state(res.cam, state, include_points=False), points=res.points)
        else:
            template, obs_dense = state, obs_now

            def residual_fn(vec):
                return prob.all_residuals(prob.unpack_state(vec, template), obs_dense,
                                          models, opts)

            res = levenberg_marquardt(
                residual_fn, prob.pack_state(state), max_iterations=num_iterations,
                parameter_tolerance=parameter_tolerance,
                mask=torch.as_tensor(mask_vec, device=dev), lower=lower, upper=upper)
            state = prob.unpack_state(res.x, template)
        lm_results.append(res)
        _t = _tick(_ph, "solve", _t)

        # refit the RPC inverse of sensors whose distortion floated
        # (updateRpcUndistortion, rig_calibrator.cc:1944-1948): the undistort
        # half has zero gradient in BA, so it is re-derived from the optimized
        # forward half before the next triangulation and the written config
        state = refit_rpc_undistortion(state, models, float_spec, cam_params,
                                       num_samples=rpc_refit_samples, verbose=verbose)
        _t = _tick(_ph, "rpc_refit", _t)

        if verbose and pass_i < num_passes - 1:
            residual_stats(state, obs_now, models, opts, sensor_names,
                           tag=f"after opt (pass {pass_i + 1})")
        observations = flag_outliers(state, observations, models, table, opts,
                                     min_triangulation_angle, max_reprojection_error,
                                     verbose=verbose)
        _t = _tick(_ph, "flag_outliers", _t)
        if profile:
            total = sum(_ph.values())
            print(f"[profile] pass {pass_i + 1}: "
                  + " ".join(f"{k}={v:.2f}s" for k, v in _ph.items())
                  + f" total={total:.2f}s")

        if checkpoint_dir is not None:
            ckpt_mod.save_checkpoint(checkpoint_dir, state, observations, pass_i)

    obs_final = observations
    if num_passes > start_pass:
        # the final stats carry the last pass's prior and mesh families
        # (fresh masks from flag_outliers, that pass's mesh intersections)
        depths_final = tuple(
            dataclasses.replace(d, mesh_xyz=dn.mesh_xyz, mesh_mask=dn.mesh_mask)
            for d, dn in zip(observations.depths, obs_now.depths))
        obs_final = dataclasses.replace(observations, depths=depths_final,
                                        mesh_tri=obs_now.mesh_tri,
                                        tri_prior=obs_now.tri_prior)
    stats_after = residual_stats(state, obs_final, models, opts, sensor_names,
                                 tag="after opt" if verbose else "")
    return CalibratorResult(state, observations, stats_before, stats_after, lm_results)
