"""Incremental SfM pose initialization (Theia's INCREMENTAL estimator role).
Port of ``multiview_tpu/sfm/incremental.py``.

The reference pins ``--reconstruction_estimator=GLOBAL``
(theia_flags.txt:64), but the engine it wraps equally offers INCREMENTAL,
with its knobs pinned in the same flagfile (theia_flags.txt:106-114:
``absolute_pose_reprojection_error_threshold``,
``partial_bundle_adjustment_num_views``,
``full_bundle_adjustment_growth_percent``,
``min_num_absolute_pose_inliers``). It is the alternative when global
averaging is weak (low-overlap chains, rotation-dominant motion):

- the initial pair comes from the batched two-view RANSAC of every pair
  (sfm/global_sfm.py::two_view_results) with a baseline-angle quality gate;
- views register by batched-hypothesis DLT-PnP RANSAC (``ransac_pnp``);
- all tracks re-triangulate each round as one padded batch
  (geometry/triangulation.py);
- partial and full bundle adjustment run on one Schur-LM solver
  (solver/schur.py) whose index arrays, observation masks and camera
  free-mask are values of each call, so the growing active set needs no new
  solver.

Everything operates on unit-plane (undistorted, focal-normalized)
observations with a single synthetic pinhole sensor (focal 1), matching
Theia's ``--intrinsics_to_optimize=NONE`` recipe (theia_flags.txt:127).
The bookkeeping (registered views, outlier flags, poses and points between
the steps) lives on the host as numpy arrays, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.geometry import triangulation as tri_mod
from multiview_tpu_torch.sfm import global_sfm
from multiview_tpu_torch.sfm import ransac as ransac_mod
from multiview_tpu_torch.solver import schur
from multiview_tpu_torch.utils.device import resolve_device
from multiview_tpu_torch.utils.padding import group_ranks


@dataclasses.dataclass(frozen=True)
class IncrementalOptions:
    """Knobs mirroring the Theia flagfile (theia_flags.txt:106-114), with
    the pixel threshold expressed on the unit plane (4 px at a 1024-wide
    image with f~1000 is ~4e-3)."""

    reproj_threshold: float = 4e-3       # absolute_pose_reprojection_error_threshold
    min_pnp_inliers: int = 30            # min_num_absolute_pose_inliers
    partial_ba_views: int = 20           # partial_bundle_adjustment_num_views
    full_ba_growth_percent: float = 5.0  # full_bundle_adjustment_growth_percent
    ba_iterations: int = 10
    min_init_angle_deg: float = 2.0      # initial-pair baseline quality gate
    essential_threshold: float = 1e-3    # Sampson gate for the view graph
    verbose: bool = False


def _triangulate_all(poses, track_cam, track_uv, track_mask):
    """Re-triangulate every track against the current poses in one batch.

    poses [V,7]; track_cam [P,MV] view index per slot; track_uv [P,MV,2]
    unit-plane obs; track_mask [P,MV] slot usable (slot exists AND its view
    is registered AND the observation is not an outlier)."""
    Pm = tri_mod.projection_matrix(torch.ones((), dtype=poses.dtype, device=poses.device),
                                   poses)
    xyz, min_depth, valid = tri_mod.triangulate_tracks(Pm[track_cam], track_uv, track_mask, 3)
    valid = valid & (min_depth > 0)
    # invalid tracks can triangulate to non-finite xyz, which would poison
    # even masked residuals (nan * 0 = nan): pin them to the origin
    ok = valid & torch.all(torch.isfinite(xyz), dim=-1)
    return torch.where(ok[:, None], xyz, torch.zeros_like(xyz)), valid


def _reproj_errors(poses, points, obs_cam, obs_pid, obs_uv):
    """Unit-plane reprojection error + camera-frame depth per observation."""
    Xc = pose_mod.pose_apply(poses[obs_cam], points[obs_pid])
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    err = torch.linalg.norm(Xc[..., :2] / zs[..., None] - obs_uv, dim=-1)
    return err, z


def _median_ray_angle_deg(x1, x2, R, inl) -> float:
    """Median angle between corresponding viewing rays after rotation
    compensation: a proxy for triangulation conditioning of the pair."""
    f1 = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    f2 = np.concatenate([x2, np.ones((len(x2), 1))], axis=1)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    f2 /= np.linalg.norm(f2, axis=1, keepdims=True)
    a2 = f2 @ np.asarray(R)             # R^T f2 per row
    cosang = np.clip(np.sum(f1 * a2, axis=1), -1.0, 1.0)
    ang = np.degrees(np.arccos(cosang))
    sel = np.asarray(inl, bool)
    if not sel.any():
        return 0.0
    return float(np.median(ang[sel]))


def run_incremental_sfm(pair_data, num_views: int, track_obs,
                        opts: IncrementalOptions = IncrementalOptions(),
                        dtype=torch.float64, device=None):
    """Incremental pose initialization on ``device`` (the first CUDA card
    when None; pass ``"cpu"`` for the CPU).

    pair_data: {(i,j): (x1 [K,2], x2 [K,2])} unit-plane correspondences.
    track_obs: (obs_cam [M], obs_pid [M], obs_uv [M,2]) flat track
        observations in unit-plane coordinates; pids in [0, num_tracks).

    Returns (poses [V,7] world->cam, registered [V] bool, points [P,3],
    point_valid [P] bool). Unregistered views keep identity poses."""
    device = resolve_device(device)
    obs_cam, obs_pid, obs_uv = (np.asarray(track_obs[0], np.int64),
                                np.asarray(track_obs[1], np.int64),
                                np.asarray(track_obs[2], float))
    num_tracks = int(obs_pid.max()) + 1 if len(obs_pid) else 0
    M = len(obs_cam)

    def dev(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    # ---- per-track padded view tables (fixed for the run) ----
    counts = np.bincount(obs_pid, minlength=num_tracks)
    MV = max(2, int(counts.max()) if len(counts) else 2)
    track_cam = np.zeros((num_tracks, MV), np.int64)
    track_uv = np.zeros((num_tracks, MV, 2), float)
    track_slot = np.zeros((num_tracks, MV), bool)
    track_obs_row = np.full((num_tracks, MV), -1, np.int64)  # flat obs index
    order, spid, rank = group_ranks(obs_pid)
    track_cam[spid, rank] = obs_cam[order]
    track_uv[spid, rank] = obs_uv[order]
    track_slot[spid, rank] = True
    track_obs_row[spid, rank] = order
    track_cam_d = dev(track_cam, torch.int64)
    track_uv_d = dev(track_uv)
    obs_cam_d, obs_pid_d, obs_uv_d = dev(obs_cam, torch.int64), dev(obs_pid, torch.int64), \
        dev(obs_uv)

    # ---- view graph: two-view RANSAC per pair, the best pair seeds ----
    items = [((i, j), len(x1), np.asarray(x1, float), np.asarray(x2, float))
             for (i, j), (x1, x2) in pair_data.items() if len(x1) >= 8]
    results = global_sfm.two_view_results(items, dtype, device, opts.essential_threshold)
    best = None  # (score, i, j, R, t)
    for (i, j), K, x1, x2 in items:
        # planar-dominated pair: the homography decomposition is the
        # reliable (R, t), with the union inlier set
        R, t, inl, n_inl = global_sfm.select_two_view_model(*results[(i, j)])
        if n_inl < 16:
            continue
        ang = _median_ray_angle_deg(x1, x2, R, inl[:K])
        score = (1 if ang >= opts.min_init_angle_deg else 0, n_inl)
        if best is None or score > best[0]:
            best = (score, i, j, R, t)
    if best is None:
        raise ValueError("incremental SfM: no pair with enough inliers")
    _, vi, vj, R0, t0 = best

    poses = np.tile(np.array([0.0, 0, 0, 0, 0, 0, 1.0]), (num_views, 1))
    poses[vj] = pose_mod.make_pose(
        torch.as_tensor(t0, dtype=torch.float64),
        pose_mod.matrix_to_quat(torch.as_tensor(R0, dtype=torch.float64))).numpy()
    registered = np.zeros(num_views, bool)
    registered[[vi, vj]] = True
    reg_order = [vi, vj]
    obs_outlier = np.zeros(M, bool)

    # ---- the one BA solver of the whole run ----
    template = prob.identity_state(num_views, 1, max(num_tracks, 1), [0], dtype=dtype,
                                   device=device)
    zeros_m = torch.zeros(M, dtype=dtype, device=device)
    pix_obs = prob.PixelObs(
        pix=obs_uv_d, beg_idx=obs_cam_d, end_idx=obs_cam_d, point_idx=obs_pid_d,
        dt_cam=zeros_m, dt_bracket=zeros_m,
        mask=torch.ones(M, dtype=torch.bool, device=device),
        dist_half_size=torch.zeros(2, dtype=dtype, device=device), sensor=0)
    observations = prob.Observations(pixels=(pix_obs,), depths=())
    cam_mask_full = prob.build_mask(template, prob.FloatSpec(cam_poses=True),
                                    no_rig=True, include_points=False)
    ba_opts = prob.BAOptions(no_rig=True, robust_threshold=0.5 * opts.reproj_threshold)
    solver = schur.make_schur_solver(
        template, observations, ("none",), ba_opts, cam_mask_full,
        max_iterations=opts.ba_iterations, cg_iterations=40, cg_tolerance=0.1)
    layout = schur.cam_layout(template)

    points = np.zeros((max(num_tracks, 1), 3))
    point_valid = np.zeros(max(num_tracks, 1), bool)

    def triangulate():
        nonlocal points, point_valid
        usable = (track_slot & registered[track_cam]
                  & ~np.where(track_obs_row >= 0,
                              obs_outlier[np.maximum(track_obs_row, 0)], True))
        xyz, valid = _triangulate_all(dev(poses), track_cam_d, track_uv_d,
                                      dev(usable, torch.bool))
        points = xyz.double().cpu().numpy()
        point_valid = valid.cpu().numpy()

    def run_ba(free_views):
        nonlocal poses, points
        cam_mask_rt = np.zeros(layout.total)
        for v in free_views:
            cam_mask_rt[layout.world_to_ref + 7 * v:layout.world_to_ref + 7 * (v + 1)] = 1.0
        mask = (~obs_outlier & registered[obs_cam] & point_valid[obs_pid])
        obs_rt = dataclasses.replace(
            observations, pixels=(dataclasses.replace(pix_obs, mask=dev(mask, torch.bool)),))
        st = dataclasses.replace(template, world_to_ref=dev(poses), points=dev(points))
        cam0 = prob.pack_state(st, include_points=False)
        res = solver(cam0, st.points, obs_rt, cam_mask_rt)
        out = prob.unpack_state(res.cam, template, include_points=False)
        poses = out.world_to_ref.double().cpu().numpy()
        points = res.points.double().cpu().numpy()
        if opts.verbose:
            print(f"  BA({len(free_views)} views free): "
                  f"{float(res.initial_cost):.3e} -> {float(res.cost):.3e}")

    def filter_outliers(threshold=None):
        nonlocal obs_outlier
        if threshold is None:
            threshold = opts.reproj_threshold
        err, z = _reproj_errors(dev(poses), dev(points), obs_cam_d, obs_pid_d, obs_uv_d)
        err = err.double().cpu().numpy()
        active = registered[obs_cam] & point_valid[obs_pid]
        bad = active & ((err > threshold) | (z.cpu().numpy() <= 0))
        obs_outlier |= bad  # monotone, like the reference's outlier gates
        sel = active & ~obs_outlier
        return float(np.median(err[sel])) if sel.any() else 0.0

    triangulate()
    run_ba(reg_order)
    filter_outliers()
    triangulate()
    last_full = 2

    while True:
        # candidate views: enough usable 2D-3D correspondences
        usable_obs = (~obs_outlier & point_valid[obs_pid] & ~registered[obs_cam])
        cand_counts = np.bincount(obs_cam[usable_obs], minlength=num_views)
        min_needed = max(6, opts.min_pnp_inliers)
        cands = [v for v in np.argsort(-cand_counts)
                 if not registered[v] and cand_counts[v] >= min_needed]
        if not cands:
            break
        newly = []
        for v in cands:
            rows = np.where(usable_obs & (obs_cam == v))[0]
            with torch.no_grad():
                res = ransac_mod.ransac_pnp(dev(points[obs_pid[rows]]), dev(obs_uv[rows]),
                                            threshold=opts.reproj_threshold)
            n_inl = int(res.num_inliers)
            if opts.verbose:
                print(f"  PnP view {v}: {n_inl}/{len(rows)} "
                      f"inliers (need {opts.min_pnp_inliers})")
            if n_inl < opts.min_pnp_inliers:
                continue
            poses[v] = res.pose.double().cpu().numpy()
            registered[v] = True
            reg_order.append(int(v))
            newly.append(int(v))
            # PnP outliers of this view are outliers for good
            obs_outlier[rows[~res.inliers.cpu().numpy()]] = True
        if not newly:
            break
        if opts.verbose:
            print(f"registered {len(newly)} views "
                  f"({int(registered.sum())}/{num_views})")
        triangulate()
        n_reg = int(registered.sum())
        if n_reg >= last_full * (1.0 + opts.full_ba_growth_percent / 100.0):
            run_ba(reg_order)          # full BA
            last_full = n_reg
        else:
            run_ba(reg_order[-opts.partial_ba_views:])  # partial BA
        filter_outliers()
        triangulate()

    # final self-tightening refinement: the registration gate may be loose
    # (it admits observations the user-level threshold allows); once every
    # view is in, progressively tighten the outlier gate toward the data's
    # own noise floor (4x the active median error) and re-optimize: the
    # mismatches that survive a loose gate are what warp near-degenerate
    # geometry (planar scenes, collinear trajectories).
    med = filter_outliers()
    for frac in (1.0, 0.5, 0.25):
        run_ba(reg_order)
        thr = max(opts.reproj_threshold * frac, 4.0 * med)
        med = filter_outliers(thr)
        triangulate()
    run_ba(reg_order)
    filter_outliers()
    triangulate()
    return dev(poses), registered, dev(points), point_valid
