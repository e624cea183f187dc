"""``sfm-init`` tool — the theia_sfm wrapper equivalent. Port of
``multiview_tpu/tools/sfm_init.py``: images -> features -> matches -> tracks
-> two-view geometry -> global (or incremental) pose initialization ->
robust BA refinement -> triangulation -> ``cameras.nvm``, the initial poses
``calibrate --nvm`` starts from.

Runs on the first CUDA card and raises when there is none; ``--device cpu``
asks for the CPU. The front end and the refinement BA compute in the
device's working type (float32 on the card, float64 on the CPU); the
two-view geometry, the averaging and the triangulation in float64 on either.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--rig_config", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute: the first CUDA card (an error when there "
                        "is none) or the CPU")
    p.add_argument("--num_overlaps", type=int, default=3)
    p.add_argument("--max_features", type=int, default=1000)
    from multiview_tpu_torch.tools.common import add_sift_args
    add_sift_args(p)
    p.add_argument("--num_ba_iterations", type=int, default=30,
                   help="robust BA refinement after the pose initialization "
                        "(Theia's build_reconstruction BA stage); 0 disables")
    p.add_argument("--reconstruction_estimator", default="GLOBAL",
                   choices=["GLOBAL", "INCREMENTAL"],
                   help="pose-initialization strategy (the engine option behind "
                        "theia_flags.txt:64; the reference recipe pins GLOBAL)")
    p.add_argument("--absolute_pose_reprojection_error_threshold",
                   type=float, default=4.0,
                   help="INCREMENTAL: PnP inlier threshold in pixels, "
                        "relative to a 1024-wide image (theia_flags.txt:112)")
    p.add_argument("--min_num_absolute_pose_inliers", type=int, default=30,
                   help="INCREMENTAL: theia_flags.txt:114")
    p.add_argument("--partial_bundle_adjustment_num_views", type=int,
                   default=20, help="INCREMENTAL: theia_flags.txt:113")
    p.add_argument("--full_bundle_adjustment_growth_percent", type=float,
                   default=5.0, help="INCREMENTAL: theia_flags.txt:114")


def _undistort_obs_batched(pix, cam_idx, sensors_of, cam_params):
    """DISTORTED -> UNDISTORTED_C for all observations, one batched convert
    per sensor. Returns (und [M,2] np, focal [M] np)."""
    from multiview_tpu_torch.geometry.camera import DISTORTED, UNDISTORTED_C

    pix = np.asarray(pix, float)
    obs_sensor = np.asarray([sensors_of[c] for c in np.asarray(cam_idx)])
    und = np.zeros_like(pix)
    focal = np.zeros(len(pix))
    for s in np.unique(obs_sensor):
        rows = np.where(obs_sensor == s)[0]
        cp = cam_params[int(s)]
        und[rows] = cp.convert(torch.as_tensor(pix[rows], dtype=cp.dtype, device=cp.device),
                               DISTORTED, UNDISTORTED_C).cpu().numpy()
        focal[rows] = float(cp.mean_focal)
    return und, focal


def _triangulate_tracks(poses, trackset, sensors_of, cam_params):
    """Triangulate every track of ``trackset`` from world->cam ``poses``
    [V,7] (a tensor; its device is where the work runs). Returns (xyz [P,3]
    np, ok [P] np, flat track arrays (cam_idx, pix, pid), und [M,2], focal
    [M])."""
    from multiview_tpu_torch.geometry import triangulation as tri_mod
    from multiview_tpu_torch.sfm.tracks import tracks_to_arrays
    from multiview_tpu_torch.utils.padding import group_ranks

    cam_idx, _, pix, pid = tracks_to_arrays(trackset)
    und, focal_rows = _undistort_obs_batched(pix, cam_idx, sensors_of, cam_params)
    dev, dt = poses.device, poses.dtype
    P = tri_mod.projection_matrix(torch.as_tensor(focal_rows, dtype=dt, device=dev),
                                  poses[torch.as_tensor(cam_idx, dtype=torch.int64, device=dev)])
    n_pts = len(trackset.tracks)
    max_views = max(np.bincount(pid).max(), 2)
    tb = np.full((n_pts, max_views), -1)
    order, spid, rank = group_ranks(pid)
    tb[spid, rank] = order
    idx = torch.as_tensor(np.maximum(tb, 0), dtype=torch.int64, device=dev)
    xyz, _, ok = tri_mod.triangulate_tracks(
        P[idx], torch.as_tensor(und, dtype=dt, device=dev)[idx],
        torch.as_tensor(tb >= 0, device=dev), 3)
    return xyz.cpu().numpy(), ok.cpu().numpy(), (cam_idx, pix, pid), und, focal_rows


def _reresect_views(poses, trackset, sensors_of, cam_params, thr, min_obs: int = 12):
    """PnP-RANSAC every view against the structure triangulated from the
    current poses; adopt the PnP pose where it explains clearly more
    observations than the current one.

    Repairs init-outlier cameras: on near-planar (nadir-survey) scenes the
    two-view geometry feeding rotation averaging is fragile, and a view
    whose initial rotation is ~10 deg off survives the robust BA as a
    self-consistent outlier (its residuals are simply down-weighted). The
    re-resection role of TheiaSfM's absolute-pose step. Returns
    (poses, n_replaced)."""
    from multiview_tpu_torch.geometry import pose as pose_mod
    from multiview_tpu_torch.sfm import ransac as ransac_mod

    xyz, okm, (cam_idx, _, pid), und, focal_rows = _triangulate_tracks(
        poses, trackset, sensors_of, cam_params)
    uv = und / focal_rows[:, None]
    dev, dt = poses.device, poses.dtype

    def count_inliers(q, X, x):
        Xc = pose_mod.pose_apply(q, X)
        z = Xc[:, 2]
        err = torch.linalg.norm(Xc[:, :2] / torch.clamp_min(z[:, None], 1e-12) - x, dim=-1)
        return int(torch.sum((err <= thr) & (z > 0)))

    poses = poses.clone()
    n_replaced = 0
    for v in range(len(poses)):
        rows = np.where((cam_idx == v) & okm[pid])[0]
        if len(rows) < min_obs:
            continue
        X = torch.as_tensor(xyz[pid[rows]], dtype=dt, device=dev)
        x = torch.as_tensor(uv[rows], dtype=dt, device=dev)
        with torch.no_grad():
            res = ransac_mod.ransac_pnp(X, x, threshold=thr)
        n_cur = count_inliers(poses[v], X, x)
        n_new = int(res.num_inliers)
        if n_new > 1.2 * n_cur + 5:
            print(f"re-resection: view {v} pose replaced "
                  f"({n_cur} -> {n_new} inliers of {len(rows)})")
            poses[v] = res.pose
            n_replaced += 1
    return poses, n_replaced


def _pair_data_from_tracks(trackset, und_per_img):
    """Pairwise unit-plane correspondences of every two views that share
    tracks: ({(i,j): (x1 [K,2], x2 [K,2])}, {(i,j): [K] track ids}) for the
    pairs with at least 16 shared tracks."""
    pair_data = {}
    pair_pids = {}
    for pid, track in enumerate(trackset.tracks):
        cids = sorted(track)
        for a in range(len(cids)):
            for b in range(a + 1, len(cids)):
                i, j = cids[a], cids[b]
                pair_data.setdefault((i, j), ([], []))
                pair_data[(i, j)][0].append(und_per_img[i][track[i]])
                pair_data[(i, j)][1].append(und_per_img[j][track[j]])
                pair_pids.setdefault((i, j), []).append(pid)
    pair_data = {k: (np.stack(v[0]), np.stack(v[1]))
                 for k, v in pair_data.items() if len(v[0]) >= 16}
    pair_pids = {k: np.asarray(v) for k, v in pair_pids.items() if k in pair_data}
    return pair_data, pair_pids


def run(args):
    from multiview_tpu_torch.geometry import pose as pose_mod
    from multiview_tpu_torch.geometry.camera import DISTORTED, UNDISTORTED_C
    from multiview_tpu_torch.io import nvm as nvm_io, rig_config as rc
    from multiview_tpu_torch.sfm import global_sfm, pipeline as fe
    from multiview_tpu_torch.sfm.tracks import subset_views, tracks_to_arrays
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils.device import resolve_device, working_dtype

    device = resolve_device(args.device)
    t_last = [time.perf_counter()]

    def _mark(label):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        print(f"[sfm-init] {label}: {now - t_last[0]:.1f} s", flush=True)
        t_last[0] = now

    rig = rc.read_rig_config(args.rig_config)
    sensor_names = [s.name for s in rig.sensors]
    # the geometry after the front end runs in float64 on either device
    cam_params = [common.cam_params_from_sensor(s, dtype=torch.float64, device=device)
                  for s in rig.sensors]

    image_data = common.scan_image_dir(args.images, sensor_names)
    records = [r for recs in image_data for r in recs]
    records.sort(key=lambda r: r.timestamp)
    sensors_of = [sensor_names.index(Path(r.name).parent.name) for r in records]
    print(f"Found {len(records)} images")

    cfg = common.frontend_config_from_args(args)
    _mark("load images")
    trackset = fe.detect_match_features([r.payload for r in records], cfg, device=device)
    _mark("detect+match+tracks")
    print(f"Built {len(trackset.tracks)} tracks")

    # pairwise unit-plane correspondences from the tracks; undistortion is
    # one batched call per image
    und_per_img = []
    for i in range(len(records)):
        cp = cam_params[sensors_of[i]]
        kps_i = np.asarray(trackset.keypoints[i])
        if len(kps_i) == 0:
            und_per_img.append(np.zeros((0, 2)))
            continue
        u = cp.convert(torch.as_tensor(kps_i, dtype=cp.dtype, device=device),
                       DISTORTED, UNDISTORTED_C).cpu().numpy()
        und_per_img.append(u / float(cp.mean_focal))
    pair_data, pair_pids = _pair_data_from_tracks(trackset, und_per_img)
    print(f"View graph edges: {len(pair_data)}")

    def pnp_threshold(sensors):
        mean_f = float(np.mean([float(cam_params[s].mean_focal) for s in sensors]))
        mean_w = float(np.mean([cam_params[s].distorted_size[0] for s in sensors]))
        return args.absolute_pose_reprojection_error_threshold * (mean_w / 1024.0) / mean_f

    if args.reconstruction_estimator == "INCREMENTAL":
        from multiview_tpu_torch.sfm import incremental as inc
        # flat unit-plane track observations (normalized by each
        # observation's sensor focal, as in the triangulation below)
        cam_idx_i, _, pix_i, pid_i = tracks_to_arrays(trackset)
        und_i, focal_i = _undistort_obs_batched(pix_i, cam_idx_i, sensors_of, cam_params)
        inc_opts = inc.IncrementalOptions(
            reproj_threshold=pnp_threshold(range(len(cam_params))),
            min_pnp_inliers=args.min_num_absolute_pose_inliers,
            partial_ba_views=args.partial_bundle_adjustment_num_views,
            full_ba_growth_percent=args.full_bundle_adjustment_growth_percent,
            verbose=True)
        poses, reg_mask, _, _ = inc.run_incremental_sfm(
            pair_data, len(records), (cam_idx_i, pid_i, und_i / focal_i[:, None]), inc_opts,
            device=device)
        print(f"Incremental SfM registered {int(reg_mask.sum())}/{len(records)} views")
    else:
        _mark("pair data prep")
        poses, reg_mask = global_sfm.run_global_sfm(
            pair_data, len(records), pair_pids=pair_pids, return_mask=True, device=device)

    if int(reg_mask.sum()) < len(records):
        # unregistered views (incremental: PnP failed; global: outside the
        # largest connected component) have no pose: drop them from the
        # output reconstruction (Theia likewise exports only estimated views)
        dropped = [records[i].name for i in range(len(records)) if not reg_mask[i]]
        print(f"Warning: dropping unregistered view(s): {dropped}")
        keep = [i for i in range(len(records)) if reg_mask[i]]
        records = [records[i] for i in keep]
        sensors_of = [sensors_of[i] for i in keep]
        trackset = subset_views(trackset, keep)
        poses = poses[torch.as_tensor(keep, dtype=torch.int64, device=poses.device)]

    _mark("global/incremental sfm")

    # ---- robust BA refinement (TheiaSfM runs a full Huber BA after global
    # init, theia_flags.txt:26-165; essential here: direction-only position
    # averaging cannot recover spacing along collinear trajectories; the
    # reprojection constraints of shared tracks can) ----
    def refine_ba(poses):
        from multiview_tpu_torch.calib import (assemble, bracketing as br,
                                               calibrator as cal, problem as prob)
        dtype = working_dtype(device)
        entries = [br.CameraEntry(
            camera_type=sensors_of[i], timestamp=records[i].timestamp,
            ref_timestamp=records[i].timestamp, beg_ref_index=i,
            end_ref_index=i, image_name=records[i].name)
            for i in range(len(records))]
        observations, num_points = assemble.build_observations(
            rig, entries, None, trackset, no_rig=True, dtype=dtype, device=device)
        poses_np = poses.double().cpu().numpy()
        state = assemble.build_state(
            rig, entries, poses_np, np.asarray([r.timestamp for r in records]), poses_np,
            num_points, no_rig=True, dtype=dtype, device=device)
        result = cal.optimize_rig(
            state, observations, tuple(s.model for s in rig.sensors),
            prob.FloatSpec(cam_poses=True), prob.BAOptions(no_rig=True, robust_threshold=1.0),
            num_passes=1, num_iterations=args.num_ba_iterations,
            sensor_names=sensor_names, verbose=False)
        return result.state.world_to_ref.double()

    if args.num_ba_iterations > 0 and len(trackset.tracks) >= 8:
        poses = refine_ba(poses)
        # re-resection repair: PnP every view against the BA'd structure;
        # a replaced pose means an init outlier survived the robust BA, so
        # refine once more from the repaired configuration
        poses, n_fix = _reresect_views(poses, trackset, sensors_of, cam_params,
                                       pnp_threshold(sorted(set(sensors_of))))
        if n_fix:
            poses = refine_ba(poses)

    _mark("robust BA refinement")
    # triangulate all tracks with the refined poses
    xyz, okm, _, _, _ = _triangulate_tracks(poses.double(), trackset, sensors_of, cam_params)
    n_pts = len(trackset.tracks)
    print(f"Triangulated {int(okm.sum())}/{n_pts} tracks")

    # write NVM (keypoints offset by optical center)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    kp_off = [trackset.keypoints[i] - np.asarray(rig.sensors[sensors_of[i]].optical_center)
              for i in range(len(records))]
    data = nvm_io.NvmData(
        cid_to_filename=[r.name for r in records],
        focal_lengths=np.asarray([float(cam_params[s].mean_focal) for s in sensors_of]),
        cid_to_keypoint=kp_off,
        pid_to_cid_fid=[t for p, t in enumerate(trackset.tracks) if okm[p]],
        pid_to_xyz=xyz[okm],
        world_to_cam=pose_mod.pose_to_matrix(poses.double()).cpu().numpy())
    nvm_io.write_nvm(out / "cameras.nvm", data)
    _mark("triangulate + write")
    print(f"Writing: {out / 'cameras.nvm'}")
    return 0
