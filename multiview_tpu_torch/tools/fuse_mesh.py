"""``fuse-mesh`` tool: the multi_stereo + voxblox_mesh pipeline. Port of
``multiview_tpu/tools/fuse_mesh.py`` with the same flags and on-disk layout:
per-sensor plane-sweep stereo on consecutive undistorted image pairs, a
per-pair cloud filter (the ASP pc_filter role), TSDF fusion of the filtered
clouds and a marching-tetrahedra mesh, ``fused_mesh.ply``.

Steps ``stereo`` -> ``pc_filter`` -> ``mesh_gen`` are selected with
--first_step / --last_step (multi_stereo:76-85). Per pair:
``<out>/<sensor>/stereo/<left>_<right>/run-PC.pcd`` (raw, left-camera
coordinates), ``run-PC-filter.pcd`` (filtered), ``run-PC-debug.ply`` (every
fourth filtered point) and ``run_cam2world.txt``; per sensor a
``voxblox_index.txt`` of (cam2world, pcd) line pairs (multi_stereo:231-239).

Runs on the first CUDA card (float32) and raises when there is none;
``--device cpu`` asks for the CPU (float64). Prints the seconds spent in
each stage (undistort, stereo, pc_filter, tsdf, marching, io).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

STEP_DICT = {"stereo": 0, "pc_filter": 1, "mesh_gen": 2}


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--rig_config", required=True)
    p.add_argument("--camera_poses", required=True, help="cameras.txt")
    p.add_argument("--images", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute: the first CUDA card (float32; an error "
                        "when there is none) or the CPU (float64)")
    p.add_argument("--sensor", default=None, help="restrict to one sensor")
    p.add_argument("--min_depth", type=float, default=0.5)
    p.add_argument("--max_depth", type=float, default=10.0)
    p.add_argument("--num_planes", type=int, default=64)
    p.add_argument("--stereo_algorithm", default="wta", choices=("wta", "sgm"),
                   help="cost selection: raw winner-take-all or 4-path "
                        "semi-global aggregation (ASP --stereo-algorithm role)")
    p.add_argument("--left_right_check", action="store_true",
                   help="sweep each pair both ways and keep the depths the two agree on "
                        "(ASP stereo's left-right consistency check; the reference "
                        "fuses unchecked depths)")
    p.add_argument("--sgm_p1", type=float, default=0.03)
    p.add_argument("--sgm_p2", type=float, default=0.3)
    p.add_argument("--voxel_size", type=float, default=0.05)
    p.add_argument("--grid_dim", type=int, default=128)
    p.add_argument("--undistorted_crop_win", default="",
                   help="'W H' central undistorted window to keep before "
                        "stereo (multi_stereo --undistorted_crop_win)")
    p.add_argument("--max_distance_from_camera", type=float, default=0.0,
                   help="pc_filter distance gate; <=0 disables "
                        "(ASP --max-distance-from-camera)")
    p.add_argument("--no_outlier_removal", action="store_true",
                   help="disable statistical outlier removal in pc_filter")
    p.add_argument("--std_ratio", type=float, default=2.0,
                   help="outlier-removal k-NN distance std threshold")
    p.add_argument("--first_step", default="stereo", choices=list(STEP_DICT),
                   help="resume support (multi_stereo --first_step role)")
    p.add_argument("--last_step", default="mesh_gen", choices=list(STEP_DICT),
                   help="stop after this step (multi_stereo --last_step)")


def run(args):
    import torch

    from multiview_tpu_torch.dense import pc_filter as pcf, stereo
    from multiview_tpu_torch.geometry import pose as pose_mod
    from multiview_tpu_torch.io import depth_io, nvm as nvm_io, ply, rig_config as rc
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import undistort as und
    from multiview_tpu_torch.utils.device import resolve_device, working_dtype

    first = STEP_DICT[args.first_step]
    last = STEP_DICT[args.last_step]
    if first > last:
        raise SystemExit("--first_step must not come after --last_step")
    device = resolve_device(args.device)
    dtype = working_dtype(device)
    stages = dict.fromkeys(("undistort", "stereo", "pc_filter", "tsdf", "marching", "io"), 0.0)
    clock = [time.perf_counter()]

    def tick(stage):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stages[stage] += now - clock[0]
        clock[0] = now

    def host_pose(m):
        return pose_mod.matrix_to_pose(torch.as_tensor(np.asarray(m, np.float64)))

    rig = rc.read_rig_config(args.rig_config)
    sensor_names = [s.name for s in rig.sensors]
    cam_params = [common.cam_params_from_sensor(s, dtype=dtype, device=device)
                  for s in rig.sensors]
    pose_names, pose_mats = nvm_io.read_camera_poses(args.camera_poses)
    name_to_pose = {Path(n).name: m for n, m in zip(pose_names, pose_mats)}

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    selected = [s for s in range(len(sensor_names))
                if not args.sensor or sensor_names[s] == args.sensor]
    crop_win = None
    if args.undistorted_crop_win:
        vals = args.undistorted_crop_win.split()
        crop_win = (int(vals[0]), int(vals[1]))
    tick("io")

    # ---- step 0: stereo (raw per-pair clouds in left-camera coordinates) ----
    if first <= 0 <= last:
        image_data = common.scan_image_dir(args.images, sensor_names)
        tick("io")
        for s in selected:
            recs = image_data[s]
            cp = cam_params[s]
            undistorted = {}

            def undistort(rec):
                # stereo runs on undistorted images (multi_stereo:164-173)
                if rec.name not in undistorted:
                    undistorted.clear()
                    img = torch.as_tensor(rec.payload, dtype=dtype, device=device)
                    undistorted[rec.name] = und.undistort_image(img, cp, crop_window=crop_win)
                return undistorted[rec.name]

            for a in range(len(recs) - 1):
                ra, rb = recs[a], recs[a + 1]
                na, nb = Path(ra.name).name, Path(rb.name).name
                if na not in name_to_pose or nb not in name_to_pose:
                    continue
                ua, K = undistort(ra)
                ub, _ = undistort(rb)
                tick("undistort")
                w2c_a, w2c_b = host_pose(name_to_pose[na]), host_pose(name_to_pose[nb])
                r2n = pose_mod.pose_compose(w2c_b, pose_mod.pose_inverse(w2c_a))
                focal = np.array([K[0, 0], K[1, 1]])
                center = np.array([K[0, 2], K[1, 2]])
                sweep = dict(min_depth=args.min_depth, max_depth=args.max_depth,
                             num_planes=args.num_planes,
                             aggregate="sgm" if args.stereo_algorithm == "sgm" else "none",
                             sgm_p1=args.sgm_p1, sgm_p2=args.sgm_p2)
                res = stereo.plane_sweep(ua, ub, focal, center, r2n, **sweep)
                if args.left_right_check:
                    back = stereo.plane_sweep(ub, ua, focal, center,
                                              pose_mod.pose_inverse(r2n), **sweep)
                    res = stereo.left_right_check(res, back, focal, center, r2n)
                pts_cam = stereo.stereo_pair_to_cloud(res, focal, center, subsample=2)
                tick("stereo")
                c2w = pose_mod.pose_to_matrix(pose_mod.pose_inverse(w2c_a)).numpy()
                pair_dir = out / sensor_names[s] / "stereo" / f"{Path(na).stem}_{Path(nb).stem}"
                pair_dir.mkdir(parents=True, exist_ok=True)
                depth_io.write_pcd(pair_dir / "run-PC.pcd", pts_cam)
                np.savetxt(pair_dir / "run_cam2world.txt", c2w, fmt="%.17g")
                print(f"pair {na} / {nb}: {len(pts_cam)} points")
                tick("io")

    # ---- step 1: pc_filter (+ per-pair debug cloud, the point2mesh role) ----
    if first <= 1 <= last:
        for s in selected:
            for pair_dir in sorted((out / sensor_names[s] / "stereo").glob("*")):
                raw = pair_dir / "run-PC.pcd"
                if not raw.exists():
                    continue
                xyz, _ = depth_io.read_pcd(raw)
                tick("io")
                filt, keep = pcf.pc_filter(
                    xyz, max_distance_from_camera=args.max_distance_from_camera,
                    outlier_removal=not args.no_outlier_removal, std_ratio=args.std_ratio,
                    device=device)
                tick("pc_filter")
                depth_io.write_pcd(pair_dir / "run-PC-filter.pcd", filt)
                # subsampled viewable cloud per pair (point2mesh -s 4 role,
                # multi_stereo:206-213)
                ply.write_ply(pair_dir / "run-PC-debug.ply", filt[::4])
                print(f"pc_filter {pair_dir.name}: kept {keep.sum()}/{len(keep)}")
                tick("io")

    # ---- step 2: mesh_gen (voxblox index + TSDF fusion) ----
    if last >= 2:
        _mesh_gen(args, out, [sensor_names[s] for s in selected], device, dtype, tick)
    print("[fuse-mesh] stage seconds: "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items()), flush=True)
    return 0


def _mesh_gen(args, out: Path, sensors, device, dtype, tick):
    """Write each sensor's voxblox index, fuse every pair cloud into one TSDF
    grid and extract ``fused_mesh.ply``."""
    import torch

    from multiview_tpu_torch.dense import marching, tsdf
    from multiview_tpu_torch.geometry import pose as pose_mod
    from multiview_tpu_torch.io import depth_io, ply

    cloud_files, c2w_files = [], []
    for name in sensors:
        sdir = out / name
        idx_lines = []
        for pair_dir in sorted((sdir / "stereo").glob("*")):
            pcd = pair_dir / "run-PC-filter.pcd"
            if not pcd.exists():
                pcd = pair_dir / "run-PC.pcd"
            c2w_f = pair_dir / "run_cam2world.txt"
            if not pcd.exists() or not c2w_f.exists():
                continue
            cloud_files.append(pcd)
            c2w_files.append(c2w_f)
            idx_lines += [str(c2w_f), str(pcd)]
        if idx_lines:
            index = sdir / "voxblox_index.txt"
            index.write_text("\n".join(idx_lines) + "\n")
            print(f"Writing: {index}")
    if not cloud_files:
        raise SystemExit("No stereo clouds produced/found")

    clouds = [(depth_io.read_pcd(p)[0], np.loadtxt(f)) for p, f in zip(cloud_files, c2w_files)]
    tick("io")
    allc = np.concatenate([xyz @ c2w[:3, :3].T + c2w[:3, 3] for xyz, c2w in clouds])
    lo = np.percentile(allc, 2, axis=0) - 2 * args.voxel_size
    hi = np.percentile(allc, 98, axis=0) + 2 * args.voxel_size
    dims = np.minimum(np.ceil((hi - lo) / args.voxel_size).astype(int) + 1, args.grid_dim)
    grid = tsdf.make_grid(tuple(int(d) for d in dims), origin=lo, voxel_size=args.voxel_size,
                          dtype=dtype, device=device)
    for pts_cam, c2w in clouds:
        # virtual rasterization camera sized to the cloud density
        vres = max(64, int(np.sqrt(len(pts_cam)) * 2))
        grid = tsdf.integrate_point_cloud(
            grid, torch.as_tensor(pts_cam, dtype=dtype, device=device),
            pose_mod.matrix_to_pose(torch.as_tensor(c2w)),
            focal=(vres * 0.8, vres * 0.8), image_size=(vres, (vres * 3) // 4),
            max_range=args.max_depth)
    tick("tsdf")
    verts, faces, vint = marching.extract_mesh(grid)
    tick("marching")
    ply.write_ply(out / "fused_mesh.ply", verts, faces, intensity=vint)
    print(f"Writing: {out / 'fused_mesh.ply'} ({len(verts)} verts, {len(faces)} faces)")
    tick("io")
