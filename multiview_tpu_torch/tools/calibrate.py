"""``calibrate`` tool — the rig_calibrator executable equivalent. Port of
``multiview_tpu/tools/calibrate.py`` with the same flags: rig config +
camera poses (+ images for feature matching, + ``.pc`` depth clouds beside
them), multi-pass robust BA with float specs, depth and mesh constraints,
reference-format outputs (rig_config.txt / cameras.txt / cameras.nvm, the
voxblox layout and world-frame depth clouds, and with ``--out_texture_dir``
one textured OBJ per image, the mesh projected into it).

Runs on the first CUDA card (float32) and raises when there is none;
``--device cpu`` asks for the CPU (float64). ``--sharded`` shards the
observations over this host's cards (``parallel/sharding.py``), and under a
``torch.distributed`` launch each process over its own cards.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def add_args(p: argparse.ArgumentParser):
    from multiview_tpu_torch.tools.common import add_sift_args
    p.add_argument("--rig_config", required=True)
    p.add_argument("--camera_poses", help="cameras.txt with initial world_to_cam")
    p.add_argument("--nvm", help="NVM with initial poses+matches (alternative)")
    p.add_argument("--images", help="image dir (<sensor>/<timestamp>.ext) for "
                                    "feature detection+matching")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute: the first CUDA card (float32; an error "
                        "when there is none) or the CPU (float64)")
    p.add_argument("--no_rig", action="store_true")
    p.add_argument("--num_iterations", type=int, default=20)
    p.add_argument("--calibrator_num_passes", type=int, default=2)
    p.add_argument("--robust_threshold", type=float, default=3.0)
    p.add_argument("--bracket_len", type=float, default=0.6)
    p.add_argument("--timestamp_offsets_max_change", type=float, default=1.0)
    p.add_argument("--intrinsics_to_float", default="",
                   help="per-sensor spec, e.g. 'cam1:focal_length,"
                        "optical_center,distortion cam2:focal_length'; bare "
                        "intrinsic names apply to all sensors")
    p.add_argument("--camera_poses_to_float", nargs="?", const="__all__", default="",
                   help="sensor names whose camera poses float; with no value, all")
    p.add_argument("--rig_transforms_to_float", nargs="?", const="__all__", default="",
                   help="sensor names whose ref-to-sensor transforms float; with no "
                        "value, all non-ref sensors")
    p.add_argument("--float_timestamp_offsets", action="store_true")
    p.add_argument("--float_scale", action="store_true")
    p.add_argument("--depth_to_image_transforms_to_float", nargs="?",
                   const="__all__", default="")
    p.add_argument("--affine_depth_to_image", action="store_true")
    p.add_argument("--depth_tri_weight", type=float, default=0.0,
                   help="weight of depth measurement vs triangulated point")
    p.add_argument("--mesh", help="PLY triangle mesh for the mesh constraints")
    p.add_argument("--mesh_tri_weight", type=float, default=0.0,
                   help="weight of triangulated point vs its rays' mesh hits")
    p.add_argument("--depth_mesh_weight", type=float, default=0.0,
                   help="weight of depth measurement vs the pixel ray's mesh hit")
    p.add_argument("--out_texture_dir", default="",
                   help="write <timestamp>_<sensor>.{obj,mtl,png} per image: the --mesh "
                        "projected into the image with the optimized cameras")
    p.add_argument("--min_ray_dist", type=float, default=0.0)
    p.add_argument("--max_ray_dist", type=float, default=100.0)
    p.add_argument("--tri_weight", type=float, default=0.0)
    p.add_argument("--tri_robust_threshold", type=float, default=0.1)
    p.add_argument("--min_triangulation_angle", type=float, default=0.5)
    p.add_argument("--max_reprojection_error", type=float, default=25.0)
    p.add_argument("--initial_max_reprojection_error", type=float, default=300.0)
    p.add_argument("--parameter_tolerance", type=float, default=1e-12)
    p.add_argument("--num_overlaps", type=int, default=0,
                   help="match each image against this many subsequent images; "
                        "0 = take matches from the NVM only")
    p.add_argument("--no_nvm_matches", action="store_true")
    p.add_argument("--max_features", type=int, default=1000)
    add_sift_args(p)
    p.add_argument("--sharded", action="store_true",
                   help="shard the observation tensors over this host's devices (a "
                        "ShardMesh) -- the distributed Schur BA path; under "
                        "torch.distributed each host process shards over its own cards")
    p.add_argument("--num_opt_threads", type=int, default=16,
                   help="accepted for reference parity")
    p.add_argument("--num_match_threads", type=int, default=8,
                   help="accepted for reference parity")
    p.add_argument("--use_initial_rig_transforms", action="store_true")
    p.add_argument("--registration", action="store_true",
                   help="register the solution to the control points of "
                        "--hugin_file / --xyz_file")
    p.add_argument("--hugin_file")
    p.add_argument("--xyz_file")
    p.add_argument("--save_nvm", action="store_true")
    p.add_argument("--save_matches", action="store_true",
                   help="export inlier matches as ASP .match files")
    p.add_argument("--export_to_voxblox", action="store_true",
                   help="write <out_dir>/voxblox/<sensor>/ clouds and poses")
    p.add_argument("--save_transformed_depth_clouds", action="store_true",
                   help="write each depth cloud as a world-frame PLY")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="print per-phase wall times per pass")


def _parse_camera_names(spec_str: str, sensor_names) -> set:
    """'cam1 cam3' / 'cam1,cam3' -> set of sensor indices; '__all__' (the
    bare-flag value) selects every sensor."""
    import re
    if spec_str == "__all__":
        return set(range(len(sensor_names)))
    out = set()
    for tok in re.split(r"[\\:,\s]+", spec_str.strip()):
        if not tok:
            continue
        if tok not in sensor_names:
            raise SystemExit(f"Sensor name not among the known sensors: {tok}")
        out.add(sensor_names.index(tok))
    return out


def _parse_intrinsics_to_float(spec_str: str, sensor_names):
    """'cam1:focal_length,optical_center cam2:focal_length' -> per-sensor
    sets; bare intrinsic names apply to all sensors."""
    import re
    per = [set() for _ in sensor_names]
    cur = None
    kinds = ("focal_length", "optical_center", "distortion")
    for tok in re.split(r"[\\:,\s]+", spec_str.strip()):
        if not tok:
            continue
        if tok in sensor_names:
            cur = sensor_names.index(tok)
            continue
        if tok not in kinds:
            raise SystemExit(f"Unexpected value when parsing intrinsics to float: {tok}")
        for s in (per if cur is None else [per[cur]]):
            s.add(tok)
    return per


def run(args, mesh=None):
    """The tool on parsed ``args``. ``mesh`` (a ``parallel.sharding.ShardMesh``
    whose lead device is the ``--device``) shards the observations over it,
    as ``--sharded`` does over this host's cards."""
    import dataclasses

    from multiview_tpu_torch.calib import assemble, calibrator as cal, rig_init
    from multiview_tpu_torch.calib import bracketing as br, problem as prob
    from multiview_tpu_torch.geometry import pose as pose_mod
    from multiview_tpu_torch.io import nvm as nvm_io, rig_config as rc
    from multiview_tpu_torch.sfm import pipeline as fe
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import images as img_utils
    from multiview_tpu_torch.utils.device import resolve_device, working_dtype

    if args.registration and not (args.hugin_file and args.xyz_file):
        raise SystemExit("--registration needs --hugin_file and --xyz_file")
    if args.out_texture_dir and not args.mesh:
        raise SystemExit("--out_texture_dir needs --mesh")
    if args.out_texture_dir and not args.images:
        raise SystemExit("--out_texture_dir needs --images")

    device = resolve_device(args.device)
    dtype = working_dtype(device)
    last = [time.perf_counter()]

    def _tk(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        if args.profile:
            print(f"[profile] cli {name}: {now - last[0]:.2f}s", flush=True)
        last[0] = now

    rig = rc.read_rig_config(args.rig_config)
    sensor_names = [s.name for s in rig.sensors]
    cam_params = [common.cam_params_from_sensor(s, dtype=dtype, device=device)
                  for s in rig.sensors]
    print(f"Read rig with sensors: {sensor_names}")

    # ---- initial poses ----
    nvm = nvm_io.read_nvm(args.nvm) if args.nvm else None
    if args.camera_poses:
        pose_names, pose_mats = nvm_io.read_camera_poses(args.camera_poses)
    elif nvm is not None:
        pose_names, pose_mats = nvm.cid_to_filename, nvm.world_to_cam
    else:
        raise SystemExit("Provide --camera_poses or --nvm")
    name_to_pose = {n: m for n, m in zip(pose_names, pose_mats)}
    name_to_pose.update({Path(n).name: m for n, m in zip(pose_names, pose_mats)})

    # ---- images + bracketing ----
    if args.images:
        image_data = common.scan_image_dir(args.images, sensor_names)
    else:
        image_data = [[] for _ in sensor_names]
        for n in pose_names:
            parts = Path(n)
            image_data[sensor_names.index(parts.parent.name)].append(
                br.ImageRecord(float(parts.stem), n, None))
        for recs in image_data:
            recs.sort(key=lambda r: r.timestamp)
    depth_data = common.scan_depth_dir(args.images, sensor_names) if args.images else []
    ref_ts_stream = [r.timestamp for r in image_data[0]]
    offsets = [s.timestamp_offset for s in rig.sensors]
    _tk("read+scan")
    cams, min_off, max_off = br.lookup_images(
        args.no_rig, ref_ts_stream, image_data, depth_data, offsets,
        bracket_len=args.bracket_len,
        timestamp_offsets_max_change=args.timestamp_offsets_max_change, verbose=True)
    print(f"Bracketing kept {len(cams)} camera entries")
    for c in cams:
        if c.image is not None:
            c.image = img_utils.adjust_image_size(
                rig.sensors[c.camera_type].image_size, c.image)
    _tk("bracket+resize")

    w2c_entries = np.stack([
        assemble.affine_to_pose(name_to_pose[c.image_name]
                                if c.image_name in name_to_pose
                                else name_to_pose[Path(c.image_name).name])
        for c in cams])
    ref_stamps, world_to_ref, _ = assemble.ref_data_from_entries(cams, w2c_entries)

    # ---- rig init ----
    if not args.use_initial_rig_transforms and not args.no_rig:
        rig_poses = rig_init.calc_rig_using_world_to_cam(
            len(sensor_names), cams, world_to_ref, w2c_entries, ref_stamps,
            np.asarray(offsets))
        mats = pose_mod.pose_to_matrix(torch.as_tensor(rig_poses)).numpy()
        for s, sensor in enumerate(rig.sensors):
            sensor.ref_to_sensor = mats[s]

    if args.num_overlaps < 1 and (not args.nvm or args.no_nvm_matches):
        raise SystemExit("No matches: specify --nvm (without --no_nvm_matches)"
                         " or a positive --num_overlaps")
    _tk("rig_init")

    # ---- tracks ----
    trackset = None
    if args.num_overlaps > 0:
        if not args.images:
            raise SystemExit("--num_overlaps > 0 needs --images")
        cfg = common.frontend_config_from_args(
            args, cam_filter_reproj_px=args.initial_max_reprojection_error)
        trackset = fe.detect_match_features(
            [c.image for c in cams], cfg, cam_params=cam_params,
            world_to_cam=w2c_entries, cams_of_image=[c.camera_type for c in cams],
            device=device)
    if args.nvm and not args.no_nvm_matches:
        nvm_trackset = _tracks_from_nvm(nvm, cams, rig)
        trackset = nvm_trackset if trackset is None \
            else _merge_tracksets(trackset, nvm_trackset)
    _tk("frontend_tracks")
    print(f"Built {len(trackset.tracks)} tracks")

    if args.float_scale and args.affine_depth_to_image:
        raise SystemExit("The options --float_scale and --affine_depth_to_image"
                         " should not be used together (rig_calibrator.cc:928)")

    observations, num_points = assemble.build_observations(
        rig, cams, ref_stamps, trackset, no_rig=args.no_rig, dtype=dtype, device=device)
    if args.depth_tri_weight > 0.0 or args.depth_mesh_weight > 0.0:
        depth_obs = assemble.build_depth_observations(
            rig, cams, ref_stamps, trackset, no_rig=args.no_rig, dtype=dtype, device=device)
        if depth_obs:
            observations = dataclasses.replace(observations, depths=depth_obs)
            print(f"Attached {sum(len(o) for o in depth_obs)} depth measurements")
    state = assemble.build_state(rig, cams, w2c_entries, ref_stamps, world_to_ref,
                                 num_points, no_rig=args.no_rig,
                                 affine_depth=args.affine_depth_to_image,
                                 dtype=dtype, device=device)
    print(f"Assembled {sum(len(o) for o in observations.pixels)} pixel observations "
          f"of {num_points} points")
    _tk("assemble")

    intr = _parse_intrinsics_to_float(args.intrinsics_to_float, sensor_names)
    cp_set = _parse_camera_names(args.camera_poses_to_float, sensor_names)
    rig_set = _parse_camera_names(args.rig_transforms_to_float, sensor_names)
    d2i_set = _parse_camera_names(args.depth_to_image_transforms_to_float, sensor_names)
    if args.rig_transforms_to_float != "__all__" and 0 in rig_set:
        raise SystemExit("Cannot float the rig transform from the reference "
                         "sensor to itself (dense_map_utils.cc:150-157)")
    spec = prob.FloatSpec(
        cam_poses=(0 in cp_set),
        cam_pose_sensors=tuple(sorted(cp_set)) if args.no_rig else None,
        rig_transforms=tuple(sorted(rig_set - {0})),
        focal=tuple(s for s in range(len(sensor_names)) if "focal_length" in intr[s]),
        optical_center=tuple(s for s in range(len(sensor_names))
                             if "optical_center" in intr[s]),
        distortion=tuple(s for s in range(len(sensor_names))
                         if "distortion" in intr[s] and len(rig.sensors[s].distortion)),
        timestamp_offsets=args.float_timestamp_offsets,
        depth_to_image=tuple(sorted(d2i_set)),
        depth_scale=args.float_scale and not args.affine_depth_to_image)
    opts = prob.BAOptions(
        robust_threshold=args.robust_threshold, no_rig=args.no_rig,
        depth_tri_weight=args.depth_tri_weight, tri_weight=args.tri_weight,
        mesh_tri_weight=args.mesh_tri_weight, depth_mesh_weight=args.depth_mesh_weight,
        affine_depth_to_image=args.affine_depth_to_image,
        tri_robust_threshold=args.tri_robust_threshold)

    mesh_tri_verts = None
    if args.mesh:
        from multiview_tpu_torch.io import ply as ply_io
        from multiview_tpu_torch.texture.raycast import mesh_tri_verts as soup
        mesh_data = ply_io.read_ply(args.mesh)
        mesh_tri_verts = torch.as_tensor(soup(mesh_data["vertices"], mesh_data["faces"]),
                                         dtype=dtype, device=device)
        print(f"Loaded mesh with {len(mesh_tri_verts)} triangles for constraints")

    if args.sharded or mesh is not None:
        from multiview_tpu_torch.parallel import distributed as pdist
        from multiview_tpu_torch.parallel import sharding as sh
        if mesh is None:
            # the calibrator's host-side outlier bookkeeping reads every
            # observation back each pass, so with several processes each
            # shards over its own cards only (the solver alone can take a
            # mesh across processes at the library level)
            mesh = (sh.make_mesh(pdist.local_devices(device)) if pdist.initialize()
                    else pdist.global_mesh(device=device))
        if mesh.lead != device:
            raise SystemExit(f"calibrate: the mesh starts at {mesh.lead}, --device is {device}")
        if mesh.size > 1:
            observations = sh.shard_observations(observations, mesh)
            state = sh.replicate(state, mesh)
            print(f"Sharded observations over {mesh.size} devices "
                  f"({pdist.process_count()} process(es))")

    bounds = np.stack([min_off, max_off], axis=1) if args.float_timestamp_offsets else None
    models = tuple(s.model for s in rig.sensors)
    _tk("pre_optimize")
    result = cal.optimize_rig(
        state, observations, models, spec, opts,
        num_passes=args.calibrator_num_passes, num_iterations=args.num_iterations,
        min_triangulation_angle=args.min_triangulation_angle,
        max_reprojection_error=args.max_reprojection_error,
        timestamp_offset_bounds=bounds, parameter_tolerance=args.parameter_tolerance,
        mesh_tri_verts=mesh_tri_verts, min_ray_dist=args.min_ray_dist,
        max_ray_dist=args.max_ray_dist, cam_params=cam_params,
        sensor_names=sensor_names, verbose=True, profile=args.profile)
    for i, r in enumerate(result.lm_results):
        print(f"BA pass {i + 1}: cost {float(r.initial_cost):.9g} -> {float(r.cost):.9g} "
              f"in {r.iterations} LM iterations, {int(r.cg_iters_total)} CG iterations")
    _tk("optimize_rig")
    state = result.state

    def world_to_cam(state):
        if args.no_rig:
            return state.world_to_ref.double().cpu().numpy()
        return rig_init.calc_world_to_cam_using_rig(
            cams, state.world_to_ref.double().cpu().numpy(), ref_stamps,
            state.ref_to_cam.double().cpu().numpy(),
            state.timestamp_offsets.double().cpu().numpy())

    w2c_final = world_to_cam(state)
    if args.registration:
        from multiview_tpu_torch.calib import registration as reg_wire
        state, _, _ = reg_wire.register_from_files(
            state, args.hugin_file, args.xyz_file, [c.image_name for c in cams], w2c_final,
            [c.camera_type for c in cams], cam_params)
        w2c_final = world_to_cam(state)
    ref_to_cam = state.ref_to_cam.double().cpu().numpy()

    # ---- outputs ----
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rig_mats = pose_mod.pose_to_matrix(torch.as_tensor(ref_to_cam)).numpy()
    for s, sensor in enumerate(rig.sensors):
        sensor.focal_length = float(state.focal[s])
        sensor.optical_center = state.optical_center[s].double().cpu().numpy()
        sensor.distortion = state.dist[s].double().cpu().numpy()
        sensor.ref_to_sensor = rig_mats[s]
        d2i_vec = torch.as_tensor(state.depth_to_image[s].double().cpu().numpy())
        if args.affine_depth_to_image:
            d2i = np.eye(4)
            d2i[:3, :3] = d2i_vec[:9].numpy().reshape(3, 3)
            d2i[:3, 3] = d2i_vec[9:12].numpy()
        else:
            d2i = pose_mod.pose_to_matrix(d2i_vec).numpy()
        d2i[:3, :3] *= float(state.depth_scale[s])
        sensor.depth_to_image = d2i
        sensor.timestamp_offset = float(state.timestamp_offsets[s])
    rc.write_rig_config(out / "rig_config.txt", rig)
    print(f"Writing: {out / 'rig_config.txt'}")

    mats = pose_mod.pose_to_matrix(torch.as_tensor(w2c_final)).numpy()
    nvm_io.write_camera_poses(out / "cameras.txt", [c.image_name for c in cams], mats)
    print(f"Writing: {out / 'cameras.txt'}")

    if args.save_nvm:
        _write_solution_nvm(out / "cameras.nvm", rig, cams, state, mats, trackset,
                            result.observations)
        print(f"Writing: {out / 'cameras.nvm'}")

    if args.out_texture_dir:
        # per-camera forward projection of the constraint mesh with the
        # optimized cameras (rig_calibrator.cc:2008-2016 -> meshProjectCameras)
        from multiview_tpu_torch.texture import mesh_project as mp
        _tk("write_outputs")
        mp.mesh_project_cameras(
            sensor_names,
            [common.cam_params_from_sensor(s, dtype=dtype, device=device) for s in rig.sensors],
            [c.image for c in cams], [c.timestamp for c in cams],
            [c.camera_type for c in cams], w2c_final, mesh_data["vertices"],
            mesh_data["faces"], args.out_texture_dir)
        _tk("out_texture")

    if args.save_matches:
        from multiview_tpu_torch.io import match_file
        inlier = _inlier_lookup(cams, trackset, result.observations)
        written = match_file.save_inlier_match_pairs(
            out / "matches", [c.image_name for c in cams], args.num_overlaps, trackset,
            lambda pid, cid: inlier.get((pid, cid), False))
        print(f"Wrote {len(written)} match files to {out / 'matches'}")

    if args.export_to_voxblox or args.save_transformed_depth_clouds:
        from multiview_tpu_torch.io import depth_io
        d2i_mats = np.stack([np.asarray(s.depth_to_image) for s in rig.sensors])
        entries = []
        for c in cams:
            inten = None
            if c.image is not None:
                inten = np.asarray(c.image)
                if inten.ndim == 3:
                    inten = inten.mean(axis=-1)
            entries.append((c.camera_type, c.timestamp, c.depth_cloud, inten))
        if args.export_to_voxblox:
            depth_io.export_to_voxblox(out, sensor_names, entries, d2i_mats, mats)
            print(f"Exported voxblox clouds to {out / 'voxblox'}")
        if args.save_transformed_depth_clouds:
            written = depth_io.save_transformed_depth_clouds(
                out / "transformed_depth_clouds", entries, d2i_mats, mats)
            print(f"Wrote {len(written)} transformed depth clouds")
    _tk("write_outputs")
    return 0


def _tracks_from_nvm(nvm, cams, rig):
    """NVM matches -> TrackSet over the bracketed camera entries
    (appendMatchesFromNvm, interest_point.cc:1790-1847); NVM keypoints are
    optical-center-offset, the offset is added back per sensor."""
    from multiview_tpu_torch.sfm.tracks import TrackSet

    nvm_cid_of = {}
    for cid_entry, c in enumerate(cams):
        for ncid, n in enumerate(nvm.cid_to_filename):
            if n == c.image_name or Path(n).name == Path(c.image_name).name:
                nvm_cid_of[ncid] = cid_entry
    tracks = []
    kp_lists = [dict() for _ in cams]
    for cid_fid in nvm.pid_to_cid_fid:
        tr = {}
        for ncid, fid in cid_fid.items():
            if ncid not in nvm_cid_of:
                continue
            e = nvm_cid_of[ncid]
            kp = nvm.cid_to_keypoint[ncid][fid] + np.asarray(
                rig.sensors[cams[e].camera_type].optical_center)
            kp_lists[e][len(kp_lists[e])] = kp
            tr[e] = len(kp_lists[e]) - 1
        if len(tr) >= 2:
            tracks.append(tr)
    kps = [np.stack([d[i] for i in range(len(d))]) if d else np.zeros((0, 2))
           for d in kp_lists]
    return TrackSet(kps, tracks)


def _merge_tracksets(a, b):
    """Concatenate two TrackSets over the same camera list."""
    from multiview_tpu_torch.sfm.tracks import TrackSet

    offs = [len(k) for k in a.keypoints]
    kps = [np.concatenate([np.asarray(ka).reshape(-1, 2), np.asarray(kb).reshape(-1, 2)])
           for ka, kb in zip(a.keypoints, b.keypoints)]
    tracks = list(a.tracks) + [
        {cid: fid + offs[cid] for cid, fid in tr.items()} for tr in b.tracks]
    return TrackSet(kps, tracks)


def _inlier_lookup(cams, trackset, observations):
    """{(pid, cid): inlier} from the per-sensor masks, whose rows follow the
    tracks in build order."""
    from multiview_tpu_torch.parallel.sharding import gathered_pixels

    counters = {obs.sensor: 0 for obs in observations.pixels}
    masks = {obs.sensor: obs.mask.cpu().numpy() for obs in gathered_pixels(observations)}
    inlier = {}
    for pid, track in enumerate(trackset.tracks):
        for cid, fid in track.items():
            s = cams[cid].camera_type
            if s in masks:
                inlier[(pid, cid)] = bool(masks[s][counters[s]])
                counters[s] += 1
    return inlier


def _write_solution_nvm(path, rig, cams, state, w2c_mats, trackset, observations):
    """Inlier tracks -> NVM (writeNvm semantics: keypoints offset by the
    optical center, interest_point.cc:1333-1405)."""
    from multiview_tpu_torch.io import nvm as nvm_io

    inlier = _inlier_lookup(cams, trackset, observations)

    kp_counts = [0] * len(cams)
    kp_map = [dict() for _ in cams]
    pid_to_cid_fid = []
    xyz_rows = []
    pts = state.points.double().cpu().numpy()
    for pid, track in enumerate(trackset.tracks):
        entry = {}
        for cid, fid in track.items():
            if not inlier.get((pid, cid), False):
                continue
            s = cams[cid].camera_type
            kp_map[cid][kp_counts[cid]] = (trackset.keypoints[cid][fid]
                                           - np.asarray(rig.sensors[s].optical_center))
            entry[cid] = kp_counts[cid]
            kp_counts[cid] += 1
        if len(entry) >= 2:
            pid_to_cid_fid.append(entry)
            xyz_rows.append(pts[pid])
    keypoints = [np.stack([m[i] for i in range(len(m))]) if m else np.zeros((0, 2))
                 for m in kp_map]
    nvm_io.write_nvm(path, nvm_io.NvmData(
        cid_to_filename=[c.image_name for c in cams],
        focal_lengths=np.asarray([float(state.focal[c.camera_type]) for c in cams]),
        cid_to_keypoint=keypoints, pid_to_cid_fid=pid_to_cid_fid,
        pid_to_xyz=np.asarray(xyz_rows) if xyz_rows else np.zeros((0, 3)),
        world_to_cam=w2c_mats))
