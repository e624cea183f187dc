"""``texture`` tool — the texrecon wrapper equivalent: mesh + calibrated
images -> view selection -> atlas -> seam leveling -> textured OBJ/MTL/PNG.
Port of ``multiview_tpu/tools/texture_mesh.py`` with the same flags and
printed lines, plus ``--device``.

Runs on the first CUDA card (float32) and raises when there is none;
``--device cpu`` asks for the CPU (float64). Prints the seconds of each
stage, the occlusion method and the atlas's pages besides the reference's
lines.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--rig_config", required=True)
    p.add_argument("--camera_poses", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--mesh", required=True, help="PLY mesh to texture")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute: the first CUDA card (float32; an error "
                        "when there is none) or the CPU (float64)")
    p.add_argument("--sensor", default=None)
    p.add_argument("--pixel_size", type=float, default=0.01,
                   help="texel size in meters (texture_processing.cc formModel)")
    p.add_argument("--max_page", type=int, default=8192,
                   help="texture page size bound; charts spill into as many pages "
                        "as needed (multi-page atlas)")
    p.add_argument("--no_seam_leveling", action="store_true")
    p.add_argument("--no_local_seam_leveling", action="store_true",
                   help="disable the per-texel Poisson seam step (texrecon's "
                        "local seam leveling)")
    p.add_argument("--no_occlusion", action="store_true")
    p.add_argument("--no_gauss_clamping", action="store_true",
                   help="disable photometric outlier removal (texrecon's default "
                        "outlier_removal is gauss_clamping)")
    p.add_argument("--grayscale", action="store_true",
                   help="texture in grayscale; default is color like the reference "
                        "(bin/texrecon feeds BGR jpgs)")
    p.add_argument("--smoothness_weight", type=float, default=0.1,
                   help="Potts smoothness of the view-selection MRF (mapmap's role "
                        "in texrecon); 0 = pure best-cost")


def run(args):
    import torch

    from multiview_tpu_torch.geometry import pose as pose_mod
    from multiview_tpu_torch.io import nvm as nvm_io, ply, rig_config as rc
    from multiview_tpu_torch.texture import texturing
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils.device import resolve_device, working_dtype

    device = resolve_device(args.device)
    dtype = working_dtype(device)
    rig = rc.read_rig_config(args.rig_config)
    sensor_names = [s.name for s in rig.sensors]
    cam_params = [common.cam_params_from_sensor(s, dtype=dtype, device=device)
                  for s in rig.sensors]
    pose_names, pose_mats = nvm_io.read_camera_poses(args.camera_poses)
    name_to_pose = {Path(n).name: m for n, m in zip(pose_names, pose_mats)}

    mesh = ply.read_ply(args.mesh)
    verts = mesh["vertices"]
    faces = mesh["faces"]
    print(f"Mesh: {len(verts)} verts, {len(faces)} faces")

    image_data = common.scan_image_dir(args.images, sensor_names, color=not args.grayscale)
    images, poses, cams = [], [], []
    for s, recs in enumerate(image_data):
        if args.sensor and sensor_names[s] != args.sensor:
            continue
        for r in recs:
            nm = Path(r.name).name
            if nm in name_to_pose:
                images.append(torch.as_tensor(r.payload, device=device))
                poses.append(pose_mod.matrix_to_pose(
                    torch.as_tensor(np.asarray(name_to_pose[nm], np.float64))))
                cams.append(cam_params[s])
    if not images:
        raise SystemExit("No posed images found")
    print(f"Texturing from {len(images)} views")

    clock = [time.perf_counter()]

    def mark(label):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        print(f"[texture] {label}: {now - clock[0]:.2f} s", flush=True)
        clock[0] = now

    verts_t = torch.as_tensor(verts, device=device).to(dtype)
    faces_t = torch.as_tensor(faces, device=device).long()
    poses_t = torch.stack(poses).to(device=device, dtype=dtype)
    if not args.no_occlusion:
        method = texturing.resolve_occlusion_method("auto", len(faces), len(images))
        print(f"Occlusion: {method} for {len(faces) * len(images)} face-view pairs")
    cost, usable = texturing.view_costs(verts_t, faces_t, poses_t,
                                        occlusion=not args.no_occlusion)
    if not args.no_gauss_clamping:
        colors = texturing.sample_face_view_colors(verts_t, faces_t, images, cams, poses_t,
                                                   usable)
        keep, _ = texturing.gauss_clamping(colors, usable)
        cost = torch.where(keep, cost, torch.full_like(cost, float("inf")))
    mark("view costs + clamping")
    adjacency = texturing.face_adjacency(faces)
    if args.smoothness_weight > 0 and len(adjacency):
        nbr = texturing.face_neighbors(faces, adjacency)
        best, visible = texturing.mrf_view_selection(cost, torch.isfinite(cost), nbr,
                                                     smoothness=args.smoothness_weight)
        # quality metric: the MRF labeling must not be worse than pure argmin
        cost_np = cost.cpu().numpy()
        e_icm = texturing.mrf_energy(cost_np, best.cpu().numpy(), nbr, args.smoothness_weight)
        e_arg = texturing.mrf_energy(cost_np, np.argmin(cost_np, axis=-1), nbr,
                                     args.smoothness_weight)
        print(f"MRF energy: argmin {e_arg:.4f} -> ICM {e_icm:.4f}")
    else:
        best = torch.argmin(cost, dim=-1)
        visible = torch.isfinite(torch.amin(cost, dim=-1))
    bv = best.cpu().numpy()
    vis = visible.cpu().numpy()
    mark("adjacency + MRF labeling")
    atlas = texturing.build_atlas(verts, faces, pixel_size=args.pixel_size,
                                  max_page=args.max_page)
    if atlas.num_pages > 1:
        print(f"Atlas: {atlas.num_pages} pages of <= {args.max_page}^2 texels")
    print(f"Atlas page sizes (W, H): {[tuple(map(int, s)) for s in atlas.page_sizes]}")

    gains = None
    channels = 1 if args.grayscale else 3
    if not args.no_seam_leveling:
        # per-face mean color sampled at the face centres in the chosen view;
        # gains are solved per channel (texrecon levels each channel)
        ctr, _, _ = texturing.face_geometry(verts_t, faces_t)
        face_col = np.zeros((len(faces), channels))
        for v in range(len(images)):
            sel = np.nonzero(vis & (bv == v))[0]
            if len(sel) == 0:
                continue
            Xc = pose_mod.pose_apply(poses_t[v], ctr[torch.as_tensor(sel, device=device)])
            pix = cams[v].project_cam_to_dist_pix(Xc)
            col = texturing._bilinear(images[v].float().to(dtype), pix[:, 0], pix[:, 1])
            face_col[sel] = col.reshape(len(sel), channels).cpu().numpy()
        if args.grayscale:
            face_col = face_col[:, 0]
        gains, lev_info = texturing.global_seam_leveling(face_col, bv, adjacency,
                                                         return_info=True, device=device)
        print(f"Global seam leveling: {lev_info['iterations']} sweeps, "
              f"relative residual {lev_info['rel_residual']:.2e}")
    mark("atlas + global gains")
    vgains = (texturing.vertex_gains_from_faces(len(verts), faces, gains)
              if gains is not None else None)
    page = texturing.render_atlas(atlas, verts, faces, bv, vis, images, cams, poses_t,
                                  face_gain=gains, vertex_gain=vgains)
    mark("render atlas")
    if len(adjacency):
        stats = texturing.seam_step_stats(page, atlas, verts, faces, bv, vis, adjacency)
        print(f"Seam step before local leveling: {stats}")
    if not args.no_local_seam_leveling and len(adjacency):
        page = texturing.local_seam_leveling(page, atlas, verts, faces, bv, vis, adjacency,
                                             device=device)
        stats = texturing.seam_step_stats(page, atlas, verts, faces, bv, vis, adjacency)
        print(f"Seam step after local leveling: {stats}")
    mark("local seam leveling + stats")
    out = Path(args.out_dir)
    obj = texturing.write_textured_obj(out / "textured_mesh", verts, faces, atlas, page)
    mark("write obj + png")
    print(f"Writing: {obj}")
    return 0
