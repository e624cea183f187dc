#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's main path on one GPU.

    python3 scripts/torch_profile.py [--n_ref 12] [--out profile_out] [--skip_ba] [--depth]
    python3 scripts/torch_profile.py --fuse [--n_ref 4]
    python3 scripts/torch_profile.py --texture [--n_ref 12]
    python3 scripts/torch_profile.py --ba_only [--linear_solver cg_blocks cg_dense_j ...]

Renders the two-sensor rig workspace of chip_smoke.py (with ``--depth`` the
three-sensor one, calibrated with the depth camera's flags of phase 4; with
``--mesh`` too, the mesh families of phase 4b), then traces with
torch.profiler (a) one ``calibrate`` run through the CLI entry point and
(b) one Schur-LM solve at the bench's size (cube scene 160x20, ~384k
observations, float32, 10 LM x 30 CG: chip_smoke.py phase 3's problem), once
for each ``--linear_solver`` mode (default ``cg_blocks``; ``--ba_only``
traces the solves alone). For each it writes the CUDA kernel
time table to ``<out>/profile_<name>.txt`` and prints wall time, summed
device time and the device idle share (1 - device time / wall time; kernels
on one stream, so they do not overlap).

With ``--fuse`` it traces ``fuse-mesh`` instead, with chip_smoke.py phase 7's
flags on the nav_cam pairs of the three-sensor workspace (after a warm-up
run), and nothing else. With ``--texture`` it runs ``fuse-mesh`` with phase
7's flags on every pair of the three-sensor workspace (not traced) and traces
``texture`` of the fused mesh with chip_smoke.py phase 8's flags (after a
warm-up run), and nothing else.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def traced(name, fn, out_dir: Path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: a host op's row repeats the time of the kernels it launched
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    (out_dir / f"profile_{name}.txt").write_text(table)
    print(f"[profile] {name}: wall {wall:.3f} s, device busy {device_us / 1e6:.3f} s, "
          f"idle share {1 - device_us / 1e6 / wall:.3f}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
    # the port's own kernels, whatever their rank in the table
    own = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and any(k in e.key for k in ("knn2", "split_sets", "row_sq_norms"))]
    for e in own:
        print(f"[profile] {name}: own kernel {e.key[:60]}: {e.count} launches, "
              f"{e.self_device_time_total / 1e3:.3f} ms", flush=True)
    print(f"[profile] {name}: own kernels {sum(e.self_device_time_total for e in own) / 1e3:.3f}"
          f" ms of {device_us / 1e3:.1f} ms device time", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_ref", type=int, default=12)
    ap.add_argument("--out", default=str(ROOT / "profile_out"))
    ap.add_argument("--skip_ba", action="store_true", help="trace calibrate only")
    ap.add_argument("--depth", action="store_true",
                    help="the three-sensor workspace and the depth-camera flags")
    ap.add_argument("--mesh", action="store_true",
                    help="with --depth: the mesh families on the tessellated terrain")
    ap.add_argument("--fuse", action="store_true",
                    help="trace fuse-mesh on the nav_cam pairs instead")
    ap.add_argument("--texture", action="store_true",
                    help="trace texture of the fused mesh of every pair instead")
    ap.add_argument("--ba_only", action="store_true",
                    help="trace the Schur-LM solves at 384k observations alone")
    ap.add_argument("--linear_solver", nargs="+", default=["cg_blocks"],
                    help="the solver modes of the traced Schur-LM solves")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile.py needs a CUDA device")
    from multiview_tpu_torch.__main__ import main as cli_main
    from multiview_tpu_torch.utils import synthetic as syn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.ba_only:
        return trace_ba(torch, args.linear_solver, out_dir)
    with tempfile.TemporaryDirectory(prefix="mv_profile_") as tmp:
        ws = Path(tmp) / "ws"
        syn.build_rig_workspace(ws, args.n_ref, (1280, 960), 1120.0,
                                depth=args.depth or args.fuse or args.texture, workers=7)
        common = ["--rig_config", str(ws / "rig_config.txt"), "--camera_poses",
                  str(ws / "cameras.txt"), "--images", str(ws / "images")]
        if args.texture:
            import chip_smoke as cs
            fused = Path(tmp) / "fused"
            with contextlib.redirect_stdout(io.StringIO()):
                cli_main(["fuse-mesh"] + common + ["--out_dir", str(fused)] + cs.FUSE_FLAGS)

            def texture(run):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    cli_main(["texture"] + common + [
                        "--mesh", str(fused / "fused_mesh.ply"),
                        "--out_dir", str(Path(tmp) / f"textured{run}")] + cs.TEXTURE_FLAGS)
                return buf.getvalue()

            print("\n".join(line for line in texture(0).splitlines()       # warm-up
                            if line.startswith(("[texture]", "Mesh", "Occlusion"))), flush=True)
            traced("texture", lambda: texture(1), out_dir)
            print(torch.cuda.get_device_name(0))
            return 0
        if args.fuse:
            import chip_smoke as cs
            fuse_argv = ["fuse-mesh", "--rig_config", str(ws / "rig_config.txt"),
                         "--camera_poses", str(ws / "cameras.txt"), "--images",
                         str(ws / "images"), "--sensor", "nav_cam"] + cs.FUSE_FLAGS

            def fuse(run):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    cli_main(fuse_argv + ["--out_dir", str(Path(tmp) / f"fused{run}")])
                return buf.getvalue()

            print(fuse(0).splitlines()[-1], flush=True)       # warm-up
            traced("fuse_mesh", lambda: fuse(1), out_dir)
            print(torch.cuda.get_device_name(0))
            return 0
        argv = ["calibrate", "--rig_config", str(ws / "rig_config.txt"),
                "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
                "--rig_transforms_to_float", "--camera_poses_to_float",
                "--bracket_len", "1.5", "--max_features", "4096", "--num_overlaps", "3",
                "--num_iterations", "20", "--calibrator_num_passes", "2", "--profile"]
        if args.depth:
            argv += ["--depth_tri_weight", "25.0", "--float_scale",
                     "--depth_to_image_transforms_to_float", "haz_cam"]
        if args.depth and args.mesh:
            syn.write_terrain_mesh(ws / "terrain.ply", step=0.03)
            argv += ["--mesh", str(ws / "terrain.ply"), "--mesh_tri_weight", "5.0",
                     "--depth_mesh_weight", "10.0", "--max_ray_dist", "10.0"]

        def calibrate(run):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli_main(argv + ["--out_dir", str(Path(tmp) / f"out{run}")])
            return buf.getvalue()

        calibrate(0)                                  # warm-up: kernel build, caches
        print("\n".join(line for line in calibrate(1).splitlines()
                        if line.startswith(("[profile]", "BA pass"))), flush=True)
        traced("calibrate", lambda: calibrate(2), out_dir)

    if args.skip_ba:
        print(torch.cuda.get_device_name(0))
        return 0
    return trace_ba(torch, args.linear_solver, out_dir)


def trace_ba(torch, modes, out_dir: Path) -> int:
    """Traces chip_smoke.py phase 3's solve once per linear-solver mode,
    each after a warm-up solve."""
    import chip_smoke as cs
    from multiview_tpu_torch.calib import problem as prob

    scene, state0, make = cs.ba_problem(torch, torch.device("cuda", 0), 160, 20)
    cam0 = prob.pack_state(state0, include_points=False)
    for mode in modes:
        solver = make(linear_solver=mode)
        res = solver(cam0, state0.points)
        print(f"[profile] ba_384k {mode}: {res.iterations} LM, {int(res.cg_iters_total)} CG, "
              f"{res.matvecs} matvecs, cost {float(res.cost):.7g}", flush=True)
        traced("ba_384k" if mode == "cg_blocks" else f"ba_384k_{mode}",
               lambda: solver(cam0, state0.points), out_dir)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
