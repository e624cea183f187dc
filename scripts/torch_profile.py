#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's main path on one GPU.

    python3 scripts/torch_profile.py [--n_ref 12] [--out profile_out]

Renders the two-sensor rig workspace of chip_smoke.py, then traces with
torch.profiler (a) one ``calibrate`` run through the CLI entry point and
(b) one Schur-LM solve at the bench's size (cube scene 160x20, ~384k
observations, float32, 10 LM x 30 CG). For each it writes the CUDA kernel
time table to ``<out>/profile_<name>.txt`` and prints wall time, summed
device time and the device idle share (1 - device time / wall time; kernels
on one stream, so they do not overlap).
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_ref", type=int, default=12)
    ap.add_argument("--out", default=str(ROOT / "profile_out"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile.py needs a CUDA device")
    from multiview_tpu_torch.__main__ import main as cli_main
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import schur
    from multiview_tpu_torch.utils import synthetic as syn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="mv_profile_") as tmp:
        ws = Path(tmp) / "ws"
        syn.build_rig_workspace(ws, args.n_ref, (1280, 960), 1120.0)
        argv = ["calibrate", "--rig_config", str(ws / "rig_config.txt"),
                "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
                "--rig_transforms_to_float", "--camera_poses_to_float",
                "--bracket_len", "1.5", "--max_features", "4096", "--num_overlaps", "3",
                "--num_iterations", "20", "--calibrator_num_passes", "2", "--profile"]

        def calibrate(run):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli_main(argv + ["--out_dir", str(Path(tmp) / f"out{run}")])
            return buf.getvalue()

        calibrate(0)                                  # warm-up: kernel build, caches
        print("\n".join(line for line in calibrate(1).splitlines()
                        if line.startswith(("[profile]", "BA pass"))), flush=True)
        traced("calibrate", lambda: calibrate(2), out_dir)

    dev = torch.device("cuda", 0)
    scene = syn.make_cube_scene(n_images=160, n_per_face=20,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), pix_noise=0.5,
                                dtype=torch.float32, device=dev)
    state0 = syn.perturb_state(scene.true_state, pose_rot=0.01, pose_trans=0.02,
                               point_sigma=0.02)
    mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True, focal=(0,),
                                                  optical_center=(0,), distortion=(0,)),
                           no_rig=True, include_points=False)
    solver = schur.make_schur_solver(state0, scene.observations, scene.models,
                                     prob.BAOptions(no_rig=True), mask, max_iterations=10,
                                     cg_iterations=30, cg_tolerance=0.1)
    cam0 = prob.pack_state(state0, include_points=False)
    solver(cam0, state0.points)
    traced("ba_384k", lambda: solver(cam0, state0.points), out_dir)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
