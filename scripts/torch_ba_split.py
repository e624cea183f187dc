#!/usr/bin/env python3
"""Splits the wall of the port's Schur-LM solve on the card into the time of
one LM iteration without its CG (the row Jacobians, the assembly, the
preconditioner, the step's bookkeeping) and the time of one CG step (the
matvec and the CG's vector update), on two problems:

- ``cube``: the benchmark's ``ba_cube_384k`` problem (``make_cube_scene(160,
  20)``, 384000 rows, float32, jacobi, cg_tolerance 0.1);
- ``rig``: a synthetic rig with three sensors and depth rows
  (``make_rig_scene(40, n_per_face=8)`` + depth on sensor 1: 45312 pixel and
  7488 depth rows, float32, schur_jacobi at cg_tolerance 1e-8 with 60 CG
  steps, as ``calibrate`` runs).

Each problem is solved with ``debug_unroll_lm=k`` twice: with
``debug_force_cg=0`` (no CG step: the LM iterations alone) and with its CG
as configured. Per LM iteration = T0 / k; per CG step = (T - T0) / matvecs.
Medians of ``--reps`` solves after a warm one, host wall around a
synchronised solve.

    python3 scripts/torch_ba_split.py [--root DIR] [--reps 5] [--lm 4]

``--root`` imports ``multiview_tpu_torch`` from another checkout (a parent
commit unpacked beside this one), so two versions can be split in one call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def solve_times(torch, solver, cam0, points0, reps):
    solver(cam0, points0)
    torch.cuda.synchronize()
    times, res = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = solver(cam0, points0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), res


def problems(torch, dev):
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=160, n_per_face=20,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), pix_noise=0.5,
                                dtype=torch.float32, device=dev)
    st = syn.perturb_state(scene.true_state, pose_rot=0.01, pose_trans=0.02, point_sigma=0.02)
    mask = prob.build_mask(st, prob.FloatSpec(cam_poses=True, focal=(0,), optical_center=(0,),
                                              distortion=(0,)), no_rig=True,
                           include_points=False)
    yield ("cube", st, scene, mask, prob.BAOptions(no_rig=True),
           dict(cg_iterations=30, cg_tolerance=0.1))
    scene = syn.add_depth_observations(syn.make_rig_scene(n_ref=40, n_per_face=8,
                                                          dtype=torch.float32, device=dev),
                                       sensors=(1,))
    st = syn.perturb_rig_state(scene.true_state, rig_rot=0.002, rig_trans=0.003)
    mask = prob.build_mask(st, prob.FloatSpec(cam_poses=True, rig_transforms=True,
                                              depth_to_image=(1,), depth_scale=True),
                           include_points=False)
    yield ("rig", st, scene, mask, prob.BAOptions(depth_tri_weight=25.0),
           dict(cg_iterations=60, cg_tolerance=1e-8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lm", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_ba_split.py: no CUDA device")
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import schur

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    for name, st, scene, mask, opts, kw in problems(torch, dev):
        def solver(**extra):
            return schur.make_schur_solver(st, scene.observations, scene.models, opts, mask,
                                           debug_unroll_lm=args.lm, **kw, **extra)

        cam0 = prob.pack_state(st, include_points=False)
        t0, _ = solve_times(torch, solver(debug_force_cg=0), cam0, st.points, args.reps)
        t, res = solve_times(torch, solver(), cam0, st.points, args.reps)
        rows = sum(len(o) for o in scene.observations.pixels) + sum(
            len(o) for o in scene.observations.depths)
        print(json.dumps({
            "problem": name, "root": args.root, "rows": rows, "lm_iterations": args.lm,
            "matvecs": res.matvecs, "cg": int(res.cg_iters_total), "solve_s": t,
            "lm_only_s": t0, "per_lm_iteration_ms": t0 / args.lm * 1e3,
            "per_cg_step_ms": (t - t0) / max(res.matvecs, 1) * 1e3, "card": card}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
