#!/usr/bin/env python3
"""``sfm-init`` of the PyTorch port on one GPU, at several depths of its
refinement BA: how good the pose initialization is before any BA, after the
default 30 LM iterations and after more, on the rendered 1280x960 workspaces
of ``chip_smoke.py`` (whose helpers this script drives; run it from the root
of a checkout, on a machine with a CUDA card and nvcc).

    python3 scripts/torch_sfm_probe.py [--iterations 0 30 90] [--incremental]
        [--calibrate PASSES ITERATIONS]... [--ba_float64] [--extra <sfm-init flags>]

Prints, for each depth, the stage times, the view-graph edges, the tracks and
the trajectory error against the truth after a similarity alignment (the
first depth is run twice, the first time as a warm-up); with ``--calibrate``
the error after ``calibrate --nvm`` from each result; then the two-view stage
alone on the card and on the CPU. A run with the same flags can land in
either of two modes (its re-resection step replaces a pose or not): repeat a
depth to see both.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, nargs="+", default=[0, 30, 90],
                    help="values of --num_ba_iterations to run")
    ap.add_argument("--incremental", action="store_true",
                    help="also run INCREMENTAL on the first row of the two-sensor "
                         "workspace and on all of it")
    ap.add_argument("--calibrate", type=int, nargs=2, action="append", default=[],
                    metavar=("PASSES", "ITERATIONS"),
                    help="after every sfm-init run, calibrate --nvm from its result at "
                         "this depth (may be given several times)")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="further sfm-init flags, passed through to every run")
    ap.add_argument("--ba_float64", action="store_true",
                    help="run the refinement BA in float64 on the card")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_sfm_probe.py: no CUDA device; this script only runs on the GPU")
    import chip_smoke as cs
    from multiview_tpu_torch import native
    from multiview_tpu_torch.sfm import matching as mm
    from multiview_tpu_torch.utils import cuda_build

    card = cs.card_line()
    cuda_build.build_libraries(["knn2_wgmma.cu", "knn2.cu"])
    if native.load() is None:
        raise RuntimeError("the host library native/mv_native.cpp did not build")
    cs.ATE_MAX_M = cs.ROT_MEAN_MAX_DEG = float("inf")      # report, do not judge
    if args.ba_float64:
        from multiview_tpu_torch.utils import device as device_mod
        device_mod.working_dtype = lambda device: torch.float64
    with tempfile.TemporaryDirectory(prefix="mv_sfm_probe_") as tmp:
        tmp = Path(tmp)
        cs.render_workspaces(tmp)
        spy = {}
        for k, iters in enumerate([args.iterations[0]] + args.iterations):
            run = cs.run_sfm_init(torch, mm, f"GLOBAL {iters}", tmp / "ws3", tmp / f"sfm_{k}",
                                  ["--num_ba_iterations", str(iters)] + args.extra, spy=spy)
            label = "warm-up, " if k == 0 else ""
            print(f"[probe] {label}GLOBAL, --num_ba_iterations {iters}: {cs.sfm_summary(run)} "
                  f"[{card}]", flush=True)
            for passes, its in ([] if k == 0 else args.calibrate):
                cal = cs.calibrate_from_nvm(
                    torch, mm, "calibrate", tmp / "ws3", tmp / f"sfm_{k}" / "cameras.nvm",
                    tmp / f"calib_{k}_{passes}_{its}", passes, its)
                print(f"[probe]   calibrate --nvm from it, {passes} x {its}: wall "
                      f"{cal['wall']:.2f} s; costs {cal['costs']}; ATE "
                      f"{cal['ate']['ate_rmse_m']:.5f} m, rotation mean "
                      f"{cal['ate']['rot_mean_deg']:.4f} deg, max "
                      f"{cal['ate']['rot_max_deg']:.4f} deg [{card}]", flush=True)
        cs.two_view_stage_times(torch, card, spy, tmp / "ws3")
        if args.incremental:
            for name in ("ws_row", "ws"):
                try:
                    run = cs.run_sfm_init(torch, mm, "INCREMENTAL", tmp / name,
                                          tmp / f"sfm_inc_{name}",
                                          ["--reconstruction_estimator", "INCREMENTAL"])
                    print(f"[probe] INCREMENTAL on {name}: {cs.sfm_summary(run)} [{card}]",
                          flush=True)
                except AssertionError as e:       # fewer views registered than images
                    print(f"[probe] INCREMENTAL on {name}: {e} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
