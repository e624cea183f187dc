"""``fit-rpc`` tool — the fit_rpc executable equivalent (fit_rpc.cc:83-146).
Port of ``multiview_tpu/tools/fit_rpc_tool.py``: fit an RPC of a given degree
to every sensor's distortion model plus its inverse, write the updated rig
config. Runs on the first CUDA card and raises when there is none;
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--rig_config", "--camera_config", dest="rig_config", required=True,
                   help="rig configuration (the reference fit_rpc's --camera_config, "
                        "fit_rpc.cc:73)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute: the first CUDA card (an error when there "
                        "is none) or the CPU")
    p.add_argument("--rpc_degree", type=int, default=2)
    p.add_argument("--verbose", action="store_true",
                   help="print the fitted coefficients (fit_rpc.cc:79)")
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--num_iterations", type=int, default=50)
    p.add_argument("--parameter_tolerance", type=float, default=1e-12)
    p.add_argument("--sensors", default="", help="restrict to these (space-sep)")


def run(args):
    from multiview_tpu_torch.geometry import rpc_fit
    from multiview_tpu_torch.io import rig_config as rc
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rig = rc.read_rig_config(args.rig_config)
    only = set(args.sensors.split()) if args.sensors else None
    for s in rig.sensors:
        if only and s.name not in only:
            continue
        if s.model == "rpc":
            print(f"{s.name}: already RPC, skipping")
            continue
        cam = common.cam_params_from_sensor(s, device=device)
        print(f"Fitting RPC distortion of degree {args.rpc_degree} for {s.name}")
        coeffs = rpc_fit.fit_rpc_dist_undist(
            cam, args.rpc_degree, num_samples=args.num_samples,
            num_iterations=args.num_iterations,
            parameter_tolerance=args.parameter_tolerance)
        err = rpc_fit.eval_rpc_dist_undist(cam, coeffs, num_samples=args.num_samples)
        print(f"Max distort_undistort error: {err}")
        coeffs = coeffs.cpu().numpy()
        if args.verbose:
            print(f"  {s.name} rpc coefficients ({len(coeffs)}): "
                  f"{np.array2string(coeffs, precision=6)}")
        s.distortion = coeffs
    out = Path(args.out_dir)
    rc.write_rig_config(out / "rig_config.txt", rig)
    print(f"Writing: {out / 'rig_config.txt'}")
    return 0
