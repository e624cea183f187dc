#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``multiview_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit (nvcc). It imports nothing of JAX or of the JAX package.

Phases (each raises on failure; the script then exits non-zero without
printing a result):

0. set-up: require CUDA, print versions and the card, build the matcher
   kernel (csrc/knn2.cu) for sm_90a with nvcc and the track builder's host
   library (native/mv_native.cpp) with g++;
1. the fused distance + top-2 kernel against its plain PyTorch version on
   the card, at the main path's shape (8 pairs of 4096x4096x128), at
   10000x10000x128 and on a ragged 1000x1037 case with planted exact
   duplicates and near-ties; median times of both over distinct inputs;
2. the main path: render a two-sensor rig workspace (1280x960, focal 1120 px,
   12 reference + 11 radtan frames with a 0.13 s clock offset) and run
   ``python -m multiview_tpu_torch calibrate`` in process, through the
   kernel; checks the launch count, the cost decrease, the recovered rig
   transform (1 deg / 0.05 m) and the output files;
3. Schur-LM bundle adjustment at the bench's size (cube scene 160 images x
   20x20 points per face, about 384k observations, float32): finite,
   decreasing cost and LM iterations per second.

The last three lines of standard output are the kernel record (JSON), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# ratio-test agreement bar (fraction of rows) and distance tolerances: the
# kernel and cuBLAS+topk sum the 128 products in different orders, so
# float32 distances of unit descriptors differ by a few 1e-7 absolute
MASK_AGREEMENT = 0.9999
DIST_RTOL = 1e-5
DIST_ATOL = 1e-6


class Tee(io.TextIOBase):
    """Copy writes to the real stdout and keep them for parsing."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def descriptors(gen, p, n, d, device):
    """SIFT-like rows: non-negative, unit norm."""
    import torch
    x = torch.randn((p, n, d), generator=gen, device=device).abs()
    return (x / x.norm(dim=-1, keepdim=True)).contiguous()


def phase1(torch, mm, device, card):
    """Kernel vs plain at the three shapes. Returns the kernel record parts."""
    gen = torch.Generator(device=device).manual_seed(1)
    reps = 5
    shapes = [("main_path_8x4096", 8, 4096, 4096), ("10k", 1, 10000, 10000),
              ("ragged_1000x1037", 1, 1000, 1037)]
    out = {}
    max_err = 0.0
    for label, P, N, M in shapes:
        inputs = []
        for _ in range(reps):
            q = descriptors(gen, P, N, 128, device)
            t = descriptors(gen, P, M, 128, device)
            if label.startswith("ragged"):
                t[0, 10] = q[0, 3]                      # exact duplicates:
                t[0, 900] = q[0, 3]                     # second == best
                t[0, 500] = q[0, 7]
                near = q[0, 20] + 1e-4 * torch.randn(128, generator=gen, device=device)
                t[0, 21] = near / near.norm()           # near-tie pair
                near = q[0, 20] + 1e-4 * torch.randn(128, generator=gen, device=device)
                t[0, 1036] = near / near.norm()
            inputs.append((q.contiguous(), t.contiguous()))
        k_ms, p_ms = [], []
        for q, t in inputs:
            for fn, acc in ((mm.knn2_cuda, k_ms), (mm.knn2_plain, p_ms)):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn(q, t)
                e.record()
                torch.cuda.synchronize()
                acc.append(s.elapsed_time(e))
        q, t = inputs[0]
        got = mm.knn2_cuda(q, t)
        torch.cuda.synchronize()
        ref = mm.knn2_plain(q, t)
        gap = ref.second_dist - ref.best_dist
        # the relative bar (1e-4 of the best distance) plus an absolute floor: float32 cancellation
        # in |q|^2+|t|^2-2q.t errs by ~1e-7 absolute, so near-duplicate rows
        # (best ~1e-6) are near-ties whatever their relative gap
        decided = gap > 1e-4 * ref.best_dist + 2 * DIST_ATOL
        idx_bad = int(((got.best_idx != ref.best_idx) & decided).sum())
        err = max(float((got.best_dist - ref.best_dist).abs().max()),
                  float((got.second_dist - ref.second_dist).abs().max()))
        close = (torch.allclose(got.best_dist, ref.best_dist, rtol=DIST_RTOL, atol=DIST_ATOL)
                 and torch.allclose(got.second_dist, ref.second_dist, rtol=DIST_RTOL,
                                    atol=DIST_ATOL))
        agree = float((mm.ratio_test_mask(got) == mm.ratio_test_mask(ref)).float().mean())
        k_med = sorted(k_ms)[len(k_ms) // 2]
        p_med = sorted(p_ms)[len(p_ms) // 2]
        flops = 2.0 * P * N * M * 128
        print(f"[phase1] {label}: P={P} N={N} M={M} D=128 kernel {k_med:.4f} ms "
              f"({flops / k_med / 1e9:.2f} TFLOP/s) plain {p_med:.4f} ms; idx mismatches "
              f"on decided rows {idx_bad}; max |dist err| {err:.3g}; ratio-mask "
              f"agreement {agree:.6f} [{card}]", flush=True)
        if label.startswith("ragged"):
            print(f"[phase1] ragged duplicates: row 3 -> idx {int(got.best_idx[0, 3])} "
                  f"best {float(got.best_dist[0, 3]):.3g} second "
                  f"{float(got.second_dist[0, 3]):.3g}", flush=True)
            if int(got.best_idx[0, 3]) != 10 or float(got.second_dist[0, 3]) != float(
                    got.best_dist[0, 3]):
                raise AssertionError("exact duplicate: lowest index and second == best expected")
        if idx_bad or not close or agree < MASK_AGREEMENT:
            raise AssertionError(f"phase 1 {label}: kernel disagrees with the plain version "
                                 f"(idx {idx_bad}, close {close}, mask agreement {agree})")
        max_err = max(max_err, err)
        out[label] = (k_med, p_med)
    return out, max_err


def phase2(torch, mm, card, workdir: Path, n_ref: int):
    """Render the rig workspace and calibrate it through the CLI entry."""
    import numpy as np
    from multiview_tpu_torch.__main__ import main as cli_main
    from multiview_tpu_torch.geometry import pose as P
    from multiview_tpu_torch.io import rig_config as rc
    from multiview_tpu_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    ws = workdir / "ws"
    rig_true = syn.build_rig_workspace(ws, n_ref, (1280, 960), 1120.0)
    render_s = time.perf_counter() - t0
    print(f"[phase2] rendered {2 * n_ref - 1} frames of 1280x960 in {render_s:.1f} s",
          flush=True)

    out = workdir / "calib"
    argv = ["calibrate", "--rig_config", str(ws / "rig_config.txt"),
            "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
            "--out_dir", str(out), "--rig_transforms_to_float", "--camera_poses_to_float",
            "--bracket_len", "1.5", "--max_features", "4096", "--num_overlaps", "3",
            "--num_iterations", "20", "--calibrator_num_passes", "2", "--profile"]
    tee = Tee(sys.stdout)
    mm.KERNEL_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ret = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mm.KERNEL_LAUNCHES
    text = tee.buf.getvalue()
    if ret != 0:
        raise AssertionError(f"calibrate returned {ret}")

    costs = [(float(a), float(b)) for a, b in re.findall(
        r"BA pass \d+: cost (\S+) -> (\S+)", text)]
    stages = re.findall(r"\[profile\] cli (\S+): (\S+)s", text)
    tracks = int(re.search(r"Built (\d+) tracks", text).group(1))
    nobs = re.search(r"Assembled (\d+) pixel observations of (\d+) points", text)
    rig2 = rc.read_rig_config(out / "rig_config.txt")
    est = P.matrix_to_pose(torch.as_tensor(rig2.sensors[1].ref_to_sensor))
    rel = P.pose_compose(P.pose_inverse(est), torch.as_tensor(rig_true["sci_cam"]))
    rot_err = float(np.degrees(np.linalg.norm(P.quat_log(P.pose_q(rel)).numpy())))
    trans_err = float(np.linalg.norm(P.pose_t(rel).numpy()))
    print(f"[phase2] calibrate wall {wall:.2f} s; stages "
          + " ".join(f"{k}={v}s" for k, v in stages)
          + f"; tracks {tracks}; pixel observations {nobs.group(1)} of {nobs.group(2)} "
          f"points; costs {costs}; matcher launches {launches}; rig error "
          f"{rot_err:.4f} deg {trans_err * 1000:.2f} mm [{card}]", flush=True)
    if launches <= 0:
        raise AssertionError("the main path did not launch the matcher kernel")
    if not costs or not costs[-1][1] < costs[0][0] or any(b > a for a, b in costs):
        raise AssertionError(f"BA cost did not decrease: {costs}")
    if not (rot_err < 1.0 and trans_err < 0.05):
        raise AssertionError(f"rig transform off: {rot_err} deg, {trans_err} m")
    for f in ("rig_config.txt", "cameras.txt"):
        if not (out / f).is_file():
            raise AssertionError(f"missing output {f}")
    return launches, wall


def phase3(torch, card):
    """Schur LM at the bench's size, float32 on the card."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import schur
    from multiview_tpu_torch.utils import synthetic as syn

    dev = torch.device("cuda", 0)
    scene = syn.make_cube_scene(n_images=160, n_per_face=20,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), pix_noise=0.5,
                                dtype=torch.float32, device=dev)
    n_obs = sum(len(o) for o in scene.observations.pixels)
    state0 = syn.perturb_state(scene.true_state, pose_rot=0.01, pose_trans=0.02,
                               point_sigma=0.02)
    cam_mask = prob.build_mask(
        state0, prob.FloatSpec(cam_poses=True, focal=(0,), optical_center=(0,),
                               distortion=(0,)), no_rig=True, include_points=False)
    solver = schur.make_schur_solver(state0, scene.observations, scene.models,
                                     prob.BAOptions(no_rig=True), cam_mask,
                                     max_iterations=10, cg_iterations=30, cg_tolerance=0.1)
    cam0 = prob.pack_state(state0, include_points=False)
    res = solver(cam0, state0.points)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solver(cam0, state0.points)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    c0, c1 = float(res.initial_cost), float(res.cost)
    rate = res.iterations / min(times)
    print(f"[phase3] cube 160x20: {n_obs} observations, cost {c0:.6g} -> {c1:.6g} in "
          f"{res.iterations} LM iterations ({int(res.cg_iters_total)} CG), solve times "
          f"{[round(t, 4) for t in times]} s, {rate:.3f} LM iterations/s [{card}]",
          flush=True)
    if not (c1 == c1 and c1 < c0):
        raise AssertionError(f"phase 3 cost not finite and decreasing: {c0} -> {c1}")
    return rate


def main() -> int:
    if not (ROOT / "multiview_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository "
                         "(multiview_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script only runs on the GPU")
    from multiview_tpu_torch.sfm import matching as mm
    from multiview_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    print(f"[phase0] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} [{card}]", flush=True)
    t0 = time.perf_counter()
    cuda_build.load_library("knn2.cu")
    build_s, report = cuda_build.build_reports.get("knn2.cu", (0.0, "already built"))
    print(f"[phase0] built csrc/knn2.cu for sm_90a in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build_s:.2f} s)", flush=True)
    print(report, flush=True)
    # the host library of the track builder (g++), built here so that the
    # timed calibrate run of phase 2 does not include its compile
    from multiview_tpu_torch import native
    t0 = time.perf_counter()
    host_lib = native.load()
    print(f"[phase0] host library native/mv_native.cpp: "
          f"{'built or loaded' if host_lib is not None else 'unavailable, Python fallback'} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    dev = torch.device("cuda", 0)
    p1, max_err = phase1(torch, mm, dev, card)
    with tempfile.TemporaryDirectory(prefix="mv_chip_smoke_") as tmp:
        launches, _ = phase2(torch, mm, card, Path(tmp), n_ref=12)
    phase3(torch, card)

    k_ms, p_ms = p1["main_path_8x4096"]
    print(f"[done] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "knn2_top2", "route": "cuda", "source": "multiview_tpu_torch/csrc/knn2.cu",
        "replaces": "multiview_tpu/sfm/matching.py:118",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
