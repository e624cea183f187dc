#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``multiview_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit (nvcc). It imports nothing of JAX or of the JAX package.

Phases (each raises on failure; the script then exits non-zero without
printing a result):

0. set-up: require CUDA, print versions and the card, build the two matcher
   kernels (csrc/knn2_wgmma.cu, csrc/knn2.cu) for sm_90a, one nvcc each,
   started together, and the track builder's host library
   (native/mv_native.cpp) with g++;
1. the matcher on the card (``knn2_cuda``: the tensor-core kernel for
   D = 64 and 128, the FMA kernel for any other D) against ``knn2_plain``,
   against ``knn2_split_plain`` and against the FMA kernel, at the main path's
   shape (8 pairs of 4096x4096x128), at 10000x10000x128, on a ragged
   1000x1037 case with planted exact duplicates and near-ties, at D = 64 and
   at D = 96 (ragged, and the shape of phase 2b); median times over distinct
   inputs of the kernel, the FMA kernel, the plain version and the product
   ``torch.matmul`` alone, beside the operation bound;
2. the main path: render a two-sensor rig workspace (1280x960, focal 1120 px,
   12 reference + 11 radtan frames with a 0.13 s clock offset) and run
   ``python -m multiview_tpu_torch calibrate`` in process, through the
   tensor-core kernel; checks the launch count, the track count, the cost
   decrease, the recovered rig transform (1 deg / 0.05 m) and the output
   files;
2b. the odd-width path: ``match_pairs_batched`` over five images of 1000
   planted features with 96-wide descriptors, through the FMA kernel; checks
   the launch count and the planted correspondences;
3. Schur-LM bundle adjustment at the bench's size (cube scene 160 images x
   20x20 points per face, about 384k observations, float32): finite,
   decreasing cost and LM iterations per second.

The last three lines of standard output are the kernel record (JSON: each
kernel with its launches on its path, its time, its plain version's, the
product ``torch.matmul``'s as ``library_ms``, its bound and largest error at
that path's shape), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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

# ratio-test agreement bar (fraction of the rows whose ratio test the
# reference decides by more than the distance tolerance) and distance
# tolerances: the kernels and cuBLAS+topk sum the products in different
# orders, so float32 distances of unit descriptors differ by a few 1e-7
# absolute
MASK_AGREEMENT = 0.9999
DIST_RTOL = 1e-5
DIST_ATOL = 1e-6

# published peaks of one H100 SXM (data sheet, dense): the bound of the matcher
# is its 2 P N M D operations over the TF32 tensor-core rate, or its bytes
# (inputs read once, outputs written once) over the memory rate
TF32_PEAK = 495e12
FP32_CORES_PEAK = 67e12
MEM_PEAK = 3.35e12
WGMMA_SOURCE = "multiview_tpu_torch/csrc/knn2_wgmma.cu"
FMA_SOURCE = "multiview_tpu_torch/csrc/knn2.cu"
TRACKS_EXPECTED = 5145     # phase 2 with the FMA kernel on this workspace
ODD_PATH = (5, 1000, 96)   # phase 2b: images, features per image, descriptor width


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


def median_ms(torch, fn, inputs):
    times = []
    for q, t in inputs:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(q, t)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2]


def compare(torch, mm, label, other, got, ref):
    """Holds ``got`` to ``ref`` under the bars above; returns the largest
    distance difference."""
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
    # the ratio test is held only where the reference decides it by more than
    # the distance tolerance: best < 0.64 second with a margin above 4 atol
    margin = (ref.best_dist - 0.64 * ref.second_dist).abs()
    held = margin > 4 * DIST_ATOL
    same = mm.ratio_test_mask(got) == mm.ratio_test_mask(ref)
    agree = float(same[held].float().mean())
    print(f"[phase1] {label} vs {other}: idx mismatches on decided rows {idx_bad}; "
          f"max |dist err| {err:.3g}; ratio-mask agreement {agree:.6f} on {int(held.sum())} "
          f"rows ({int((~held).sum())} within tolerance of the ratio, "
          f"{int((~same & ~held).sum())} of them differ)", flush=True)
    if idx_bad or not close or agree < MASK_AGREEMENT:
        raise AssertionError(f"phase 1 {label}: the kernel disagrees with {other} "
                             f"(idx {idx_bad}, close {close}, mask agreement {agree})")
    return err


def phase1(torch, mm, device, card):
    """The matcher on the card against its plain versions and the FMA kernel.
    Returns {label: record} with times, bound and largest error per shape."""
    gen = torch.Generator(device=device).manual_seed(1)
    reps = 5
    n_img, k_odd, d_odd = ODD_PATH
    shapes = [("main_path_8x4096", 8, 4096, 4096, 128), ("10k", 1, 10000, 10000, 128),
              ("ragged_1000x1037", 1, 1000, 1037, 128), ("d64_4x2048x2000", 4, 2048, 2000, 64),
              ("odd_d96_ragged", 2, 1000, 1037, 96),
              ("odd_path_d96", 2 * n_img - 3, k_odd, k_odd, d_odd)]
    out = {}
    product = lambda q, t: torch.matmul(q, t.transpose(-1, -2))  # noqa: E731
    for label, P, N, M, D in shapes:
        inputs = []
        for _ in range(reps):
            q = descriptors(gen, P, N, D, device)
            t = descriptors(gen, P, M, D, device)
            if label.startswith("ragged"):
                t[0, 10] = q[0, 3]                      # exact duplicates:
                t[0, 900] = q[0, 3]                     # second == best
                t[0, 500] = q[0, 7]
                near = q[0, 20] + 1e-4 * torch.randn(D, generator=gen, device=device)
                t[0, 21] = near / near.norm()           # near-tie pair
                near = q[0, 20] + 1e-4 * torch.randn(D, generator=gen, device=device)
                t[0, 1036] = near / near.norm()
            inputs.append((q.contiguous(), t.contiguous()))
        name = mm.kernel_for(D)
        times = {}
        order = [("kernel", mm.knn2_cuda), ("fma", mm.knn2_cuda_fma),
                 ("plain", mm.knn2_plain), ("product", product)]
        for key, fn in order + order[::-1]:             # in turns, the better of two
            ms = median_ms(torch, fn, inputs)
            times[key] = min(times.get(key, ms), ms)
        q, t = inputs[0]
        before = (mm.WGMMA_LAUNCHES, mm.FMA_LAUNCHES)
        got = mm.knn2_cuda(q, t)
        torch.cuda.synchronize()
        launched = (mm.WGMMA_LAUNCHES - before[0], mm.FMA_LAUNCHES - before[1])
        if launched != ((1, 0) if name == "knn2_wgmma" else (0, 1)):
            raise AssertionError(f"phase 1 {label}: D={D} must launch {name} once, counted "
                                 f"(tensor-core, FMA) = {launched}")
        err = compare(torch, mm, label, "knn2_plain", got, mm.knn2_plain(q, t))
        if name == "knn2_wgmma":
            compare(torch, mm, label, "knn2_split_plain", got, mm.knn2_split_plain(q, t))
            compare(torch, mm, label, "the FMA kernel", got, mm.knn2_cuda_fma(q, t))
        flop = 2.0 * P * N * M * D
        nbytes = 4.0 * P * (N + M) * D + 12.0 * P * N
        bound_ms = max(flop / TF32_PEAK, nbytes / MEM_PEAK) * 1e3
        bound_by = "operations" if flop / TF32_PEAK >= nbytes / MEM_PEAK else "bytes"
        print(f"[phase1] {label}: P={P} N={N} M={M} D={D} -> {name} {times['kernel']:.4f} ms "
              f"({flop / times['kernel'] / 1e9:.2f} TFLOP/s); FMA kernel {times['fma']:.4f} ms; "
              f"plain {times['plain']:.4f} ms; torch.matmul (product only, no top-2) "
              f"{times['product']:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} (TF32 tensor "
              f"cores; FP32 CUDA cores {flop / FP32_CORES_PEAK * 1e3:.4f} ms; memory "
              f"{nbytes / MEM_PEAK * 1e3:.4f} ms); share of bound "
              f"{bound_ms / times['kernel']:.4f} [{card}]", flush=True)
        if label.startswith("ragged"):
            print(f"[phase1] ragged duplicates: row 3 -> idx {int(got.best_idx[0, 3])} "
                  f"best {float(got.best_dist[0, 3]):.3g} second "
                  f"{float(got.second_dist[0, 3]):.3g}", flush=True)
            if int(got.best_idx[0, 3]) != 10 or float(got.second_dist[0, 3]) != float(
                    got.best_dist[0, 3]):
                raise AssertionError("exact duplicate: lowest index and second == best expected")
        out[label] = {"ms": times["kernel"], "fma_ms": times["fma"], "plain_ms": times["plain"],
                      "library_ms": times["product"], "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": err}
    return out


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
    mm.WGMMA_LAUNCHES = mm.FMA_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ret = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mm.WGMMA_LAUNCHES
    fma_launches = mm.FMA_LAUNCHES
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
          f"points; costs {costs}; tensor-core matcher launches {launches} (FMA kernel "
          f"{fma_launches}); rig error "
          f"{rot_err:.4f} deg {trans_err * 1000:.2f} mm [{card}]", flush=True)
    if launches <= 0 or fma_launches != 0:
        raise AssertionError("the main path (D = 128) must launch the tensor-core matcher "
                             f"and only it: counted {launches} and {fma_launches} (FMA)")
    if abs(tracks - TRACKS_EXPECTED) > 0.01 * TRACKS_EXPECTED:
        raise AssertionError(f"{tracks} tracks, expected {TRACKS_EXPECTED} within 1%")
    if not costs or not costs[-1][1] < costs[0][0] or any(b > a for a, b in costs):
        raise AssertionError(f"BA cost did not decrease: {costs}")
    if not (rot_err < 1.0 and trans_err < 0.05):
        raise AssertionError(f"rig transform off: {rot_err} deg, {trans_err} m")
    for f in ("rig_config.txt", "cameras.txt"):
        if not (out / f).is_file():
            raise AssertionError(f"missing output {f}")
    return launches, wall


def phase2b(torch, mm, device, card):
    """Descriptors of a width the tensor-core kernel is not built for, through
    the front end's batched matcher: planted correspondences must come back."""
    from multiview_tpu_torch.sfm import features as feat
    from multiview_tpu_torch.sfm import pipeline as fe

    n_img, k, d = ODD_PATH
    gen = torch.Generator(device=device).manual_seed(2)
    base_desc = descriptors(gen, 1, k, d, device)[0]
    base_xy = torch.rand((k, 2), generator=gen, device=device) * 1000.0
    shift = torch.tensor([7.0, -3.0], device=device)
    kps, descs, perms = [], [], []
    for i in range(n_img):
        perm = torch.randperm(k, generator=gen, device=device)
        noisy = base_desc[perm] + 0.01 * torch.randn((k, d), generator=gen, device=device)
        descs.append((noisy / noisy.norm(dim=-1, keepdim=True)).contiguous())
        xy = base_xy[perm] + i * shift
        kps.append(feat.Keypoints(xy, torch.ones(k, device=device), torch.ones(k, device=device),
                                  torch.zeros(k, device=device),
                                  torch.ones(k, dtype=torch.bool, device=device)))
        perms.append(perm)
    pair_ids = [(i, j) for i in range(n_img) for j in range(i + 1, min(i + 3, n_img))]
    mm.WGMMA_LAUNCHES = mm.FMA_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matches = fe.match_pairs_batched(kps, descs, pair_ids, fe.FrontendConfig())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, wgmma_launches = mm.FMA_LAUNCHES, mm.WGMMA_LAUNCHES
    found = 0
    for (i, j), (xi, xj) in matches.items():
        off = xj - xi - (j - i) * shift.cpu().numpy()
        if len(xi) and float(abs(off).max()) > 1e-3:
            raise AssertionError(f"phase 2b pair {(i, j)}: a match off the planted shift")
        found += len(xi)
    print(f"[phase2b] {len(pair_ids)} pairs of {k}x{k}x{d} through match_pairs_batched in "
          f"{wall * 1e3:.1f} ms: {found} of {len(pair_ids) * k} planted matches; FMA kernel "
          f"launches {launches} (tensor-core {wgmma_launches}) [{card}]", flush=True)
    if launches <= 0 or wgmma_launches != 0:
        raise AssertionError(f"D = {d} must launch the FMA kernel and only it: counted "
                             f"{launches} and {wgmma_launches} (tensor-core)")
    if found < 0.95 * len(pair_ids) * k:
        raise AssertionError(f"phase 2b: only {found} of {len(pair_ids) * k} planted matches")
    return launches


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
    sources = ["knn2_wgmma.cu", "knn2.cu"]
    cuda_build.build_libraries(sources)        # one nvcc each, started together
    print(f"[phase0] built csrc/{{{','.join(sources)}}} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for src in sources:
        build_s, report = cuda_build.build_reports.get(src, (0.0, "already built"))
        print(f"[phase0] csrc/{src}: nvcc {build_s:.2f} s\n{report}", flush=True)
        cuda_build.load_library(src)
    # the host library of the track builder (g++), built here so that the
    # timed calibrate run of phase 2 does not include its compile
    from multiview_tpu_torch import native
    t0 = time.perf_counter()
    if native.load() is None:
        raise RuntimeError("the host library native/mv_native.cpp did not build (g++): "
                           "phase 2 would time the Python track builder instead")
    print(f"[phase0] host library native/mv_native.cpp built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    dev = torch.device("cuda", 0)
    p1 = phase1(torch, mm, dev, card)
    with tempfile.TemporaryDirectory(prefix="mv_chip_smoke_") as tmp:
        launches, _ = phase2(torch, mm, card, Path(tmp), n_ref=12)
    fma_launches = phase2b(torch, mm, dev, card)
    phase3(torch, card)

    print(f"[done] total {time.perf_counter() - t_start:.1f} s", flush=True)
    replaces = "multiview_tpu/sfm/matching.py:118"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "knn2_wgmma", "route": "cuda", "source": WGMMA_SOURCE, "replaces": replaces,
         "launches": launches, **{k: p1["main_path_8x4096"][k] for k in keys}},
        {"name": "knn2_top2", "route": "cuda", "source": FMA_SOURCE, "replaces": replaces,
         "launches": fma_launches, **{k: p1["odd_path_d96"][k] for k in keys}}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
