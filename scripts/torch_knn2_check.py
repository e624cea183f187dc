#!/usr/bin/env python3
"""Check and time the two descriptor-matcher kernels of multiview_tpu_torch
on one NVIDIA GPU.

    python3 scripts/torch_knn2_check.py [--out DIR] [--reps 7] [--quick]

Builds csrc/knn2_wgmma.cu and csrc/knn2.cu (prints the ptxas reports), then

1. layout probe: one-hot queries and train rows, for which the best index of
   row i must be i whatever the rounding; a wrong shared-memory layout shows
   as a permutation;
2. at each shape: the tensor-core kernel against ``knn2_plain``, against
   ``knn2_split_plain``, against the FMA kernel and against a float64
   reference (index mismatches on decided rows, largest and mean signed
   distance error), and the median time over distinct inputs of both
   kernels, the plain version and the product ``torch.matmul`` alone, the
   device time of each launch of the tensor-core path (torch.profiler) and
   the share of a sweep's clocks that a consumer warpgroup spends waiting
   for a tile, in its wgmma chains and in the top-2 fold;
3. prints the operation and byte bounds of each shape beside the times, with
   the card's name and power limit.

``--quick`` stops after the correctness part of the small shapes. Results go
to standard output and, with ``--out``, to DIR/knn2_check.json.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (FP32_CORES_PEAK, MEM_PEAK, TF32_PEAK, card_line,  # noqa: E402
                        descriptors, median_ms)
from multiview_tpu_torch.sfm import matching as mm  # noqa: E402
from multiview_tpu_torch.utils import cuda_build  # noqa: E402


def layout_probe(device):
    ok = True
    for d in (128, 64):
        for shift in range(0, d, 64):
            n = 64
            q = torch.zeros((n, d), device=device)
            q[torch.arange(n), shift + torch.arange(n) % (d - shift)] = 1.0
            t = q.clone()
            got = mm.knn2_cuda_wgmma(q, t)
            torch.cuda.synchronize()
            want = torch.arange(n, device=device, dtype=torch.int32)
            good = bool(torch.equal(got.best_idx, want)) and float(got.best_dist.abs().max()) == 0.0 \
                and bool((got.second_dist == 2.0).all())
            print(f"[layout] D={d} columns {shift}..{shift + 63}: {'ok' if good else 'WRONG'}",
                  flush=True)
            if not good:
                ok = False
                print("  best_idx", got.best_idx.tolist())
                print("  best", [round(v, 3) for v in got.best_dist.tolist()])
                print("  second", [round(v, 3) for v in got.second_dist.tolist()])
    return ok


def check_shape(label, P, N, M, D, device, gen, reps, time_it):
    inputs = [(descriptors(gen, P, N, D, device), descriptors(gen, P, M, D, device))
              for _ in range(reps if time_it else 1)]
    q, t = inputs[0]
    kernel = mm.knn2_cuda_wgmma if mm.kernel_for(D) == "knn2_wgmma" else mm.knn2_cuda_fma
    got = kernel(q, t)
    torch.cuda.synchronize()
    rec = {"shape": [P, N, M, D], "kernel": mm.kernel_for(D)}
    refs = {"plain": mm.knn2_plain(q, t), "fma": mm.knn2_cuda_fma(q, t)}
    if D in mm.WGMMA_DIMS:
        refs["split_plain"] = mm.knn2_split_plain(q, t)
    # float64 reference, a pair at a time (the [N,M] float64 matrix is large)
    e1, e2 = [], []
    for p in range(P):
        r64 = mm.knn2_plain(q[p].double(), t[p].double())
        e1.append(got.best_dist[p].double() - r64.best_dist)
        e2.append(got.second_dist[p].double() - r64.second_dist)
    e = torch.cat(e1 + e2)
    rec["vs_float64"] = {"max_abs": float(e.abs().max()), "mean_signed": float(e.mean())}
    for name, ref in refs.items():
        gap = ref.second_dist - ref.best_dist
        decided = gap > 1e-4 * ref.best_dist + 2e-6
        rec["vs_" + name] = {
            "idx_mismatch_decided": int(((got.best_idx != ref.best_idx) & decided).sum()),
            "idx_mismatch_all": int((got.best_idx != ref.best_idx).sum()),
            "max_abs": max(float((got.best_dist - ref.best_dist).abs().max()),
                           float((got.second_dist - ref.second_dist).abs().max())),
            "mask_agreement": float((mm.ratio_test_mask(got) == mm.ratio_test_mask(ref))
                                    .float().mean())}
    if time_it:
        qt = lambda a, b: torch.matmul(a, b.transpose(-1, -2))  # noqa: E731
        order = [("kernel", kernel), ("fma", mm.knn2_cuda_fma), ("plain", mm.knn2_plain),
                 ("matmul", qt)]
        for name, fn in order + order[::-1]:          # each twice, in turns
            ms = median_ms(torch, fn, inputs)
            rec[name + "_ms"] = min(rec.get(name + "_ms", ms), ms)
        flop = 2.0 * P * N * M * D
        nbytes = 4.0 * P * (N + M) * D + 12.0 * P * N
        rec["flop"] = flop
        rec["bytes"] = nbytes
        rec["bound_ms"] = {"tf32": flop / TF32_PEAK * 1e3, "fp32_cuda_cores": flop / FP32_CORES_PEAK * 1e3,
                           "memory": nbytes / MEM_PEAK * 1e3}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            kernel(q, t)
            torch.cuda.synchronize()
        if kernel is mm.knn2_cuda_wgmma:
            clocks = []
            kernel(q, t, clocks=clocks)
            torch.cuda.synchronize()
            c = clocks[0].double().mean(dim=(0, 1))
            rec["sweep_clock_share"] = {"waiting_for_a_tile": float(c[0] / c[3]),
                                        "wgmma_chains": float(c[1] / c[3]),
                                        "top2_fold": float(c[2] / c[3]),
                                        "clocks_per_block": float(c[3]),
                                        "blocks": int(clocks[0].shape[0])}
        rec["device_us_by_kernel"] = {
            k.key[:40]: round(getattr(k, "device_time_total", 0.0) or
                              getattr(k, "cuda_time_total", 0.0), 1)
            for k in prof.key_averages()}
    print(f"[check] {label}: {json.dumps(rec)}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_knn2_check.py: no CUDA device")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cuda_build.build_libraries(["knn2_wgmma.cu", "knn2.cu"])
    for name, (secs, report) in cuda_build.build_reports.items():
        print(f"[build] {name}: nvcc {secs:.2f} s\n{report}", flush=True)
    result = {"card": card, "ptxas": {k: v[1] for k, v in cuda_build.build_reports.items()},
              "shapes": {}}
    if not layout_probe(device):
        raise SystemExit("layout probe failed")
    gen = torch.Generator(device=device).manual_seed(1)
    small = [("one_tile", 1, 64, 64, 128), ("ragged", 1, 300, 517, 128),
             ("ragged_d64", 3, 200, 1037, 64), ("odd_d96", 2, 333, 517, 96)]
    for label, P, N, M, D in small:
        result["shapes"][label] = check_shape(label, P, N, M, D, device, gen, 1, False)
    if not args.quick:
        big = [("main_path_8x4096", 8, 4096, 4096, 128), ("10k", 1, 10000, 10000, 128),
               ("ragged_1000x1037", 1, 1000, 1037, 128), ("d64_8x4096", 8, 4096, 4096, 64),
               ("odd_d96_2x1000x1037", 2, 1000, 1037, 96)]
        for label, P, N, M, D in big:
            result["shapes"][label] = check_shape(label, P, N, M, D, device, gen, args.reps, True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "knn2_check.json").write_text(json.dumps(result, indent=1))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
