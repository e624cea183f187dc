#!/usr/bin/env python3
"""Check and time the descriptor matcher of multiview_tpu_torch on one
NVIDIA GPU, in this checkout or in several (a parent commit unpacked with
``git archive`` into a gitignored directory beside it).

    python3 scripts/torch_knn2_check.py [--trees DIR ...] [--shapes LABEL ...]
        [--reps 7] [--quick] [--out DIR]

Each tree named by ``--trees`` (default: this checkout) runs in a process
of its own, in the order given (``--trees P . . P`` for parent, change,
change, parent), and builds its csrc/knn2_wgmma.cu and csrc/knn2.cu (the
ptxas reports are printed). A run

1. probes the tensor-core kernel's shared-memory layout: one-hot queries
   and train rows, for which the best index of row i must be i whatever the
   rounding (a wrong layout shows as a permutation), at D = 64 and 128 and,
   where the tree takes them, 160 and 256;
2. at each shape (``SHAPES``, the shapes of ``chip_smoke.py``'s phase 1;
   the ragged ones with planted exact duplicates and near-ties): the wrapper
   ``knn2_cuda`` against ``knn2_plain``, ``knn2_split_plain``, the FMA
   kernel and a float64 reference (index mismatches on decided rows, largest
   and mean signed distance error, ratio-mask agreement), the kernels it
   launched (counters), the median time over distinct inputs of the
   wrapper, the FMA kernel, the plain version and the product
   ``torch.matmul`` alone (in turns, the better of two), the device kernels
   of one call (torch.profiler: their count and time each) and, where the
   tree's tensor-core kernel takes the shape, the in-kernel clock counters:
   the share of a consumer warpgroup's cycles in each part
   (``matching.CLOCK_PARTS``);
3. prints the TF32 bound, the 3xTF32 floor (three products on the tensor
   cores) and the byte bound of each shape beside the times, with the
   card's name and power limit.

``--quick`` keeps to the correctness part of the small shapes. With several
trees the last line is one JSON object {tree tag: {shape: record}}; each
tree's whole output goes to DIR/<tag>.log and its records to
DIR/knn2_check.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# label, pairs, N, M, D (chip_smoke.py phase 1, and the one-tile probe)
SHAPES = [("main_path_8x4096", 8, 4096, 4096, 128), ("10k", 1, 10000, 10000, 128),
          ("ragged_1000x1037", 1, 1000, 1037, 128), ("d64_4x2048x2000", 4, 2048, 2000, 64),
          ("odd_d96_ragged", 2, 1000, 1037, 96), ("odd_path_d96", 7, 1000, 1000, 96),
          ("cli_default_8x1000", 8, 1000, 1000, 128), ("d256_2x2048x2000", 2, 2048, 2000, 256),
          ("odd_d160_ragged", 1, 1000, 1037, 160)]
SMALL = [("one_tile", 1, 64, 64, 128), ("ragged_small", 1, 300, 517, 128),
         ("ragged_d64_small", 3, 200, 1037, 64), ("odd_d96_small", 2, 333, 517, 96),
         ("odd_d72_small", 2, 333, 517, 72), ("d256_small", 1, 300, 517, 256),
         ("d16_small", 2, 200, 300, 16), ("d300_small", 1, 300, 517, 300)]
# what a parent tree without matching.CLOCK_PARTS counts
PARENT_CLOCK_PARTS = ("waiting for a tile", "wgmma chains", "top-2 fold", "whole sweep")


def takes(mm, d: int) -> bool:
    """Whether the tree's tensor-core wrapper takes width ``d`` unpadded."""
    dims = getattr(mm, "WGMMA_DIMS", None)
    return dims is None or d in dims


def layout_probe(torch, mm, device):
    ok = True
    for d in (64, 128, 160, 256):
        if not takes(mm, d):
            continue
        # 64 distinct one-hot rows need 64 columns: the last window ends at d
        for shift in sorted({*range(0, d - 63, 64), d - 64}):
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


def make_inputs(torch, cs, gen, label, P, N, M, D, device, count):
    inputs = []
    for _ in range(count):
        q = cs.descriptors(gen, P, N, D, device)
        t = cs.descriptors(gen, P, M, D, device)
        if label.startswith(("ragged", "odd_d160")):
            t[0, 10] = q[0, 3]                      # exact duplicates: second == best
            t[0, 900 % M] = q[0, 3]
            t[0, 500 % M] = q[0, 7]
            for row in (21, M - 1):                 # a near-tie pair
                near = q[0, 20] + 1e-4 * torch.randn(D, generator=gen, device=device)
                t[0, row] = near / near.norm()
        inputs.append((q.contiguous(), t.contiguous()))
    return inputs


def check_shape(torch, cs, mm, label, P, N, M, D, device, gen, reps, time_it):
    inputs = make_inputs(torch, cs, gen, label, P, N, M, D, device, reps if time_it else 1)
    q, t = inputs[0]
    before = (mm.WGMMA_LAUNCHES, mm.FMA_LAUNCHES)
    got = mm.knn2_cuda(q, t)
    torch.cuda.synchronize()
    rec = {"shape": [P, N, M, D], "kernel": mm.kernel_for(D),
           "counted": [mm.WGMMA_LAUNCHES - before[0], mm.FMA_LAUNCHES - before[1]]}
    refs = {"plain": mm.knn2_plain(q, t), "split_plain": mm.knn2_split_plain(q, t),
            "fma": mm.knn2_cuda_fma(q, t)}
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
    if label.startswith(("ragged", "odd_d160")):
        rec["duplicate_row3"] = [int(got.best_idx[0, 3]), float(got.best_dist[0, 3]),
                                 float(got.second_dist[0, 3])]
    if time_it:
        product = lambda a, b: torch.matmul(a, b.transpose(-1, -2))  # noqa: E731
        order = [("ms", mm.knn2_cuda), ("fma_ms", mm.knn2_cuda_fma),
                 ("plain_ms", mm.knn2_plain), ("library_ms", product)]
        for name, fn in order + order[::-1]:          # each twice, in turns
            ms = cs.median_ms(torch, fn, inputs)
            rec[name] = min(rec.get(name, ms), ms)
        flop = 2.0 * P * N * M * D
        nbytes = 4.0 * P * (N + M) * D + 12.0 * P * N
        rec["bound_ms"] = {"tf32": flop / cs.TF32_PEAK * 1e3,
                           "3xtf32_floor": 3 * flop / cs.TF32_PEAK * 1e3,
                           "fp32_cuda_cores": flop / cs.FP32_CORES_PEAK * 1e3,
                           "memory": nbytes / cs.MEM_PEAK * 1e3}
        rec["share_of_bound"] = max(rec["bound_ms"]["tf32"], rec["bound_ms"]["memory"]) / rec["ms"]
        # host time to issue one call (no wait for the device), the mean of 20
        for name, fn in (("host_us", mm.knn2_cuda), ("library_host_us", product)):
            torch.cuda.synchronize()
            t_host = 0.0
            for _ in range(20):
                t_start = time.perf_counter()
                fn(q, t)
                t_host += time.perf_counter() - t_start
                torch.cuda.synchronize()
            rec[name] = t_host / 20 * 1e6
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            mm.knn2_cuda(q, t)
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if getattr(ev, "device_type", None) is not None
                  and str(ev.device_type).endswith("CUDA")]
        rec["device_kernels_a_call"] = len(events)
        rec["device_us_by_kernel"] = {
            k.key[:48]: round(getattr(k, "device_time_total", 0.0) or
                              getattr(k, "cuda_time_total", 0.0), 2)
            for k in prof.key_averages()
            if (getattr(k, "device_time_total", 0.0) or getattr(k, "cuda_time_total", 0.0))}
    if takes(mm, D) and (time_it or label == "one_tile"):
        clocks = []
        mm.knn2_cuda_wgmma(q, t, clocks=clocks)
        torch.cuda.synchronize()
        parts = getattr(mm, "CLOCK_PARTS", PARENT_CLOCK_PARTS)
        by_wg = clocks[0].double().reshape(-1, clocks[0].shape[-2], len(parts)).mean(dim=0)
        c = by_wg.mean(dim=0)
        rec["clocks_a_warpgroup"] = {name: float(c[i]) for i, name in enumerate(parts)}
        rec["clocks_by_warpgroup"] = [{name: float(w[i]) for i, name in enumerate(parts)}
                                      for w in by_wg]
        rec["clock_share"] = {name: float(c[i] / c[-1]) for i, name in enumerate(parts[:-1])}
        rec["clock_blocks"] = int(clocks[0].shape[0])
    print(f"[check] {label}: {json.dumps(rec)}", flush=True)
    return rec


def host_breakdown(torch, mm, device, calls=200):
    """Host microseconds a call of the pieces of a small call (1 x 1000 x
    1037 x 160), each the mean of `calls` calls with no wait for the card."""
    gen = torch.Generator(device=device).manual_seed(3)
    q = torch.rand((1000, 160), generator=gen, device=device)
    t = torch.rand((1037, 160), generator=gen, device=device)
    pieces = {
        "knn2_cuda": lambda: mm.knn2_cuda(q, t),
        "torch.matmul(q, t.T)": lambda: torch.matmul(q, t.transpose(-1, -2)),
        "torch.empty((3, N))": lambda: torch.empty((3, 1000), dtype=torch.float32, device=device),
        "unbind": lambda: torch.empty((3, 1000), device=device).unbind(0),
        "data_ptr": lambda: q.data_ptr(),
        "torch.cuda.current_device": torch.cuda.current_device,
    }
    if hasattr(mm, "_check_pairs"):
        pieces["_check_pairs"] = lambda: mm._check_pairs("x", q, t)
    out = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - start) / calls * 1e6
        torch.cuda.synchronize()
    return out


def worker(root: str, labels, reps: int, quick: bool) -> int:
    """One run in checkout ``root``; the last line its records (JSON)."""
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_knn2_check.py: no CUDA device")
    import chip_smoke as cs
    from multiview_tpu_torch.sfm import matching as mm
    from multiview_tpu_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}; tree {root}",
          flush=True)
    cuda_build.build_libraries(["knn2_wgmma.cu", "knn2.cu"])
    for name, (secs, report) in cuda_build.build_reports.items():
        print(f"[build] {name}: nvcc {secs:.2f} s\n{report}", flush=True)
    result = {"card": card, "tree": root, "shapes": {}}
    if not layout_probe(torch, mm, device):
        raise SystemExit("layout probe failed")
    gen = torch.Generator(device=device).manual_seed(1)
    for label, P, N, M, D in SMALL:
        result["shapes"][label] = check_shape(torch, cs, mm, label, P, N, M, D, device, gen, 1,
                                              False)
    if not quick:
        for label, P, N, M, D in SHAPES:
            if labels and label not in labels:
                continue
            result["shapes"][label] = check_shape(torch, cs, mm, label, P, N, M, D, device, gen,
                                                  reps, True)
    if not quick:
        result["host_breakdown_us"] = host_breakdown(torch, mm, device)
        print(f"[host] {json.dumps(result['host_breakdown_us'])}", flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)],
                    help="checkouts to run, in this order")
    ap.add_argument("--shapes", nargs="*", default=[], help="labels of SHAPES (default all)")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.shapes, args.reps, args.quick)
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    summary, failed, seen = {}, 0, {}
    for tree in args.trees:
        root = str(Path(tree).resolve())
        seen[root] = seen.get(root, 0) + 1
        tag = f"{Path(root).name}{seen[root]}"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", root,
               "--reps", str(args.reps), "--shapes", *args.shapes]
        if args.quick:
            cmd.append("--quick")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if not line.startswith("{"):
                print(f"{tag}: {line}", end="", flush=True)
        rc = proc.wait()
        print(f"== {tag} ({root}) rc={rc} {time.perf_counter() - t0:.1f} s", flush=True)
        failed += rc != 0
        if out:
            (out / f"{tag}.log").write_text("".join(lines))
        try:
            summary[tag] = json.loads(lines[-1])["shapes"]
        except (ValueError, KeyError, IndexError):
            summary[tag] = None
    if out:
        (out / "knn2_check.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({tag: {label: {k: r.get(k) for k in ("ms", "library_ms", "fma_ms",
                                                            "host_us", "device_kernels_a_call")}
                            for label, r in (recs or {}).items() if "ms" in r}
                      for tag, recs in summary.items()}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
