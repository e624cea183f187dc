"""Runs ``chip_smoke.py``'s phases 3 (the benchmark's cube solved on the
card) and 4 (``calibrate`` with the depth camera on the rendered
three-sensor workspace) and its kernel phases 3c-3g (the Schur matvec, the
row blocks, the assembly, the CG solve and step, the LM step, each against
its plain version and timed on the first systems of phases 3 and 4) in
this checkout and in another (``--parent``, e.g. a parent commit unpacked
with ``git archive`` into a gitignored directory), on one card, in turns:
parent, change, change, parent, each run a process of its own that builds
its kernels first. Prints each run's phase lines as they come and, last,
one JSON object: per run, the kernels' times (eager and from a CUDA graph)
by phase and system.

    python3 scripts/torch_phase3_compare.py --parent DIR [--phases 3c 3d 3e 3f 3g]
        [--out chiprun_out/compare]

Each run's whole output is kept under ``--out`` (``<tag>.log``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PHASES = ("3c", "3d", "3e", "3f", "3g")
# the numbers kept from each phase's record: by system (and, for 3f, by part)
KEYS = ("ms", "kernel_graph_ms", "sel_ms", "sel_graph_ms", "plain_ms", "bound_ms")


def worker(root: str, phases) -> int:
    """One run in checkout ``root``: build, phases 3 and 4 (under the smoke's
    spies), then the kernel phases; the last line the records (JSON)."""
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_phase3_compare.py: no CUDA device")
    import chip_smoke as cs
    from multiview_tpu_torch.sfm import matching as mm
    from multiview_tpu_torch.utils import cuda_build

    card = cs.card_line()
    t0 = time.perf_counter()
    cuda_build.build_libraries(["knn2_wgmma.cu", "knn2.cu", "schur_mv.cu", "row_blocks.cu",
                                "lm_assembly.cu", "cg_step.cu", "lm_step.cu"])
    print(f"[compare] {root}: built in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    p3 = cs.phase3(torch, card)
    with tempfile.TemporaryDirectory(prefix="mv_compare_") as tmp:
        rig_true = cs.render_workspaces(Path(tmp))
        cs.phase4(torch, mm, card, Path(tmp), rig_true)
    records = {}
    for ph in phases:
        fn = getattr(cs, f"phase{ph}")
        got = fn(torch, card, p3) if ph == "3g" else fn(torch, card)
        records[ph] = {}
        for system, rec in got.items():
            if not isinstance(rec, dict):
                continue
            parts = rec if ph == "3f" else {"": rec}
            if ph == "3d":
                parts = {k: v for k, v in rec.items() if isinstance(v, dict)} \
                    if system == "families" else {}
            for part, r in parts.items():
                if isinstance(r, dict) and "ms" in r:
                    records[ph][f"{system} {part}".strip()] = {k: r.get(k) for k in KEYS}
    print(json.dumps({"root": root, "card": card, "records": records}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--phases", nargs="+", default=list(PHASES), choices=PHASES)
    ap.add_argument("--out", default="chiprun_out/compare")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.phases)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    roots = {"parent": str(Path(args.parent).resolve()), "change": str(HERE.parent)}
    summary, failed = {}, 0
    for i, tag in enumerate(("parent", "change", "change", "parent")):
        name = f"{tag}{1 + i // 2}"
        log = out / f"{name}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, __file__, "--parent", args.parent,
                                     "--worker", roots[tag], "--phases", *args.phases],
                                    cwd=roots[tag], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            last = ""
            for line in proc.stdout:
                f.write(line)
                if line.startswith(("[phase3", "[phase4]", "[compare]")):
                    print(f"{name}: {line}", end="", flush=True)
                if line.strip():
                    last = line
            rc = proc.wait()
        print(f"== {name} ({roots[tag]}) rc={rc} {time.perf_counter() - t0:.1f} s", flush=True)
        failed += rc != 0
        try:
            summary[name] = json.loads(last)["records"]
        except (ValueError, KeyError):
            summary[name] = None
    print(json.dumps(summary))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
