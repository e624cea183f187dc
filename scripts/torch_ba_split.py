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

``--split`` then splits the LM loop (``_solve`` of ``solver/schur.py``,
CG included) into its parts: a line tracer on that one function
synchronises the card at each of its lines and adds the time since the
previous line to that line's part, so each part holds its host time and
its device time, serialised (a traced solve is slower than an untraced
one, both are printed). The parts are found in the function's source by
the statements that begin them, so the same split runs on an older
checkout: the row blocks (``blocks_at``, once before the loop and once an
iteration), the assembly (since ``solver/assembly.py``: one call for the
gradient, Hpp, the Jacobi diagonal, Hpp^-1 and the SCHUR_JACOBI inverses;
before it the gradient J^T r, the Hpp and Jacobi-diagonal assembly,
``inv3x3_spd``, the SCHUR_JACOBI blocks and their ``torch.linalg.inv``, each
a part of its own), the CG's set-up (the Schur system and its right-hand
side), the CG (``cg.pcg`` since ``solver/cg.py``, the closure ``pcg``
before), the back-substitution, since ``solver/cg_solve.py`` the CG solve
of one shard (``cg_solve.solve``: the right-hand side, the CG and the
back-substitution's product in one launch on the card, and since the
solve writes it in its tail the trial point too), since
``solver/lm_step.py`` the trial point (``lm_step.trial``; on one shard of
``cg_blocks`` it launches nothing since the CG solve writes it), the row blocks
at it (``rows_trial`` on the card; ``rows_at`` since the current and trial
halves) and the accept (``lm_step.accept``: the
model reduction, the accept, lam and the counts), the host's read of the
stop test (``lm_step.read``; ``assembly.stop_test`` before), and the LM
bookkeeping (every other line). A part's statement that spans several
lines is the part's on all of them.
Medians over ``--reps`` traced solves, in ms a solve and a LM iteration.

``--ops`` counts the ATen operations each part runs per LM iteration
(a ``TorchDispatchMode`` over untraced solves of ``--lm`` and ``2 --lm``
iterations, each operation given to the line of the LM loop running when
it was dispatched; the difference over ``--lm``): on the card the eager
operations around the kernels, each a launch or an allocation or a view.

    python3 scripts/torch_ba_split.py [--root DIR] [--reps 5] [--lm 4] [--split] [--ops]

``--root`` imports ``multiview_tpu_torch`` from another checkout (a parent
commit unpacked beside this one), so two versions can be split in one call.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# (the statement that begins a part of the LM loop, the part); a part ends
# where the next begins; "until" parts end after the named statement
PARTS = [("blocks_at(", "row blocks"), ("rows_now(", "row blocks"),
         ("rows_trial(", "row blocks"), ("rows_at(", "row blocks"),
         ("lm_step.trial(", "trial point (lm_step.trial)"),
         ("lm_step.accept(", "accept (lm_step.accept)"),
         ("stop_test(", "stop test (host read)"), ("lm_step.read(", "stop test (host read)"),
         ("assembly.assemble(", "assembly (solver/assembly.py)"),
         ("gc_raw, g_p = JTc(r), JTp(r)", "gradient (J^T r)"),
         ("hpp_parts, diag_parts", "Hpp and Jacobi diagonal"),
         ("inv3x3_spd(", "inv3x3_spd"),
         ("if use_block_precond:", "SCHUR_JACOBI blocks"),
         ("torch.linalg.inv(", "SCHUR_JACOBI torch.linalg.inv"),
         ("smv.SchurSystem(", "CG set-up"), ("smv.schur_rhs(", "CG set-up"),
         ("= pcg(", "CG"), ("= cg.pcg(", "CG"), ("= dense_schur_solve(", "CG"),
         ("row_products(", "back-substitution"),
         ("cg_solve.solve(", "CG solve (right-hand side, CG, back-substitution, trial point)")]
ONE_LINE = {"row blocks", "assembly (solver/assembly.py)", "gradient (J^T r)",
            "inv3x3_spd", "trial point (lm_step.trial)", "accept (lm_step.accept)",
            "stop test (host read)",
            "SCHUR_JACOBI torch.linalg.inv", "CG set-up", "CG", "back-substitution",
            "CG solve (right-hand side, CG, back-substitution, trial point)"}
BOOKKEEPING = "LM bookkeeping"


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


def solve_code(schur):
    """The code object of the LM loop (``_solve``, nested in
    ``make_schur_solver``) and its lines' parts {line number: part}."""
    code = next(c for c in schur.make_schur_solver.__code__.co_consts
                if inspect.iscode(c) and c.co_name == "_solve")
    lines, first = inspect.getsourcelines(code)
    parts, current, open_part, depth = {}, BOOKKEEPING, None, 0
    for i, text in enumerate(lines):
        if open_part is not None:
            # the rest of a one-line part's statement
            parts[first + i] = open_part
            depth += text.count("(") - text.count(")")
            open_part = open_part if depth > 0 else None
            continue
        hit = next((part for marker, part in PARTS
                    if marker in text and not text.lstrip().startswith("def ")), None)
        if hit is not None and hit not in ONE_LINE:
            current = hit
        parts[first + i] = hit if hit in ONE_LINE else current
        if hit in ONE_LINE:
            depth = text.count("(") - text.count(")")
            open_part = hit if depth > 0 else None
        if hit in ("inv3x3_spd", "SCHUR_JACOBI torch.linalg.inv"):
            current = BOOKKEEPING
    return code, parts


def traced_solve(torch, schur, solver, cam0, points0):
    """(ms by part, traced wall s) of one solve, the card synchronised at
    each line of the LM loop."""
    code, parts = solve_code(schur)
    spent = collections.defaultdict(float)
    last = [None, 0.0]

    def on_line(frame, event, arg):
        if event in ("line", "return"):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if last[0] is not None:
                spent[parts.get(last[0], BOOKKEEPING)] += (now - last[1]) * 1e3
            last[0], last[1] = (frame.f_lineno if event == "line" else None), now
        return on_line

    def on_call(frame, event, arg):
        return on_line if frame.f_code is code else None

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys.settrace(on_call)
    try:
        solver(cam0, points0)
    finally:
        sys.settrace(None)
    torch.cuda.synchronize()
    return dict(spent), time.perf_counter() - t0


def counted_ops(torch, schur, solver, cam0, points0):
    """{part: ATen operations} of one untraced solve: a line tracer on the
    LM loop keeps the part of the line running (no synchronise), and a
    ``TorchDispatchMode`` gives each operation to it (those before the
    loop's first line to the set-up)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    code, parts = solve_code(schur)
    where = ["set-up"]
    counts = collections.Counter()

    def on_line(frame, event, arg):
        if event == "line":
            where[0] = parts.get(frame.f_lineno, BOOKKEEPING)
        return on_line

    def on_call(frame, event, arg):
        return on_line if frame.f_code is code else None

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[where[0]] += 1
            return func(*args, **(kwargs or {}))

    sys.settrace(on_call)
    try:
        with Count():
            solver(cam0, points0)
            torch.cuda.synchronize()
    finally:
        sys.settrace(None)
    return dict(counts)


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
    ap.add_argument("--split", action="store_true",
                    help="also split the LM loop into its parts (a traced solve)")
    ap.add_argument("--ops", action="store_true",
                    help="also count the ATen operations of each part per LM iteration")
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
                                           **{"debug_unroll_lm": args.lm, **kw, **extra})

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
        if args.split:
            s = solver()
            traced_solve(torch, schur, s, cam0, st.points)          # warm
            runs = [traced_solve(torch, schur, s, cam0, st.points) for _ in range(args.reps)]
            names = sorted({k for ms, _ in runs for k in ms})
            per_solve = {k: statistics.median(ms.get(k, 0.0) for ms, _ in runs) for k in names}
            print(json.dumps({
                "problem": name, "root": args.root, "split": True, "lm_iterations": args.lm,
                "matvecs": res.matvecs, "untraced_solve_s": t,
                "traced_solve_s": statistics.median(w for _, w in runs),
                "ms_per_solve": per_solve,
                "ms_per_lm_iteration": {k: v / args.lm for k, v in per_solve.items()},
                "card": card}), flush=True)
        if args.ops:
            few, many = (counted_ops(torch, schur, solver(debug_unroll_lm=k), cam0, st.points)
                         for k in (args.lm, 2 * args.lm))
            per_it = {k: (many.get(k, 0) - few.get(k, 0)) / args.lm
                      for k in sorted(set(few) | set(many))}
            print(json.dumps({
                "problem": name, "root": args.root, "ops": True,
                "aten_ops_per_lm_iteration": {k: v for k, v in per_it.items() if v},
                "total_per_lm_iteration": sum(per_it.values()),
                "aten_ops_per_solve": {"lm": args.lm, "2lm": 2 * args.lm, "few": few,
                                       "many": many}, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
