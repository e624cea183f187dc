#!/usr/bin/env python3
"""Three probes of the BA's kernels on the card, on the first assembly and CG
solve of the benchmark's cube (``chip_smoke.py``'s ``ba_problem``: 384000
rows, jacobi), of ``calibrate``'s own system (``chip_smoke.py``'s phase 4:
four families, 12 poses, SCHUR_JACOBI) and of the split's rig
(``scripts/torch_ba_split.py``'s ``problems``: 52800 rows of 4 families,
SCHUR_JACOBI):

    python3 scripts/torch_ba_probe.py [--out profile_out/probe] [--parent DIR]
        [--skip_ablate] [--skip_drift]

- ``--parent DIR``, where DIR holds the parent commit's tree (``git archive
  <commit> | tar -x -C DIR``): the parent's assembly kernel against this
  tree's on the cube and on calibrate's system, in turns (parent, change,
  change, parent): ms eager (the parent through its own wrapper, the change
  through an ``AssemblyPlan``) and from a CUDA graph, and each pass's time
  from %globaltimer stamps. The parent's kernel has no stamps of its own: a
  copy of its source gets them at its grid barriers (the same places as
  this tree's ``marks``), built with the package's nvcc flags into ``--out``
  and launched through the parent's own ``solver/assembly.py``;
- ablations of this tree's assembly (``csrc/lm_assembly.cu``): copies of
  the source with one part of the rows pass cut out (the points' float64
  atomics, the point arithmetic, the camera arithmetic) or of the blocks
  pass (its sums into the pose blocks, its arithmetic; each part kept from
  being compiled away by a data-dependent test that never holds), each timed from
  a CUDA graph through an ``AssemblyPlan`` with its passes' stamps
  (``RECORD_MARKS``): what each part costs. The copies are made by exact
  text replacement, so an edit to one of the replaced lines makes the probe
  raise, naming the variant;
- the float64 CG by steps on the cube and the split's rig: after 1, 2, 3,
  5, 10, 20, 30 forced steps, the one-launch solve (``cg_solve.solve_cuda``)
  against the plain solve, against a second run of itself, and the per-step
  path (``schur_mv.cu``'s matvecs, ``cg_step.cu``'s steps) against both,
  with the path's preconditioner and with Jacobi: max |diff| / max |plain|.
  Two runs of one kernel differ by the order of its atomics; the steps show
  how CG amplifies that.

Prints one line a measurement, each with the card's name and power limit."""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import statistics
import subprocess
import sys
import tempfile
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (variant, [(text of csrc/lm_assembly.cu, its replacement)])
VARIANTS = [
    ("as it is", []),
    ("without the points' atomics", [
        ("for (int j = 0; j < 3; ++j) atomicAdd(gp + key * 3 + j, v[j]);",
         "for (int j = 0; j < 3; ++j) if (v[j] == 1.25e300) atomicAdd(gp + key * 3 + j, v[j]);"),
        ("for (int j = 0; j < 6; ++j) atomicAdd(hpp + key * 6 + j, v[3 + j]);",
         "for (int j = 0; j < 6; ++j) if (v[3 + j] == 1.25e300) "
         "atomicAdd(hpp + key * 6 + j, v[3 + j]);")]),
    ("without the point arithmetic", [
        ("    if (f.j_pt) {\n      double v[9];",
         "    if (f.j_pt && rr[0] == 1.25e300) {\n      double v[9];")]),
    ("without the camera arithmetic", [
        ("    if (f.j_cam) {\n      const T* J = s.jc + (valid ? row : 0) * K * b;\n"
         "      const long long kb",
         "    if (f.j_cam && rr[0] == 1.25e300) {\n"
         "      const T* J = s.jc + (valid ? row : 0) * K * b;\n      const long long kb")]),
    ("without the blocks pass's sums", [
        ("    add_keyed<kBlock>(kb, bb, blk);",
         "    if (bb[0] == 1.25e300) add_keyed<kBlock>(kb, bb, blk);"),
        ("    add_keyed<kBlock>(valid && !merged ? ke : -1ll, bb, blk);",
         "    if (bb[0] == 1.25e300) add_keyed<kBlock>(valid && !merged ? ke : -1ll, bb, blk);")]),
    ("without the blocks pass's arithmetic", [
        ("    if (valid) side_block<K>(J, b, 0, kb, p.cf, pt, Jp, H, bb);",
         "    if (valid && H[0] == 1.25e300) side_block<K>(J, b, 0, kb, p.cf, pt, Jp, H, bb);"),
        ("    if (merged) side_block<K>(J, b, 1, ke, p.cf, pt, Jp, H, bb);",
         "    if (merged && H[0] == 1.25e300) side_block<K>(J, b, 1, ke, p.cf, pt, Jp, H, bb);"),
        ("    if (valid && !merged) side_block<K>(J, b, 1, ke, p.cf, pt, Jp, H, bb);",
         "    if (valid && !merged && H[0] == 1.25e300) "
         "side_block<K>(J, b, 1, ke, p.cf, pt, Jp, H, bb);")]),
]

# %globaltimer stamps for the parent's assembly kernel (thread 0 of a block,
# as this tree's ``marks``): its start, the end of the zeroing phase and of
# each pass, before the grid barrier that follows it
_PARENT_MARKS = 6
_PARENT_GRID = 4096
_PARENT_STAMPS = [
    ("template <typename T>\n__global__ void __launch_bounds__(kThreads, 1) assembly_kernel(",
     f"__device__ long long g_probe_marks[{_PARENT_GRID * _PARENT_MARKS}];\n"
     "__device__ __forceinline__ void probe_mark(int i) {\n"
     f"  if (threadIdx.x == 0 && blockIdx.x < {_PARENT_GRID}) {{\n"
     "    long long t;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     f"    g_probe_marks[blockIdx.x * {_PARENT_MARKS} + i] = t;\n"
     "  }\n}\n\n"
     "template <typename T>\n__global__ void __launch_bounds__(kThreads, 1) assembly_kernel("),
    ("             poses = p.passes & kPoses;\n\n  // phase 0",
     "             poses = p.passes & kPoses;\n  probe_mark(0);\n\n  // phase 0"),
    ("  if (rows || blocks) grid.sync();\n\n  if (rows) {",
     "  probe_mark(1);\n  if (rows || blocks) grid.sync();\n\n  if (rows) {"),
    ("    if (p.cam_copies) flush_copies(smem, size, p.acc);\n"
     "    if (points || blocks || poses) grid.sync();",
     "    if (p.cam_copies) flush_copies(smem, size, p.acc);\n    probe_mark(2);\n"
     "    if (points || blocks || poses) grid.sync();"),
    ("    if (blocks || poses) grid.sync();\n  }\n\n  if (blocks) {",
     "    probe_mark(3);\n    if (blocks || poses) grid.sync();\n  }\n\n  if (blocks) {"),
    ("    if (p.block_copies) flush_copies(smem, size, p.blocks);\n    if (poses) grid.sync();",
     "    if (p.block_copies) flush_copies(smem, size, p.blocks);\n    probe_mark(4);\n"
     "    if (poses) grid.sync();"),
    ("          p.pose_inv[r * 49 + i * 7 + j] = static_cast<T>(ok ? inv[i][j] : 0.0);\n"
     "    }\n  }\n}",
     "          p.pose_inv[r * 49 + i * 7 + j] = static_cast<T>(ok ? inv[i][j] : 0.0);\n"
     "    }\n    probe_mark(5);\n  }\n}"),
]
_PARENT_READ = (
    "\nextern \"C\" int probe_marks(long long* out, long long n) {\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_probe_marks, n * sizeof(long long)));\n"
    "}\n")


def edited(src: str, edits, name: str) -> str:
    """``src`` with each (old, new) replaced; raises unless every old is in it once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:40]!r} is not in the source once")
        src = src.replace(old, new)
    return src


def build(sources: dict, out: Path, include: Path) -> dict:
    """{name: ctypes library} of each {name: CUDA source text}, one nvcc each,
    started together, with the package's flags."""
    from multiview_tpu_torch.utils import cuda_build
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        (out / f"assembly_{i}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(include), "-o",
             str(out / f"assembly_{i}.so"), str(out / f"assembly_{i}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name!r} did not build:\n{report[-3000:]}")
        libs[name] = ctypes.CDLL(str(out / f"assembly_{i}.so"))
    return libs


def bind(module, lib):
    """``lib``, given by the module's own ``_lib`` the argtypes it gives the
    package's build (``module._lib`` then returns it; ``module._unbound_lib``
    keeps the module's own, so that a second ``bind`` binds its lib too)."""
    own = module.__dict__.setdefault("_unbound_lib", module._lib)
    real = module.cuda_build
    module.cuda_build = types.SimpleNamespace(load_library=lambda _name: lib)
    try:
        bound = own()
    finally:
        module.cuda_build = real
    module._lib = lambda: bound
    return bound


def parent_passes_us(marks, grid: int, passes: int):
    """{pass: us} from the parent kernel's stamps, read as
    ``chip_smoke.pass_times_us`` reads this tree's (the zeroing phase a pass
    of its own)."""
    m = marks[:grid]
    names = [("zero", 1), ("rows", 2), ("points", 3)] + \
        ([("blocks", 4), ("poses", 5)] if passes & 4 else [])
    out = {"block_start_spread": (int(m[:, 0].max()) - int(m[:, 0].min())) / 1e3}
    last = int(m[:, 0].min())
    for n, c in names:
        end = int(m[:, c].max())
        out[n] = (end - last) / 1e3
        last = end
    return out


def median_passes(runs):
    return {k: round(statistics.median(r[k] for r in runs), 1) for k in runs[0]}


def rel(a, b):
    return float((a.double() - b.double()).abs().max()) / float(b.double().abs().max())


def compare_parent(torch, cs, asm, parent_dir: Path, out: Path, card: str, labels):
    """The parent's assembly kernel against this tree's, in turns."""
    psrc = parent_dir / "multiview_tpu_torch"
    spec = importlib.util.spec_from_file_location("parent_assembly",
                                                  psrc / "solver" / "assembly.py")
    pasm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pasm)
    text = edited((psrc / "csrc" / "lm_assembly.cu").read_text(), _PARENT_STAMPS,
                  "the parent's stamps") + _PARENT_READ
    lib = bind(pasm, build({"parent": text}, out / "parent", psrc / "csrc")["parent"])
    lib.probe_marks.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.probe_marks.restype = ctypes.c_int
    n_marks = _PARENT_GRID * _PARENT_MARKS

    def parent_marks():
        torch.cuda.synchronize()
        host = (ctypes.c_longlong * n_marks)()
        if lib.probe_marks(host, n_marks) != 0:
            raise RuntimeError("the parent's stamps could not be read")
        return torch.tensor(list(host), dtype=torch.int64).reshape(_PARENT_GRID, _PARENT_MARKS)

    for label in labels:
        call = cs.ASM_CALLS[label][:9]
        dev = call[4].device
        flag = pasm.new_flag(dev)
        plan = asm.AssemblyPlan()
        runs = {"parent": lambda: pasm.assemble_cuda(*call, flag),
                "change": lambda: plan(*call)}
        got = {k: fn() for k, fn in runs.items()}
        diff = {k: rel(getattr(got["change"], k), getattr(got["parent"], k))
                for k in got["parent"]._fields
                if getattr(got["parent"], k) is not None and getattr(got["change"], k, None)
                is not None}
        stamps = {"parent": [], "change": []}
        for _ in range(5):
            pasm.RECORD_LAUNCH = True
            try:
                runs["parent"]()
            finally:
                pasm.RECORD_LAUNCH = False
            grid, passes = pasm.LAST_LAUNCH["grid"], pasm.LAST_LAUNCH["passes"]
            stamps["parent"].append(parent_passes_us(parent_marks(), grid, passes))
            asm.RECORD_LAUNCH = asm.RECORD_MARKS = True
            try:
                runs["change"]()
                torch.cuda.synchronize()
            finally:
                asm.RECORD_LAUNCH = asm.RECORD_MARKS = False
            stamps["change"].append(cs.pass_times_us(asm.LAST_MARKS, asm.LAST_LAUNCH["grid"],
                                                     asm.LAST_LAUNCH["passes"]))
        timed = [(f"{k} eager", fn) for k, fn in runs.items()] + \
            [(f"{k} from a CUDA graph", cs.graphed(torch, fn)) for k, fn in runs.items()]
        ms = {}
        for key, fn in timed + timed[::-1]:          # parent, change, change, parent
            t = min(cs.per_call_ms(torch, fn, reps=50) for _ in range(3))
            ms[key] = min(ms.get(key, t), t)
        print(f"[parent] {label}: ms an assembly "
              f"{ {k: round(v, 4) for k, v in ms.items()} }; us a pass (median of 5 eager "
              f"launches) parent {median_passes(stamps['parent'])}, change "
              f"{median_passes(stamps['change'])}; parent grid {pasm.LAST_LAUNCH['grid']}, "
              f"change grid {asm.LAST_LAUNCH['grid']}; change against parent, max |diff| / max "
              f"|parent| {({k: float(f'{v:.3g}') for k, v in diff.items()})} [{card}]",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profile_out/probe")
    ap.add_argument("--parent", default=None,
                    help="a directory holding the parent commit's tree")
    ap.add_argument("--skip_ablate", action="store_true")
    ap.add_argument("--skip_drift", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_ba_probe.py: no CUDA device")
    import chip_smoke as cs
    import torch_ba_split as split
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.sfm import matching as mm
    from multiview_tpu_torch.solver import assembly as asm, cg, cg_solve, schur
    from multiview_tpu_torch.solver import schur_matvec as smv
    from multiview_tpu_torch.utils import cuda_build

    card = cs.card_line()
    cuda_build.build_libraries(["knn2_wgmma.cu", "knn2.cu", "schur_mv.cu", "row_blocks.cu",
                                "lm_assembly.cu", "cg_step.cu"])
    dev = torch.device("cuda", 0)
    scene, state0, make = cs.ba_problem(torch, dev, 160, 20)
    with cs.first_assembly_and_cg("cube"):
        make()(prob.pack_state(state0, include_points=False), state0.points)
    with tempfile.TemporaryDirectory(prefix="mv_ba_probe_") as tmp:
        # phase 4 keeps calibrate's first assembly and CG solve under "rig"
        cs.phase4(torch, mm, card, Path(tmp), cs.render_workspaces(Path(tmp)))
    for calls in (cs.ASM_CALLS, cs.SOLVE_CALLS):
        calls["calibrate"] = calls.pop("rig")
    _, st, sc, mask, opts, kw = list(split.problems(torch, dev))[1]
    with cs.first_assembly_and_cg("rig"):
        schur.make_schur_solver(st, sc.observations, sc.models, opts, mask, max_iterations=2,
                                **kw)(prob.pack_state(st, include_points=False), st.points)
    torch.cuda.synchronize()

    if args.parent:
        compare_parent(torch, cs, asm, Path(args.parent), Path(args.out), card,
                       ("cube", "calibrate"))

    if not args.skip_ablate:
        src = (cuda_build.CSRC_DIR / "lm_assembly.cu").read_text()
        libs = build({name: edited(src, edits, f"variant {name!r}") for name, edits in VARIANTS},
                     Path(args.out) / "ablate", cuda_build.CSRC_DIR)
        original = asm._lib
        try:
            for label in ("cube", "calibrate", "rig"):
                call = cs.ASM_CALLS[label][:9]
                for name, lib in libs.items():
                    bind(asm, lib)
                    plan = asm.AssemblyPlan()
                    for _ in range(3):
                        plan(*call)
                    torch.cuda.synchronize()
                    asm.RECORD_LAUNCH = asm.RECORD_MARKS = True
                    try:
                        plan(*call)
                        torch.cuda.synchronize()
                    finally:
                        asm.RECORD_LAUNCH = asm.RECORD_MARKS = False
                    passes = cs.pass_times_us(asm.LAST_MARKS, asm.LAST_LAUNCH["grid"],
                                              asm.LAST_LAUNCH["passes"])
                    replay = cs.graphed(torch, lambda: plan(*call))
                    ms = min(cs.per_call_ms(torch, replay, reps=50) for _ in range(3))
                    print(f"[ablate] {label}, {name}: {ms * 1e3:.1f} us an assembly from a CUDA "
                          f"graph; us a pass {({k: round(v, 1) for k, v in passes.items()})} "
                          f"[{card}]", flush=True)
        finally:
            asm._lib = original
            del asm._unbound_lib

    if not args.skip_drift:
        for label in ("rig", "cube"):
            system, g_c, g_p, M, iterations, tolerance = cs.SOLVE_CALLS[label][:6]
            s64 = dataclasses.replace(system, J=cs.in64(torch, system.J),
                                      cam_free=system.cam_free.double(), dc=system.dc.double(),
                                      hpp_inv=system.hpp_inv.double(), _plans=None)
            M64, gc64, gp64 = cs.in64(torch, M), g_c.double(), g_p.double()
            for pre, m in (("the path's preconditioner", M64),
                           ("jacobi", cg.Preconditioner(M64.precond))):
                rows = []
                for k in (1, 2, 3, 5, 10, 20, 30):
                    f1 = cg_solve.solve_cuda(s64, gc64, gp64, m, iterations, tolerance, k).x
                    f2 = cg_solve.solve_cuda(s64, gc64, gp64, m, iterations, tolerance, k).x
                    plain = cg_solve.solve_plain(s64, gc64, gp64, m, iterations, tolerance, 1,
                                                 k).x
                    rhs = smv.schur_rhs_cuda(s64, gc64, gp64)
                    steps, _ = cg.pcg_cuda(lambda v: smv.schur_matvec_cuda(s64, v), m, rhs,
                                           iterations, tolerance, 2, k)
                    rows.append((k, rel(f1, plain), rel(f1, f2), rel(steps, plain),
                                 rel(steps, f1)))
                print(f"[drift] {label}, float64, {pre}: (steps, solve-plain, solve-solve, "
                      f"per-step-plain, per-step-solve) "
                      + " ".join(f"({k} {a:.2g} {b:.2g} {c:.2g} {d:.2g})"
                                 for k, a, b, c, d in rows) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
