"""The one-launch CG solve of the port's ``cg_blocks`` Schur-LM
(``solver/cg_solve.py``), the assembly's per-solve plan
(``solver/assembly.py::AssemblyPlan``) and the build key of the CUDA
sources (``utils/cuda_build.py``), on the CPU.

- The semantics the kernel implements (CG's stop test at every step, the
  reference's ``cg_cond``): the port's plain solve with its host check
  interval set to 1 against the JAX package's ``while_loop`` solver on the
  scene of ``__graft_entry__`` (one sensor, 8 images, float64): the same LM
  and CG counts, matvecs equal to the CG count, cost and cameras within
  1e-10 (relative and absolute: the two packages' float64 sums in other
  orders).
- The routing: a single-shard ``cg_blocks`` solve makes one call of
  ``cg_solve.solve`` an LM iteration; two logical shards and the ``cg`` /
  ``cg_dense_j`` modes keep the per-step ``cg.pcg``.
- The assembly's plan with a fake launch in place of the kernel's library
  call: its table is checked once a solve, and every LM iteration's launch
  carries that iteration's J and r pointers (new tensors from
  ``torch.where``).
- CPU tensors are refused by both kernel paths, before any build.
- The build key: a source's local headers, followed into the headers they
  include, are hashed with it (no compiler needed)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from multiview_tpu.calib import problem as JPr
from multiview_tpu.solver import schur as JS
from multiview_tpu_torch.calib import problem as TPr
from multiview_tpu_torch.parallel import sharding as sh
from multiview_tpu_torch.solver import assembly as asm, cg, cg_solve, schur as TS
from multiview_tpu_torch.utils import cuda_build
from torch_port_scenes import one_torch_thread, port_problem  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(max_iterations=10, cg_iterations=60, cg_tolerance=1e-2)


def _cube(dtype=jnp.float64):
    """The graft scene and its free mask (cameras and the first focal)."""
    _, cam0, pts0, scene, state0 = graft._build(8, 3, dtype, max_iterations=10)
    mask = JPr.build_mask(state0, JPr.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                          include_points=False)
    return cam0, pts0, scene, state0, mask


def _port_solver(scene, state0, mask, obs=None, **kw):
    st, tobs = port_problem(state0, scene.observations)
    solver = TS.make_schur_solver(st, tobs, scene.models, TPr.BAOptions(no_rig=True), mask,
                                  **{**KW, **kw})
    return solver, st, tobs


def test_the_stop_test_at_every_step_matches_the_reference(monkeypatch):
    cam0, pts0, scene, state0, mask = _cube()
    jres = jax.jit(JS.make_schur_solver(state0, scene.observations, scene.models,
                                        JPr.BAOptions(no_rig=True), mask, **KW))(cam0, pts0)
    monkeypatch.setattr(TS, "CG_CHECK_EVERY", 1)
    solver, st, _ = _port_solver(scene, state0, mask)
    tres = solver(TPr.pack_state(st, include_points=False), st.points)
    assert tres.iterations == int(jres.iterations) > 1
    assert tres.matvecs == int(tres.cg_iters_total) == int(jres.cg_iters_total) > 0
    assert tres.matvecs < KW["cg_iterations"] * tres.iterations // 4
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-10)
    np.testing.assert_allclose(tres.cam.numpy(), np.asarray(jres.cam), rtol=1e-10, atol=1e-10)
    # the host's check interval only masks steps: the same x, count and result
    monkeypatch.setattr(TS, "CG_CHECK_EVERY", 2)
    again = solver(TPr.pack_state(st, include_points=False), st.points)
    assert int(again.cg_iters_total) == int(tres.cg_iters_total) <= again.matvecs
    for a, b in zip(again[:4], tres[:4]):
        assert torch.equal(a, b)


def _count_calls(monkeypatch):
    calls = {"solve": 0, "pcg": 0, "pcg_in_solve": 0}
    solve, pcg = cg_solve.solve, cg.pcg
    inside = []

    def spy_solve(*args):
        calls["solve"] += 1
        inside.append(1)
        try:
            return solve(*args)
        finally:
            inside.pop()

    def spy_pcg(*args):
        calls["pcg_in_solve" if inside else "pcg"] += 1
        return pcg(*args)

    monkeypatch.setattr(cg_solve, "solve", spy_solve)
    monkeypatch.setattr(cg, "pcg", spy_pcg)
    return calls


@pytest.mark.parametrize("path", ["cg_blocks", "two shards", "cg", "cg_dense_j"])
def test_one_solve_call_an_lm_iteration_on_one_shard(monkeypatch, path):
    cam0, pts0, scene, state0, mask = _cube()
    mode = "cg_blocks" if path == "two shards" else path
    solver, st, tobs = _port_solver(scene, state0, mask, max_iterations=3, linear_solver=mode)
    obs = sh.shard_observations(tobs, sh.make_mesh(["cpu"] * 2)) if path == "two shards" \
        else None
    calls = _count_calls(monkeypatch)
    res = solver(TPr.pack_state(st, include_points=False), st.points, obs)
    if path == "cg_blocks":
        assert calls == {"solve": res.iterations, "pcg": 0, "pcg_in_solve": res.iterations}
    else:
        assert calls == {"solve": 0, "pcg": res.iterations, "pcg_in_solve": 0}
    assert float(res.cost) < float(res.initial_cost)


def test_the_assembly_plan_is_checked_once_and_follows_each_iteration(monkeypatch):
    """The LM loop's per-solve plan, driven with the solver's own arguments
    at every iteration, a fake launch recording the table it is handed."""
    cam0, pts0, scene, state0, mask = _cube()
    solver, st, _ = _port_solver(scene, state0, mask, max_iterations=4,
                                 preconditioner="schur_jacobi")
    checks, launches, plans = [], [], set()
    check = asm._check
    monkeypatch.setattr(asm, "_check", lambda *a: checks.append(a[0]) or check(*a))
    monkeypatch.setattr(asm, "_require_card", lambda lead, devs: None)

    def fake_launch(passes, zero_first, table, dev, cam_free, lam, P, R, acc=None,
                    blocks=None, hinv=None, out=None, singular=None, halt=None):
        t = table.table
        launches.append((passes, zero_first, [(t[10 * i], t[10 * i + 1], t[10 * i + 6])
                                               for i in range(table.families)]))

    monkeypatch.setattr(asm, "_launch", fake_launch)
    assemble = asm.assemble
    seen = []

    def spy(*args):
        plan = args[10]
        plans.add(id(plan))
        before = len(checks)
        plan(*args[:10])
        seen.append((len(checks) - before, args[2], args[3]))
        return assemble(*args)

    monkeypatch.setattr(asm, "assemble", spy)
    res = solver(TPr.pack_state(st, include_points=False), st.points)
    assert len(plans) == 1 and len(seen) == res.iterations >= 3
    # the families' tensors, cam_free and the flag checked at the first call
    # only (lam, new each iteration, by its dtype, device and shape alone)
    assert seen[0][0] > 3 and all(n == 0 for n, _, _ in seen[1:])
    assert len(launches) == res.iterations
    for (passes, zero_first, ptrs), (_, J, r) in zip(launches, seen):
        assert passes == 15 and not zero_first
        (jc, jp), = J
        off, want = 0, []
        for a, b in zip(jc, jp):
            n, k = (b if a is None else a).shape[:2]
            want.append((0 if a is None else a.data_ptr(), 0 if b is None else b.data_ptr(),
                         r[0].data_ptr() + off * r[0].element_size()))
            off += n * k
        assert ptrs == want
    # the loop makes new J tensors each iteration after an accepted step
    assert len({ptrs[0][0] for _, _, ptrs in launches}) > 1


def test_the_kernel_paths_refuse_cpu_tensors(monkeypatch):
    """Handed CPU tensors, the one-launch solve and the assembly raise before
    any build; they never compute on the CPU themselves."""
    monkeypatch.setattr(cuda_build, "load_library", lambda *a, **k: pytest.fail("built"))
    cam0, pts0, scene, state0, mask = _cube()
    solver, st, _ = _port_solver(scene, state0, mask, max_iterations=1)
    seen = {}
    solve, assemble = cg_solve.solve, asm.assemble

    def spy_solve(*args):
        seen.setdefault("solve", args)
        return solve(*args)

    def spy_asm(*args):
        seen.setdefault("assemble", args)
        return assemble(*args)

    monkeypatch.setattr(cg_solve, "solve", spy_solve)
    monkeypatch.setattr(asm, "assemble", spy_asm)
    solver(TPr.pack_state(st, include_points=False), st.points)
    system, g_c, g_p, M, iterations, tolerance = seen["solve"][:6]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cg_solve.solve_cuda(system, g_c, g_p, M, iterations, tolerance)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        asm.assemble_cuda(*seen["assemble"][:10])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        asm.AssemblyPlan()(*seen["assemble"][:10])


def test_the_build_key_follows_the_local_headers(tmp_path):
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("constexpr int kB = 1;\n")
    (tmp_path / "one.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (tmp_path / "two.cu").write_text(' # include "b.cuh"\nint f();\n')
    (tmp_path / "none.cu").write_text("#include <cstdio>\n")
    assert cuda_build.local_headers("one.cu", tmp_path) == ("a.cuh", "b.cuh")
    assert cuda_build.local_headers("two.cu", tmp_path) == ("b.cuh",)
    assert cuda_build.local_headers("none.cu", tmp_path) == ()
    keys = {n: cuda_build.build_key(n, tmp_path) for n in ("one.cu", "two.cu", "none.cu")}
    (tmp_path / "b.cuh").write_text("constexpr int kB = 2;\n")
    after = {n: cuda_build.build_key(n, tmp_path) for n in keys}
    assert after["one.cu"] != keys["one.cu"] and after["two.cu"] != keys["two.cu"]
    assert after["none.cu"] == keys["none.cu"]
    (tmp_path / "bad.cu").write_text('#include "missing.cuh"\n')
    with pytest.raises(FileNotFoundError):
        cuda_build.local_headers("bad.cu", tmp_path)
    # the package's sources: the fused solve and the step share one header
    assert cuda_build.local_headers("schur_mv.cu") == ("cg_step.cuh", "row_tiles.cuh")
    assert cuda_build.local_headers("cg_step.cu") == ("cg_step.cuh",)
    assert cuda_build.local_headers("lm_assembly.cu") == ("row_tiles.cuh",)
    assert cuda_build.local_headers("knn2_wgmma.cu") == ()
    # without a header, the key of the source and the flags as before
    import hashlib
    src = (cuda_build.CSRC_DIR / "knn2.cu").read_bytes()
    assert cuda_build.build_key("knn2.cu") == hashlib.sha256(
        src + " ".join(cuda_build.NVCC_FLAGS).encode()).hexdigest()
