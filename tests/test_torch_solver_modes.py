"""Port parity of the Schur-LM solver's linear solvers and of CG's early stop:
``multiview_tpu_torch.solver.schur.make_schur_solver`` in each of the modes
``cg``, ``cg_blocks``, ``cg_dense_j`` and ``dense_schur`` against the JAX
package's solver in the same mode, in float64 on the CPU, on the rig scene
of tests/test_schur.py::TestLinearSolverModes with a depth family added.

Bars (those of tests/test_torch_schur.py): the same LM iteration count and
CG total, final cost within rtol 1e-6, cameras within atol 1e-6. Each test
builds its own JAX solver, so that a worker running one case compiles only
that case's solver."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from multiview_tpu.calib import problem as JPr
from multiview_tpu.solver import schur as JS
from multiview_tpu.utils import synthetic as JSyn
from multiview_tpu_torch.calib import problem as TPr
from multiview_tpu_torch.solver import schur as TS
from torch_port_scenes import make_depth_scene, one_torch_thread, port_problem  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPEC = dict(cam_poses=True, rig_transforms=True, focal=(0, 1), optical_center=(0, 1))
OPTS = dict(depth_tri_weight=100.0)


def _problem():
    scene = make_depth_scene(JSyn, n_ref=10, pix_noise=0.2, depth_noise=0.002)
    state0 = JSyn.perturb_rig_state(scene.true_state, pose_rot=0.003, pose_trans=0.005,
                                    point_sigma=0.01)
    mask = JPr.build_mask(state0, JPr.FloatSpec(**SPEC), include_points=False)
    return scene, state0, mask


def _solve_both(kw):
    """(JAX result, port result) of one solver configuration."""
    scene, state0, mask = _problem()
    jres = jax.jit(JS.make_schur_solver(state0, scene.observations, scene.models,
                                        JPr.BAOptions(**OPTS), mask, **kw))(
        JPr.pack_state(state0, include_points=False), state0.points)
    st, obs = port_problem(state0, scene.observations)
    assert len(obs.depths) == 1
    tres = TS.make_schur_solver(st, obs, scene.models, TPr.BAOptions(**OPTS), mask, **kw)(
        TPr.pack_state(st, include_points=False), st.points)
    return jres, tres


def _hold(jres, tres, drop=0.1):
    assert tres.iterations == int(jres.iterations)
    assert int(tres.cg_iters_total) == int(jres.cg_iters_total)
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-6)
    np.testing.assert_allclose(tres.cam.numpy(), np.asarray(jres.cam), atol=1e-6)
    assert float(tres.cost) < drop * float(tres.initial_cost)


@pytest.mark.parametrize("mode", ["cg", "cg_blocks", "cg_dense_j", "dense_schur"])
def test_linear_solver_mode_matches_the_reference(mode):
    jres, tres = _solve_both(dict(max_iterations=8, cg_iterations=40, cg_tolerance=0.1,
                                  linear_solver=mode))
    _hold(jres, tres)
    if mode == "dense_schur":
        assert int(tres.cg_iters_total) == 0 and tres.matvecs == 0


def _cube_both(kw, check_every=None):
    """(JAX result, port result) on the scene of __graft_entry__ (one sensor,
    8 images; its solver compiles in seconds). ``check_every`` replaces the
    port's CG check interval."""
    _, cam0, pts0, scene, state0 = graft._build(8, 3, jnp.float64, max_iterations=10)
    mask = JPr.build_mask(state0, JPr.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                          include_points=False)
    jres = None if check_every else jax.jit(JS.make_schur_solver(
        state0, scene.observations, scene.models, JPr.BAOptions(no_rig=True), mask, **kw))(
        cam0, pts0)
    st, obs = port_problem(state0, scene.observations)
    solver = TS.make_schur_solver(st, obs, scene.models, TPr.BAOptions(no_rig=True), mask, **kw)
    return jres, solver(TPr.pack_state(st, include_points=False), st.points)


def test_cg_stops_at_the_reference_test(monkeypatch):
    """The port's CG total equals the reference's while_loop count; the
    matvecs it runs stay within one check interval of that count per LM
    iteration, far below the budget; and the result is bit for bit that of
    the masked loop run to the whole budget."""
    kw = dict(max_iterations=10, cg_iterations=60, cg_tolerance=1e-2)
    jres, tres = _cube_both(kw)
    _hold(jres, tres, 0.5)
    cg = int(tres.cg_iters_total)
    assert cg <= tres.matvecs <= cg + (TS.CG_CHECK_EVERY - 1) * tres.iterations
    assert tres.matvecs < kw["cg_iterations"] * tres.iterations // 4
    monkeypatch.setattr(TS, "CG_CHECK_EVERY", kw["cg_iterations"] + 1)
    _, full = _cube_both(kw, check_every=True)
    assert full.matvecs == kw["cg_iterations"] * full.iterations
    assert full.iterations == tres.iterations and int(full.cg_iters_total) == cg
    for a, b in zip(full[:4], tres[:4]):
        assert torch.equal(a, b)


def test_debug_force_cg_and_unroll_lm_match_the_reference():
    """Exactly m CG steps per LM iteration with no stop test, and exactly k
    LM iterations, in both packages."""
    jres, tres = _cube_both(dict(max_iterations=8, cg_iterations=40, cg_tolerance=0.1,
                                 debug_force_cg=5, debug_unroll_lm=3))
    assert tres.iterations == int(jres.iterations) == 3
    assert int(tres.cg_iters_total) == int(jres.cg_iters_total) == 15 == tres.matvecs
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-6)
    np.testing.assert_allclose(tres.cam.numpy(), np.asarray(jres.cam), atol=1e-6)


def test_unknown_mode_and_sharded_dense_modes_raise():
    from multiview_tpu_torch.parallel import sharding
    from multiview_tpu_torch.utils import synthetic as TSyn

    scene = TSyn.make_cube_scene(n_images=4, n_per_face=2, device="cpu")
    st = scene.true_state
    mask = TPr.build_mask(st, TPr.FloatSpec(cam_poses=True), no_rig=True, include_points=False)
    with pytest.raises(ValueError, match="linear_solver"):
        TS.make_schur_solver(st, scene.observations, scene.models,
                             TPr.BAOptions(no_rig=True), mask, linear_solver="cholmod")
    mesh = sharding.make_mesh(["cpu"] * 2)
    obs = sharding.shard_observations(scene.observations, mesh)
    solver = TS.make_schur_solver(st, obs, scene.models, TPr.BAOptions(no_rig=True), mask,
                                  linear_solver="dense_schur")
    with pytest.raises(ValueError, match="unsharded"):
        solver(TPr.pack_state(st, include_points=False), st.points)
