"""Port parity: the BA problem, the Schur-complement LM solver and the
calibrator passes of multiview_tpu_torch against the JAX package, in
float64 on the identical problem (carried across with
``problem.from_numpy`` from the JAX dataclasses).

Tolerances: residuals and row Jacobians rtol 1e-10 (same formulas); the
solve's final cost rtol 1e-6 and camera vector atol 1e-6 (the bar of
tests/test_sharding.py: sums of the CG matvecs run in another order) and
the same LM iteration count."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from multiview_tpu.calib import calibrator as JCal, problem as JPr
from multiview_tpu.solver import schur as JS
from multiview_tpu.utils import synthetic as JSyn
from multiview_tpu_torch.calib import calibrator as TCal, problem as TPr
from multiview_tpu_torch.solver import schur as TS
from multiview_tpu_torch.utils import synthetic as TSyn


def _leaf(x):
    return tuple(np.asarray(v) for v in x) if isinstance(x, tuple) else np.asarray(x)


def port_problem(state, observations):
    """JAX RigState/Observations -> the port's, by field name."""
    sa = {k: _leaf(v) for k, v in dataclasses.asdict(state).items()}
    oa = {"pixels": [{f.name: (o.sensor if f.name == "sensor" else np.asarray(getattr(o, f.name)))
                      for f in dataclasses.fields(o)} for o in observations.pixels]}
    for name in ("tri_prior", "mesh_tri"):
        pr = getattr(observations, name)
        if pr is not None:
            oa[name] = {f.name: np.asarray(getattr(pr, f.name)) for f in dataclasses.fields(pr)}
    return TPr.from_numpy(sa, oa, device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def rig_scene():
    scene = JSyn.make_rig_scene(n_ref=6, n_per_face=3, pix_noise=0.3)
    state0 = JSyn.perturb_rig_state(scene.true_state, pose_rot=0.003, pose_trans=0.005,
                                    point_sigma=0.01)
    return scene, state0


def test_from_numpy_round_trip(rig_scene):
    scene, state0 = rig_scene
    st, obs = port_problem(state0, scene.observations)
    back = TPr.to_numpy(st)
    for f in dataclasses.fields(state0):
        for a, b in zip(np.atleast_1d(back[f.name]) if f.name != "dist" else back[f.name],
                        np.atleast_1d(_leaf(getattr(state0, f.name)))
                        if f.name != "dist" else _leaf(state0.dist)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TPr.pack_state(st).numpy(), np.asarray(JPr.pack_state(state0)))


def test_pixel_residuals_and_row_jacobians(rig_scene):
    scene, state0 = rig_scene
    st, obs = port_problem(state0, scene.observations)
    opts = JPr.BAOptions()
    topts = TPr.BAOptions()
    for jo, to in zip(scene.observations.pixels, obs.pixels):
        model = scene.models[jo.sensor]
        for robust in (True, False):
            ref = jax.jit(JPr.pixel_residuals, static_argnums=(2, 3, 4))(
                state0, jo, model, opts, robust)
            np.testing.assert_allclose(
                TPr.pixel_residuals(st, to, model, topts, robust=robust).numpy(),
                np.asarray(ref), rtol=1e-10, atol=1e-10)
        jc, jp, jr = jax.jit(JS._pixel_row_blocks, static_argnums=(2, 3))(
            state0, jo, model, opts)
        tc, tp, tr = TS.pixel_row_blocks(st, to, model, topts)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-10, atol=1e-9)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(
        TPr.all_residuals(st, obs, scene.models, topts).numpy(),
        np.asarray(JPr.all_residuals(state0, scene.observations, scene.models, opts)),
        rtol=1e-10, atol=1e-10)


def test_cube_scene_and_perturbation_are_identical():
    j = JSyn.make_cube_scene(n_images=8, n_per_face=3, dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4),
                             pix_noise=0.3)
    t = TSyn.make_cube_scene(n_images=8, n_per_face=3, dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4),
                             pix_noise=0.3)
    for a, b in ((t.observations.pixels[0].pix, j.observations.pixels[0].pix),
                 (t.observations.pixels[0].point_idx, j.observations.pixels[0].point_idx),
                 (t.true_state.world_to_ref, j.true_state.world_to_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-9)
    jp = JSyn.perturb_state(j.true_state, pose_rot=0.005, pose_trans=0.01, point_sigma=0.01)
    tp = TSyn.perturb_state(t.true_state, pose_rot=0.005, pose_trans=0.01, point_sigma=0.01)
    np.testing.assert_allclose(TPr.pack_state(tp).numpy(), np.asarray(JPr.pack_state(jp)),
                               rtol=1e-10, atol=1e-10)


def _compare_solves(jres, tres):
    assert tres.iterations == int(jres.iterations)
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-6)
    np.testing.assert_allclose(tres.cam.numpy(), np.asarray(jres.cam), atol=1e-6)
    np.testing.assert_allclose(tres.points.numpy(), np.asarray(jres.points), atol=1e-6)
    assert float(tres.cost) < float(tres.initial_cost)


@pytest.mark.parametrize("preconditioner,cg_tolerance", [("jacobi", 0.1),
                                                         ("schur_jacobi", 1e-8)])
def test_schur_lm_on_the_graft_entry_scene(preconditioner, cg_tolerance):
    _, cam0, pts0, scene, state0 = graft._build(8, 3, jnp.float64, max_iterations=10)
    mask = JPr.build_mask(state0, JPr.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                          include_points=False)
    kw = dict(max_iterations=10, cg_iterations=20, cg_tolerance=cg_tolerance,
              preconditioner=preconditioner)
    jres = jax.jit(JS.make_schur_solver(state0, scene.observations, scene.models,
                                        JPr.BAOptions(no_rig=True), mask, **kw))(cam0, pts0)
    st, obs = port_problem(state0, scene.observations)
    tmask = TPr.build_mask(st, TPr.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                           include_points=False)
    np.testing.assert_array_equal(tmask, mask)
    tres = TS.make_schur_solver(st, obs, scene.models, TPr.BAOptions(no_rig=True), tmask,
                                **kw)(TPr.pack_state(st, include_points=False), st.points)
    _compare_solves(jres, tres)


def test_schur_lm_rig_scene_with_bounds_and_tri_prior(rig_scene):
    """Bracketed rig rows, floated rig transforms and timestamp offsets
    under bounds, and an xyz prior family."""
    scene, state0 = rig_scene
    P = state0.points.shape[0]
    tri = JPr.XyzPriorObs(ref_xyz=state0.points, point_idx=jnp.arange(P),
                          mask=jnp.ones(P, bool))
    jobs = dataclasses.replace(scene.observations, tri_prior=tri)
    opts = JPr.BAOptions(tri_weight=0.5)
    spec = JPr.FloatSpec(cam_poses=True, rig_transforms=True, focal=(1,),
                         timestamp_offsets=True)
    mask = JPr.build_mask(state0, spec, include_points=False)
    nc = mask.shape[0]
    lower = np.full(nc, -np.inf)
    upper = np.full(nc, np.inf)
    off0 = state0.world_to_ref.size + state0.ref_to_cam.size
    lower[off0:off0 + 3] = [-1.0, 0.25, -0.25]
    upper[off0:off0 + 3] = [1.0, 0.35, -0.15]
    kw = dict(max_iterations=8, cg_iterations=30)
    jres = jax.jit(JS.make_schur_solver(state0, jobs, scene.models, opts, mask,
                                        lower=jnp.asarray(lower), upper=jnp.asarray(upper),
                                        **kw))(JPr.pack_state(state0, include_points=False),
                                               state0.points)
    st, obs = port_problem(state0, jobs)
    topts = TPr.BAOptions(tri_weight=0.5)
    tres = TS.make_schur_solver(st, obs, scene.models, topts, mask,
                                lower=torch.as_tensor(lower), upper=torch.as_tensor(upper),
                                **kw)(TPr.pack_state(st, include_points=False), st.points)
    _compare_solves(jres, tres)


def test_calibrator_pass_pieces(rig_scene):
    """Track table, re-triangulation and the outlier gates of one pass."""
    scene, state0 = rig_scene
    st, obs = port_problem(state0, scene.observations)
    jt = JCal.build_track_table(scene.observations, state0.points.shape[0])
    tt = TCal.build_track_table(obs, st.points.shape[0])
    np.testing.assert_array_equal(tt.track_obs, jt.track_obs)
    np.testing.assert_array_equal(tt.track_valid, jt.track_valid)
    jx, jok = JCal.retriangulate(state0, scene.observations, scene.models, jt)
    tx, tok = TCal.retriangulate(st, obs, scene.models, tt)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9, atol=1e-9)
    opts, topts = JPr.BAOptions(), TPr.BAOptions()
    jflag = JCal.flag_outliers(state0, scene.observations, scene.models, jt, opts, 0.5, 1.0,
                               verbose=False)
    tflag = TCal.flag_outliers(st, obs, scene.models, tt, topts, 0.5, 1.0, verbose=False)
    for a, b in zip(tflag.pixels, jflag.pixels):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
    assert sum(int(o.mask.sum()) for o in tflag.pixels) < sum(len(o) for o in obs.pixels)
    js = JCal.residual_stats(state0, scene.observations, scene.models, opts)
    ts = TCal.residual_stats(st, obs, scene.models, topts)
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-9)
