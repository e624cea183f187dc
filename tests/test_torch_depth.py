"""Port parity: the depth-camera constraints of multiview_tpu_torch against
the JAX package, in float64 on the CPU: the synthetic rig+depth scene, the
depth residual families, the depth row Jacobians of the Schur solver, a
Schur solve and a two-pass ``optimize_rig`` with floated depth_to_image and
scale, and the mask release of depth rows.

Tolerances: scenes 1e-12, residuals 1e-10, row Jacobians 1e-9 (same
formulas); the Schur solve's final cost and camera vector rtol 1e-8 (reached:
3e-13 and 4e-12, the CG sums run in another order); ``optimize_rig`` masks exact,
stats rtol 1e-6, recovered depth_to_image and scale 1e-6 of the JAX result.
The JAX solvers are built from the observations they solve (the reference
decides its bracket fold at build time)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.calib import calibrator as JCal, problem as JPr
from multiview_tpu.geometry import pose as JP
from multiview_tpu.solver import schur as JS
from multiview_tpu.utils import synthetic as JSyn
from multiview_tpu_torch.calib import calibrator as TCal, problem as TPr
from multiview_tpu_torch.geometry import pose as TP
from multiview_tpu_torch.solver import schur as TS
from multiview_tpu_torch.utils import synthetic as TSyn
from torch_port_scenes import make_depth_scene, one_torch_thread, port_problem

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), rtol=tol, atol=tol)


def _same_problem(tstate, tobs, jstate, jobs, tol=1e-12):
    _close(TPr.pack_state(tstate), JPr.pack_state(jstate), tol)
    assert len(tobs.pixels) == len(jobs.pixels) and len(tobs.depths) == len(jobs.depths)
    for to, jo in list(zip(tobs.pixels, jobs.pixels)) + list(zip(tobs.depths, jobs.depths)):
        assert to.sensor == jo.sensor
        for f in dataclasses.fields(jo):
            a, b = getattr(to, f.name), getattr(jo, f.name)
            if f.name == "sensor":
                continue
            assert (a is None) == (b is None), f.name
            if a is None:
                continue
            if a.dtype in (torch.int64, torch.bool):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                _close(a, b, tol)


@pytest.fixture(scope="module")
def scenes():
    return make_depth_scene(JSyn), make_depth_scene(TSyn, device="cpu")


def _with_mesh(jobs, state, seed=0):
    """The depth obs with synthetic mesh intersections: the true point plus
    an offset, with misses whose mesh_xyz is NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for o in jobs.depths:
        n = len(o)
        mesh_xyz = np.asarray(state.points)[np.asarray(o.point_idx)] \
            + 0.01 * rng.normal(size=(n, 3))
        mesh_mask = rng.uniform(size=n) > 0.3
        mesh_xyz[~mesh_mask] = np.nan
        out.append(dataclasses.replace(o, mesh_xyz=jnp.asarray(mesh_xyz),
                                       mesh_mask=jnp.asarray(mesh_mask)))
    return dataclasses.replace(jobs, depths=tuple(out))


def _perturbed(scene):
    """The JAX scene's start: perturbed poses, rig, points, depth_to_image
    of the depth sensor and its scale."""
    st = JSyn.perturb_rig_state(scene.true_state, pose_rot=0.003, pose_trans=0.005,
                                point_sigma=0.01)
    d2i = np.asarray(st.depth_to_image).copy()
    d2i[1] = np.asarray(JP.pose_compose(
        JP.make_pose(jnp.asarray([0.02, 0.01, -0.01]),
                     JP.quat_exp(jnp.asarray([0.01, -0.02, 0.01]))), st.depth_to_image[1]))
    return dataclasses.replace(st, depth_to_image=jnp.asarray(d2i),
                               depth_scale=st.depth_scale * jnp.asarray([1.0, 0.97, 1.0]))


def test_rig_depth_scene_is_identical_and_carries_across(scenes):
    jscene, tscene = scenes
    assert tscene.models == jscene.models and tscene.n_points == jscene.n_points
    _same_problem(tscene.true_state, tscene.observations, jscene.true_state,
                  jscene.observations)
    st, obs = port_problem(jscene.true_state, _with_mesh(jscene.observations,
                                                         jscene.true_state))
    _same_problem(st, obs, jscene.true_state,
                  _with_mesh(jscene.observations, jscene.true_state), tol=0)
    jp = JSyn.perturb_rig_state(jscene.true_state, pose_rot=0.003, pose_trans=0.005)
    tp = TSyn.perturb_rig_state(tscene.true_state, pose_rot=0.003, pose_trans=0.005)
    _close(TPr.pack_state(tp), JPr.pack_state(jp), 1e-12)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("robust", [True, False])
def test_depth_residual_families(scenes, affine, robust):
    jscene = scenes[0]
    jstate = _perturbed(jscene)
    if affine:
        jstate = dataclasses.replace(jstate, depth_to_image=JP.pose_to_affine(
            jstate.depth_to_image))
    P = jstate.points.shape[0]
    prior = JPr.XyzPriorObs(ref_xyz=jscene.true_state.points, point_idx=jnp.arange(P),
                            mask=jnp.asarray(np.arange(P) % 5 != 0))
    jobs = dataclasses.replace(_with_mesh(jscene.observations, jscene.true_state),
                               mesh_tri=prior, tri_prior=prior)
    kw = dict(depth_tri_weight=10.0, depth_mesh_weight=7.0, mesh_tri_weight=3.0,
              tri_weight=0.5, affine_depth_to_image=affine)
    jopts, topts = JPr.BAOptions(**kw), TPr.BAOptions(**kw)
    st, obs = port_problem(jstate, jobs)
    if affine:
        _close(TP.pose_to_affine(port_problem(_perturbed(jscene), jobs)[0].depth_to_image),
               jstate.depth_to_image, 1e-14)
    for jo, to in zip(jobs.depths, obs.depths):
        _close(TPr.depth_tri_residuals(st, to, topts, robust=robust),
               JPr.depth_tri_residuals(jstate, jo, jopts, robust=robust), 1e-10)
        mesh = TPr.depth_mesh_residuals(st, to, topts, robust=robust)
        assert torch.isfinite(mesh).all()
        _close(mesh, JPr.depth_mesh_residuals(jstate, jo, jopts, robust=robust), 1e-10)
    tall = TPr.all_residuals(st, obs, jscene.models, topts, robust=robust)
    jall = JPr.all_residuals(jstate, jobs, jscene.models, jopts, robust=robust)
    assert tall.shape == jall.shape
    _close(tall, jall, 1e-10)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("mesh_variant", [False, True])
def test_depth_row_blocks(scenes, affine, mesh_variant):
    jscene = scenes[0]
    jstate = _perturbed(jscene)
    if affine:
        jstate = dataclasses.replace(jstate, depth_to_image=JP.pose_to_affine(
            jstate.depth_to_image))
    jobs = _with_mesh(jscene.observations, jscene.true_state)
    kw = dict(depth_tri_weight=10.0, depth_mesh_weight=7.0, affine_depth_to_image=affine)
    st, obs = port_problem(jstate, jobs)
    jc, jp, jr = jax.jit(JS._depth_row_blocks, static_argnums=(2, 3))(
        jstate, jobs.depths[0], JPr.BAOptions(**kw), mesh_variant)
    tc, tp, tr = TS.depth_row_blocks(st, obs.depths[0], TPr.BAOptions(**kw), mesh_variant)
    assert tc.shape == (len(obs.depths[0]), 3, 35 if affine else 30)
    _close(tr, jr, 1e-10)
    _close(tc, jc, 1e-9)
    if mesh_variant:
        assert tp is None and not np.asarray(jp).any()
    else:
        _close(tp, jp, 1e-9)
    assert torch.isfinite(tc).all()


_SPEC = dict(cam_poses=True, rig_transforms=True, depth_to_image=(1,), depth_scale=True)


def test_schur_solve_with_depth_families(scenes):
    jscene = scenes[0]
    jstate = _perturbed(jscene)
    jobs = _with_mesh(jscene.observations, jscene.true_state)
    kw = dict(depth_tri_weight=25.0, depth_mesh_weight=7.0)
    mask = JPr.build_mask(jstate, JPr.FloatSpec(**_SPEC), include_points=False)
    skw = dict(max_iterations=8, cg_iterations=40)
    jres = jax.jit(JS.make_schur_solver(jstate, jobs, jscene.models, JPr.BAOptions(**kw), mask,
                                        **skw))(JPr.pack_state(jstate, include_points=False),
                                                jstate.points)
    st, obs = port_problem(jstate, jobs)
    tmask = TPr.build_mask(st, TPr.FloatSpec(**_SPEC), include_points=False)
    np.testing.assert_array_equal(tmask, mask)
    tres = TS.make_schur_solver(st, obs, jscene.models, TPr.BAOptions(**kw), tmask, **skw)(
        TPr.pack_state(st, include_points=False), st.points)
    assert tres.iterations == int(jres.iterations)
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-8)
    np.testing.assert_allclose(tres.cam.numpy(), np.asarray(jres.cam), rtol=1e-8, atol=1e-8)
    print("reached: cost rel", abs(float(tres.cost) / float(jres.cost) - 1.0), "cam abs",
          float(np.abs(tres.cam.numpy() - np.asarray(jres.cam)).max()))
    assert float(tres.cost) < 0.1 * float(tres.initial_cost)


def test_optimize_rig_recovers_depth_to_image(scenes):
    """Float depth_to_image and scale from a perturbed guess (rig fixed), as
    tests/test_depth_ba.py::test_recover_depth_to_image, two passes."""
    jscene = scenes[0]
    st0 = jscene.true_state
    jstate = dataclasses.replace(st0, depth_to_image=_perturbed(jscene).depth_to_image,
                                 depth_scale=st0.depth_scale * jnp.asarray([1.0, 0.97, 1.0]))
    spec = dict(depth_to_image=(1,), depth_scale=True)
    kw = dict(num_passes=2, num_iterations=25)
    jres = JCal.optimize_rig(jstate, jscene.observations, jscene.models, JPr.FloatSpec(**spec),
                             JPr.BAOptions(depth_tri_weight=100.0), **kw)
    st, obs = port_problem(jstate, jscene.observations)
    tres = TCal.optimize_rig(st, obs, jscene.models, TPr.FloatSpec(**spec),
                             TPr.BAOptions(depth_tri_weight=100.0), **kw)
    for a, b in list(zip(tres.observations.pixels, jres.observations.pixels)) \
            + list(zip(tres.observations.depths, jres.observations.depths)):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
    for before_after in ("stats_before", "stats_after"):
        js, ts = getattr(jres, before_after), getattr(tres, before_after)
        assert list(js) == list(ts) and "depth_tri_x_m" in ts
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-6, atol=1e-12)
    _close(tres.state.depth_to_image, jres.state.depth_to_image, 1e-6)
    _close(tres.state.depth_scale, jres.state.depth_scale, 1e-6)
    true_d2i = torch.as_tensor(np.array(st0.depth_to_image[1]))
    rel = TP.pose_compose(TP.pose_inverse(tres.state.depth_to_image[1]), true_d2i)
    assert float(torch.linalg.norm(TP.quat_log(TP.pose_q(rel)))) < 1e-4
    assert float(torch.linalg.norm(TP.pose_t(rel))) < 1e-4
    assert abs(float(tres.state.depth_scale[1]) - 1.02) < 1e-4


def _pix(mod, point_idx, sensor=0):
    n = len(point_idx)
    if mod is JPr:
        return JPr.PixelObs(
            pix=jnp.zeros((n, 2)), beg_idx=jnp.zeros(n, jnp.int32),
            end_idx=jnp.zeros(n, jnp.int32), point_idx=jnp.asarray(point_idx, jnp.int32),
            dt_cam=jnp.zeros(n), dt_bracket=jnp.zeros(n), mask=jnp.ones(n, bool),
            dist_half_size=jnp.asarray([320.0, 240.0]), sensor=sensor)
    z = torch.zeros(n, dtype=torch.float64)
    zi = torch.zeros(n, dtype=torch.int64)
    return TPr.PixelObs(pix=torch.zeros((n, 2), dtype=torch.float64), beg_idx=zi, end_idx=zi,
                        point_idx=torch.as_tensor(point_idx, dtype=torch.int64), dt_cam=z,
                        dt_bracket=z, mask=torch.ones(n, dtype=torch.bool),
                        dist_half_size=torch.tensor([320.0, 240.0], dtype=torch.float64),
                        sensor=sensor)


def _dep(mod, point_idx, pix_row=None):
    n = len(point_idx)
    if mod is JPr:
        return JPr.DepthObs(
            depth_xyz=jnp.zeros((n, 3)), beg_idx=jnp.zeros(n, jnp.int32),
            end_idx=jnp.zeros(n, jnp.int32), point_idx=jnp.asarray(point_idx, jnp.int32),
            dt_cam=jnp.zeros(n), dt_bracket=jnp.zeros(n), mask=jnp.ones(n, bool),
            pix_row=None if pix_row is None else jnp.asarray(pix_row, jnp.int32))
    z = torch.zeros(n, dtype=torch.float64)
    zi = torch.zeros(n, dtype=torch.int64)
    return TPr.DepthObs(
        depth_xyz=torch.zeros((n, 3), dtype=torch.float64), beg_idx=zi, end_idx=zi,
        point_idx=torch.as_tensor(point_idx, dtype=torch.int64), dt_cam=z, dt_bracket=z,
        mask=torch.ones(n, dtype=torch.bool),
        pix_row=None if pix_row is None else torch.as_tensor(pix_row, dtype=torch.int64))


# (pixel point ids per sensor, depth point ids, depth pix_row, global masks
# applied in turn, expected depth mask at the end)
_RELEASE_CASES = {
    "pix_row_releases_flagged_feature": (
        [[0, 1, 2, 1]], [1, 1], [1, 3], [[True, False, True, True]], [False, True]),
    "track_fallback_releases_dead_track": (
        [[0, 1], [1, 0]], [0, 1, 1], None, [[True, False, False, True]],
        [True, False, False]),
    "masks_are_monotone_pix_row": (
        [[0, 1, 2]], [0, 1, 2], [0, 1, 2], [[True, False, True], [True, True, True]],
        [True, False, True]),
    "masks_are_monotone_track_fallback": (
        [[0, 1, 2]], [0, 1, 2], None, [[True, False, True], [True, True, True]],
        [True, False, True]),
    "out_of_range_depth_point_ids_die": (
        [[0, 1]], [0, 7, -1], None, [[True, True]], [True, False, False]),
}


@pytest.mark.parametrize("case", sorted(_RELEASE_CASES))
def test_depth_mask_release(case):
    pix_ids, dep_ids, pix_row, gmasks, expected = _RELEASE_CASES[case]
    out = {}
    for mod, cal in ((JPr, JCal), (TPr, TCal)):
        obs = mod.Observations(
            pixels=tuple(_pix(mod, ids, sensor=s) for s, ids in enumerate(pix_ids)),
            depths=(_dep(mod, dep_ids, pix_row),))
        for g in gmasks:
            obs = cal._scatter_mask_updates(obs, np.asarray(g))
        out[mod] = ([np.asarray(o.mask) for o in obs.pixels], np.asarray(obs.depths[0].mask))
    for a, b in zip(out[TPr][0], out[JPr][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[TPr][1], out[JPr][1])
    np.testing.assert_array_equal(out[TPr][1], expected)
