"""Port parity: ray casting and the mesh constraints of multiview_tpu_torch
against the JAX package, in float64 on the CPU.

Tolerances: ``ray_mesh_intersect`` hit flags exact, distances 1e-12, triangle
indices exact wherever the nearest distance is unique (a ray through an edge
shared by two triangles reports the lower index in both packages);
``mesh_intersections`` points 1e-10 with the same NaN pattern;
``optimize_rig`` with both mesh families: final cost rtol 1e-8, masks exact."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.calib import calibrator as JCal, mesh_constraints as JMesh, problem as JPr
from multiview_tpu.geometry import pose as JP
from multiview_tpu.texture import raycast as JRay
from multiview_tpu.utils import synthetic as JSyn
from multiview_tpu_torch.calib import calibrator as TCal, mesh_constraints as TMesh
from multiview_tpu_torch.calib import problem as TPr
from multiview_tpu_torch.texture import raycast as TRay
from test_mesh_constraints import make_roof_scene, roof_mesh
from torch_port_scenes import one_torch_thread, port_problem

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _soup(rng, n):
    ctr = rng.uniform(-2, 2, size=(n, 1, 3)) + np.array([0, 0, 5.0])
    return ctr + 0.6 * rng.normal(size=(n, 3, 3))


def _rays(rng, n):
    o = rng.normal(size=(n, 3)) * 0.3
    d = np.column_stack([rng.uniform(-0.5, 0.5, size=(n, 2)), np.ones(n)])
    return o, d


_QUAD = np.array([[[-1, -1, 2.0], [1, -1, 2.0], [1, 1, 2.0]],      # two triangles sharing
                  [[-1, -1, 2.0], [1, 1, 2.0], [-1, 1, 2.0]]])     # the diagonal x == y
_Z = np.array([[0.0, 0.0, 1.0]])


def _cases():
    rng = np.random.default_rng(0)
    o, d = _rays(rng, 300)
    yield "random_soup", o, d, _soup(rng, 700), {}
    o, d = _rays(rng, 50)
    yield "triangles_not_a_multiple_of_the_chunk", o, d, _soup(rng, 37), dict(chunk=16)
    o, d = _rays(rng, 130)
    yield "forced_small_tri_chunk", o, d, _soup(rng, 100), dict(tri_chunk=8, chunk=8)
    o, d = _rays(rng, 130)
    yield "ray_blocks", o, d, _soup(rng, 64), dict(ray_chunk=32)
    yield "edge_shared_by_two_triangles", np.array([[0.25, 0.25, 0.0]]), _Z, _QUAD, {}
    yield "parallel_ray", np.array([[0.3, -0.2, 2.0]]), np.array([[1.0, 0.0, 0.0]]), _QUAD, {}
    yield "hit_before_min_dist", np.array([[0.5, -0.2, 0.0]]), _Z, _QUAD, dict(min_dist=2.5)
    yield "hit_beyond_max_dist", np.array([[0.5, -0.2, 0.0]]), _Z, _QUAD, dict(max_dist=1.5)
    yield "hit_at_max_dist", np.array([[0.5, -0.2, 0.0]]), _Z, _QUAD, dict(max_dist=2.0)
    o = np.tile([[0.5, -0.2, 0.0]], (4, 1))
    yield "per_ray_min_dist", o, np.tile(_Z, (4, 1)), _QUAD, dict(
        min_dist=np.array([0.0, 1.9, 2.0, 2.1]))


_CASES = {c[0]: c[1:] for c in _cases()}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_ray_mesh_intersect(case):
    o, d, tri, kw = _CASES[case]
    jkw = dict(kw)
    if "min_dist" in jkw and np.ndim(jkw["min_dist"]):
        jkw["min_dist"] = jnp.asarray(jkw["min_dist"])
    jt, ji, jh = JRay.ray_mesh_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tri), **jkw)
    tkw = {k: v for k, v in kw.items() if k != "tri_chunk"}   # the port has one tile size
    if "min_dist" in tkw and np.ndim(tkw["min_dist"]):
        tkw["min_dist"] = torch.as_tensor(tkw["min_dist"])
    tt, ti, th = TRay.ray_mesh_intersect(torch.as_tensor(o), torch.as_tensor(d),
                                         torch.as_tensor(tri), **tkw)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int64 and (ti[~th] == -1).all() and (tt[~th] == 0).all()
    if case == "random_soup":
        assert 0.2 < float(th.double().mean()) < 1.0
    if case == "edge_shared_by_two_triangles":
        assert bool(th[0]) and int(ti[0]) == 0
    if case in ("parallel_ray", "hit_before_min_dist", "hit_beyond_max_dist"):
        assert not bool(th.any())
    if case == "hit_at_max_dist":
        assert bool(th[0])
    if case == "per_ray_min_dist":
        assert th.tolist() == [True, True, True, False]


def test_empty_ray_set():
    t, i, h = TRay.ray_mesh_intersect(torch.zeros((0, 3)), torch.zeros((0, 3)),
                                      torch.as_tensor(_QUAD, dtype=torch.float32))
    assert t.shape == i.shape == h.shape == (0,)
    np.testing.assert_array_equal(TRay.mesh_tri_verts(*roof_mesh()),
                                  JRay.mesh_tri_verts(*roof_mesh()))


@pytest.fixture(scope="module")
def roof():
    state, obs, models = make_roof_scene(pix_noise=0.1)
    verts, faces = roof_mesh()
    return state, obs, models, verts[faces]


def test_mesh_intersections_and_prior(roof):
    state, obs, models, tri = roof
    # kill a few observations: masked rays must read as misses
    pix = obs.pixels[0]
    obs = dataclasses.replace(obs, pixels=(dataclasses.replace(
        pix, mask=jnp.asarray(np.arange(len(pix)) % 7 != 0)),))
    j_obs, j_track = JMesh.mesh_intersections(state, obs, models, tri, max_ray_dist=50.0)
    st, tobs = port_problem(state, obs)
    t_obs, t_track = TMesh.mesh_intersections(st, tobs, models, torch.as_tensor(tri),
                                              max_ray_dist=50.0)
    for t, j in ((t_obs, j_obs), (t_track, j_track)):
        np.testing.assert_array_equal(torch.isnan(t).numpy(), np.isnan(j))
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-10, atol=1e-10)
    assert np.isnan(j_obs).any() and np.isfinite(j_obs).any()
    jp = JMesh.build_mesh_prior(state, obs, models, tri)
    tp = TMesh.build_mesh_prior(st, tobs, models, tri)
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    np.testing.assert_array_equal(tp.point_idx.numpy(), np.asarray(jp.point_idx))
    np.testing.assert_allclose(tp.ref_xyz.numpy(), np.asarray(jp.ref_xyz), atol=1e-10)


def test_optimize_rig_with_mesh_families(roof):
    """mesh_tri prior and depth-vs-mesh rows together, mesh hits recomputed
    every pass (tests/test_depth_ba.py::TestDepthMeshConstraint's scene)."""
    state, obs, models, tri = roof
    pobs = obs.pixels[0]
    n = len(pobs)
    depth_xyz = JP.pose_apply(state.world_to_ref[pobs.beg_idx], state.points[pobs.point_idx])
    dob = JPr.DepthObs(depth_xyz=depth_xyz, beg_idx=pobs.beg_idx, end_idx=pobs.end_idx,
                       point_idx=pobs.point_idx, dt_cam=pobs.dt_cam,
                       dt_bracket=pobs.dt_bracket, mask=jnp.ones(n, bool),
                       pix_row=jnp.arange(n, dtype=jnp.int32), sensor=0)
    jobs = dataclasses.replace(obs, depths=(dob,))
    bad = JSyn.perturb_state(state, pose_rot=0.003, pose_trans=0.008, point_sigma=0.01)
    okw = dict(no_rig=True, mesh_tri_weight=20.0, depth_mesh_weight=15.0)
    kw = dict(num_passes=2, num_iterations=15, max_reprojection_error=0.25)
    jres = JCal.optimize_rig(bad, jobs, models, JPr.FloatSpec(cam_poses=True),
                             JPr.BAOptions(**okw), mesh_tri_verts=tri, **kw)
    st, tobs = port_problem(bad, jobs)
    tres = TCal.optimize_rig(st, tobs, models, TPr.FloatSpec(cam_poses=True),
                             TPr.BAOptions(**okw), mesh_tri_verts=torch.as_tensor(tri), **kw)
    assert len(tres.lm_results) == 2
    for tr, jr in zip(tres.lm_results, jres.lm_results):
        np.testing.assert_allclose(float(tr.initial_cost), float(jr.initial_cost), rtol=1e-8)
        np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-8)
        assert float(tr.cost) < float(tr.initial_cost)
    for a, b in list(zip(tres.observations.pixels, jres.observations.pixels)) \
            + list(zip(tres.observations.depths, jres.observations.depths)):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
    assert not bool(tres.observations.pixels[0].mask.all())      # the gate did cut
    assert list(tres.stats_after) == list(jres.stats_after)
    assert {"depth_mesh_x_m", "mesh_tri_x_m"} <= set(tres.stats_after)
    for k in jres.stats_after:
        np.testing.assert_allclose(tres.stats_after[k], jres.stats_after[k], rtol=1e-6,
                                   atol=1e-12)
