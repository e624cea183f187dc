"""The Schur complement matvec of the port's BA (``solver/schur_matvec.py``)
on the CPU: its plain version against a dense NumPy S x, against the
composition the solver ran before the kernel existed, and sharded against
unsharded. The kernel (``csrc/schur_mv.cu``) is held to the plain version on
the card by ``tests/test_torch_cuda.py``. Imports no JAX.

The problem: a float64 rig scene with every residual family (three pixel
sensors, depth against the triangulated point, depth against the mesh, an
xyz prior) and a camera mask with frozen columns; the systems are the ones
the solver builds in its first LM iteration, caught by a spy on
``schur_matvec``. Tolerances: against the dense product 1e-10 relative
(float64, other summation orders); two logical shards against one 1e-12
(their Hpp, Jacobi diagonal and row sums are added in another order)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.parallel import sharding as sh
from multiview_tpu_torch.solver import schur, schur_matvec as smv
from multiview_tpu_torch.utils import cuda_build, synthetic as syn


@pytest.fixture(scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = prob.BAOptions(depth_tri_weight=25.0, depth_mesh_weight=7.0, tri_weight=0.5)
SPEC = prob.FloatSpec(cam_poses=True, rig_transforms=True, focal=(1,), depth_to_image=(1,),
                      depth_scale=True)


def _scene():
    scene = syn.make_rig_scene(n_ref=6, n_per_face=3, device="cpu")
    d2i = np.tile([0, 0, 0, 0, 0, 0, 1.0], (3, 1))
    d2i[1] = pose_mod.make_pose(
        torch.tensor([0.01, -0.02, 0.005], dtype=torch.float64),
        pose_mod.quat_exp(torch.tensor([0.02, 0.01, -0.015], dtype=torch.float64))).numpy()
    scene = syn.add_depth_observations(scene, sensors=(1,), subsample=2, depth_to_image=d2i,
                                       depth_scale=np.array([1.0, 1.02, 1.0]))
    rng = np.random.default_rng(3)
    st = scene.true_state
    depths = []
    for o in scene.observations.depths:
        n = len(o)
        mesh_xyz = st.points[o.point_idx].numpy() + 0.01 * rng.normal(size=(n, 3))
        hit = rng.uniform(size=n) > 0.3
        mesh_xyz[~hit] = np.nan
        depths.append(dataclasses.replace(o, mesh_xyz=torch.as_tensor(mesh_xyz),
                                          mesh_mask=torch.as_tensor(hit)))
    P = st.points.shape[0]
    pidx = np.sort(rng.choice(P, size=P // 3, replace=False))
    prior = prob.XyzPriorObs(
        ref_xyz=st.points[pidx] + torch.as_tensor(0.02 * rng.normal(size=(len(pidx), 3))),
        point_idx=torch.as_tensor(pidx), mask=torch.ones(len(pidx), dtype=torch.bool))
    obs = dataclasses.replace(scene.observations, depths=tuple(depths), tri_prior=prior)
    state0 = syn.perturb_rig_state(st, rig_rot=0.002, rig_trans=0.003, pose_rot=0.003,
                                    pose_trans=0.005, point_sigma=0.01)
    return state0, obs, scene.models


def _systems(state0, obs, models):
    """The SchurSystem of the first LM iteration, and the x of its matvecs."""
    mask = prob.build_mask(state0, SPEC, include_points=False)
    seen = []
    original = smv.schur_matvec

    def spy(system, x):
        seen.append((system, x))
        return original(system, x)

    smv.schur_matvec = spy
    try:
        schur.make_schur_solver(state0, obs, models, OPTS, mask, max_iterations=1,
                                cg_iterations=4)(prob.pack_state(state0, include_points=False),
                                                 state0.points, obs)
    finally:
        smv.schur_matvec = original
    return seen, mask


@pytest.fixture(scope="module")
def problem():
    state0, obs, models = _scene()
    seen, mask = _systems(state0, obs, models)
    sharded, _ = _systems(state0, sh.shard_observations(obs, sh.make_mesh(["cpu"] * 2)),
                          models)
    return types.SimpleNamespace(system=seen[0][0], xs=[x for _, x in seen], mask=mask,
                                 sharded=sharded[0][0])


def _vec(system, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=system.total))


def _dense(system):
    """(J_c [rows, C], J_p [rows, 3P], Hpp^-1 [3P, 3P]) of every shard's
    families, stacked in residual order, as float64 NumPy."""
    C, P = system.total, system.num_points
    jc_rows, jp_rows = [], []
    for fams, (jc, jp) in zip(system.shards, system.J):
        for f, a, b in zip(fams, jc, jp):
            n, k = (b if a is None else a).shape[:2]
            dc = np.zeros((n, k, C))
            dp = np.zeros((n, k, 3 * P))
            rows = np.arange(n)
            if a is not None:
                a = a.numpy()
                beg, end = f.beg_idx.numpy(), f.end_idx.numpy()
                for j in range(7):
                    np.add.at(dc, (rows, slice(None), beg * 7 + j), a[:, :, j])
                    np.add.at(dc, (rows, slice(None), end * 7 + j), a[:, :, 7 + j])
                for i, col in enumerate(f.const_cols.numpy()):
                    dc[:, :, col] += a[:, :, 14 + i]
            if b is not None:
                pidx = f.point_idx.numpy()
                for j in range(3):
                    np.add.at(dp, (rows, slice(None), pidx * 3 + j), b.numpy()[:, :, j])
            jc_rows.append(dc.reshape(n * k, C))
            jp_rows.append(dp.reshape(n * k, 3 * P))
    hinv = np.zeros((3 * P, 3 * P))
    for p, h in enumerate(system.hpp_inv.numpy()):
        hinv[3 * p:3 * p + 3, 3 * p:3 * p + 3] = h
    return np.concatenate(jc_rows), np.concatenate(jp_rows), hinv


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_the_problem_has_every_family_and_frozen_columns(problem):
    kinds = [f.kind for f in problem.system.shards[0]]
    assert kinds == ["pix", "pix", "pix", "depth_tri", "depth_mesh", "prior"]
    shapes = [(None if a is None else tuple(a.shape[1:]), None if b is None else b.shape[1])
              for a, b in zip(*problem.system.J[0])]
    assert [s[0][0] for s in shapes[:5]] == [2, 2, 2, 3, 3]
    assert shapes[4][1] is None and shapes[5][0] is None
    assert 0 < int((problem.system.cam_free == 0).sum()) < problem.system.total
    assert len(problem.xs) == 4 and problem.system.hpp_inv.dtype == torch.float64


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_plain_matvec_matches_the_dense_product(problem, seed):
    system = problem.system
    Jc, Jp, hinv = _dense(system)
    cf, dc = system.cam_free.numpy(), system.dc.numpy()
    x = problem.xs[seed] if seed < len(problem.xs) else _vec(system, seed)
    xn = x.numpy()
    u = Jc @ (cf * xn)
    ref = cf * (Jc.T @ (u - Jp @ (hinv @ (Jp.T @ u)))) + dc * xn
    _close(smv.schur_matvec_plain(system, x).numpy(), ref, 1e-10)
    assert np.all(smv.schur_matvec_plain(system, x).numpy()[cf == 0] == (dc * xn)[cf == 0])


def test_plain_rhs_and_row_products_match_the_dense_products(problem):
    system = problem.system
    Jc, Jp, hinv = _dense(system)
    cf = system.cam_free.numpy()
    rng = np.random.default_rng(5)
    g_c = torch.as_tensor(rng.normal(size=system.total))
    g_p = torch.as_tensor(rng.normal(size=(system.num_points, 3)))
    ref = -(g_c.numpy() - cf * (Jc.T @ (Jp @ (hinv @ g_p.numpy().reshape(-1)))))
    _close(smv.schur_rhs(system, g_c, g_p).numpy(), ref, 1e-10)
    x = _vec(system, 6)
    u, jtp_u = smv.row_products(system, x)
    u_ref = Jc @ (cf * x.numpy())
    _close(torch.cat(u).numpy(), u_ref, 1e-10)
    _close(jtp_u.numpy().reshape(-1), Jp.T @ u_ref, 1e-10)


def _previous(system, x):
    """S x, its right-hand side and the back-substitution's products as the
    solver's closures composed them before the kernel existed."""
    mesh, shards, J = system.mesh, system.shards, system.J
    cam_free, dc, hpp_inv, num_ref = system.cam_free, system.dc, system.hpp_inv, system.num_ref
    C, P, dtype, devs = system.total, system.num_points, cam_free.dtype, mesh.devices

    def on(t, s):
        return None if t is None else t.to(devs[s])

    def split(u, jc, jp):
        out, off = [], 0
        for a, b in zip(jc, jp):
            n, k = (b if a is None else a).shape[:2]
            out.append(u[off:off + n * k].reshape(n, k))
            off += n * k
        return out

    def gather_cols(f, xc):
        wref = xc[:num_ref * 7].reshape(num_ref, 7)
        n = f.beg_idx.shape[0]
        return torch.cat([wref[f.beg_idx], wref[f.end_idx],
                          xc[f.const_cols].expand(n, -1)], dim=-1)

    def reduce_cols(contribs, dev):
        gc = torch.zeros(C, dtype=dtype, device=dev)
        gpose = torch.zeros((num_ref, 7), dtype=dtype, device=dev)
        for f, c in contribs:
            gpose.index_add_(0, f.beg_idx, c[:, :7])
            gpose.index_add_(0, f.end_idx, c[:, 7:14])
            gc.index_add_(0, f.const_cols, c[:, 14:].sum(0))
        gc[:num_ref * 7] += gpose.reshape(-1)
        return gc

    def Jmv(xc, xp):
        out = []
        for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
            xcs, xps = on(xc, s), on(xp, s)
            parts = []
            for f, a, b in zip(fams, jc, jp):
                u = None
                if a is not None and xcs is not None:
                    u = torch.einsum("nkb,nb->nk", a, gather_cols(f, xcs))
                if b is not None and xps is not None:
                    up = torch.einsum("nkj,nj->nk", b, xps[f.point_idx])
                    u = up if u is None else u + up
                if u is None:
                    u = torch.zeros((b if a is None else a).shape[:2], dtype=dtype,
                                    device=devs[s])
                parts.append(u.reshape(-1))
            out.append(torch.cat(parts))
        return out

    def JTmv_c(u):
        partials = []
        for s, (fams, (jc, jp), us) in enumerate(zip(shards, J, u)):
            contribs = [(f, torch.einsum("nkb,nk->nb", a, ub))
                        for f, a, ub in zip(fams, jc, split(us, jc, jp)) if a is not None]
            partials.append(reduce_cols(contribs, devs[s]))
        return mesh.sum(partials)

    def JTmv_p(u):
        partials = []
        for s, (fams, (jc, jp), us) in enumerate(zip(shards, J, u)):
            gp = torch.zeros((P, 3), dtype=dtype, device=devs[s])
            for f, b, ub in zip(fams, jp, split(us, jc, jp)):
                if b is not None:
                    gp.index_add_(0, f.point_idx, torch.einsum("nkj,nk->nj", b, ub))
            partials.append(gp)
        return mesh.sum(partials)

    def solve3(rhs):
        return torch.einsum("pij,pj->pi", hpp_inv, rhs)

    u = Jmv(x * cam_free, None)
    w = solve3(JTmv_p(u))
    z = Jmv(None, w)
    mv = JTmv_c([a - b for a, b in zip(u, z)]) * cam_free + dc * x
    g_p = torch.as_tensor(np.random.default_rng(8).normal(size=(P, 3)))
    rhs = -(x - JTmv_c(Jmv(None, solve3(g_p))) * cam_free)
    return mv, (g_p, rhs), (u, JTmv_p(u))


@pytest.mark.parametrize("which", ["one shard", "two shards"])
def test_plain_version_is_the_previous_composition_bit_for_bit(problem, which):
    system = problem.system if which == "one shard" else problem.sharded
    for x in problem.xs + [_vec(system, 9)]:
        mv, (g_p, rhs), (u, jtp_u) = _previous(system, x)
        assert torch.equal(smv.schur_matvec_plain(system, x), mv)
        assert torch.equal(smv.schur_rhs_plain(system, x, g_p), rhs)
        got_u, got_jtp_u = smv.row_products_plain(system, x)
        assert all(torch.equal(a, b) for a, b in zip(got_u, u))
        assert torch.equal(got_jtp_u, jtp_u)


def test_two_logical_shards_match_one(problem):
    one, two = problem.system, problem.sharded
    assert two.mesh.size == 2 and [len(f) for f in two.shards] == [6, 3]
    assert [f.kind for f in two.shards[1]] == ["pix"] * 3
    _close(two.hpp_inv.numpy(), one.hpp_inv.numpy(), 1e-12)
    _close(two.dc.numpy(), one.dc.numpy(), 1e-12)
    rng = np.random.default_rng(11)
    g_c = torch.as_tensor(rng.normal(size=one.total))
    g_p = torch.as_tensor(rng.normal(size=(one.num_points, 3)))
    for seed in range(3):
        x = _vec(one, seed)
        _close(smv.schur_matvec(two, x).numpy(), smv.schur_matvec(one, x).numpy(), 1e-12)
        _close(smv.row_products(two, x)[1].numpy(), smv.row_products(one, x)[1].numpy(),
               1e-12)
    _close(smv.schur_rhs(two, g_c, g_p).numpy(), smv.schur_rhs(one, g_c, g_p).numpy(), 1e-12)


def test_the_cpu_path_neither_builds_nor_launches_the_kernel(problem, monkeypatch):
    def no_build(*args, **kw):
        raise AssertionError("the CPU path reached the kernel's build")

    monkeypatch.setattr(cuda_build, "load_library", no_build)
    before = smv.LAUNCHES
    state0, obs, models = _scene()
    res = schur.make_schur_solver(state0, obs, models, OPTS, problem.mask, max_iterations=2,
                                  cg_iterations=5)(
        prob.pack_state(state0, include_points=False), state0.points)
    assert smv.LAUNCHES == before and res.matvecs > 0
    assert float(res.cost) < float(res.initial_cost)


def test_the_kernel_path_refuses_cpu_tensors(problem, monkeypatch):
    """Handed CPU tensors, the kernel's wrappers raise before any build; they
    never compute on the CPU themselves."""
    monkeypatch.setattr(cuda_build, "load_library", lambda *a, **k: pytest.fail("built"))
    system = dataclasses.replace(problem.system, _plans=None)
    x = problem.xs[0]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        smv.schur_matvec_cuda(system, x)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        smv.row_products_cuda(system, x)
