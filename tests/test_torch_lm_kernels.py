"""The per-iteration assembly (``solver/assembly.py``) and the preconditioned
CG (``solver/cg.py``) of the port's Schur-LM on the CPU, where they run their
plain versions: ``inv3x3_spd`` against the JAX package's; the assembly
against a dense NumPy assembly of the JAX package's own row blocks; both bit
for bit against the composition the solver ran before the kernels existed;
two logical shards against one; the routing by device. The kernels
(``csrc/lm_assembly.cu``, ``csrc/cg_step.cu``) are held to the plain versions
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phases
3e-3f.

The problem: the rig of ``tests/row_block_scenes.py`` with every residual
family (three pixel sensors, depth against the point and the mesh, the xyz
prior) and frozen camera columns, float64; the inputs the solver hands the
assembly and the CG in its first LM iteration, caught by spies. Tolerances:
against the NumPy assembly 1e-10 relative to each output's largest value
(float64, other summation orders, ``np.linalg.inv`` in place of the
closed-form and LU inverses); ``inv3x3_spd`` 1e-10 (the same formula, its
rounding, XLA's against PyTorch's, amplified by the near-rank-1 blocks'
condition numbers of up to 1e4); two logical shards against one 1e-10 (sums
added in another order, amplified by the 7x7 inverses and the CG)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_tpu.calib import problem as JPr
from multiview_tpu.solver import schur as JS
from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.parallel import sharding as sh
from multiview_tpu_torch.solver import assembly as asm, cg, schur, schur_matvec as smv
from multiview_tpu_torch.utils import cuda_build
from row_block_scenes import every_family_scene
from torch_port_scenes import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CG_KW = dict(max_iterations=1, cg_iterations=6, cg_tolerance=1e-9)


def _caught(state0, obs, models, opts, mask, preconditioner):
    """The arguments of the first ``assembly.assemble`` and ``cg.pcg`` calls
    of a one-iteration solve."""
    seen = {}
    originals = (asm.assemble, cg.pcg)

    def spy_asm(*args):
        seen.setdefault("assemble", args)
        return originals[0](*args)

    def spy_cg(*args):
        seen.setdefault("pcg", args)
        return originals[1](*args)

    asm.assemble, cg.pcg = spy_asm, spy_cg
    try:
        schur.make_schur_solver(state0, obs, models, opts, mask, preconditioner=preconditioner,
                                **CG_KW)(prob.pack_state(state0, include_points=False),
                                         state0.points, obs)
    finally:
        asm.assemble, cg.pcg = originals
    return seen


@pytest.fixture(scope="module")
def problem():
    state0, obs, models, opts, mask = every_family_scene(rig_rot=0.002, rig_trans=0.003)
    sobs = sh.shard_observations(obs, sh.make_mesh(["cpu"] * 2))
    out = types.SimpleNamespace(state0=state0, obs=obs, models=models, opts=opts, mask=mask)
    for pre in ("jacobi", "schur_jacobi"):
        setattr(out, pre, _caught(state0, obs, models, opts, mask, pre))
        setattr(out, pre + "_sharded", _caught(state0, sobs, models, opts, mask, pre))
    return out


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_inv3x3_spd_matches_the_jax_package():
    """Damped SPD blocks, near-singular ones and blocks with det <= 0 (a
    zero inverse), 1e-10 relative."""
    rng = np.random.default_rng(0)
    m = rng.normal(size=(64, 3, 3))
    blocks = m @ m.transpose(0, 2, 1) + 1e-3 * np.eye(3)
    u = rng.normal(size=(16, 3, 1))
    blocks[:16] = u @ u.transpose(0, 2, 1) + 1e-3 * np.eye(3)            # near rank 1
    blocks[16:24] = -blocks[16:24]                                         # det < 0
    blocks[24:28] = 0.0                                                    # det = 0
    blocks[28:32] = np.diag([1.0, -2.0, 3.0])                              # indefinite
    got = asm.inv3x3_spd(torch.as_tensor(blocks)).numpy()
    ref = np.asarray(jax.jit(JS.inv3x3_spd)(jnp.asarray(blocks)))
    assert not got[16:28].any() and not ref[16:28].any()
    _close(got, ref, 1e-10)


def _jax_obs(cls, o):
    kw = {}
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        kw[f.name] = v if f.name == "sensor" or v is None else jnp.asarray(v.numpy())
    return cls(**kw)


def _jax_state(st):
    return JPr.RigState(**{f.name: (tuple(jnp.asarray(d.numpy()) for d in st.dist)
                                    if f.name == "dist" else
                                    jnp.asarray(getattr(st, f.name).numpy()))
                           for f in dataclasses.fields(st)})


def _jax_row_blocks(problem, families):
    """Per family (J_cam or None, J_pt or None, res) by the JAX package's
    ``_pixel_row_blocks`` / ``_depth_row_blocks`` / ``_prior_row_blocks``
    at the start state, all in one compile."""
    opts = JPr.BAOptions(**dataclasses.asdict(problem.opts))
    jobs = []
    for f in families:
        if f.kind == "pix":
            jobs.append((JS._pixel_row_blocks, _jax_obs(JPr.PixelObs, f.obs),
                         problem.models[f.obs.sensor], opts))
        elif f.kind == "prior":
            jobs.append((JS._prior_row_blocks, _jax_obs(JPr.XyzPriorObs, f.obs), f.weight, f.th))
        else:
            jobs.append((JS._depth_row_blocks, _jax_obs(JPr.DepthObs, f.obs), opts,
                         f.kind == "depth_mesh"))
    out = jax.jit(lambda st: [fn(st, o, a, b) for fn, o, a, b in jobs])(
        _jax_state(problem.state0))
    blocks = []
    for f, o in zip(families, out):
        if f.kind == "prior":
            blocks.append((None, np.asarray(o[0]), np.asarray(o[1])))
        else:
            jc, jp, res = (np.asarray(x) for x in o)
            blocks.append((jc, None if f.kind == "depth_mesh" else jp, res))
    return blocks


def _numpy_assembly(families, blocks, cam_free, lam, num_ref, num_points):
    """The assembly of ``blocks`` (per family J_cam, J_pt, res) in NumPy: the
    gradient and Hpp as dense products, the diagonal per block column, the
    SCHUR_JACOBI blocks per row and side, ``np.linalg.inv``."""
    C, P = cam_free.shape[0], num_points
    jc_rows, jp_rows, r_rows = [], [], []
    diag = np.zeros(C)
    rows_sides = []
    for f, (a, b, res) in zip(families, blocks):
        n, k = res.shape
        dc_ = np.zeros((n, k, C))
        dp_ = np.zeros((n, k, 3 * P))
        rows = np.arange(n)
        if a is not None:
            beg, end, cols = f.beg_idx.numpy(), f.end_idx.numpy(), f.const_cols.numpy()
            for j in range(7):
                np.add.at(dc_, (rows, slice(None), beg * 7 + j), a[:, :, j])
                np.add.at(dc_, (rows, slice(None), end * 7 + j), a[:, :, 7 + j])
                np.add.at(diag, beg * 7 + j, (a[:, :, j] ** 2).sum(1))
                np.add.at(diag, end * 7 + j, (a[:, :, 7 + j] ** 2).sum(1))
            for i, col in enumerate(cols):
                dc_[:, :, col] += a[:, :, 14 + i]
                diag[col] += (a[:, :, 14 + i] ** 2).sum()
            rows_sides.append((a, b, beg, end, None if b is None else f.point_idx.numpy()))
        if b is not None:
            pidx = f.point_idx.numpy()
            for j in range(3):
                np.add.at(dp_, (rows, slice(None), pidx * 3 + j), b[:, :, j])
        jc_rows.append(dc_.reshape(n * k, C))
        jp_rows.append(dp_.reshape(n * k, 3 * P))
        r_rows.append(res.reshape(-1))
    Jc, Jp, r = np.concatenate(jc_rows), np.concatenate(jp_rows), np.concatenate(r_rows)
    hpp_full = Jp.T @ Jp
    hpp = np.stack([hpp_full[3 * p:3 * p + 3, 3 * p:3 * p + 3] for p in range(P)])
    cam_diag = np.clip(diag, 1e-12, 1e32)
    pt_diag = np.clip(np.diagonal(hpp, axis1=1, axis2=2), 1e-12, 1e32)
    hpp_inv = np.linalg.inv(hpp + lam * pt_diag[:, :, None] * np.eye(3))
    dc = lam * cam_diag * cam_free + (1.0 - cam_free)
    blocks7 = np.zeros((num_ref, 7, 7))
    fp = cam_free[:num_ref * 7].reshape(num_ref, 7)
    for a, b, beg, end, pidx in rows_sides:
        for side, pose in ((0, beg), (1, end)):
            jb = a[:, :, 7 * side:7 * side + 7] * fp[pose][:, None, :]
            bb = np.einsum("nki,nkj->nij", jb, jb)
            if b is not None:
                E = np.einsum("nki,nkm->nim", jb, b)
                bb -= np.einsum("nim,nmq,njq->nij", E, hpp_inv[pidx], E)
            np.add.at(blocks7, pose, bb)
    pose_inv = np.linalg.inv(blocks7 + dc[:num_ref * 7].reshape(num_ref, 7)[:, :, None] *
                             np.eye(7))
    return asm.Assembly(cam_free * (Jc.T @ r), (Jp.T @ r).reshape(P, 3), hpp, cam_diag,
                        pt_diag, hpp_inv, dc, 1.0 / (cam_diag * cam_free + dc), pose_inv)


def test_plain_assembly_matches_a_numpy_assembly_of_the_jax_row_blocks(problem):
    mesh, shards, J, r, cam_free, lam, num_ref, num_points, block, flag = \
        problem.schur_jacobi["assemble"]
    families = shards[0]
    assert [f.kind for f in families] == ["pix", "pix", "pix", "depth_tri", "depth_mesh",
                                          "prior"]
    assert block and 0 < int((cam_free == 0).sum()) < cam_free.shape[0]
    blocks = _jax_row_blocks(problem, families)
    # the solver's row blocks are the JAX package's (tests/test_torch_row_blocks.py)
    for (a, b), (ja, jb, _) in zip(zip(*J[0]), blocks):
        for got, ref in ((a, ja), (b, jb)):
            assert (got is None) == (ref is None)
            if ref is not None:
                _close(got.numpy(), ref, 1e-10)
    ref = _numpy_assembly(families, blocks, cam_free.numpy(), float(lam), num_ref, num_points)
    got = asm.assemble(mesh, shards, J, r, cam_free, lam, num_ref, num_points, True, flag)
    for name, g, want in zip(got._fields, got, ref):
        assert tuple(g.shape) == want.shape, name
        _close(g.numpy(), want, 1e-10)


def _previous_assembly(mesh, shards, J, r, cam_free, lam, num_ref, num_points,
                       use_block_precond):
    """The gradient, Hpp, diagonal, Hpp^-1 and the SCHUR_JACOBI inverses as the
    solver's loop composed them before the kernels existed."""
    dtype, devs, total = cam_free.dtype, mesh.devices, cam_free.shape[0]
    free_pose = cam_free[:num_ref * 7].reshape(num_ref, 7)

    def on(x, s):
        return None if x is None else x.to(devs[s])

    partials = [smv.shard_jtmv_c(fams, jc, jp, us, num_ref, total, dtype, devs[s])
                for s, (fams, (jc, jp), us) in enumerate(zip(shards, J, r))]
    gc_raw = mesh.sum(partials)
    g_p = mesh.sum([smv.shard_jtmv_p(fams, jc, jp, us, num_points, dtype, devs[s])
                    for s, (fams, (jc, jp), us) in enumerate(zip(shards, J, r))])
    g_c = gc_raw * cam_free
    hpp_parts, diag_parts = [], []
    for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
        hpp = torch.zeros((num_points, 3, 3), dtype=dtype, device=devs[s])
        for f, b in zip(fams, jp):
            if b is not None:
                hpp.index_add_(0, f.point_idx, torch.einsum("nki,nkj->nij", b, b))
        hpp_parts.append(hpp)
        diag_parts.append(smv.reduce_cols([(f, torch.sum(a * a, dim=1))
                                           for f, a in zip(fams, jc) if a is not None],
                                          num_ref, total, dtype, devs[s]))
    hpp = mesh.sum(hpp_parts)
    cam_diag = torch.clamp(mesh.sum(diag_parts), 1e-12, 1e32)
    pt_diag = torch.clamp(torch.diagonal(hpp, dim1=-2, dim2=-1), 1e-12, 1e32)
    hpp_inv = asm.inv3x3_spd(hpp + torch.diag_embed(lam * pt_diag))
    dc = lam * cam_diag * cam_free + (1.0 - cam_free)
    precond = 1.0 / (cam_diag * cam_free + dc)
    pose_prec_inv = None
    if use_block_precond:
        block_parts = []
        for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
            fp, hi = on(free_pose, s), on(hpp_inv, s)
            blocks = torch.zeros((num_ref, 7, 7), dtype=dtype, device=devs[s])
            for f, a, b in zip(fams, jc, jp):
                if a is None:
                    continue
                for sl, idx in ((slice(0, 7), f.beg_idx), (slice(7, 14), f.end_idx)):
                    jb = a[:, :, sl] * fp[idx][:, None, :]
                    bb = torch.einsum("nki,nkj->nij", jb, jb)
                    if b is not None:
                        E = torch.einsum("nki,nkm->nim", jb, b)
                        bb = bb - torch.einsum("nim,nmq,njq->nij", E, hi[f.point_idx], E)
                    blocks.index_add_(0, idx, bb)
            block_parts.append(blocks)
        blocks = mesh.sum(block_parts) + torch.diag_embed(
            dc[:num_ref * 7].reshape(num_ref, 7))
        pose_prec_inv = torch.linalg.inv(blocks)
    return asm.Assembly(g_c, g_p, hpp, cam_diag, pt_diag, hpp_inv, dc, precond, pose_prec_inv)


def _previous_pcg(schur_mv, precond, pose_prec_inv, num_ref, rhs, cg_iterations,
                  cg_tolerance, debug_force_cg, check_every):
    """The solver's ``pcg`` closure and ``precond_apply`` as they were."""
    device = rhs.device

    def dot(a, b):
        return torch.sum(a * b)

    if pose_prec_inv is not None:
        rest_precond = precond[num_ref * 7:]

        def precond_apply(v):
            vp = torch.einsum("rij,rj->ri", pose_prec_inv, v[:num_ref * 7].reshape(num_ref, 7))
            return torch.cat([vp.reshape(-1), v[num_ref * 7:] * rest_precond])
    else:
        def precond_apply(v):
            return precond * v

    x = torch.zeros_like(rhs)
    rr = rhs
    p = precond_apply(rr)
    rz = dot(rr, p)

    def step(x, rr, p, rz):
        Ap = schur_mv(p)
        denom = dot(p, Ap)
        pos = denom > 0
        alpha = torch.where(pos, rz / torch.where(pos, denom, torch.ones_like(denom)),
                            torch.zeros_like(denom))
        rr_n = rr - alpha * Ap
        zz = precond_apply(rr_n)
        rz_n = dot(rr_n, zz)
        beta = rz_n / torch.where(rz > 0, rz, torch.ones_like(rz))
        return x + alpha * p, rr_n, zz + beta * p, rz_n

    if debug_force_cg is not None:
        for _ in range(debug_force_cg):
            x, rr, p, rz = step(x, rr, p, rz)
        return x, torch.full((), debug_force_cg, dtype=torch.int64, device=device)
    stop2 = cg_tolerance ** 2 * dot(rhs, rhs)
    active = torch.ones((), dtype=torch.bool, device=device)
    cg_k = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(cg_iterations):
        active = active & (dot(rr, rr) > stop2)
        if k % check_every == 0 and not bool(active):
            break
        new = step(x, rr, p, rz)
        x, rr, p, rz = (torch.where(active, a, b) for a, b in zip(new, (x, rr, p, rz)))
        cg_k = cg_k + active.to(torch.int64)
    return x, cg_k


@pytest.mark.parametrize("shards", ["one shard", "two shards"])
@pytest.mark.parametrize("pre", ["jacobi", "schur_jacobi"])
def test_plain_versions_are_the_previous_composition_bit_for_bit(problem, pre, shards):
    seen = getattr(problem, pre if shards == "one shard" else pre + "_sharded")
    args = seen["assemble"]
    block = args[8]
    assert block == (pre == "schur_jacobi")
    got = asm.assemble_plain(*args[:9])
    ref = _previous_assembly(*args[:9])
    for name, g, want in zip(got._fields, got, ref):
        assert (g is None) == (want is None) and (g is None or torch.equal(g, want)), name
    schur_mv, M, rhs, iterations, tolerance, check_every, force = seen["pcg"]
    assert torch.equal(M.precond, got.precond) and (M.pose_inv is None) == (not block)
    for force, tol in ((None, tolerance), (None, 1e-2), (4, tolerance)):
        x, k = cg.pcg_plain(schur_mv, M, rhs, iterations, tol, check_every, force)
        x_ref, k_ref = _previous_pcg(schur_mv, M.precond, M.pose_inv, args[6], rhs, iterations,
                                     tol, force, check_every)
        assert torch.equal(x, x_ref) and torch.equal(k, k_ref), (force, tol)


def test_the_cg_stops_as_the_reference_test_says(problem):
    """The stop test read every 2 steps: the count is that of a test at
    every step, at most one matvec past it; forced steps run them all."""
    schur_mv, M, rhs, iterations, _, check_every, _ = problem.schur_jacobi["pcg"]
    calls = []

    def counted(v):
        calls.append(1)
        return schur_mv(v)

    x, k = cg.pcg(counted, M, rhs, 40, 1e-2, 2)
    assert 0 < int(k) <= len(calls) <= int(k) + 1 < 40
    x_all, k_all = cg.pcg(schur_mv, M, rhs, 40, 1e-2, 41)
    assert torch.equal(x, x_all) and int(k_all) == int(k)
    calls.clear()
    _, k = cg.pcg(counted, M, rhs, 40, 1e-2, 2, force=7)
    assert int(k) == 7 == len(calls)


def test_two_logical_shards_match_one(problem):
    for pre in ("jacobi", "schur_jacobi"):
        one, two = getattr(problem, pre), getattr(problem, pre + "_sharded")
        assert one["assemble"][0].size == 1 and two["assemble"][0].size == 2
        a1, a2 = asm.assemble(*one["assemble"]), asm.assemble(*two["assemble"])
        for name, g1, g2 in zip(a1._fields, a1, a2):
            assert (g1 is None) == (g2 is None) == (name == "pose_inv" and pre == "jacobi")
            if g1 is not None:
                _close(g2.numpy(), g1.numpy(), 1e-10)
        x1, k1 = cg.pcg(*one["pcg"])
        x2, k2 = cg.pcg(*two["pcg"])
        assert int(k1) == int(k2)
        _close(x2.numpy(), x1.numpy(), 1e-10)


def test_the_cpu_path_neither_builds_nor_launches_a_kernel(problem, monkeypatch):
    def no_build(*args, **kw):
        raise AssertionError("the CPU path reached a kernel's build")

    monkeypatch.setattr(cuda_build, "load_library", no_build)
    before = (asm.LAUNCHES, cg.LAUNCHES)
    res = schur.make_schur_solver(problem.state0, problem.obs, problem.models, problem.opts,
                                  problem.mask, max_iterations=2, cg_iterations=5,
                                  preconditioner="schur_jacobi")(
        prob.pack_state(problem.state0, include_points=False), problem.state0.points)
    assert (asm.LAUNCHES, cg.LAUNCHES) == before and res.matvecs > 0
    assert float(res.cost) < float(res.initial_cost)


def test_the_kernel_paths_refuse_cpu_tensors(problem, monkeypatch):
    """Handed CPU tensors, the kernels' wrappers raise before any build;
    they never compute on the CPU themselves."""
    monkeypatch.setattr(cuda_build, "load_library", lambda *a, **k: pytest.fail("built"))
    args = problem.schur_jacobi["assemble"]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        asm.assemble_cuda(*args)
    schur_mv, M, rhs, iterations, tolerance, check_every, force = problem.schur_jacobi["pcg"]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cg.pcg_cuda(schur_mv, M, rhs, iterations, tolerance, check_every, force)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cg.CudaCG(M, rhs, tolerance)


def test_a_singular_block_raises_at_the_stop_test():
    """The flag the kernel sets is read with the LM loop's stop test: it
    raises there, as ``torch.linalg.inv`` does on the CPU."""
    done = torch.tensor(True)
    assert asm.stop_test(done, asm.new_flag("cpu")) is True
    assert asm.stop_test(~done, asm.new_flag("cpu")) is False
    with pytest.raises(torch.linalg.LinAlgError):
        asm.stop_test(done, torch.ones((), dtype=torch.int32))
