"""The per-row residuals and block Jacobians of the port's BA
(``solver/row_blocks.py``) on the CPU, where they run their plain version:
against the JAX package's ``_pixel_row_blocks`` / ``_depth_row_blocks`` /
``_prior_row_blocks`` on rows that plant every branch of the residual
(``tests/row_block_scenes.py``), the routing by device, and the solve that
takes them. The kernel (``csrc/row_blocks.cu``) is held to the plain version
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 3d.

Tolerances: rtol 1e-10 / atol 1e-9 against the JAX package (the same
formulas in float64, reverse mode on both sides), the bar of the existing
parity tests; the solve to the bars of ``tests/test_torch_schur.py``'s
solves against the JAX package."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.calib import problem as JPr
from multiview_tpu.solver import schur as JS
from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.solver import row_blocks as rb, schur
from multiview_tpu_torch.utils import cuda_build
from row_block_scenes import (CASES, args_of, every_family_scene, in_float64, planted_rows,
                              row_blocks_of)
from torch_port_scenes import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PORT = {"pixel": rb.pixel_row_blocks, "depth": rb.depth_row_blocks,
        "prior": rb.prior_row_blocks}


def _np(t):
    return None if t is None else np.asarray(t.numpy())


def _jax_obs(cls, obs):
    """A port observation dataclass as the JAX package's."""
    kw = {}
    for f in dataclasses.fields(obs):
        v = getattr(obs, f.name)
        kw[f.name] = v if f.name == "sensor" or v is None else jnp.asarray(v.numpy())
    return cls(**kw)


def _jax_state(st):
    return JPr.RigState(**{f.name: (tuple(jnp.asarray(d.numpy()) for d in st.dist)
                                    if f.name == "dist" else
                                    jnp.asarray(getattr(st, f.name).numpy()))
                           for f in dataclasses.fields(st)})


def _jax_opts(opts):
    return JPr.BAOptions(**dataclasses.asdict(opts))


def _jax_row_blocks(case):
    """(J_cam or None, J_pt, res) of a planted case by the JAX package."""
    st = _jax_state(case.state)
    if case.kind == "pixel":
        return jax.jit(JS._pixel_row_blocks, static_argnums=(2, 3))(
            st, _jax_obs(JPr.PixelObs, case.obs), case.model, _jax_opts(case.opts))
    if case.kind == "depth":
        return jax.jit(JS._depth_row_blocks, static_argnums=(2, 3))(
            st, _jax_obs(JPr.DepthObs, case.obs), _jax_opts(case.opts), case.mesh_variant)
    jp, res = jax.jit(JS._prior_row_blocks, static_argnums=(2, 3))(
        st, _jax_obs(JPr.XyzPriorObs, case.obs), case.weight, case.th)
    return None, jp, res


@pytest.mark.parametrize("name", CASES)
def test_planted_rows_match_the_jax_package(name):
    """Every branch of each family, model and depth_to_image kind (the xyz
    prior's ``prior_row_blocks`` against ``_prior_row_blocks`` among them)."""
    case = planted_rows(0)[name]
    got = row_blocks_of(case, PORT)
    ref = _jax_row_blocks(case)
    for label, g, r in zip(("J_cam", "J_pt", "res"), got, ref):
        if g is None:
            # the mesh variant touches no point: JAX returns zeros, the port None
            assert label == "J_cam" and r is None or not np.asarray(r).any(), label
            continue
        assert g.shape == tuple(np.shape(r)) and torch.isfinite(g).all(), label
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-10, atol=1e-9, err_msg=label)


def test_the_planted_rows_take_each_branch():
    """What the rows plant holds in float64 and in float32 (the dtypes of the
    card's checks): the degenerate bracket gives the end pose and the rig
    exactly zero columns, masked rows and mesh misses zero blocks, the
    camera plane and the exact rows their values."""
    for dtype in (torch.float64, torch.float32):
        cases = planted_rows(0, dtype)
        for name in (c for c in CASES if not c.startswith("prior")):
            case = cases[name]
            jc, jp, res = row_blocks_of(case, PORT)
            assert torch.isfinite(jc).all() and torch.isfinite(res).all(), name
            assert not jc[1, :, 7:21].any(), name           # dt_bracket == 0: no end, no rig
            assert not jc[7].any() and not res[7].any(), name            # masked
            assert not res[-1].any(), name                   # the exact row: residual 0
            st, obs = case.state, case.obs
            w2c = prob.world_to_cam_rows(st, obs)
            if case.kind == "pixel":
                z = pose_mod.pose_apply(w2c, st.points[obs.point_idx])[:, 2]
                assert float(z[-3]) == 0.0 and bool((z[:-3].abs() > 1.0).all()), name
            elif case.mesh_variant:
                miss = ~obs.mesh_mask
                assert miss.any() and not jc[miss].any() and not res[miss].any(), name
        q = cases["pixel-none"].state.world_to_ref[:, 3:]
        dots = (pose_mod.quat_normalize(q[[0, 1]]) * pose_mod.quat_normalize(q[[5, 6]])).sum(-1)
        assert float(dots[0]) < 0.0 and float(dots[1]) > 1.0 - 16 * torch.finfo(dtype).eps


# A host build of the kernel's arithmetic: csrc/row_blocks.cu compiles for
# the host too; this loop over the rows takes the place of the launch.
_HOST_LOOP = r"""
#include "%s"
using namespace rowblocks;
template <typename T> int run(const RowBlocksArgs& h) {
  const Args<T> a = typed_args<T>(h);
  C sp[kSensorMax];
  if (h.family == 0) load_pixel_sensor(a, h.model, sp);
  if (h.family == 1) load_depth_sensor(a, h.affine ? 12 : 7, sp);
  for (long long i = 0; i < a.n; ++i) {
    if (h.family == 2) { prior_row<T>(a, i); continue; }
    if (h.family == 1) {
      if (h.affine && h.mesh) depth_row<T, true, true>(a, sp, i);
      else if (h.affine) depth_row<T, true, false>(a, sp, i);
      else if (h.mesh) depth_row<T, false, true>(a, sp, i);
      else depth_row<T, false, false>(a, sp, i);
      continue;
    }
    switch (h.model) {
      case kNone: pixel_row<T, kNone>(a, sp, i); break;
      case kFov: pixel_row<T, kFov>(a, sp, i); break;
      case kTsai4: pixel_row<T, kTsai4>(a, sp, i); break;
      case kTsai5: pixel_row<T, kTsai5>(a, sp, i); break;
      default: pixel_row<T, kRpc>(a, sp, i);
    }
  }
  return 0;
}
extern "C" int host_row_blocks(const RowBlocksArgs* h) {
  return h->elem == 4 ? run<float>(*h) : run<double>(*h);
}
"""


def test_the_kernel_source_compiled_for_the_host_matches_the_plain_version(tmp_path):
    """csrc/row_blocks.cu's forward-mode arithmetic, compiled by g++ for the
    host and run row by row on the wrappers' own arguments, against the plain
    version in float64 on the same inputs, every planted case, to the card's
    bars: 1e-9 of max |plain| for each output with float64 tensors, 1e-4
    with float32 tensors (the kernel computes in float64 and rounds its
    outputs to float32)."""
    import ctypes
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's arithmetic for the host")
    src = tmp_path / "host_loop.cpp"
    src.write_text(_HOST_LOOP % (cuda_build.CSRC_DIR / rb.SOURCE))
    lib_path = tmp_path / "host_row_blocks.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.host_row_blocks.argtypes = [ctypes.POINTER(rb._Args)]
    wrapper_args = {"pixel": rb._pixel_args, "depth": rb._depth_args, "prior": rb._prior_args}
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        for name, case in planted_rows(0, dtype).items():
            chk, a, out = wrapper_args[case.kind](*args_of(case))
            a.elem = dtype.itemsize
            assert lib.host_row_blocks(ctypes.byref(a)) == 0
            ref = PORT[case.kind](*in_float64(args_of(case)))
            for g, r in zip(out, ref):
                if r is None:
                    continue
                assert torch.isfinite(g).all(), (name, dtype)
                err = float((g - r).abs().max())
                assert err <= tol * float(r.abs().max()), (name, dtype, err)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """A CPU solve with every family runs the plain version: no build, no
    launch."""
    monkeypatch.setattr(cuda_build, "load_library",
                        lambda *a, **k: pytest.fail("the CPU path reached the kernel's build"))
    state0, obs, models, opts, mask = every_family_scene(rig_rot=0.002, rig_trans=0.003)
    before = rb.LAUNCHES
    res = schur.make_schur_solver(state0, obs, models, opts, mask, max_iterations=2,
                                  cg_iterations=5)(
        prob.pack_state(state0, include_points=False), state0.points)
    assert rb.LAUNCHES == before
    assert float(res.cost) < float(res.initial_cost)


def test_the_kernel_wrappers_refuse_what_they_do_not_take(monkeypatch):
    """Handed CPU tensors, a dtype, shape or index type they do not take, or
    a distortion model and coefficient count they have no kernel for (an
    irregular rpc count, rpc of degree 9), the ``*_cuda`` wrappers raise
    before any build."""
    monkeypatch.setattr(cuda_build, "load_library", lambda *a, **k: pytest.fail("built"))
    cases = planted_rows(0)
    pix, depth, prior = cases["pixel-tsai4"], cases["depth-tri-affine"], cases["prior-cauchy"]
    with pytest.raises(ValueError, match="not on a CUDA device"):
        rb.pixel_row_blocks_cuda(pix.state, pix.obs, pix.model, pix.opts)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        rb.depth_row_blocks_cuda(depth.state, depth.obs, depth.opts, False)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        rb.prior_row_blocks_cuda(prior.state, prior.obs, prior.weight, prior.th)
    half = planted_rows(0, torch.float16)["pixel-tsai4"]
    with pytest.raises(TypeError, match="float32 or float64"):
        rb.pixel_row_blocks_cuda(half.state, half.obs, half.model, half.opts)
    with pytest.raises(ValueError, match="shape"):
        rb.pixel_row_blocks_cuda(pix.state, dataclasses.replace(pix.obs, pix=pix.obs.pix[:, :1]),
                                 pix.model, pix.opts)
    with pytest.raises(TypeError, match="int64"):
        rb.pixel_row_blocks_cuda(pix.state, dataclasses.replace(
            pix.obs, beg_idx=pix.obs.beg_idx.int()), pix.model, pix.opts)
    with pytest.raises(ValueError, match="contiguous"):
        rb.depth_row_blocks_cuda(depth.state, dataclasses.replace(
            depth.obs, depth_xyz=depth.obs.depth_xyz.t().contiguous().t()), depth.opts, False)
    for d in (10, 2 * rb.dist_mod.rpc_num_params_from_degree(rb.RPC_MAX_DEGREE + 1)):
        rpc = dataclasses.replace(pix.state, dist=(pix.state.dist[0],
                                                   torch.zeros(d, dtype=torch.float64)))
        with pytest.raises(ValueError, match="no kernel"):
            rb.pixel_row_blocks_cuda(rpc, pix.obs, "rpc", pix.opts)
    for model, d in (("none", 0), ("fov", 1), ("tsai", 4), ("tsai", 5), ("rpc", 20),
                     ("rpc", 2 * rb.dist_mod.rpc_num_params_from_degree(rb.RPC_MAX_DEGREE))):
        rb.model_code(model, d)


def _jax_problem(state0, obs):
    """The JAX package's RigState and Observations of a port scene."""
    return _jax_state(state0), JPr.Observations(
        pixels=tuple(_jax_obs(JPr.PixelObs, o) for o in obs.pixels),
        depths=tuple(_jax_obs(JPr.DepthObs, o) for o in obs.depths),
        tri_prior=_jax_obs(JPr.XyzPriorObs, obs.tri_prior))


def test_the_cg_blocks_solve_matches_the_jax_package():
    """The ``cg_blocks`` solve of tests/test_torch_schur_matvec.py's scene
    (every family, its rows through ``solver/row_blocks.py``) against the JAX
    package's solver on the same scene, with the CG run to 1e-10: the same LM
    count, CG counts within 1% (the last steps of a converging CG cross the
    tolerance a step apart), the costs, cameras and points to the bars of
    tests/test_torch_schur.py. A CG cut at 20 steps is not compared: its
    truncated solution amplifies rounding, and the two packages' steps part
    by 1e-6 of the cost after one LM iteration on this scene although their
    row blocks agree to 1e-10."""
    state0, obs, models, opts, mask = every_family_scene(rig_rot=0.002, rig_trans=0.003)
    jst, jobs = _jax_problem(state0, obs)
    kw = dict(max_iterations=4, cg_iterations=100, cg_tolerance=1e-10)
    jres = jax.jit(JS.make_schur_solver(jst, jobs, models, _jax_opts(opts), mask, **kw))(
        JPr.pack_state(jst, include_points=False), jst.points)
    tres = schur.make_schur_solver(state0, obs, models, opts, mask, **kw)(
        prob.pack_state(state0, include_points=False), state0.points)
    assert tres.iterations == int(jres.iterations) == 4
    assert abs(int(tres.cg_iters_total) - int(jres.cg_iters_total)) <= \
        0.01 * int(jres.cg_iters_total)
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-6)
    np.testing.assert_allclose(tres.cam.numpy(), np.asarray(jres.cam), atol=1e-6)
    np.testing.assert_allclose(tres.points.numpy(), np.asarray(jres.points), atol=1e-6)
    assert float(tres.cost) < float(tres.initial_cost)


def test_the_first_lm_step_at_the_default_rig_perturbation_is_rejected_in_both_packages():
    """At the default rig perturbation (0.02 rad / 3 cm) the first LM step
    on this scene is rejected by the JAX package's solver too: the same
    cost, lam raised to 2e-4 from 1e-4, the same CG count."""
    state0, obs, models, opts, mask = every_family_scene()
    jst, jobs = _jax_problem(state0, obs)
    kw = dict(debug_unroll_lm=1, cg_iterations=20)
    jres = jax.jit(JS.make_schur_solver(jst, jobs, models, _jax_opts(opts), mask, **kw))(
        JPr.pack_state(jst, include_points=False), jst.points)
    tres = schur.make_schur_solver(state0, obs, models, opts, mask, **kw)(
        prob.pack_state(state0, include_points=False), state0.points)
    for r in (jres, tres):
        assert float(r.cost) == float(r.initial_cost)           # the step is rejected
        assert float(r.lam) == pytest.approx(2e-4, rel=1e-12)
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-10)
    assert int(tres.cg_iters_total) == int(jres.cg_iters_total)
