"""Port parity: the dense LM, the RPC fit and inverse refit, and the dense
back end of ``optimize_rig`` of multiview_tpu_torch against the JAX package,
in float64 on the CPU.

Tolerances: LM solutions 1e-9 with equal iteration counts; RPC coefficients
rtol 1e-5 (asked: 1e-6; measured 3.6e-6 on 3 of 76 coefficients of an
ill-conditioned fit, the rest within 1e-6) and the round-trip error within
1e-6 px of the JAX value; the refit state 1e-6; the dense ``optimize_rig``
1e-8."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.calib import calibrator as JCal, problem as JPr
from multiview_tpu.geometry import camera as JC, distortion as JD, pose as JP, rpc_fit as JRpc
from multiview_tpu.solver.lm import levenberg_marquardt as jax_lm
from multiview_tpu.utils import synthetic as JSyn
from multiview_tpu_torch.calib import calibrator as TCal, problem as TPr
from multiview_tpu_torch.geometry import camera as TC, distortion as TD, rpc_fit as TRpc
from multiview_tpu_torch.solver.lm import levenberg_marquardt as torch_lm
from torch_port_scenes import one_torch_thread, port_problem

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_RNG = np.random.default_rng(0)
_A, _B = _RNG.normal(size=(20, 5)), _RNG.normal(size=20)
_T50, _T30 = np.linspace(0, 1, 50), np.linspace(0, 1, 30)
_Y50 = 2.0 * np.exp(-1.3 * _T50)


def _lm_cases(xp, arr, stack):
    """The LM problems of tests/test_lm_rpc.py on either array library:
    name -> (residual, x0, keyword arguments)."""
    A, b, t50, y50, t30 = arr(_A), arr(_B), arr(_T50), arr(_Y50), arr(_T30)
    y30 = 2.0 * t30 + 3.0
    return {
        "linear_one_step": (lambda x: A @ x - b, arr(np.zeros(5)), dict(max_iterations=10)),
        "rosenbrock": (lambda x: stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]]),
                       arr([-1.2, 1.0]), dict(max_iterations=100)),
        "exponential_fit": (lambda p: p[0] * xp.exp(p[1] * t50) - y50, arr([1.0, 0.0]),
                            dict(max_iterations=50)),
        "mask_freezes": (lambda p: p[0] * t30 + p[1] - y30, arr([0.0, 9.9]),
                         dict(max_iterations=50, mask=arr(np.array([True, False])))),
        "bounds_projection": (lambda p: p - arr([5.0]), arr([0.0]),
                              dict(max_iterations=20, lower=arr([-1.0]), upper=arr([2.0]))),
        "indefinite_start": (lambda p: stack([p[0] * p[1] - 1.0, p[0] - 2.0, 1e-3 * p[1]]),
                             arr([0.0, 0.0]), dict(max_iterations=60, lam0=1e-12)),
    }


@pytest.mark.parametrize("case", ["linear_one_step", "rosenbrock", "exponential_fit",
                                  "mask_freezes", "bounds_projection", "indefinite_start"])
def test_levenberg_marquardt(case):
    jr, jx0, jkw = _lm_cases(jnp, jnp.asarray, jnp.stack)[case]
    tr, tx0, tkw = _lm_cases(torch, lambda v: torch.as_tensor(np.asarray(v)), torch.stack)[case]
    jres = jax_lm(jr, jx0, **jkw)
    tres = torch_lm(tr, tx0, **tkw)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-9, atol=1e-9)
    assert tres.iterations == int(jres.iterations)
    assert tres.converged == bool(jres.converged)
    np.testing.assert_allclose(float(tres.initial_cost), float(jres.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost), rtol=1e-7, atol=1e-18)
    np.testing.assert_allclose(float(tres.lam), float(jres.lam), rtol=1e-6)
    if case == "mask_freezes":
        assert float(tres.x[1]) == 9.9
    if case == "bounds_projection":
        np.testing.assert_allclose(tres.x.numpy(), [2.0], atol=1e-9)


_TSAI = ((640, 480), (500.0, 500.0), (320.0, 240.0), (-0.1, 0.02, 1e-4, -1e-4))


def test_rpc_helpers_and_sample_pairs():
    for deg in (1, 2, 3):
        np.testing.assert_array_equal(TD.rpc_identity_params(deg), JD.rpc_identity_params(deg))
        np.testing.assert_array_equal(
            TD.rpc_increment_degree(TD.rpc_identity_params(deg)),
            JD.rpc_increment_degree(JD.rpc_identity_params(deg)))
    jcam = JC.CameraParams.create(*_TSAI, distorted_crop_size=(600, 440))
    tcam = TC.CameraParams.create(*_TSAI, distorted_crop_size=(600, 440), device="cpu")
    ju, jd = JRpc.gen_undist_dist_pairs(jcam, 21)
    tu, td = TRpc.gen_undist_dist_pairs(tcam, 21)
    assert 0 < len(ju) < 21 * 21
    np.testing.assert_allclose(tu.numpy(), ju, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-12, atol=1e-10)


def test_fit_rpc_dist_undist_tsai():
    jcam = JC.CameraParams.create(*_TSAI)
    tcam = TC.CameraParams.create(*_TSAI, device="cpu")
    kw = dict(rpc_degree=3, num_samples=20, num_iterations=40)
    jco = JRpc.fit_rpc_dist_undist(jcam, **kw)
    tco = TRpc.fit_rpc_dist_undist(tcam, **kw)
    assert tco.dtype == torch.float64 and tco.shape == jco.shape
    # measured: 3 of 76 coefficients differ by up to 3.6e-6 relative (the normal
    # equations hold monomials of pixel coordinates up to degree 6, and the two
    # packages sum J^T J in another order); the rest agree to 1e-6
    np.testing.assert_allclose(tco.numpy(), jco, rtol=1e-5, atol=1e-12)
    assert np.mean(np.abs(tco.numpy() - jco) <= 1e-6 * np.abs(jco) + 1e-12) > 0.9
    jrt = JRpc.eval_rpc_dist_undist(jcam, jco, num_samples=25)
    trt = TRpc.eval_rpc_dist_undist(tcam, tco, num_samples=25)
    assert abs(trt - jrt) < 1e-6 and trt < 0.2
    rpc_cam = TC.CameraParams.create(*_TSAI[:3], tco, device="cpu")
    assert rpc_cam.model == "rpc"
    pix = torch.tensor([[50.0, 30.0]], dtype=torch.float64)
    np.testing.assert_allclose(rpc_cam.distort_centered(pix).numpy(),
                               tcam.distort_centered(pix).numpy(), atol=0.1)


def test_fit_rpc_runs_in_float64_for_a_float32_camera():
    cam32 = TC.CameraParams.create(*_TSAI, dtype=torch.float32, device="cpu")
    cam64 = TC.CameraParams.create(*_TSAI, device="cpu")
    kw = dict(rpc_degree=2, num_samples=15, num_iterations=30)
    c32, c64 = TRpc.fit_rpc_dist_undist(cam32, **kw), TRpc.fit_rpc_dist_undist(cam64, **kw)
    assert c32.dtype == torch.float64
    assert TRpc.eval_rpc_dist_undist(cam32, c32, num_samples=20) < 0.2
    np.testing.assert_allclose(c32.numpy(), c64.numpy(), rtol=5e-2, atol=1e-6)


def test_refit_rpc_undistortion_after_optimize_rig():
    """Calibrate with a floated RPC distortion (the scene of
    tests/test_lm_rpc.py::TestRpcRefitInCalibration at a small size): the
    inverse half is refit after the pass in both packages."""
    tsai = ((640, 480), (250.0, 250.0), (320.0, 240.0), (-0.02, 0.004, 1e-5, -1e-5))
    true_coeffs = JRpc.fit_rpc_dist_undist(JC.CameraParams.create(*tsai), rpc_degree=2,
                                           num_samples=12, num_iterations=30)
    specs = [
        dict(name="nav_cam", focal=600.0, size=(1280, 960), dist=(), offset=0.0,
             rig=np.array([0, 0, 0, 0, 0, 0, 1.0])),
        dict(name="haz_cam", focal=250.0, size=(640, 480), dist=tuple(true_coeffs), offset=0.3,
             rig=np.asarray(JP.make_pose(jnp.asarray([0.1, 0.02, -0.05]),
                                         JP.quat_exp(jnp.asarray([0.05, -0.03, 0.08]))))),
    ]
    scene = JSyn.make_rig_scene(n_ref=6, n_per_face=3, sensor_specs=specs)
    assert scene.models[1] == "rpc"
    n = len(true_coeffs) // 2
    bad_fwd = true_coeffs[:n] * (1.0 + 0.05 * np.random.default_rng(0).normal(size=n))
    state0 = dataclasses.replace(scene.true_state, dist=(
        scene.true_state.dist[0], jnp.asarray(np.concatenate([bad_fwd, true_coeffs[n:]]))))
    kw = dict(num_passes=1, num_iterations=25, rpc_refit_samples=12,
              sensor_names=["nav_cam", "haz_cam"])
    jcam = JC.CameraParams.create(*tsai[:3], true_coeffs)
    jres = JCal.optimize_rig(state0, scene.observations, scene.models,
                             JPr.FloatSpec(distortion=(1,)), JPr.BAOptions(),
                             cam_params=[None, jcam], **kw)
    st, obs = port_problem(state0, scene.observations)
    tcam = TC.CameraParams.create(*tsai[:3], true_coeffs, device="cpu")
    tres = TCal.optimize_rig(st, obs, scene.models, TPr.FloatSpec(distortion=(1,)),
                             TPr.BAOptions(), cam_params=[None, tcam], **kw)
    final = tres.state.dist[1].numpy()
    assert not np.array_equal(final[n:], true_coeffs[n:])       # the inverse was refit
    np.testing.assert_allclose(final, np.asarray(jres.state.dist[1]), rtol=1e-6, atol=1e-9)
    cam_final = tcam.with_intrinsics(focal=tres.state.focal[1] * torch.ones(2, dtype=torch.float64),
                                     optical_offset=tres.state.optical_center[1],
                                     dist_coeffs=tres.state.dist[1])
    jcam_final = jcam.with_intrinsics(focal=jres.state.focal[1] * jnp.ones(2),
                                      optical_offset=jres.state.optical_center[1],
                                      dist_coeffs=jres.state.dist[1])
    trt = TRpc.eval_rpc_dist_undist(cam_final, final, num_samples=20)
    jrt = JRpc.eval_rpc_dist_undist(jcam_final, np.asarray(jres.state.dist[1]), num_samples=20)
    assert abs(trt - jrt) < 1e-6 and trt < 0.05       # degree 2 on 12x12 samples
    assert tres.stats_after["haz_cam_pix_x"][1] < 0.1
    # with no cam_params the refit is a no-op, as in the JAX package
    same = TCal.refit_rpc_undistortion(st, scene.models, TPr.FloatSpec(distortion=(1,)), None)
    assert same is st


def test_optimize_rig_dense_backend():
    scene = JSyn.make_cube_scene(n_images=6, n_per_face=3, pix_noise=0.2)
    st0 = JSyn.perturb_state(scene.true_state)
    kw = dict(num_passes=2, num_iterations=12, backend="dense")
    jres = JCal.optimize_rig(st0, scene.observations, scene.models,
                             JPr.FloatSpec(cam_poses=True), JPr.BAOptions(no_rig=True), **kw)
    st, obs = port_problem(st0, scene.observations)
    tres = TCal.optimize_rig(st, obs, scene.models, TPr.FloatSpec(cam_poses=True),
                             TPr.BAOptions(no_rig=True), **kw)
    for tr, jr in zip(tres.lm_results, jres.lm_results):
        assert tr.iterations == int(jr.iterations)
        np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-8)
        assert float(tr.cost) < float(tr.initial_cost)
    np.testing.assert_allclose(TPr.pack_state(tres.state).numpy(),
                               np.asarray(JPr.pack_state(jres.state)), rtol=1e-8, atol=1e-8)
    np.testing.assert_array_equal(tres.observations.pixels[0].mask.numpy(),
                                  np.asarray(jres.observations.pixels[0].mask))
    with pytest.raises(ValueError):
        TCal.optimize_rig(st, obs, scene.models, TPr.FloatSpec(), backend="sparse")
