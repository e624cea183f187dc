"""Port parity for incremental SfM (``multiview_tpu_torch/sfm/incremental.py``)
on the scenes of tests/test_incremental_sfm.py, with the JAX package's
hypothesis draws handed to the port's RANSACs.

Bars: registered masks and valid-point masks equal; poses within the bars
tests/test_incremental_sfm.py holds the JAX package to against the truth
(1e-6 noise-free, 0.05 with noise and bad matches, after a similarity
alignment); poses within 1e-6 of the JAX result (both run float64 on the
CPU; the bundle adjustments sum in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_incremental_sfm as ref_tests
from multiview_tpu.sfm import incremental as JI
from multiview_tpu_torch.sfm import incremental as TI
from multiview_tpu_torch.sfm import ransac as TR
from torch_port_scenes import jax_sampler, one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _scene(case):
    if case == "noise_free":
        poses_true, pts, pair_data, track_obs = ref_tests._ring_scene()
        return poses_true, pts, pair_data, track_obs, dict(min_pnp_inliers=20), 1e-6
    poses_true, pts, pair_data, track_obs = ref_tests._ring_scene(noise=1e-3, seed=1)
    rng = np.random.default_rng(2)
    obs_cam, obs_pid, obs_uv = track_obs
    bad = rng.random(len(obs_cam)) < 0.10
    obs_uv = obs_uv.copy()
    obs_uv[bad] += rng.uniform(0.05, 0.2, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
    return (poses_true, pts, pair_data, (obs_cam, obs_pid, obs_uv),
            dict(min_pnp_inliers=20, reproj_threshold=5e-3), 0.05)


@pytest.mark.parametrize("case", ["noise_free", "bad_matches"])
def test_run_incremental_sfm_matches_jax(case, monkeypatch):
    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    poses_true, pts, pair_data, track_obs, opts, bar = _scene(case)
    pj, rj, xj, vj = JI.run_incremental_sfm(pair_data, len(poses_true), track_obs,
                                            JI.IncrementalOptions(**opts))
    pt, rt, xt, vt = TI.run_incremental_sfm(pair_data, len(poses_true), track_obs,
                                            TI.IncrementalOptions(**opts), device="cpu")
    assert rt.sum() == len(poses_true) and np.array_equal(rj, rt)
    assert np.array_equal(vj, vt) and vt.sum() >= (0.95 if case == "noise_free" else 0.9) * len(pts)
    assert ref_tests._ate_after_alignment(pt.numpy(), poses_true, rt) < bar
    assert np.abs(np.asarray(pj) - pt.numpy()).max() < 1e-6
    assert np.abs(np.asarray(xj)[vj] - xt.numpy()[vt]).max() < 1e-6


def test_triangulation_reprojection_and_ray_angle_match_jax():
    poses_true, pts, pair_data, (obs_cam, obs_pid, obs_uv) = ref_tests._ring_scene(
        n_views=5, n_points=30, noise=1e-3, seed=4)
    V, Pn = 5, 30
    track_cam = np.tile(np.arange(V), (Pn, 1))
    track_uv = obs_uv.reshape(V, Pn, 2).transpose(1, 0, 2).copy()
    mask = np.random.default_rng(0).random((Pn, V)) < 0.8
    mask[0] = False
    xj, vj = JI._triangulate_all(jnp.asarray(poses_true), jnp.asarray(track_cam),
                                 jnp.asarray(track_uv), jnp.asarray(mask))
    xt, vt = TI._triangulate_all(torch.as_tensor(poses_true), torch.as_tensor(track_cam),
                                 torch.as_tensor(track_uv), torch.as_tensor(mask))
    assert np.array_equal(np.asarray(vj), vt.numpy()) and not vt[0] and vt.sum() > 20
    assert np.abs(np.asarray(xj) - xt.numpy()).max() < 1e-10
    assert np.abs(xt.numpy()[vt.numpy()] - pts[vt.numpy()]).max() < 0.05
    ej, zj = JI._reproj_errors(jnp.asarray(poses_true), jnp.asarray(pts), jnp.asarray(obs_cam),
                               jnp.asarray(obs_pid), jnp.asarray(obs_uv))
    et, zt = TI._reproj_errors(torch.as_tensor(poses_true), torch.as_tensor(pts),
                               torch.as_tensor(obs_cam), torch.as_tensor(obs_pid),
                               torch.as_tensor(obs_uv))
    assert np.abs(np.asarray(ej) - et.numpy()).max() < 1e-12
    assert np.abs(np.asarray(zj) - zt.numpy()).max() < 1e-12
    x1, x2 = pair_data[(0, 1)]
    R = np.eye(3)
    inl = np.arange(len(x1)) % 2 == 0
    assert JI._median_ray_angle_deg(x1, x2, R, inl) == TI._median_ray_angle_deg(x1, x2, R, inl)
    assert TI._median_ray_angle_deg(x1, x2, R, np.zeros(len(x1), bool)) == 0.0


def test_no_pair_with_enough_inliers_raises_as_jax_does():
    rng = np.random.default_rng(0)
    pair_data = {(0, 1): (rng.normal(size=(5, 2)), rng.normal(size=(5, 2)))}
    obs = (np.zeros(4, int), np.arange(4), rng.normal(size=(4, 2)))
    for run, kw in ((JI.run_incremental_sfm, {}), (TI.run_incremental_sfm, {"device": "cpu"})):
        with pytest.raises(ValueError, match="no pair with enough inliers"):
            run(pair_data, 2, obs, **kw)
