"""Port parity: checkpoint and resume of ``optimize_rig`` in
multiview_tpu_torch. The port writes ``state_<pass>.npz``,
``masks_<pass>.npz`` and ``latest.json`` (the JAX package writes its state
through orbax): the files differ, the behaviour must not. A run resumed after
pass 1 ends bit-equal to the uninterrupted run of the port, and within 1e-10
of the JAX package's resumed run."""

import json

import numpy as np
import pytest
import torch

from multiview_tpu.calib import calibrator as JCal, checkpoint as JCk, problem as JPr
from multiview_tpu.utils import synthetic as JSyn
from multiview_tpu_torch.calib import calibrator as TCal, checkpoint as TCk, problem as TPr
from torch_port_scenes import make_depth_scene, one_torch_thread, port_problem

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_save_load_round_trip_with_empty_distortion_and_depth_masks(tmp_path):
    scene = make_depth_scene(JSyn)
    st, obs = port_problem(JSyn.perturb_rig_state(scene.true_state), scene.observations)
    assert st.dist[0].numel() == 0                      # the pinhole reference sensor
    dm = obs.depths[0].mask.clone()
    dm[::3] = False
    obs = TPr.Observations(pixels=obs.pixels,
                           depths=(TPr.DepthObs(**{**obs.depths[0].__dict__, "mask": dm}),))
    assert TCk.latest_pass(tmp_path) is None
    TCk.save_checkpoint(tmp_path, st, obs, 3)
    assert TCk.latest_pass(tmp_path) == 3
    assert json.loads((tmp_path / "latest.json").read_text()) == {"pass": 3}
    assert (tmp_path / "state_3.npz").is_file() and (tmp_path / "masks_3.npz").is_file()
    fresh = port_problem(scene.true_state, scene.observations)
    st2, obs2, p = TCk.load_checkpoint(tmp_path, *fresh)
    assert p == 3
    np.testing.assert_array_equal(TPr.pack_state(st2).numpy(), TPr.pack_state(st).numpy())
    assert [tuple(d.shape) for d in st2.dist] == [tuple(d.shape) for d in st.dist]
    for a, b in zip(obs2.pixels + obs2.depths, obs.pixels + obs.depths):
        np.testing.assert_array_equal(a.mask.numpy(), b.mask.numpy())
    # the masks file has the JAX package's keys
    JCk_keys = {f"pix_{o.sensor}" for o in scene.observations.pixels} | {"depth_1"}
    assert set(np.load(tmp_path / "masks_3.npz").files) == JCk_keys


def test_resumed_run_ends_where_the_uninterrupted_run_ends(tmp_path):
    scene = JSyn.make_cube_scene(n_images=6, n_per_face=3, pix_noise=0.2)
    st0 = JSyn.perturb_state(scene.true_state)
    kw = dict(num_passes=2, num_iterations=15, max_reprojection_error=0.5)
    st, obs = port_problem(st0, scene.observations)
    spec, opts = TPr.FloatSpec(cam_poses=True), TPr.BAOptions(no_rig=True)
    full = TCal.optimize_rig(st, obs, scene.models, spec, opts, checkpoint_dir=tmp_path / "t",
                             **kw)
    assert TCk.latest_pass(tmp_path / "t") == 1
    # a crash after pass 1: the record says pass index 0 was the last finished
    (tmp_path / "t" / "latest.json").write_text(json.dumps({"pass": 0}))
    resumed = TCal.optimize_rig(st, obs, scene.models, spec, opts,
                                checkpoint_dir=tmp_path / "t", resume=True, **kw)
    assert len(resumed.lm_results) == 1 and len(full.lm_results) == 2
    assert torch.equal(TPr.pack_state(resumed.state), TPr.pack_state(full.state))
    assert torch.equal(resumed.observations.pixels[0].mask, full.observations.pixels[0].mask)
    assert float(resumed.lm_results[-1].cost) == float(full.lm_results[-1].cost)
    for k in full.stats_after:
        np.testing.assert_array_equal(resumed.stats_after[k], full.stats_after[k])
    # resume with nothing saved runs every pass
    cold = TCal.optimize_rig(st, obs, scene.models, spec, opts,
                             checkpoint_dir=tmp_path / "empty", resume=True, **kw)
    assert len(cold.lm_results) == 2

    jspec, jopts = JPr.FloatSpec(cam_poses=True), JPr.BAOptions(no_rig=True)
    JCal.optimize_rig(st0, scene.observations, scene.models, jspec, jopts,
                      checkpoint_dir=tmp_path / "j", **kw)
    (tmp_path / "j" / "latest.json").write_text(json.dumps({"pass": 0}))
    jres = JCal.optimize_rig(st0, scene.observations, scene.models, jspec, jopts,
                             checkpoint_dir=tmp_path / "j", resume=True, **kw)
    assert JCk.latest_pass(tmp_path / "j") == 1 and len(jres.lm_results) == 1
    np.testing.assert_allclose(TPr.pack_state(resumed.state).numpy(),
                               np.asarray(JPr.pack_state(jres.state)), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(resumed.observations.pixels[0].mask.numpy(),
                                  np.asarray(jres.observations.pixels[0].mask))
