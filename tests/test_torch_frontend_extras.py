"""Port parity: the rest of the front end against the JAX package on the
CPU. SURF detection and description; out-of-core matching through the
feature store; ASP match files; registration to control points; the pose
storage and the plane helpers.

Bars: given the JAX package's determinant-of-Hessian maps, the port selects
bitwise the same SURF keypoints, and its descriptors agree within 1e-3 on at
least 99% of the valid slots (the DoG bar of tests/test_torch_frontend.py:
float32 summation order, and a sample now and then across a bin edge);
out-of-core ``detect_match_features`` builds the tracks of the in-core run;
match files byte for byte the JAX writer's, under the same names;
``register_from_files`` 1e-10 in float64; the pose storage and the plane
helpers 1e-12 on the cases of tests/test_parity_helpers.py and
tests/test_triangulation_registration.py. The port runs on the CPU."""

import re
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.calib import pose_storage as JPS, registration as JReg
from multiview_tpu.geometry import camera as JC, plane as JPlane, pose as JP
from multiview_tpu.io import match_file as JMF
from multiview_tpu.sfm import features as JF
from multiview_tpu.utils import synthetic as jsyn
from multiview_tpu_torch.__main__ import main as torch_main
from multiview_tpu_torch.calib import pose_storage as TPS, registration as TReg
from multiview_tpu_torch.geometry import camera as TC, plane as TPlane, pose as P
from multiview_tpu_torch.io import match_file as TMF, nvm as nvm_io
from multiview_tpu_torch.sfm import features as TF, pipeline as TPl
from multiview_tpu_torch.utils import synthetic as syn
from torch_port_scenes import (one_torch_thread, port_problem, ref_pose, render_plane_image,
                               write_rig_workspace)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def frames():
    return [render_plane_image(ref_pose(i)).astype(np.float32) / 255.0 for i in range(4)]


def test_surf_keypoints_and_descriptors_given_the_jax_maps(frames):
    th, mf, mr = TF.default_threshold("surf"), 30, 5
    shared, n_valid = 0, 0
    for img in frames[:3]:
        bases, sc, ce = jax.jit(JF.detect_scores, static_argnums=(1, 2, 3, 4, 5, 6, 7, 8))(
            jnp.asarray(img), 3, 4, 1.6, th, 10.0, "surf", mf, mr)
        xy, scale, resp, valid = JF.select_keypoints(sc, ce, 3, 1.6, 300, "surf")
        valid = JF._adaptive_valid(resp, valid, th, mf, mr)
        v = np.asarray(valid)
        sel = TF.select_keypoints([torch.as_tensor(np.array(s))[None] for s in sc],
                                  [torch.as_tensor(np.array(c))[None] for c in ce], 3, 1.6, 300,
                                  "surf")
        np.testing.assert_array_equal(TF.adaptive_valid(sel[2], sel[3], th, mf, mr)[0], v)
        for a, b in zip(sel[:3], (xy, scale, resp)):
            np.testing.assert_array_equal(a[0].numpy()[v], np.asarray(b)[v])
        _, dj = JF.describe_keypoints(bases, xy, scale, resp, valid, 1.6, "surf")
        args = ([torch.as_tensor(np.array(b)) for b in bases],
                *(torch.as_tensor(np.array(a)) for a in (xy, scale, resp, valid)))
        _, d = TF.describe_keypoints(*args, 1.6, "surf")
        assert d.shape == (300, 128) and not d[:, 64:].any()
        shared += (np.abs(np.asarray(dj) - d.numpy()).max(-1)[v] < 1e-3).sum()
        n_valid += v.sum()
    assert n_valid > 500
    assert shared >= 0.99 * n_valid, (shared, n_valid)


def test_surf_maps_match_jax(frames):
    """The port's own Hessian maps: the DoH slabs within 1e-4 of the JAX
    package's (float32 blurs summed in another order), the same detections."""
    _, sc_j, ce_j = jax.jit(JF.detect_scores, static_argnums=(1, 2, 3, 4, 5, 6))(
        jnp.asarray(frames[0]), 3, 4, 1.6, 1e-6, 10.0, "surf")
    _, sc_t, ce_t = TF.detect_scores(torch.as_tensor(frames[0])[None], detector="surf",
                                     contrast_threshold=1e-6)
    for a, b, sa, sb in zip(ce_j, ce_t, sc_j, sc_t):
        scale = float(np.abs(np.asarray(a)).max())
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=0, atol=1e-4 * scale)
        assert abs(int((np.asarray(sa) > 0).sum()) - int((sb[0] > 0).sum())) <= 2
    with pytest.raises(ValueError, match="unknown detector"):
        TF.detect_scores(torch.as_tensor(frames[0])[None], detector="orb")


def test_out_of_core_matching_builds_the_in_core_tracks(frames, tmp_path):
    cfg = TPl.FrontendConfig(max_features=300, num_overlaps=2, feature_detector="surf")
    in_core = TPl.detect_match_features(frames, cfg, device="cpu")
    ooc = TPl.FrontendConfig(max_features=300, num_overlaps=2, feature_detector="surf",
                             match_out_of_core=True, matching_working_directory=str(tmp_path),
                             matching_max_num_images_in_cache=2)
    spilled = TPl.detect_match_features(frames, ooc, device="cpu")
    assert len(in_core.tracks) > 100
    assert spilled.tracks == in_core.tracks
    for a, b in zip(spilled.keypoints, in_core.keypoints):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        f"feat_{i:06d}.npz" for i in range(len(frames))]
    store = TPl.FeatureStore(tmp_path, max_in_cache=2, device="cpu")
    store.n = len(frames)
    kp0 = store.kps[0]
    assert [d.shape for d in store.descs] == [(300, 128)] * len(frames)
    assert len(store._cache) == 2 and isinstance(kp0, TF.Keypoints)


def test_match_files_are_the_jax_writers(tmp_path):
    rng = np.random.default_rng(3)
    names = [f"/ws/images/{s}/{t:.2f}.pgm" for s, t in (
        ("nav_cam", 10000.0), ("sci_cam", 10000.63), ("nav_cam", 10001.0), ("nav_cam", 10002.0))]
    keypoints = [rng.uniform(0, 300, (40, 2)) for _ in names]
    tracks = [{c: int(rng.integers(40)) for c in sorted(rng.choice(4, int(rng.integers(2, 5)),
                                                                  replace=False))}
              for _ in range(60)]
    ts = types.SimpleNamespace(tracks=tracks, keypoints=keypoints)
    out_lier = {(p, c) for p in range(60) for c in range(4) if (p * 7 + c) % 11 == 0}

    def inlier(pid, cid):
        return (pid, cid) not in out_lier

    wj = JMF.save_inlier_match_pairs(tmp_path / "jax", names, 2, ts, inlier)
    wt = TMF.save_inlier_match_pairs(tmp_path / "torch", names, 2, ts, inlier)
    assert len(wt) == len(wj) > 3
    for a, b in zip(wj, wt):
        assert a.name == b.name
        assert b.read_bytes() == a.read_bytes()
    assert wt[0].name.count("__") == 3
    xy1, xy2 = TMF.read_match_file(wt[0])
    assert len(xy1) == len(xy2) > 0
    desc = rng.normal(size=(3, 5))
    JMF.write_match_file(tmp_path / "dj.match", keypoints[0][:3], keypoints[1][:3], desc, desc)
    TMF.write_match_file(tmp_path / "dt.match", keypoints[0][:3], keypoints[1][:3], desc, desc)
    assert (tmp_path / "dt.match").read_bytes() == (tmp_path / "dj.match").read_bytes()


def test_registration_matches_jax(tmp_path):
    size, focal, dist = (320, 240), 280.0, (-0.1, 0.02, 1e-4, -2e-4)
    tcam = TC.CameraParams.create(size, focal, (161.0, 119.0), dist, device="cpu")
    jcam = JC.CameraParams.create(size, focal, (161.0, 119.0), dist, dtype=jnp.float64)
    w2c = np.stack([syn.look_at_pose(np.array([0.45 * i, 0.1, 2.0]),
                                     np.array([0.45 * i + 0.15, 0.12, 1.0])) for i in (0, 1)])
    mats = P.pose_to_matrix(torch.as_tensor(w2c)).numpy()
    names = ["/ws/images/nav_cam/10000.00.pgm", "/ws/images/nav_cam/10001.00.pgm"]
    world = syn.write_control_points(tmp_path / "cp.pto", tmp_path / "cp.xyz", names, mats,
                                     [tcam, tcam], n=8)
    # the survey's frame: a similarity away from the cameras'
    R = P.quat_to_matrix(P.quat_exp(torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)))
    surveyed = 1.7 * world @ R.numpy().T + np.array([10.0, -4.0, 2.5])
    (tmp_path / "cp.xyz").write_text("".join(f"{x!r} {y!r} {z!r}\n"
                                             for x, y, z in surveyed.tolist()))
    scene = jsyn.make_rig_scene(n_ref=4, n_per_face=2)
    tstate = port_problem(scene.true_state, scene.observations)[0]
    sj, scale_j, err_j = JReg.register_from_files(
        scene.true_state, tmp_path / "cp.pto", tmp_path / "cp.xyz", names, w2c, [0, 0], [jcam],
        verbose=False)
    st, scale_t, err_t = TReg.register_from_files(
        tstate, tmp_path / "cp.pto", tmp_path / "cp.xyz", names, w2c, [0, 0], [tcam],
        verbose=False)
    assert abs(scale_j - 1.7) < 1e-6 and err_j < 1e-6
    assert abs(scale_t - scale_j) < 1e-10 and abs(err_t - err_j) < 1e-10
    for field in ("world_to_ref", "points", "ref_to_cam"):
        np.testing.assert_allclose(getattr(st, field).numpy(), np.asarray(getattr(sj, field)),
                                   rtol=0, atol=1e-10)


def test_calibrate_with_every_front_end_flag(tmp_path, capsys):
    """One port ``calibrate`` with SURF, out-of-core matching, the match
    files and registration to control points made from the truth. The
    registered camera centres are held to the truth within 0.05 m: at 200x150
    a pixel spans 1.1 cm of the terrain (chip_smoke.py phase 2c holds 0.02 m
    at 1280x960, where it spans 1.8 mm)."""
    ws = tmp_path / "ws"
    write_rig_workspace(ws)
    names, mats = nvm_io.read_camera_poses(ws / "cameras.txt")
    nav = [i for i, n in enumerate(names) if "nav_cam" in n][1:3]
    cam = TC.CameraParams.create((200, 150), 180.0, (100.0, 75.0), device="cpu")
    syn.write_control_points(ws / "cp.pto", ws / "cp.xyz", [names[i] for i in nav], mats[nav],
                             [cam, cam], n=6)
    out = tmp_path / "calib"
    assert torch_main([
        "calibrate", "--device", "cpu", "--rig_config", str(ws / "rig_config.txt"),
        "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
        "--out_dir", str(out), "--rig_transforms_to_float", "--camera_poses_to_float",
        "--bracket_len", "1.5", "--max_features", "300", "--num_overlaps", "2",
        "--num_iterations", "20", "--calibrator_num_passes", "2",
        "--feature_detector", "SURF", "--match_out_of_core", "--matching_working_directory",
        str(tmp_path / "feat"), "--matching_max_num_images_in_cache", "3", "--save_matches",
        "--registration", "--hugin_file", str(ws / "cp.pto"), "--xyz_file",
        str(ws / "cp.xyz")]) == 0
    log = capsys.readouterr().out
    err = float(re.search(r"Registration mean absolute error: (\S+) meters", log).group(1))
    assert err < 0.01
    truth = dict(zip(names, mats))
    for n, M in zip(*nvm_io.read_camera_poses(out / "cameras.txt")):
        c_est, c_true = -M[:3, :3].T @ M[:3, 3], -truth[n][:3, :3].T @ truth[n][:3, 3]
        assert np.linalg.norm(c_est - c_true) < 0.05
    files = list((out / "matches").glob("*.match"))
    assert files and len(list((tmp_path / "feat").glob("feat_*.npz"))) == len(names)
    assert all(len(a) == len(b) > 0 for a, b in map(TMF.read_match_file, files))
    with pytest.raises(SystemExit, match="--hugin_file"):
        torch_main(["calibrate", "--device", "cpu", "--rig_config", str(ws / "rig_config.txt"),
                    "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
                    "--out_dir", str(tmp_path / "c2"), "--num_overlaps", "1", "--registration"])


def _pose(t, rvec):
    return np.array(JP.make_pose(jnp.asarray(t, jnp.float64),
                                 JP.quat_exp(jnp.asarray(rvec, jnp.float64))))


@pytest.mark.parametrize("times,query", [
    ((1.0, 0.0), (0.5, -0.1, 1.1, 1.0, 0.0)),         # tests/test_parity_helpers.py
    ((0.0, 0.3, 0.9, 2.0), (0.1, 0.3, 0.31, 1.5, 2.0, 2.01)),
])
def test_pose_storage_matches_jax(times, query):
    rng = np.random.default_rng(len(times))
    poses = [_pose(rng.normal(0, 1, 3), rng.normal(0, 0.5, 3)) for _ in times]
    sj, st = JPS.StampedPoseStorage(), TPS.StampedPoseStorage()
    for t, p in zip(times, poses):
        sj.add(t, p)
        st.add(t, p)
    assert len(st) == len(sj)
    for q in query:
        a, b = sj.interp_pose(q), st.interp_pose(q)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)


@pytest.mark.parametrize("rvec", [(0.0, 0.0, np.pi / 2), (0.3, -0.2, 0.1), (1e-9, 0.0, 0.0)])
def test_max_rotation_angle_matches_jax(rvec):
    a, b = _pose((0, 0, 0), (0.05, 0.0, -0.02)), _pose((1, 2, 3), rvec)
    assert abs(TPS.max_rotation_angle(a, b) - JPS.max_rotation_angle(a, b)) < 1e-9


def test_plane_helpers_match_jax():
    """The cases of tests/test_triangulation_registration.py::TestPlaneUtils."""
    rng = np.random.default_rng(0)
    n = rng.normal(size=(64, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.concatenate([n, [[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]]])     # the poles
    aj, ej = JPlane.normal_to_azimuth_elevation(jnp.asarray(n))
    at, et = TPlane.normal_to_azimuth_elevation(torch.as_tensor(n))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0, atol=1e-12)
    np.testing.assert_allclose(TPlane.azimuth_elevation_to_normal(at, et).numpy(), n, atol=1e-12)
    for v in ([0.05, -0.03, 0.998], [0.7, 0.02, 0.7], [-0.3, 0.9, -0.2]):
        got = TPlane.snap_plane_normal(torch.tensor(v, dtype=torch.float64))
        np.testing.assert_allclose(got.numpy(), np.asarray(JPlane.snap_plane_normal(jnp.asarray(v))),
                                   rtol=0, atol=1e-12)
    rng = np.random.default_rng(1)
    xy = rng.uniform(-1, 1, (200, 2))
    pts = np.column_stack([xy, 2.0 + 0.3 * xy[:, 0] - 0.2 * xy[:, 1] + rng.normal(0, 1e-4, 200)])
    cj, nj = JPlane.best_fit_plane(jnp.asarray(pts))
    ct, nt = TPlane.best_fit_plane(torch.as_tensor(pts))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(nt.numpy() * np.sign(nt.numpy() @ np.asarray(nj)),
                               np.asarray(nj), rtol=0, atol=1e-12)
