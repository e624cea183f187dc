"""Port parity for the slice as a whole: both ``sfm-init`` CLIs on the
single-sensor workspace of tests/test_cli_tools.py (five 200x150 frames of a
textured terrain along a line, 300 features, written as PGM), GLOBAL once and
INCREMENTAL once, the JAX package's RANSAC draws handed to the port; then the
port's ``calibrate --nvm`` from the port's cameras.nvm.

Bars: both packages read each cameras.nvm alike; every view registered; the
assertions of tests/test_cli_tools.py::TestSfmInitTool (5 views, more than 20
points, the trajectory's spread for GLOBAL, finite distinct centres for
INCREMENTAL with that test's two loosened flags); track counts within 5%;
in the gauge of the first camera, camera centres within 2% of the
trajectory's length and rotations within 0.5 deg of the JAX package's
(features differ by float32 summation order, and the refinement BA stops
after 30 iterations in both). The port runs with ``--device cpu``."""

import re

import numpy as np
import pytest
import torch

from multiview_tpu.__main__ import main as jax_main
from multiview_tpu.io import nvm as jax_nvm
from multiview_tpu_torch.__main__ import main as torch_main
from multiview_tpu_torch.geometry import pose as P
from multiview_tpu_torch.io import nvm as nvm_io, rig_config as rc
from multiview_tpu_torch.sfm import ransac as TR
from multiview_tpu_torch.utils import synthetic as syn
from multiview_tpu_torch.utils.images import write_pgm
from torch_port_scenes import FOCAL, jax_sampler, one_torch_thread, render_plane_image, SIZE

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_IMG = 5
COMMON = ["--max_features", "300", "--num_overlaps", "2"]
INCREMENTAL = ["--reconstruction_estimator", "INCREMENTAL",
               "--min_num_absolute_pose_inliers", "6",
               "--absolute_pose_reprojection_error_threshold", "30"]


def _write_workspace(ws):
    sensor = rc.SensorConfig(
        name="nav_cam", focal_length=FOCAL, optical_center=np.array([SIZE[0] / 2.0, SIZE[1] / 2.0]),
        distortion=np.array([]), image_size=SIZE, distorted_crop_size=SIZE,
        undistorted_image_size=SIZE, ref_to_sensor=np.eye(4), depth_to_image=np.eye(4),
        timestamp_offset=0.0)
    rc.write_rig_config(ws / "rig_config.txt", rc.RigConfig([sensor]))
    d = ws / "images" / "nav_cam"
    d.mkdir(parents=True)
    names, mats = [], []
    for i in range(N_IMG):
        pos = np.array([0.4 * i, 0.1 * i, 2.0 + 0.05 * i])
        w2c = syn.look_at_pose(pos, pos + np.array([0.15, 0.0, -1.0]))   # near-nadir view
        path = d / f"{10000 + i:.1f}.pgm"
        write_pgm(path, render_plane_image(w2c))
        names.append(str(path))
        mats.append(P.pose_to_matrix(torch.as_tensor(w2c)).numpy())
    nvm_io.write_camera_poses(ws / "cameras.txt", names, np.stack(mats))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    """The four CLI runs on one workspace: {(package, estimator): (out dir,
    log)}. The port's RANSACs draw what the JAX package draws."""
    ws = tmp_path_factory.mktemp("sfmws")
    _write_workspace(ws)
    mp = pytest.MonkeyPatch()
    mp.setattr(TR, "sample_hypotheses", jax_sampler)
    out = {"ws": ws}
    try:
        for est, extra in (("GLOBAL", []), ("INCREMENTAL", INCREMENTAL)):
            for pkg, main, dev in (("jax", jax_main, []), ("torch", torch_main,
                                                           ["--device", "cpu"])):
                d = ws / f"sfm_{pkg}_{est}"
                with pytest.MonkeyPatch.context() as cap:
                    import io
                    import sys
                    buf = io.StringIO()
                    cap.setattr(sys, "stdout", buf)
                    ret = main(["sfm-init", "--rig_config", str(ws / "rig_config.txt"),
                                "--images", str(ws / "images"), "--out_dir", str(d)]
                               + COMMON + extra + dev)
                assert ret == 0
                out[(pkg, est)] = (d, buf.getvalue())
    finally:
        mp.undo()
    return out


def _centres(data):
    return np.stack([-M[:3, :3].T @ M[:3, 3] for M in data.world_to_cam])


def _first_camera_gauge(world_to_cam):
    """[N,4,4] world->cam matrices -> [N,3,4]: relative to the first camera,
    camera centres (in the last column) in units of the distance between the
    first and the last."""
    M = np.asarray(world_to_cam) @ np.linalg.inv(world_to_cam[0])
    out = M[:, :3].copy()
    out[:, :, 3] = -np.einsum("nji,nj->ni", M[:, :3, :3], M[:, :3, 3])
    out[:, :, 3] /= np.linalg.norm(out[-1, :, 3])
    return out


def _compare(runs, est):
    (dj, log_j), (dt, log_t) = runs[("jax", est)], runs[("torch", est)]
    nj, nt = nvm_io.read_nvm(dj / "cameras.nvm"), nvm_io.read_nvm(dt / "cameras.nvm")
    assert [n.split("/")[-1] for n in nt.cid_to_filename] == \
        [n.split("/")[-1] for n in nj.cid_to_filename]
    assert len(nt.cid_to_filename) == N_IMG and len(nt.pid_to_cid_fid) > 20
    tracks_j = int(re.search(r"Built (\d+) tracks", log_j).group(1))
    tracks_t = int(re.search(r"Built (\d+) tracks", log_t).group(1))
    assert abs(tracks_t - tracks_j) <= 0.05 * tracks_j, (tracks_t, tracks_j)
    assert abs(len(nt.pid_to_cid_fid) - len(nj.pid_to_cid_fid)) <= 0.05 * len(nj.pid_to_cid_fid)
    for stage in ("detect+match+tracks", "global/incremental sfm", "robust BA refinement",
                  "triangulate + write"):
        assert re.search(rf"\[sfm-init\] {re.escape(stage)}: \S+ s", log_t), stage
    # in the gauge of the first camera, with the first-to-last baseline as the
    # unit (an alignment of the centres alone leaves the rotation about a
    # near-collinear trajectory free)
    gj, gt = _first_camera_gauge(nj.world_to_cam), _first_camera_gauge(nt.world_to_cam)
    assert np.linalg.norm(gj[:, :, 3] - gt[:, :, 3], axis=-1).max() < 0.02
    cosang = (np.einsum("nij,nij->n", gj[:, :, :3], gt[:, :, :3]) - 1.0) / 2.0
    assert np.degrees(np.arccos(np.clip(cosang, -1, 1))).max() < 0.5
    return nt


def test_sfm_init_global_cli_matches_jax(runs):
    nvm = _compare(runs, "GLOBAL")
    ctrs = _centres(nvm)      # camera centres spread roughly linearly (the true trajectory)
    assert np.linalg.norm(ctrs[4] - ctrs[0]) > 2.5 * np.linalg.norm(ctrs[1] - ctrs[0])
    # against the truth: the centres only (they lie on a line, so their
    # alignment leaves the rotation about it free)
    ate = syn.compute_ate(nvm.cid_to_filename, nvm.world_to_cam, runs["ws"] / "cameras.txt")
    assert ate["n_poses"] == N_IMG and ate["ate_rmse_m"] < 0.05


def test_sfm_init_incremental_cli_matches_jax(runs):
    nvm = _compare(runs, "INCREMENTAL")
    assert "Incremental SfM registered 5/5 views" in runs[("torch", "INCREMENTAL")][1]
    ctrs = _centres(nvm)
    assert np.all(np.isfinite(ctrs))
    d = np.linalg.norm(ctrs[:, None] - ctrs[None, :], axis=-1)
    assert np.all(d[np.triu_indices(N_IMG, 1)] > 1e-4)  # no collapsed views


@pytest.mark.parametrize("est", ["GLOBAL", "INCREMENTAL"])
def test_both_packages_read_each_cameras_nvm_alike(runs, est):
    for pkg in ("jax", "torch"):
        path = runs[(pkg, est)][0] / "cameras.nvm"
        a, b = jax_nvm.read_nvm(path), nvm_io.read_nvm(path)
        assert a.cid_to_filename == b.cid_to_filename
        assert a.pid_to_cid_fid == b.pid_to_cid_fid
        for f in ("focal_lengths", "pid_to_xyz", "world_to_cam"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
        assert all(np.array_equal(x, y) for x, y in zip(a.cid_to_keypoint, b.cid_to_keypoint))


def test_calibrate_starts_from_the_ports_cameras_nvm(runs, tmp_path, capsys):
    ws = runs["ws"]
    ret = torch_main(["calibrate", "--device", "cpu", "--rig_config", str(ws / "rig_config.txt"),
                      "--nvm", str(runs[("torch", "GLOBAL")][0] / "cameras.nvm"),
                      "--images", str(ws / "images"), "--out_dir", str(tmp_path / "calib"),
                      "--no_rig", "--camera_poses_to_float", "--num_iterations", "10",
                      "--calibrator_num_passes", "1"] + COMMON)
    assert ret == 0
    a, b = re.search(r"BA pass 1: cost (\S+) -> (\S+)", capsys.readouterr().out).groups()
    assert float(b) < float(a)
    names, mats = nvm_io.read_camera_poses(tmp_path / "calib" / "cameras.txt")
    ate = syn.compute_ate(names, mats, ws / "cameras.txt")
    assert ate["n_poses"] == N_IMG and ate["ate_rmse_m"] < 0.05


def test_sfm_init_names_its_device_and_its_unported_flag(runs, tmp_path):
    """Without ``--device cpu`` and without a card ``sfm-init`` raises the
    error that names the flag, before reading an image. (Its one unported
    flag, --match_out_of_core, is ported now: tests/test_torch_frontend_extras.py
    holds it.)"""
    ws = runs["ws"]
    argv = ["sfm-init", "--rig_config", str(ws / "rig_config.txt"), "--images",
            str(ws / "images"), "--out_dir", str(tmp_path / "out")] + COMMON
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device exists")
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            torch_main(argv + extra)
    assert not (tmp_path / "out").exists()


def test_compute_ate_matches_the_pipeline_bench(tmp_path):
    """``utils/synthetic.py::compute_ate`` is the port's copy of
    scripts/bench_pipeline.py::compute_ate: the same numbers on a perturbed,
    rescaled and rotated serpentine trajectory (to the 5 decimals that script
    keeps)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import bench_pipeline as bp

    rng = np.random.default_rng(0)
    true = np.stack([syn.look_at_pose(np.array([0.45 * (i % 4), 0.8 * (i // 4), 2.0]),
                                      np.array([0.45 * (i % 4) + 0.15, 0.8 * (i // 4), 1.0]))
                     for i in range(8)])
    world = P.make_pose(torch.tensor([0.3, -0.2, 0.5], dtype=torch.float64),
                        P.quat_exp(torch.tensor([0.2, -0.1, 0.4], dtype=torch.float64)))
    noisy = P.pose_compose(
        P.make_pose(torch.as_tensor(rng.normal(0, 0.01, (8, 3))),
                    P.quat_exp(torch.as_tensor(rng.normal(0, 0.01, (8, 3))))),
        torch.as_tensor(true))
    est = P.pose_compose(noisy, P.pose_inverse(world))
    est = torch.cat([1.7 * P.pose_t(est), P.pose_q(est)], dim=-1)       # another scale
    names = [f"nav_cam/{10000 + i}.pgm" for i in range(8)]
    nvm_io.write_camera_poses(tmp_path / "gt.txt", names, P.pose_to_matrix(torch.as_tensor(true)).numpy())
    nvm_io.write_camera_poses(tmp_path / "est.txt", names, P.pose_to_matrix(est).numpy())
    ref = bp.compute_ate(tmp_path / "est.txt", tmp_path / "gt.txt")
    got = syn.compute_ate(*nvm_io.read_camera_poses(tmp_path / "est.txt"), tmp_path / "gt.txt")
    assert got["n_poses"] == ref["n_poses"] == 8
    assert 0.001 < got["ate_rmse_m"] < 0.05 and 0.1 < got["rot_mean_deg"] < 2.0
    for key, digits in (("ate_rmse_m", 5), ("rot_mean_deg", 4), ("rot_max_deg", 4)):
        assert abs(got[key] - ref[key]) <= 0.6 * 10 ** -digits, key
