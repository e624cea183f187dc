"""Port parity for the depth-camera path of ``calibrate`` as a whole: the port's rendered three-sensor workspace (320x240,
6 reference frames, haz_cam with a ``.pc`` cloud per frame and a
depth_to_image guess that is 3% and one degree off) through both CLIs with
``--depth_tri_weight 25 --float_scale --depth_to_image_transforms_to_float
haz_cam`` and both depth exports, one run each, shared by the assertions:
attached depth rows within 2%, both rigs within 0.01 deg / 1 mm of each other
and 0.5 deg / 0.02 m of the truth, the depth_to_image scale within 1e-3 of
each other and of 1; and one run of the port with ``--mesh``.

Lengths are compared in the gauge of the truth. With ``--float_scale``, the
camera poses and the rig all floating, the problem has a free global scale,
and the depth term (metres) rewards a smaller world: at this size 40 LM
iterations take the world to 0.60 of its size in the port and to 0.77 in the
JAX package in float32 (measured; 0.99885 at 1280x960 on an H100). Both
packages agree in everything the gauge leaves alone, so translations and the
depth_to_image scale are divided by the world scale, read off the length of
the calibrated reference trajectory against the true one."""

import re

import numpy as np
import pytest
import torch

from multiview_tpu.__main__ import main as jax_main
from multiview_tpu_torch.__main__ import main as torch_main
from multiview_tpu_torch.geometry import pose as TP
from multiview_tpu_torch.io import rig_config as rc
from multiview_tpu_torch.sfm import ransac as TR
from multiview_tpu_torch.utils import synthetic as TSyn
from torch_port_scenes import jax_sampler, one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = ["--device", "cpu"]

DEPTH_ARGS = ["--rig_transforms_to_float", "--camera_poses_to_float", "--bracket_len", "1.5",
              "--num_iterations", "20", "--calibrator_num_passes", "2",
              "--max_features", "600", "--num_overlaps", "3", "--depth_tri_weight", "25.0",
              "--float_scale", "--depth_to_image_transforms_to_float", "haz_cam"]
EXPORTS = ["--export_to_voxblox", "--save_transformed_depth_clouds", "--save_nvm"]


def _pose_error(M, truth_pose):
    est = TP.matrix_to_pose(torch.as_tensor(np.asarray(M, np.float64)))
    rel = TP.pose_compose(TP.pose_inverse(est), torch.as_tensor(truth_pose))
    return (float(np.degrees(torch.linalg.norm(TP.quat_log(TP.pose_q(rel))))),
            float(torch.linalg.norm(TP.pose_t(rel))))


def _world_scale(out, ws):
    """Length of the calibrated nav_cam trajectory over that of the true one."""
    from pathlib import Path
    from multiview_tpu_torch.io import nvm as nvm_io
    truth = {Path(n).name: M for n, M in zip(*nvm_io.read_camera_poses(ws / "cameras.txt"))}
    names, mats = nvm_io.read_camera_poses(out / "cameras.txt")
    nav = [i for i, n in enumerate(names) if Path(n).parent.name == "nav_cam"]

    def length(ms):
        c = np.stack([-M[:3, :3].T @ M[:3, 3] for M in ms])
        return np.linalg.norm(np.diff(c, axis=0), axis=1).sum()
    return float(length([mats[i] for i in nav])
                 / length([truth[Path(names[i]).name] for i in nav]))


def _in_true_gauge(M, k):
    M = np.array(M, np.float64)
    M[:3, 3] /= k
    return M


def _depth_run(main, ws, out, extra):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(["calibrate", "--rig_config", str(ws / "rig_config.txt"),
                    "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
                    "--out_dir", str(out)] + DEPTH_ARGS + list(extra))
    assert ret == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def depth_workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("rigws_depth")
    guess = np.eye(4)
    guess[:3, :3] = 1.03 * TP.quat_to_matrix(TP.quat_exp(
        torch.tensor([0.01, -0.012, 0.008], dtype=torch.float64))).numpy()
    truth = TSyn.build_rig_workspace(ws, 6, (320, 240), 280.0, depth=True,
                                     depth_to_image_guess=guess)
    return ws, truth


@pytest.fixture(scope="module")
def depth_runs(depth_workspace, tmp_path_factory):
    """One run of each CLI on the three-sensor workspace, with the exports."""
    ws, truth = depth_workspace
    out = tmp_path_factory.mktemp("depth_out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR, "sample_hypotheses", jax_sampler)
        text_j = _depth_run(jax_main, ws, out / "jax", EXPORTS)
        text_t = _depth_run(torch_main, ws, out / "torch", EXPORTS + CPU)
    return ws, truth, out, text_j, text_t


def test_depth_calibrate_cli_matches_jax(depth_runs):
    ws, truth, out, text_j, text_t = depth_runs
    n_j, n_t = (int(re.search(r"Attached (\d+) depth measurements", t).group(1))
                for t in (text_j, text_t))
    assert n_j > 300 and abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    for t in (text_j, text_t):
        assert "depth_tri_x_m" in t and "Number of images for sensor 2: 5" in t
    rig_j = rc.read_rig_config(out / "jax" / "rig_config.txt")
    rig_t = rc.read_rig_config(out / "torch" / "rig_config.txt")
    assert [s.name for s in rig_t.sensors] == ["nav_cam", "sci_cam", "haz_cam"]
    k_j, k_t = _world_scale(out / "jax", ws), _world_scale(out / "torch", ws)
    for s in (1, 2):
        name = rig_t.sensors[s].name
        M_j = _in_true_gauge(rig_j.sensors[s].ref_to_sensor, k_j)
        M_t = _in_true_gauge(rig_t.sensors[s].ref_to_sensor, k_t)
        for M in (M_j, M_t):
            rot, trans = _pose_error(M, truth[name])
            assert rot < 0.5 and trans < 0.02, (name, rot, trans)
        rot, trans = _pose_error(M_t, TP.matrix_to_pose(torch.as_tensor(M_j)).numpy())
        assert rot < 0.01 and trans < 0.001, (name, rot, trans)
    scales = [float(np.linalg.det(r.sensors[2].depth_to_image[:3, :3]) ** (1 / 3)) / k
              for r, k in ((rig_j, k_j), (rig_t, k_t))]
    assert abs(scales[0] - scales[1]) < 1e-3 and abs(scales[1] - 1.0) < 2e-3, scales
    d2i = np.array(rig_t.sensors[2].depth_to_image, np.float64)
    d2i[:3, :3] /= scales[1] * k_t
    rot, trans = _pose_error(_in_true_gauge(d2i, k_t), np.array([0, 0, 0, 0, 0, 0, 1.0]))
    assert rot < 0.1 and trans < 0.005, (rot, trans)      # from one degree off
    costs = [(float(a), float(b)) for a, b in re.findall(
        r"BA pass \d+: cost (\S+) -> (\S+)", text_t)]
    assert len(costs) == 2 and all(b < a for a, b in costs), costs


def test_depth_exports_write_the_files_the_jax_cli_writes(depth_runs):
    ws, truth, out, _, _ = depth_runs

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    files_j, files_t = tree(out / "jax"), tree(out / "torch")
    assert files_t == files_j
    assert sum(f.startswith("voxblox/haz_cam/") and f.endswith(".pcd") for f in files_t) == 5
    assert sum(f.startswith("transformed_depth_clouds/") for f in files_t) == 5
    assert {"rig_config.txt", "cameras.txt", "cameras.nvm",
            "voxblox/nav_cam/index.txt"} <= set(files_t)
    from multiview_tpu_torch.io import depth_io, ply
    f = next(f for f in files_t if f.endswith("_trans.ply"))
    a = ply.read_ply(out / "jax" / f)["vertices"]
    b = ply.read_ply(out / "torch" / f)["vertices"]
    # each calibration has its own gauge: the cloud's extent agrees in the truth's
    ext_j = np.linalg.norm(a[0] - a[-1]) / _world_scale(out / "jax", ws)
    ext_t = np.linalg.norm(b[0] - b[-1]) / _world_scale(out / "torch", ws)
    assert a.shape == b.shape and abs(ext_j - ext_t) < 5e-3, (ext_j, ext_t)
    f = next(f for f in files_t if f.endswith(".pcd"))
    assert depth_io.read_pcd(out / "jax" / f)[0].shape == depth_io.read_pcd(
        out / "torch" / f)[0].shape


def test_depth_calibrate_with_mesh(depth_workspace, tmp_path):
    ws, truth = depth_workspace
    n_tri = TSyn.write_terrain_mesh(tmp_path / "terrain.ply", lo=(-2.0, -2.0), hi=(5.0, 3.0),
                                    step=0.2)
    text = _depth_run(torch_main, ws, tmp_path / "out", CPU + [
        "--mesh", str(tmp_path / "terrain.ply"), "--mesh_tri_weight", "5.0",
        "--depth_mesh_weight", "10.0", "--max_ray_dist", "10.0"])
    assert f"Loaded mesh with {n_tri} triangles" in text
    costs = [(float(a), float(b)) for a, b in re.findall(
        r"BA pass \d+: cost (\S+) -> (\S+)", text)]
    assert len(costs) == 2 and all(b < a for a, b in costs), costs
    for group in ("depth_mesh_x_m", "mesh_tri_x_m", "depth_tri_x_m"):
        assert group in text
    hits = [int(n) for n in re.findall(r"depth_mesh_x_m: .* \((\d+) residuals\)", text)]
    rows = [int(n) for n in re.findall(r"depth_tri_x_m: .* \((\d+) residuals\)", text)]
    assert hits[-1] > 0.9 * rows[-1]
    rig = rc.read_rig_config(tmp_path / "out" / "rig_config.txt")
    k = _world_scale(tmp_path / "out", ws)
    for s in (1, 2):
        rot, trans = _pose_error(_in_true_gauge(rig.sensors[s].ref_to_sensor, k),
                                 truth[rig.sensors[s].name])
        assert rot < 0.5 and trans < 0.02, (rot, trans)


def test_affine_depth_to_image_runs_and_excludes_float_scale(depth_workspace, tmp_path):
    ws, _ = depth_workspace
    base = ["calibrate", "--rig_config", str(ws / "rig_config.txt"),
            "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
            "--out_dir", str(tmp_path / "out")] + CPU
    with pytest.raises(SystemExit, match="float_scale"):
        torch_main(base + DEPTH_ARGS + ["--affine_depth_to_image"])
    args = [a for a in DEPTH_ARGS if a != "--float_scale"]
    args[args.index("--calibrator_num_passes") + 1] = "1"
    assert torch_main(base + args + ["--affine_depth_to_image"]) == 0
    rig = rc.read_rig_config(tmp_path / "out" / "rig_config.txt")
    L = rig.sensors[2].depth_to_image[:3, :3]
    k = _world_scale(tmp_path / "out", ws)
    assert abs(np.linalg.det(L) ** (1 / 3) / k - 1.0) < 5e-3   # from 1.03, all 12 entries free
