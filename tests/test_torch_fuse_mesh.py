"""Port parity for the dense slice as a whole: both ``fuse-mesh`` CLIs on the
single-sensor workspace of tests/test_torch_sfm_init.py (five 200x150
frames of a textured terrain along a line), with the flags of
tests/test_cli_tools.py::TestFuseMeshTool.

The JAX tool computes in float32, the port on the CPU in float64, so the
bars are: the same pair directories, files and voxblox index; per-pair point
counts and kept counts within 1%; the fused mesh's vertex count within 2%
and its median z within 10% of the JAX package's. A resume (--last_step
pc_filter, then --first_step mesh_gen) writes the mesh of the whole run. The
port's ``--left_right_check`` (not in the reference tool) keeps fewer depths
and a mesh closer to the terrain. The port runs with ``--device cpu``."""

import re

import numpy as np
import pytest

from multiview_tpu.__main__ import main as jax_main
from multiview_tpu_torch.__main__ import main as torch_main
from multiview_tpu_torch.io import ply
from multiview_tpu_torch.utils.synthetic import terrain_height
from test_torch_sfm_init import _write_workspace
from torch_port_scenes import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLAGS = ["--min_depth", "1.0", "--max_depth", "4.0", "--num_planes", "48",
         "--voxel_size", "0.08"]
FILES = ("run-PC.pcd", "run-PC-filter.pcd", "run-PC-debug.ply", "run_cam2world.txt")


def _argv(ws, out):
    return ["fuse-mesh", "--rig_config", str(ws / "rig_config.txt"), "--camera_poses",
            str(ws / "cameras.txt"), "--images", str(ws / "images"), "--out_dir", str(out)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    """Both CLIs on one workspace: {package: (out dir, log)}."""
    import contextlib
    import io

    ws = tmp_path_factory.mktemp("fusews")
    _write_workspace(ws)
    out = {"ws": ws}
    for pkg, main, dev in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(_argv(ws, ws / pkg) + FLAGS + dev) == 0
        out[pkg] = (ws / pkg, buf.getvalue())
    return out


def test_layout_and_pair_clouds_match_jax(runs):
    (dj, log_j), (dt, log_t) = runs["jax"], runs["torch"]
    pairs = sorted(p.name for p in (dj / "nav_cam" / "stereo").glob("*"))
    assert len(pairs) == 4
    assert sorted(p.name for p in (dt / "nav_cam" / "stereo").glob("*")) == pairs
    for p in pairs:
        for f in FILES:
            assert (dt / "nav_cam" / "stereo" / p / f).is_file()
        np.testing.assert_array_equal(np.loadtxt(dt / "nav_cam" / "stereo" / p / FILES[3]),
                                      np.loadtxt(dj / "nav_cam" / "stereo" / p / FILES[3]))
    index = [(dt / "nav_cam" / "voxblox_index.txt").read_text().replace(str(dt), "OUT"),
             (dj / "nav_cam" / "voxblox_index.txt").read_text().replace(str(dj), "OUT")]
    assert index[0] == index[1] and len(index[0].splitlines()) == 8
    for pattern in (r"pair \S+ / \S+: (\d+) points", r"kept (\d+)/"):
        cj = np.array(re.findall(pattern, log_j), float)
        ct = np.array(re.findall(pattern, log_t), float)
        assert len(cj) == len(ct) == 4
        np.testing.assert_allclose(ct, cj, rtol=0.01)
    assert re.search(r"\[fuse-mesh\] stage seconds: undistort=\S+ stereo=\S+ pc_filter=\S+ "
                     r"tsdf=\S+ marching=\S+ io=\S+", log_t)


def test_fused_mesh_matches_jax(runs):
    mj = ply.read_ply(runs["jax"][0] / "fused_mesh.ply")
    mt = ply.read_ply(runs["torch"][0] / "fused_mesh.ply")
    nj, nt = len(mj["vertices"]), len(mt["vertices"])
    assert nj > 1000
    assert abs(nt - nj) <= 0.02 * nj
    zj, zt = np.median(mj["vertices"][:, 2]), np.median(mt["vertices"][:, 2])
    assert abs(zt - zj) <= 0.1 * abs(zj)
    assert abs(zt) < 0.2                      # the terrain's relief is +-0.25 m


def test_resume_writes_the_same_mesh(runs, tmp_path):
    ws = runs["ws"]
    out = tmp_path / "resume"
    assert torch_main(_argv(ws, out) + FLAGS + ["--device", "cpu", "--last_step",
                                                "pc_filter"]) == 0
    assert not (out / "fused_mesh.ply").exists()
    assert len(list((out / "nav_cam" / "stereo").glob("*/run-PC-filter.pcd"))) == 4
    assert torch_main(_argv(ws, out) + FLAGS + ["--device", "cpu", "--first_step",
                                                "mesh_gen"]) == 0
    whole = ply.read_ply(runs["torch"][0] / "fused_mesh.ply")
    resumed = ply.read_ply(out / "fused_mesh.ply")
    np.testing.assert_array_equal(resumed["faces"], whole["faces"])
    np.testing.assert_array_equal(resumed["vertices"], whole["vertices"])
    with pytest.raises(SystemExit):
        torch_main(_argv(ws, out) + ["--device", "cpu", "--first_step", "mesh_gen",
                                     "--last_step", "stereo"])


def test_left_right_check_keeps_fewer_depths_and_a_closer_mesh(runs, tmp_path, capsys):
    ws = runs["ws"]
    out = tmp_path / "checked"
    assert torch_main(_argv(ws, out) + FLAGS + ["--device", "cpu", "--left_right_check"]) == 0
    checked = np.array(re.findall(r"pair \S+ / \S+: (\d+) points", capsys.readouterr().out), int)
    plain = np.array(re.findall(r"pair \S+ / \S+: (\d+) points", runs["torch"][1]), int)
    assert len(checked) == 4 and np.all(checked < plain) and np.all(checked > 0.5 * plain)

    def error(path):
        v = ply.read_ply(path)["vertices"]
        return np.median(np.abs(v[:, 2] - terrain_height(v[:, 0], v[:, 1])))

    assert error(out / "fused_mesh.ply") < error(runs["torch"][0] / "fused_mesh.ply")


def test_fuse_mesh_needs_a_device_or_the_cpu(runs, tmp_path, monkeypatch):
    """Without ``--device cpu`` and without a card ``fuse-mesh`` raises the
    error that names the flag, before it writes anything."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main(_argv(runs["ws"], tmp_path / "out") + FLAGS)
    assert not (tmp_path / "out").exists()
