"""Port parity for the slice as a whole: the two-sensor rig workspace of
tests/test_cli_tools.py (200x150 PGM frames, 300 features) through both
``calibrate`` CLIs, with the JAX package's RANSAC draws fed to the port.

Bars: track counts within 2% (features agree to float32 summation order,
see test_torch_frontend.py); the port's recovered rig transform within
0.05 deg and 2 mm of the JAX package's; both within the truth bar of
test_cli_tools.py (1 deg, 0.05 m). The port runs with ``--device cpu``:
without it the tool asks for a CUDA card and raises where there is none."""

import re

import numpy as np
import pytest
import torch

from multiview_tpu.__main__ import main as jax_main
from multiview_tpu_torch.__main__ import main as torch_main
from multiview_tpu_torch.io import rig_config as rc
from multiview_tpu_torch.sfm import ransac as TR
from torch_port_scenes import jax_sampler, one_torch_thread, rig_error, write_rig_workspace

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--rig_transforms_to_float", "--camera_poses_to_float", "--bracket_len", "1.5",
        "--num_iterations", "15", "--calibrator_num_passes", "1",
        "--max_features", "300", "--num_overlaps", "2"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("rigws_pgm")
    write_rig_workspace(ws)
    return ws


def _run(main, ws, out, capsys, extra=()):
    ret = main(["calibrate", "--rig_config", str(ws / "rig_config.txt"),
                "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
                "--out_dir", str(out)] + ARGS + list(extra))
    assert ret == 0
    text = capsys.readouterr().out
    n_tracks = int(re.search(r"Built (\d+) tracks", text).group(1))
    return rc.read_rig_config(out / "rig_config.txt"), n_tracks


def test_calibrate_cli_matches_jax(workspace, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    rig_j, tracks_j = _run(jax_main, workspace, tmp_path / "jax", capsys)
    rig_t, tracks_t = _run(torch_main, workspace, tmp_path / "torch", capsys, CPU)
    assert tracks_j > 100
    assert abs(tracks_t - tracks_j) <= 0.02 * tracks_j, (tracks_t, tracks_j)

    for rig in (rig_j, rig_t):
        rot, trans = rig_error(rig.sensors[1].ref_to_sensor)
        assert rot < 1.0 and trans < 0.05, (rot, trans)
    Mj = rig_j.sensors[1].ref_to_sensor
    Mt = rig_t.sensors[1].ref_to_sensor
    rel = Mj[:3, :3].T @ Mt[:3, :3]
    rot_diff = np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))
    assert rot_diff < 0.05, rot_diff
    assert np.linalg.norm(Mt[:3, 3] - Mj[:3, 3]) < 0.002
    cams_j = (tmp_path / "jax" / "cameras.txt").read_text().splitlines()
    cams_t = (tmp_path / "torch" / "cameras.txt").read_text().splitlines()
    assert [c.split()[0] for c in cams_t] == [c.split()[0] for c in cams_j]


@pytest.mark.parametrize("flag", [["--sharded"], ["--out_texture_dir", "tex"]])
def test_unported_flags_raise(workspace, tmp_path, flag):
    """``--sharded`` is the one flag still refused. ``--out_texture_dir`` is
    ported: without ``--mesh``, and without ``--images``, it stops with the
    reference's messages (multiview_tpu/tools/calibrate.py:418-421), before
    any work."""
    argv = ["calibrate", "--rig_config", str(workspace / "rig_config.txt"),
            "--camera_poses", str(workspace / "cameras.txt"),
            "--out_dir", str(tmp_path / "out")] + ARGS + CPU + flag
    if flag[0] == "--sharded":
        with pytest.raises(NotImplementedError, match=flag[0]):
            torch_main(argv)
        return
    with pytest.raises(SystemExit, match="--out_texture_dir needs --mesh"):
        torch_main(argv)
    with pytest.raises(SystemExit, match="--out_texture_dir needs --images"):
        torch_main(argv + ["--mesh", str(tmp_path / "mesh.ply")])
    assert not (tmp_path / "out").exists()


def test_calibrate_without_device_cpu_raises_and_never_reaches_the_front_end(
        workspace, tmp_path, monkeypatch):
    """The port never picks the CPU by itself: where there is no CUDA card,
    ``calibrate`` without ``--device cpu`` raises an error that names the
    flag, before any image is read or feature detected."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device exists")
    from multiview_tpu_torch.sfm import pipeline as TPl
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import device as dev_mod

    def unreachable(*a, **k):
        raise AssertionError("reached the front end without a device")

    detect_all = TPl.detect_all
    monkeypatch.setattr(TPl, "detect_match_features", unreachable)
    monkeypatch.setattr(TPl, "detect_all", unreachable)
    monkeypatch.setattr(common, "scan_image_dir", unreachable)
    argv = ["calibrate", "--rig_config", str(workspace / "rig_config.txt"),
            "--camera_poses", str(workspace / "cameras.txt"),
            "--images", str(workspace / "images"), "--out_dir", str(tmp_path / "out")] + ARGS
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            torch_main(argv + extra)
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dev_mod.default_device()
    with pytest.raises(RuntimeError, match="--device cpu"):
        detect_all([np.zeros((8, 8), np.float32)], TPl.FrontendConfig())
    assert dev_mod.resolve_device("cpu") == torch.device("cpu")
