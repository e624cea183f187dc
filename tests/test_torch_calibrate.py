"""Port parity for the slice as a whole: the two-sensor rig workspace of
tests/test_cli_tools.py (200x150 PGM frames, 300 features) through both
``calibrate`` CLIs, with the JAX package's RANSAC draws fed to the port.

Bars: track counts within 2% (features agree to float32 summation order,
see test_torch_frontend.py); the port's recovered rig transform within
0.05 deg and 2 mm of the JAX package's; both within the truth bar of
test_cli_tools.py (1 deg, 0.05 m)."""

import re

import numpy as np
import pytest

from multiview_tpu.__main__ import main as jax_main
from multiview_tpu_torch.__main__ import main as torch_main
from multiview_tpu_torch.io import rig_config as rc
from multiview_tpu_torch.sfm import ransac as TR
from torch_port_scenes import jax_sampler, rig_error, write_rig_workspace

ARGS = ["--rig_transforms_to_float", "--camera_poses_to_float", "--bracket_len", "1.5",
        "--num_iterations", "15", "--calibrator_num_passes", "1",
        "--max_features", "300", "--num_overlaps", "2"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("rigws_pgm")
    write_rig_workspace(ws)
    return ws


def _run(main, ws, out, capsys):
    ret = main(["calibrate", "--rig_config", str(ws / "rig_config.txt"),
                "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
                "--out_dir", str(out)] + ARGS)
    assert ret == 0
    text = capsys.readouterr().out
    n_tracks = int(re.search(r"Built (\d+) tracks", text).group(1))
    return rc.read_rig_config(out / "rig_config.txt"), n_tracks


def test_calibrate_cli_matches_jax(workspace, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    rig_j, tracks_j = _run(jax_main, workspace, tmp_path / "jax", capsys)
    rig_t, tracks_t = _run(torch_main, workspace, tmp_path / "torch", capsys)
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


@pytest.mark.parametrize("flag", [["--depth_tri_weight", "1000"], ["--mesh", "m.ply"],
                                  ["--registration"], ["--sharded"],
                                  ["--out_texture_dir", "tex"], ["--export_to_voxblox"],
                                  ["--num_nearest_neighbors_for_global_descriptor_matching",
                                   "5"], ["--match_out_of_core"]])
def test_unported_flags_raise(workspace, tmp_path, flag):
    with pytest.raises(NotImplementedError):
        torch_main(["calibrate", "--rig_config", str(workspace / "rig_config.txt"),
                    "--camera_poses", str(workspace / "cameras.txt"),
                    "--out_dir", str(tmp_path)] + ARGS + flag)
