"""Port parity for the texture slice as a whole: both ``texture`` CLIs on the
single-sensor workspace of tests/test_torch_sfm_init.py (five 200x150 frames
of the textured terrain along a line), texturing a coarse tessellation of
that terrain (``utils/synthetic.py::terrain_mesh``, 0.1 m cells) over the
frames' footprint, once with ``--no_occlusion`` and once with the defaults
(colour, exact occlusion at this size, gauss clamping, the MRF, global and
local seam leveling); then both ``calibrate --mesh --out_texture_dir`` CLIs
(tests/test_cli_tools.py::TestCalibrateTool::test_out_texture_dir). The port
runs with ``--device cpu``.

Bars for ``texture``: equal OBJ and MTL bytes; PNG pixels within one gray
level on at most 0.1% of the texels; the same printed MRF energies and
global leveling sweeps and residual; the seam-step lines with the same edge
counts and each statistic within 1e-5 (the pages are float32 renders in two
libraries). For ``calibrate``: the same file names, ``f`` lines and PNG
pixels; ``vt`` within 1e-3 (the two calibrations agree to about that)."""

import ast
import contextlib
import io
import re

import numpy as np
import pytest

from multiview_tpu.__main__ import main as jax_main
from multiview_tpu_torch.__main__ import main as torch_main
from multiview_tpu_torch.io import ply
from multiview_tpu_torch.sfm import ransac as TR
from multiview_tpu_torch.utils import synthetic as syn
from multiview_tpu_torch.utils.images import read_png
from test_torch_sfm_init import _write_workspace
from torch_port_scenes import jax_sampler, one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PIXEL = ["--pixel_size", "0.02"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def ws(tmp_path_factory, one_torch_thread):
    ws = tmp_path_factory.mktemp("texws")
    _write_workspace(ws)
    verts, faces = syn.terrain_mesh(lo=(-0.8, -0.9), hi=(2.6, 1.3), step=0.1)
    ply.write_ply(ws / "terrain.ply", verts, faces)
    return ws


def _texture(main, ws, out, extra):
    return _run(main, ["texture", "--rig_config", str(ws / "rig_config.txt"),
                       "--camera_poses", str(ws / "cameras.txt"), "--images",
                       str(ws / "images"), "--mesh", str(ws / "terrain.ply"),
                       "--out_dir", str(out)] + PIXEL + extra)


def _seam_stats(log):
    return {k: ast.literal_eval(v) for k, v in re.findall(
        r"Seam step (before|after) local leveling: (\{.*\})", log)}


@pytest.mark.parametrize("extra", [["--no_occlusion"], []], ids=["no_occlusion", "defaults"])
def test_texture_cli_matches_jax(ws, tmp_path, extra):
    from PIL import Image
    log_j = _texture(jax_main, ws, tmp_path / "jax", extra)
    log_t = _texture(torch_main, ws, tmp_path / "torch", extra + ["--device", "cpu"])
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    for name in ("textured_mesh.obj", "textured_mesh.mtl"):
        assert (dt / name).read_bytes() == (dj / name).read_bytes(), name
    a = read_png(dt / "textured_mesh.png").astype(int)
    b = np.asarray(Image.open(dj / "textured_mesh.png")).astype(int)
    assert a.shape == b.shape and a.ndim == 3
    assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3
    assert b.std() > 10                                   # texture, not a flat page
    for pattern in (r"Mesh: .*", r"Texturing from .*", r"MRF energy: .*",
                    r"Global seam leveling: .*"):
        lj, lt = re.findall(pattern, log_j), re.findall(pattern, log_t)
        assert lj == lt and len(lj) == 1, (lj, lt)
    sj, st = _seam_stats(log_j), _seam_stats(log_t)
    assert sorted(st) == sorted(sj) == ["after", "before"]
    for when in sj:
        assert sorted(st[when]) == sorted(sj[when])
        for key, val in sj[when].items():
            assert abs(st[when][key] - val) <= 1e-5, (when, key)
    assert st["after"]["seam_mean"] <= st["before"]["seam_mean"]
    energy = re.search(r"argmin (\S+) -> ICM (\S+)", log_t)
    assert float(energy.group(2)) <= float(energy.group(1))
    occlusion = re.findall(r"Occlusion: (\w+) for (\d+) face-view pairs", log_t)
    assert occlusion == ([] if extra else [("exact", "7480")])


def _calibrate(main, ws, out, tex, extra=()):
    return _run(main, ["calibrate", "--rig_config", str(ws / "rig_config.txt"),
                       "--camera_poses", str(ws / "cameras.txt"), "--images",
                       str(ws / "images"), "--out_dir", str(out), "--no_rig",
                       "--num_iterations", "3", "--calibrator_num_passes", "1",
                       "--max_features", "200", "--num_overlaps", "2",
                       "--mesh", str(ws / "plane.ply"), "--out_texture_dir", str(tex)]
                + list(extra))


def test_calibrate_out_texture_dir_matches_jax(ws, tmp_path, monkeypatch):
    from PIL import Image
    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    # a quad small enough that all its vertices project inside camera 0
    verts = np.array([[-0.3, -0.4, 0], [0.7, -0.4, 0], [0.7, 0.6, 0], [-0.3, 0.6, 0.0]])
    ply.write_ply(ws / "plane.ply", verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    _calibrate(jax_main, ws, tmp_path / "cj", tmp_path / "jax")
    _calibrate(torch_main, ws, tmp_path / "ct", tmp_path / "torch", ["--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 15 and names[0].endswith("_nav_cam.mtl")
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == names
    n_faces = 0
    for name in names:
        j, t = tmp_path / "jax" / name, tmp_path / "torch" / name
        if name.endswith(".png"):
            assert np.array_equal(read_png(t), np.asarray(Image.open(j)))
        elif name.endswith(".obj"):
            lines = [[ln for ln in p.read_text().splitlines() if ln.startswith(k)]
                     for p in (t, j) for k in ("f ", "vt ")]
            assert lines[0] == lines[2]
            vt_t, vt_j = (np.array([ln.split()[1:] for ln in lines[i]], float) for i in (1, 3))
            np.testing.assert_allclose(vt_t, vt_j, rtol=0, atol=1e-3)
            n_faces += len(lines[0])
    assert n_faces >= 2
