"""Port parity: image undistortion (``utils/undistort.py``) and both
``undistort`` CLIs, against the JAX package on the CPU.

Bars: ``undistort_image`` of a radtan camera at 160x120, scale 1 and 0.5,
with and without a crop window, to 1e-12 in float64 with K equal (both
resample bilinearly with taps outside the image read as 0, the port by an
explicit four-tap gather); the CLIs' pixels within one gray level and their
intrinsics files equal. The port runs with ``--device cpu``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.__main__ import main as jax_main
from multiview_tpu.geometry.camera import CameraParams as JaxCam
from multiview_tpu.utils import undistort as JU
from multiview_tpu_torch.__main__ import main as torch_main
from multiview_tpu_torch.geometry.camera import CameraParams
from multiview_tpu_torch.io import rig_config as rc
from multiview_tpu_torch.utils import undistort as TU
from multiview_tpu_torch.utils.images import read_pgm, read_ppm, write_pgm
from torch_port_scenes import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = (160, 120)
FOCAL, CENTER = 150.0, (81.0, 59.0)
DIST = (-0.12, 0.03, 5e-4, -4e-4)


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("crop", [None, (100, 80)])
def test_undistort_image_matches_jax(scale, crop):
    jc = JaxCam.create(SIZE, FOCAL, CENTER, DIST, dtype=jnp.float64)
    tc = CameraParams.create(SIZE, FOCAL, CENTER, DIST, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(int(round(SIZE[1] * scale)), int(round(SIZE[0] * scale))))
    a, Ka = JU.undistort_image(img, jc, crop_window=crop, scale=scale)
    b, Kb = TU.undistort_image(torch.as_tensor(img), tc, crop_window=crop, scale=scale)
    assert b.shape == a.shape
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(Kb, Ka)


def test_color_image_and_intrinsic_matrix_match_jax():
    jc = JaxCam.create(SIZE, FOCAL, CENTER, DIST, dtype=jnp.float64)
    tc = CameraParams.create(SIZE, FOCAL, CENTER, DIST, dtype=torch.float64, device="cpu")
    img = np.random.default_rng(1).uniform(size=(SIZE[1], SIZE[0], 3))
    a, _ = JU.undistort_image(img, jc)
    b, _ = TU.undistort_image(torch.as_tensor(img), tc)
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-12)
    for frame in ("raw", "distorted", "distorted_c", "undistorted", "undistorted_c"):
        np.testing.assert_array_equal(tc.intrinsic_matrix(frame).numpy(),
                                      np.asarray(jc.intrinsic_matrix(frame)))


@pytest.fixture(scope="module")
def undistort_ws(tmp_path_factory):
    """One radtan sensor and two rendered-texture frames as PGM."""
    ws = tmp_path_factory.mktemp("undws")
    sensor = rc.SensorConfig(
        name="cam", focal_length=FOCAL, optical_center=np.array(CENTER), distortion=np.array(DIST),
        image_size=SIZE, distorted_crop_size=SIZE, undistorted_image_size=SIZE,
        ref_to_sensor=np.eye(4), depth_to_image=np.eye(4))
    rc.write_rig_config(ws / "rig_config.txt", rc.RigConfig([sensor]))
    rng = np.random.default_rng(2)
    frames = []
    for k in range(2):
        coarse = rng.uniform(size=(16, 12))
        img = np.kron(coarse, np.ones((10, 10))).T + 0.2 * rng.uniform(size=(SIZE[1], SIZE[0]))
        path = ws / f"{k}.pgm"
        write_pgm(path, (np.clip(img / 1.2, 0, 1) * 255).astype(np.uint8))
        frames.append(path)
    return ws, frames


@pytest.mark.parametrize("extra", [[], ["--scale", "1.0", "--undistorted_crop_win", "120 90",
                                        "--histogram_equalization"]])
def test_undistort_clis_agree(undistort_ws, tmp_path, extra):
    ws, frames = undistort_ws
    outs = {}
    for pkg, main, dev in (("jax", jax_main, []), ("torch", torch_main, ["--device", "cpu"])):
        out = tmp_path / pkg
        assert main(["undistort", "--rig_config", str(ws / "rig_config.txt"), "--sensor", "cam",
                     "--images", *map(str, frames), "--out_dir", str(out)] + extra + dev) == 0
        outs[pkg] = out
    for f in frames:
        a = read_pgm(outs["jax"] / f.name).astype(int)
        b = read_pgm(outs["torch"] / f.name).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1
    assert (outs["jax"] / "undistorted_intrinsics.txt").read_text() == \
        (outs["torch"] / "undistorted_intrinsics.txt").read_text()


def test_undistort_cli_lists_and_color(undistort_ws, tmp_path):
    """--image_list / --output_list / --undistorted_intrinsics, and
    --save_bgr writing a binary PPM whose channels equal the gray output."""
    ws, frames = undistort_ws
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{f}\n" for f in frames))
    outs = [tmp_path / "u" / f"im{k}.ppm" for k in range(len(frames))]
    olst = tmp_path / "olist.txt"
    olst.write_text("".join(f"{o}\n" for o in outs))
    intr = tmp_path / "intr.txt"
    assert torch_main(["undistort", "--device", "cpu", "--rig_config", str(ws / "rig_config.txt"),
                       "--sensor", "cam", "--image_list", str(lst), "--output_list", str(olst),
                       "--save_bgr", "--undistorted_intrinsics", str(intr)]) == 0
    assert intr.read_text().splitlines()[1].split()[:2] == [str(SIZE[0]), str(SIZE[1])]
    gray = tmp_path / "g"
    assert torch_main(["undistort", "--device", "cpu", "--rig_config", str(ws / "rig_config.txt"),
                       "--sensor", "cam", "--images", str(frames[0]), "--out_dir",
                       str(gray)]) == 0
    color = read_ppm(outs[0])
    assert color.shape == (SIZE[1], SIZE[0], 3)
    for c in range(3):
        np.testing.assert_array_equal(color[..., c], read_pgm(gray / frames[0].name))


def test_undistort_cli_needs_a_device_or_the_cpu(undistort_ws, tmp_path, monkeypatch):
    ws, frames = undistort_ws
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["undistort", "--rig_config", str(ws / "rig_config.txt"), "--sensor", "cam",
                    "--images", str(frames[0]), "--out_dir", str(tmp_path)])


def test_camera_file_writers_match_jax(tmp_path):
    """The ASP .tsai and texrecon .cam writers: the JAX writers' text."""
    K = np.array([[151.25, 0.0, 80.5], [0.0, 150.75, 59.25], [0.0, 0.0, 1.0]])
    rng = np.random.default_rng(4)
    M = np.eye(4)
    M[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    M[:3, 3] = rng.normal(size=3)
    for name, jax_write, torch_write, arg in (
            ("cam.tsai", JU.write_tsai_camera, TU.write_tsai_camera, ()),
            ("cam.cam", JU.write_texrecon_cam, TU.write_texrecon_cam, (SIZE,))):
        jax_write(tmp_path / "jax" / name, K, M, *arg)
        torch_write(tmp_path / "torch" / name, K, M, *arg)
        assert (tmp_path / "torch" / name).read_text() == (tmp_path / "jax" / name).read_text()
