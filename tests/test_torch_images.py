"""The port's image files without PIL or imageio: the PNG writer
(``utils/images.py::write_png``, the texture pages) decoded by PIL, its
reader, and ``tools/common.py::load_color`` / ``load_gray`` of PGM and PPM
files against the JAX package's loaders of the same files (exact)."""

import numpy as np
import pytest

from multiview_tpu.tools import common as jax_common
from multiview_tpu_torch.tools import common
from multiview_tpu_torch.utils.images import read_png, write_pgm, write_png, write_ppm
from torch_port_scenes import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("shape", [(1, 1), (1, 1, 3), (5, 7), (4, 9, 3), (33, 65), (17, 31, 3)])
def test_png_decodes_to_the_written_pixels(tmp_path, shape):
    from PIL import Image
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    write_png(tmp_path / "a.png", img)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == ("RGB" if len(shape) == 3 else "L")
        assert np.array_equal(np.asarray(im), img)
    back = read_png(tmp_path / "a.png")
    assert back.dtype == np.uint8 and np.array_equal(back, img)


def test_png_refuses_what_it_does_not_write(tmp_path):
    from PIL import Image
    with pytest.raises(ValueError):
        write_png(tmp_path / "f.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        write_png(tmp_path / "f.png", np.zeros((4, 4, 4), np.uint8))
    Image.fromarray(np.zeros((4, 4, 4), np.uint8)).save(tmp_path / "rgba.png")
    with pytest.raises(ValueError, match="8-bit gray or RGB"):
        read_png(tmp_path / "rgba.png")
    (tmp_path / "x.png").write_bytes(b"P5\n1 1\n255\n\0")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "x.png")


def test_load_color_and_gray_equal_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    gray = rng.integers(0, 256, (15, 21), dtype=np.uint8)
    rgb = rng.integers(0, 256, (15, 21, 3), dtype=np.uint8)
    write_pgm(tmp_path / "g.pgm", gray)
    write_ppm(tmp_path / "c.ppm", rgb)
    for name in ("g.pgm", "c.ppm"):
        for ours, ref in ((common.load_color, jax_common.load_color),
                          (common.load_gray, jax_common.load_gray)):
            got, want = ours(tmp_path / name), ref(tmp_path / name)
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want), (name, ours.__name__)
    assert common.load_color(tmp_path / "g.pgm").shape == (15, 21, 3)
