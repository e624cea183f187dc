"""Port parity for the per-camera mesh projection of ``calibrate
--out_texture_dir`` (``texture/mesh_project.py``): the same mesh, cameras and
images, made from a seed with numpy, through both packages; the port on the
CPU in float64.

Tolerances: equal face masks; UVs to 1e-9 (the distortion model is computed
differently in each package); the same file names; ``v``, ``f``, ``mtllib``
and ``usemtl`` lines byte-equal and ``vt`` lines equal as parsed numbers to
1e-9; each PNG decodes to the reference's pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_tpu.geometry.camera import CameraParams as JCam
from multiview_tpu.texture import mesh_project as JM
from multiview_tpu_torch.geometry.camera import CameraParams as TCam
from multiview_tpu_torch.texture import mesh_project as TM
from multiview_tpu_torch.utils import synthetic as syn
from multiview_tpu_torch.utils.images import read_png
from test_torch_texturing import grid_mesh
from torch_port_scenes import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = (96, 72)
DIST = (-0.08, 0.02, 0.001, -0.0005)


def scene():
    """A bumpy ground grid with an occluder quad above it, and three
    cameras; one sees the grid from below."""
    verts, faces = grid_mesh(6, 0.5)
    rng = np.random.default_rng(0)
    verts[:, 2] = 0.03 * rng.normal(size=len(verts))
    ov, of = grid_mesh(1, 0.12, z=0.7)
    verts = np.concatenate([verts, ov + [0.1, 0.05, 0.0]])
    faces = np.concatenate([faces, of + 49])
    poses = [syn.look_at_pose(np.array(p), np.zeros(3)) for p in
             ((0.05, 0.02, 2.0), (0.6, -0.3, 1.7), (0.2, 0.1, -1.8))]
    return verts, faces, poses


def cams(crop=None):
    kw = dict(distorted_crop_size=crop) if crop else {}
    j = JCam.create(SIZE, (70.0, 71.0), (49.0, 35.5), DIST, **kw)
    t = TCam.create(SIZE, (70.0, 71.0), (49.0, 35.5), DIST, device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("crop,raw_factor", [(None, 1), ((80, 60), 2)])
def test_face_masks_and_uvs_equal(crop, raw_factor):
    verts, faces, poses = scene()
    cj, ct = cams(crop)
    shape = (SIZE[1] * raw_factor, SIZE[0] * raw_factor)
    seen = 0
    for p in poses:
        okj, uvj, costj = JM.project_texture_uv(verts, faces, cj, jnp.asarray(p), shape)
        okt, uvt, costt = TM.project_texture_uv(verts, faces, ct, torch.as_tensor(p), shape)
        okj = np.asarray(okj)
        assert np.array_equal(okt.numpy(), okj)
        np.testing.assert_allclose(uvt.numpy(), np.asarray(uvj), rtol=0, atol=1e-9)
        np.testing.assert_allclose(costt.numpy()[okj], np.asarray(costj)[okj], rtol=0,
                                   atol=1e-12)
        seen += okj.sum()
    assert 0 < seen < len(faces) * len(poses)
    with pytest.raises(ValueError, match="integer multiple"):
        TM.project_texture_uv(verts, faces, ct, torch.as_tensor(poses[0]), (73, 96))


def _lines(path, kind):
    return [ln for ln in path.read_text().splitlines() if ln.split(" ", 1)[0] == kind]


def test_mesh_project_cameras_files_equal(tmp_path):
    verts, faces, poses = scene()
    cj, ct = cams()
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(-0.1, 1.1, (SIZE[1], SIZE[0])).astype(np.float32) for _ in poses]
    imgs[1] = (imgs[1] * 255).clip(0, 255).astype(np.uint8)       # written as it is
    stamps = [10001.25, 10002.5, 10003.0]
    args = (imgs, stamps, [0, 1, 1])
    JM.mesh_project_cameras(["nav_cam", "sci_cam"], [cj, cj], *args,
                            [jnp.asarray(p) for p in poses], verts, faces, tmp_path / "jax")
    TM.mesh_project_cameras(["nav_cam", "sci_cam"], [ct, ct], *args, np.stack(poses), verts,
                            faces, tmp_path / "torch")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 9 and "10001.2500000_nav_cam.obj" in names
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == names
    from PIL import Image
    n_faces = 0
    for name in names:
        j, t = tmp_path / "jax" / name, tmp_path / "torch" / name
        if name.endswith(".png"):
            assert np.array_equal(read_png(t), np.asarray(Image.open(j)))
            continue
        if name.endswith(".mtl"):
            assert t.read_bytes() == j.read_bytes()
            continue
        for kind in ("v", "f", "mtllib", "usemtl"):
            assert _lines(t, kind) == _lines(j, kind), (name, kind)
        vt_t = np.array([ln.split()[1:] for ln in _lines(t, "vt")], float)
        vt_j = np.array([ln.split()[1:] for ln in _lines(j, "vt")], float)
        np.testing.assert_allclose(vt_t, vt_j, rtol=0, atol=1e-9)
        n_faces += len(_lines(t, "f"))
    assert n_faces > 0
