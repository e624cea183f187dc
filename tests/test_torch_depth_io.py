"""Port parity: the depth-cloud and mesh file formats of multiview_tpu_torch
against the JAX package's. Both are host numpy: for the same arrays the two
writers give the same bytes, and each reader reads the other's file.
``depth_value`` / ``depth_values_batch`` are discrete (round-half-even, the
far edge, the (0,0,0) sentinel) and must agree exactly, as must the records
of ``scan_depth_dir`` and the rows of ``build_depth_observations``."""

import filecmp
from pathlib import Path

import numpy as np
import pytest

from multiview_tpu.calib import assemble as JAsm, bracketing as JBr
from multiview_tpu.io import depth_io as JD, ply as JPly, rig_config as JRc
from multiview_tpu.sfm.tracks import TrackSet as JTrackSet
from multiview_tpu.tools import common as JCommon
from multiview_tpu.utils import images as JImg
from multiview_tpu_torch.calib import assemble as TAsm, bracketing as TBr
from multiview_tpu_torch.io import depth_io as TD, ply as TPly, rig_config as TRc
from multiview_tpu_torch.sfm.tracks import TrackSet as TTrackSet
from multiview_tpu_torch.tools import common as TCommon
from multiview_tpu_torch.utils import images as TImg
from multiview_tpu_torch.utils import synthetic as TSyn

RNG = np.random.default_rng(5)
CLOUD = RNG.normal(size=(12, 16, 3)).astype(np.float32)
CLOUD[3, 4] = 0.0                       # an invalid measurement
CLOUD[0, 0] = 0.0


def _same_bytes(a, b):
    assert Path(a).read_bytes() == Path(b).read_bytes()


def test_xyz_image_pc(tmp_path):
    JD.write_xyz_image(tmp_path / "j.pc", CLOUD)
    TD.write_xyz_image(tmp_path / "t.pc", CLOUD)
    _same_bytes(tmp_path / "j.pc", tmp_path / "t.pc")
    np.testing.assert_array_equal(TD.read_xyz_image(tmp_path / "j.pc"), CLOUD)
    np.testing.assert_array_equal(JD.read_xyz_image(tmp_path / "t.pc"), CLOUD)
    with pytest.raises(ValueError):
        TD.write_xyz_image(tmp_path / "bad.pc", CLOUD[..., :2])


@pytest.mark.parametrize("binary", [True, False])
def test_pcd(tmp_path, binary):
    xyz = RNG.normal(size=(40, 3))
    kw = dict(intensity=RNG.uniform(size=40), weight=RNG.uniform(size=40),
              error=RNG.uniform(size=40), binary=binary)
    JD.write_pcd(tmp_path / "j.pcd", xyz, **kw)
    TD.write_pcd(tmp_path / "t.pcd", xyz, **kw)
    _same_bytes(tmp_path / "j.pcd", tmp_path / "t.pcd")
    for reader, f in ((TD.read_pcd, "j.pcd"), (JD.read_pcd, "t.pcd")):
        got_xyz, got_n = reader(tmp_path / f)
        np.testing.assert_allclose(got_xyz, xyz.astype(np.float32), rtol=1e-7)
        np.testing.assert_allclose(got_n[:, 1], kw["weight"].astype(np.float32), rtol=1e-7)
    JD.write_pcd(tmp_path / "j0.pcd", xyz)
    TD.write_pcd(tmp_path / "t0.pcd", xyz)
    _same_bytes(tmp_path / "j0.pcd", tmp_path / "t0.pcd")


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("faces", [True, False])
@pytest.mark.parametrize("extras", [True, False])
def test_ply(tmp_path, binary, faces, extras):
    verts = RNG.normal(size=(30, 3))
    kw = dict(binary=binary)
    if faces:
        kw["faces"] = RNG.integers(0, 30, size=(50, 3))
    if extras:
        kw.update(normals=RNG.normal(size=(30, 3)), intensity=RNG.uniform(size=30),
                  colors=RNG.integers(0, 256, size=(30, 3)))
    JPly.write_ply(tmp_path / "j.ply", verts, **kw)
    TPly.write_ply(tmp_path / "t.ply", verts, **kw)
    _same_bytes(tmp_path / "j.ply", tmp_path / "t.ply")
    a, b = TPly.read_ply(tmp_path / "j.ply"), JPly.read_ply(tmp_path / "t.ply")
    assert a.keys() == b.keys() and ("faces" in a) == faces and ("normals" in a) == extras
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
    np.testing.assert_allclose(a["vertices"], verts.astype(np.float32), rtol=1e-7)
    if faces:
        np.testing.assert_array_equal(a["faces"], kw["faces"])


def test_ply_polygon_list_falls_back_to_the_per_face_reader(tmp_path):
    """A binary face list that is not all triangles is read face by face."""
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 4\nproperty float x\n"
              "property float y\nproperty float z\nelement face 2\n"
              "property list uchar int vertex_indices\nend_header\n").encode()
    verts = RNG.normal(size=(4, 3)).astype("<f4").tobytes()
    body = b"\x03" + np.array([0, 1, 2], "<i4").tobytes() \
        + b"\x03" + np.array([0, 2, 3], "<i4").tobytes()
    (tmp_path / "tri.ply").write_bytes(header + verts + body)
    np.testing.assert_array_equal(TPly.read_ply(tmp_path / "tri.ply")["faces"],
                                  JPly.read_ply(tmp_path / "tri.ply")["faces"])
    quad = b"\x04" + np.array([0, 1, 2, 3], "<i4").tobytes() \
        + b"\x04" + np.array([3, 2, 1, 0], "<i4").tobytes()
    (tmp_path / "quad.ply").write_bytes(header + verts + quad)
    np.testing.assert_array_equal(TPly.read_ply(tmp_path / "quad.ply")["faces"],
                                  JPly.read_ply(tmp_path / "quad.ply")["faces"])


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def test_voxblox_and_transformed_clouds(tmp_path):
    entries = [(0, 10000.0, None, None), (1, 10000.25, CLOUD, RNG.uniform(size=(12, 16))),
               (1, 10001.25, CLOUD[::-1].copy(), None)]
    d2i = np.stack([np.eye(4), np.eye(4)])
    d2i[1, :3, :3] *= 1.03
    d2i[1, :3, 3] = [0.01, -0.02, 0.03]
    w2c = np.stack([np.eye(4)] * 3)
    w2c[1, :3, 3] = [0.5, 0.1, -0.2]
    for mod, name in ((JD, "j"), (TD, "t")):
        mod.export_to_voxblox(tmp_path / name, ["nav_cam", "haz_cam"], entries, d2i, w2c)
        written = mod.save_transformed_depth_clouds(tmp_path / name / "clouds", entries, d2i, w2c)
        assert len(written) == 2
        mod.save_transformed_mesh(tmp_path / name / "mesh.ply", RNG.normal(size=(5, 3)) * 0 + 1.0,
                                  np.array([[0, 1, 2]]), w2c[1])
    assert _tree(tmp_path / "j") == _tree(tmp_path / "t")
    assert "voxblox/haz_cam/10000.2500000.pcd" in _tree(tmp_path / "t")
    for f in _tree(tmp_path / "t"):
        if f.endswith("index.txt"):      # lists absolute paths under each root
            a = (tmp_path / "j" / f).read_text().replace(str(tmp_path / "j"), "")
            b = (tmp_path / "t" / f).read_text().replace(str(tmp_path / "t"), "")
            assert a == b
        else:
            assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f, shallow=False), f


def test_registration_control_point_parsers(tmp_path):
    (tmp_path / "a.pto").write_text(
        'p f2\ni w640 h480 n"nav/1.jpg"\ni w640 h480 n"nav/2.jpg"\n'
        "c n0 N1 x10.5 y20.25 X30 Y40.5 t0\nc n1 N0 x1 y2 X3 Y4 t0\n")
    (tmp_path / "a.xyz").write_text("# comment\n1.0, 2.0, 3.0\n\n4 5 6 7\n")
    ji, jp = JD.parse_hugin_control_points(tmp_path / "a.pto")
    ti, tp = TD.parse_hugin_control_points(tmp_path / "a.pto")
    assert ti == ji == ["nav/1.jpg", "nav/2.jpg"]
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(TD.parse_xyz(tmp_path / "a.xyz"), JD.parse_xyz(tmp_path / "a.xyz"))


def test_depth_value_agrees_on_half_pixels_and_edges():
    h, w = CLOUD.shape[:2]
    xs = np.concatenate([np.arange(0, w, 0.5), [w - 0.5, w - 0.49, w - 1.0]])
    ys = np.concatenate([np.arange(0, h, 0.5), [h - 0.5, h - 0.49, h - 1.0]])
    pix = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    n_none = 0
    for p in pix:
        a, b = TImg.depth_value(CLOUD, p), JImg.depth_value(CLOUD, p)
        assert (a is None) == (b is None), p
        n_none += a is None
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert 0 < n_none < len(pix)         # the far edge and the two sentinels
    for bad in ((-0.6, 1.0), (1.0, h + 0.6)):
        with pytest.raises(ValueError):
            TImg.depth_value(CLOUD, bad)
        with pytest.raises(ValueError):
            JImg.depth_value(CLOUD, bad)
    assert TImg.depth_value(None, (1, 1)) is None
    inb = pix[(pix[:, 0] < w - 0.5) & (pix[:, 1] < h - 0.5)]
    for cloud in (CLOUD, None):
        txyz, tval = TImg.depth_values_batch(cloud, inb)
        jxyz, jval = JImg.depth_values_batch(cloud, inb)
        np.testing.assert_array_equal(txyz, jxyz)
        np.testing.assert_array_equal(tval, jval)
    single = np.array([TImg.depth_value(CLOUD, p) is not None for p in inb])
    np.testing.assert_array_equal(TImg.depth_values_batch(CLOUD, inb)[1], single)


def _sensor(rc, name, off=0.0):
    return rc.SensorConfig(
        name=name, focal_length=20.0, optical_center=np.array([8.0, 6.0]),
        distortion=np.array([]), image_size=(16, 12), distorted_crop_size=(16, 12),
        undistorted_image_size=(16, 12), ref_to_sensor=np.eye(4), depth_to_image=np.eye(4),
        timestamp_offset=off)


def test_scan_depth_dir_and_build_depth_observations(tmp_path):
    """Clouds on disk -> records -> bracketed entries -> depth rows: the same
    in both packages, ``pix_row`` included (the haz rows follow the nav rows
    in the global pixel order)."""
    for t in (10000.25, 10001.25):
        TD.write_xyz_image(tmp_path / "haz_cam" / f"{t:.2f}.pc",
                           CLOUD + np.float32(t - 10000.0) * (CLOUD != 0))
    (tmp_path / "haz_cam" / "notes.pc").write_bytes(b"")      # not a timestamp: skipped
    (tmp_path / "nav_cam").mkdir()
    names = ["nav_cam", "haz_cam"]
    jrecs, trecs = JCommon.scan_depth_dir(tmp_path, names), TCommon.scan_depth_dir(tmp_path, names)
    assert [len(r) for r in trecs] == [len(r) for r in jrecs] == [0, 2]
    for a, b in zip(trecs[1], jrecs[1]):
        assert (a.timestamp, a.name) == (b.timestamp, b.name)
        np.testing.assert_array_equal(a.payload, b.payload)

    ref_ts = [10000.0, 10001.0, 10002.0]
    out = {}
    for key, br, asm, rc, ts_cls, recs in (("j", JBr, JAsm, JRc, JTrackSet, jrecs),
                                          ("t", TBr, TAsm, TRc, TTrackSet, trecs)):
        images = [[br.ImageRecord(t, f"nav_cam/{t}.pgm", None) for t in ref_ts],
                  [br.ImageRecord(t, f"haz_cam/{t}.pgm", None) for t in (10000.25, 10001.25)]]
        cams, _, _ = br.lookup_images(False, ref_ts, images, recs, [0.0, 0.0], bracket_len=1.5)
        assert sum(c.depth_cloud is not None for c in cams) == 2
        kps = [RNG.uniform(1, 10, size=(6, 2)) if key == "j" else None for _ in cams]
        out[key] = (cams, kps, asm, rc, ts_cls)
    jcams, kps, *_ = out["j"]
    haz = [i for i, c in enumerate(jcams) if c.camera_type == 1]
    kps[haz[0]][2] = [4.0, 3.0]                  # the (0,0,0) sentinel of the haz cloud
    kps[haz[1]][0] = [15.6, 5.0]                 # rounds to the far edge
    tracks = [{0: k, haz[0]: k, haz[1]: (k + 1) % 6} for k in range(6)] + [{0: 0, 1: 1}]
    kw = dict(no_rig=False)
    jcams, _, jasm, jrc, jts = out["j"]
    tcams, _, tasm, trc, tts = out["t"]
    jrig = jrc.RigConfig([_sensor(jrc, "nav_cam"), _sensor(jrc, "haz_cam")])
    trig = trc.RigConfig([_sensor(trc, "nav_cam"), _sensor(trc, "haz_cam")])
    jdep = jasm.build_depth_observations(jrig, jcams, np.asarray(ref_ts), jts(kps, tracks), **kw)
    tdep = tasm.build_depth_observations(trig, tcams, np.asarray(ref_ts), tts(kps, tracks),
                                         device="cpu", **kw)
    assert len(tdep) == len(jdep) == 1 and tdep[0].sensor == jdep[0].sensor == 1
    assert 0 < len(tdep[0]) < 12                 # the sentinel and the edge rows are dropped
    for f in ("depth_xyz", "beg_idx", "end_idx", "point_idx", "dt_cam", "dt_bracket", "mask",
              "pix_row"):
        np.testing.assert_array_equal(getattr(tdep[0], f).numpy(),
                                      np.asarray(getattr(jdep[0], f)), err_msg=f)
    n_nav = sum(jcams[cid].camera_type == 0 for tr in tracks for cid in tr)
    assert tdep[0].mesh_xyz is None and int(tdep[0].pix_row.min()) >= n_nav > 0


def test_terrain_mesh_round_trip(tmp_path):
    n = TSyn.write_terrain_mesh(tmp_path / "terrain.ply", lo=(-1.0, -1.0), hi=(2.0, 1.0),
                                step=0.25)
    mesh = JPly.read_ply(tmp_path / "terrain.ply")
    assert mesh["faces"].shape == (n, 3) and n == 2 * 12 * 8
    v = mesh["vertices"]
    np.testing.assert_allclose(v[:, 2], TSyn.terrain_height(v[:, 0], v[:, 1]), atol=1e-6)
    tri = v[mesh["faces"]]
    normal_z = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])[:, 2]
    assert (normal_z > 0).all()                  # consistently wound, facing up
    np.testing.assert_allclose(0.5 * np.abs(normal_z).sum(), 3.0 * 2.0, rtol=1e-6)
