"""Port parity of the public helpers the earlier slices left out and of
``utils/profiling.py``: each function of multiview_tpu_torch against its
counterpart in the JAX package on the same inputs, on the CPU in float64.
Float results agree to 1e-12; index and mask results, union-find roots and
file bytes are equal."""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu import native as JN
from multiview_tpu.calib import calibrator as JCal, problem as JPr, rig_init as JRi
from multiview_tpu.geometry import camera as JCam, pose as JP
from multiview_tpu.sfm import tracks as JTr
from multiview_tpu.tools import common as JCo
from multiview_tpu.utils import images as JIm, profiling as JProf, synthetic as JSyn
from multiview_tpu_torch import native as TN
from multiview_tpu_torch.calib import calibrator as TCal, problem as TPr, rig_init as TRi
from multiview_tpu_torch.geometry import camera as TCam, pose as TP
from multiview_tpu_torch.sfm import tracks as TTr
from multiview_tpu_torch.tools import common as TCo
from multiview_tpu_torch.utils import images as TIm, profiling as TProf, synthetic as TSyn
from torch_port_scenes import one_torch_thread, port_problem  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("coeffs,undist,scale", [
    ((), None, 1.0), ((0.9,), (200, 150), 1.0), ((-0.1, 0.02, 1e-4, -1e-4), None, 0.5),
    ((-0.1, 0.02, 1e-4, -1e-4, 0.003), (180, 140), 1.5)])
def test_undistortion_remap_grid(coeffs, undist, scale):
    args = ((160, 120), (150.0, 152.0), (80.5, 58.2), coeffs)
    ref = JCam.undistortion_remap_grid(
        JCam.CameraParams.create(*args, undistorted_size=undist, dtype=jnp.float64), scale)
    got = TCam.undistortion_remap_grid(
        TCam.CameraParams.create(*args, undistorted_size=undist, device="cpu"), scale)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quat_identity(dtype):
    got = TP.quat_identity(getattr(torch, dtype), device="cpu")
    ref = JP.quat_identity(getattr(jnp, dtype))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("weighted,iters", [(False, 4), (True, 4), (True, 1)])
def test_quat_mean(weighted, iters):
    rng = np.random.default_rng(5)
    base = rng.normal(size=4)
    qs = np.array(JP.quat_mul(jnp.asarray(base / np.linalg.norm(base)),
                              JP.quat_exp(jnp.asarray(rng.normal(size=(20, 3)) * 0.05))))
    w = rng.uniform(0.2, 2.0, 20) if weighted else None
    ref = JP.quat_mean(jnp.asarray(qs), None if w is None else jnp.asarray(w), iters)
    got = TP.quat_mean(torch.as_tensor(qs), None if w is None else torch.as_tensor(w), iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


_IMG_U8 = np.random.default_rng(0).integers(0, 256, (8, 9, 3)).astype(np.uint8)
_IMG_F = np.random.default_rng(1).uniform(0, 1, (8, 9))


@pytest.mark.parametrize("name,args", [
    ("srgb_gamma", (np.linspace(-0.01, 1.0, 97),)),
    ("srgb_inv_gamma", (np.linspace(-0.01, 1.0, 97),)),
    ("exposure_correction", (100.0, 10.0, 10.0, _IMG_U8)),
    ("exposure_correction", (400.0, 10.0, 7.0, _IMG_U8)),
    ("exposure_correction", (400.0, 10.0, 7.0, _IMG_F)),
    ("scale_image", (400.0, 10.0, 10.0, _IMG_U8)),
    ("scale_image", (50.0, 10.0, 10.0, _IMG_F)),
    ("pick_timestamps_in_bounds", ([0.0, 1.0, 2.0, 3.0], 0.5, 2.5, 0.0)),
    ("pick_timestamps_in_bounds", ([5.0], 0.0, 1.0, -4.5)),
    ("pick_timestamps_in_bounds", ([0.0, 0.4, 0.9], 0.3, 0.35, 0.1)),
    ("pick_timestamps_in_bounds", ([2.0, 3.0], 0.0, 1.0, 0.0)),
])
def test_image_helpers(name, args):
    ref = getattr(JIm, name)(*args)
    got = getattr(TIm, name)(*args)
    if isinstance(ref, list):
        assert got == ref
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.fixture(scope="module")
def rig_problem():
    scene = JSyn.make_rig_scene(n_ref=4, n_per_face=3, pix_noise=0.3)
    state0 = JSyn.perturb_rig_state(scene.true_state, pose_rot=0.003, pose_trans=0.005,
                                    point_sigma=0.01)
    return scene, state0, port_problem(state0, scene.observations)


def test_flag_outliers_by_exclusion_dist(rig_problem):
    scene, _, (_, obs) = rig_problem
    sizes = {0: (1280, 960), 1: (640, 480), 2: (960, 720)}
    crops = {0: (1000, 700), 1: (640, 480), 2: (500, 400)}
    ref = JCal.flag_outliers_by_exclusion_dist(scene.observations, crops, sizes)
    got = TCal.flag_outliers_by_exclusion_dist(obs, crops, sizes)
    kept = 0
    for a, b, o in zip(got.pixels, ref.pixels, obs.pixels):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        kept += int(a.mask.sum())
    assert 0 < kept < sum(len(o) for o in obs.pixels)


def test_reprojection_errors(rig_problem):
    scene, state0, (st, obs) = rig_problem
    ref = JCal.reprojection_errors(state0, scene.observations, scene.models, JPr.BAOptions())
    got = TCal.reprojection_errors(st, obs, scene.models, TPr.BAOptions())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("beg,end,offset,t", [(0, 1, 0.0, 0.25), (1, 2, 0.3, 1.9),
                                               (2, 2, 0.0, 2.0), (0, 1, -0.2, 0.1)])
def test_interp_world_to_ref_np(beg, end, offset, t):
    rng = np.random.default_rng(3)
    w2r = np.concatenate([rng.normal(size=(3, 3)), rng.normal(size=(3, 4))], axis=1)
    ts = np.array([0.0, 1.0, 2.0])
    np.testing.assert_allclose(TRi.interp_world_to_ref_np(w2r, ts, beg, end, offset, t),
                               JRi.interp_world_to_ref_np(w2r, ts, beg, end, offset, t), **TOL)


def test_calc_world_to_cam_no_rig():
    w2c = np.random.default_rng(4).normal(size=(5, 7))
    np.testing.assert_array_equal(TRi.calc_world_to_cam_no_rig([], w2c),
                                  JRi.calc_world_to_cam_no_rig([], w2c))


def test_native_available_and_read_files(tmp_path):
    assert TN.available() == JN.available()
    paths = []
    for i in range(12):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes(np.random.default_rng(i).integers(0, 256, 50 * i, dtype=np.uint8)))
        paths.append(str(p))
    paths.insert(5, str(tmp_path / "missing.bin"))
    for threads in (0, 3):
        got = TN.read_files(paths, num_threads=threads)
        assert got == JN.read_files(paths, num_threads=threads)
        assert got[5] is None and got[0] == b"" and len(got[12]) == 550


@pytest.mark.parametrize("seed", [0, 1])
def test_union_find(seed):
    rng = np.random.default_rng(seed)
    ja, ta = JTr.UnionFind(200), TTr.UnionFind(200)
    for a, b in rng.integers(0, 200, (150, 2)):
        ja.union(int(a), int(b))
        ta.union(int(a), int(b))
    roots = [ta.find(i) for i in range(200)]
    assert roots == [ja.find(i) for i in range(200)]
    np.testing.assert_array_equal(ta.parent, ja.parent)


def test_sensor_from_cam_params():
    args = ((640, 480), (300.0, 302.0), (321.5, 239.0), (-0.1, 0.02, 1e-4, -1e-4))
    kw = dict(undistorted_size=(700, 520), distorted_crop_size=(600, 440))
    rig = np.eye(4)
    rig[:3, 3] = [0.1, 0.2, 0.3]
    ref = JCo.sensor_from_cam_params("sci_cam", JCam.CameraParams.create(
        *args, **kw, dtype=jnp.float64), ref_to_sensor=rig, timestamp_offset=0.25)
    got = TCo.sensor_from_cam_params("sci_cam", TCam.CameraParams.create(
        *args, **kw, device="cpu"), ref_to_sensor=rig, timestamp_offset=0.25)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_allclose(a, b, **TOL)
        else:
            assert a == b, f.name


def test_profiling_stages(capsys):
    """stage / stage_times / reset keep the reference's registry and its
    printed line; device_trace on the CPU writes a Chrome trace holding an
    annotated region."""
    for mod in (JProf, TProf):
        mod.reset()
        for name in ("match", "solve", "match"):
            with mod.stage(name, verbose=name == "solve"):
                pass
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" took ")[0] for ln in lines] == ["solve", "solve"]
    assert all(ln.endswith(" seconds") for ln in lines)
    jt, tt = JProf.stage_times(), TProf.stage_times()
    assert list(tt) == list(jt) == ["match", "solve"]
    assert all(v >= 0.0 for v in tt.values())
    TProf.reset()
    assert TProf.stage_times() == {}


def test_device_trace_on_the_cpu(tmp_path):
    with TProf.device_trace(str(tmp_path), device="cpu"):
        with TProf.annotate("probe_region"):
            torch.ones(64).sum()
    (trace,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "probe_region" in names


@pytest.mark.parametrize("n", [0, 1, 4, 5, 8, 3, 7])
def test_dist_mod_name(n):
    """The model of a coefficient count: none, fov, tsai (4 and 5), rpc (an
    even count above 5); an irregular count raises in both packages."""
    if n in (3, 7):
        with pytest.raises(ValueError, match="Irregular"):
            JSyn.dist_mod_name(n)
        with pytest.raises(ValueError, match="Irregular"):
            TSyn.dist_mod_name(n)
        return
    assert TSyn.dist_mod_name(n) == JSyn.dist_mod_name(n)
