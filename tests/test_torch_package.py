"""The PyTorch port imports neither jax nor the JAX package: every module of
multiview_tpu_torch is imported in a subprocess in which both are made
unimportable."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "multiview_tpu"):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, Block())
import multiview_tpu_torch
names = [m.name for m in pkgutil.walk_packages(multiview_tpu_torch.__path__,
                                                 "multiview_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "multiview_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 36
    for new in ("sfm.global_sfm", "sfm.incremental", "sfm.retrieval", "tools.sfm_init",
                "texture.raycast", "calib.mesh_constraints", "calib.checkpoint", "solver.lm",
                "geometry.rpc_fit", "geometry.registration", "io.depth_io", "io.ply",
                "tools.fit_rpc_tool", "dense.stereo", "dense.pc_filter", "dense.tsdf",
                "dense.marching", "utils.undistort", "tools.fuse_mesh", "tools.undistort_tool",
                "io.match_file", "calib.registration", "calib.pose_storage", "geometry.plane",
                "texture.texturing", "texture.mesh_project", "tools.texture_mesh",
                "parallel.sharding", "parallel.distributed", "parallel.dryrun",
                "utils.profiling"):
        assert (ROOT / "multiview_tpu_torch" / (new.replace(".", "/") + ".py")).is_file()


def test_chip_smoke_and_scripts_name_no_jax():
    """Neither chip_smoke.py nor any module of the port imports jax or the
    JAX package, by the text of their import statements too."""
    import re
    files = ([ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))
             + sorted((ROOT / "multiview_tpu_torch").rglob("*.py")))
    assert len(files) > 40
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|multiview_tpu)(?:\.|\s|$)", re.M)
    bad = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert not bad, bad


def test_chip_smoke_refuses_to_run_without_a_gpu_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result on a machine with no
    CUDA device, and in a directory holding nothing else of the repo."""
    import torch
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                                   capture_output=True, text=True, timeout=120))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def _constructors(device):
    """Every constructor of the port that puts a problem on a device, called
    at a tiny size; ``device`` None means "name no device"."""
    import numpy as np
    import torch
    from multiview_tpu_torch.calib import assemble, bracketing as br, problem as prob
    from multiview_tpu_torch.geometry import pose
    from multiview_tpu_torch.geometry.camera import CameraParams
    from multiview_tpu_torch.io import rig_config as rc
    from multiview_tpu_torch.sfm.tracks import TrackSet
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import synthetic as syn

    kw = {} if device is None else {"device": device}
    sensor = rc.SensorConfig(
        name="nav_cam", focal_length=50.0, optical_center=np.array([32.0, 24.0]),
        distortion=np.array([]), image_size=(64, 48), distorted_crop_size=(64, 48),
        undistorted_image_size=(64, 48), ref_to_sensor=np.eye(4), depth_to_image=np.eye(4),
        timestamp_offset=0.0)
    rig = rc.RigConfig([sensor])
    cloud = np.ones((48, 64, 3), np.float32)
    images = [[br.ImageRecord(float(t), f"nav_cam/{t}.pgm", None) for t in (0, 1)]]
    depth = [[br.ImageRecord(float(t), f"nav_cam/{t}.pc", cloud) for t in (0, 1)]]
    cams, _, _ = br.lookup_images(False, [0.0, 1.0], images, depth, [0.0], bracket_len=1.5)
    tracks = TrackSet([np.array([[10.0, 12.0]]), np.array([[11.0, 12.0]])], [{0: 0, 1: 0}])
    ident = np.tile([0, 0, 0, 0, 0, 0, 1.0], (2, 1))
    cpu_scene = syn.make_cube_scene(n_images=3, n_per_face=2, device="cpu")
    arrays = prob.to_numpy(cpu_scene.true_state)
    obs_arrays = {"pixels": [{
        f: getattr(cpu_scene.observations.pixels[0], f).numpy()
        for f in ("pix", "beg_idx", "end_idx", "point_idx", "dt_cam", "dt_bracket", "mask",
                  "dist_half_size")}]}
    return {
        "from_numpy": lambda: prob.from_numpy(arrays, obs_arrays, **kw)[0].points,
        "build_state": lambda: assemble.build_state(
            rig, cams, ident, np.array([0.0, 1.0]), ident, 1, **kw).points,
        "build_observations": lambda: assemble.build_observations(
            rig, cams, np.array([0.0, 1.0]), tracks, **kw)[0].pixels[0].pix,
        "build_depth_observations": lambda: assemble.build_depth_observations(
            rig, cams, np.array([0.0, 1.0]), tracks, **kw)[0].depth_xyz,
        "make_cube_scene": lambda: syn.make_cube_scene(
            n_images=3, n_per_face=2, **kw).true_state.points,
        "make_rig_scene": lambda: syn.make_rig_scene(
            n_ref=3, n_per_face=2, **kw).true_state.points,
        "add_depth_observations": lambda: syn.add_depth_observations(
            syn.make_rig_scene(n_ref=3, n_per_face=2, **kw)).observations.depths[0].depth_xyz,
        "CameraParams.create": lambda: CameraParams.create(
            (64, 48), 50.0, (32.0, 24.0), **kw).focal,
        "cam_params_from_sensor": lambda: common.cam_params_from_sensor(sensor, **kw).focal,
        "quat_identity": lambda: pose.quat_identity(**kw),
    }


_CONSTRUCTORS = ["from_numpy", "build_state", "build_observations", "build_depth_observations",
                 "make_cube_scene", "make_rig_scene", "add_depth_observations",
                 "CameraParams.create", "cam_params_from_sensor", "quat_identity"]


def test_constructor_list_is_complete():
    assert sorted(_constructors("cpu")) == sorted(_CONSTRUCTORS)


@pytest.mark.parametrize("name", _CONSTRUCTORS)
def test_constructors_never_choose_the_cpu_by_themselves(name):
    """With ``device="cpu"`` each constructor works on the CPU; with no device
    named it puts its tensors on the first CUDA card, and raises the error
    that names the remedy where there is none."""
    import torch
    assert _constructors("cpu")[name]().device.type == "cpu"
    if torch.cuda.is_available():
        assert _constructors(None)[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            _constructors(None)[name]()


def test_render_terrain_names_the_cpu_itself(tmp_path):
    """The workspace renderer is host numpy work: it runs with no device
    named and no card."""
    from multiview_tpu_torch.utils import synthetic as syn
    syn.build_rig_workspace(tmp_path, 2, (32, 24), 28.0, depth=True)
    assert (tmp_path / "images" / "haz_cam" / "10000.25.pc").is_file()


def _sfm_entry_points(device):
    """The entry points of the sfm-init slice that put work on a device,
    called at a tiny size; ``device`` None means "name no device"."""
    import numpy as np
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.sfm import global_sfm as gs, incremental as inc

    kw = {} if device is None else {"device": device}
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (40, 3)) + [0, 0, 4.0]
    cams = [np.array([0.3 * i, 0.0, 0.0]) for i in range(3)]
    uv = [(pts - c)[:, :2] / (pts - c)[:, 2:] for c in cams]
    pair_data = {(0, 1): (uv[0], uv[1]), (1, 2): (uv[1], uv[2])}
    obs = (np.repeat(np.arange(3), 40), np.tile(np.arange(40), 3), np.concatenate(uv))
    return {
        "make_view_graph": lambda: gs.make_view_graph(
            [[0, 1]], [[0, 0, 0, 1.0]], [[1.0, 0, 0]], [1.0], **kw).rel_rot,
        "view_graph_from_matches": lambda: gs.view_graph_from_matches(
            pair_data, 3, **kw).rel_rot,
        "run_global_sfm": lambda: gs.run_global_sfm(pair_data, 3, **kw),
        "run_incremental_sfm": lambda: inc.run_incremental_sfm(
            pair_data, 3, obs, inc.IncrementalOptions(min_pnp_inliers=10), **kw)[0],
        "identity_state": lambda: prob.identity_state(2, 1, 3, [0], **kw).points,
    }


@pytest.mark.parametrize("name", ["make_view_graph", "view_graph_from_matches", "run_global_sfm",
                                  "run_incremental_sfm", "identity_state"])
def test_sfm_entry_points_never_choose_the_cpu_by_themselves(name):
    """As the constructors above: the CPU only when it is named."""
    import torch
    assert sorted(_sfm_entry_points("cpu")) == sorted(_sfm_entry_points(None))
    assert _sfm_entry_points("cpu")[name]().device.type == "cpu"
    if torch.cuda.is_available():
        assert _sfm_entry_points(None)[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            _sfm_entry_points(None)[name]()


def test_ransacs_and_retrieval_run_where_their_tensors_are():
    """The RANSACs and ``select_pairs`` take tensors and compute on those
    tensors' device (the front end and ``view_graph_from_matches`` put them on the
    device the caller named); nothing in them moves work to the CPU."""
    import re
    for mod in ("sfm/ransac.py", "sfm/retrieval.py"):
        text = (ROOT / "multiview_tpu_torch" / mod).read_text()
        assert not re.search(r"device\s*=\s*[\"']cpu", text), mod
        assert ".cpu()" not in text.replace("(g @ g.T).cpu()", ""), mod


def _texture_entry_points(ws, device):
    """The texture slice's entry points that compute on a device of their
    choosing, at a tiny size; ``device`` None means "name no device"."""
    import numpy as np
    from multiview_tpu_torch.__main__ import main as torch_main
    from multiview_tpu_torch.texture import texturing as TT

    kw = {} if device is None else {"device": device}
    flags = [] if device is None else ["--device", device]
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0.0]])
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    atlas = TT.build_atlas(verts, faces, pixel_size=0.1)
    page = np.full((atlas.size[1], atlas.size[0], 3), 0.5, np.float32)
    adjacency = TT.face_adjacency(faces)
    return {
        "texture": lambda: torch_main([
            "texture", "--rig_config", str(ws / "rig_config.txt"), "--camera_poses",
            str(ws / "cameras.txt"), "--images", str(ws / "images"), "--mesh",
            str(ws / "terrain.ply"), "--out_dir", str(ws / "tex"), "--pixel_size", "0.1"]
            + flags),
        "global_seam_leveling": lambda: TT.global_seam_leveling(
            np.array([0.2, 0.6]), np.array([0, 1]), adjacency, **kw),
        "local_seam_leveling": lambda: TT.local_seam_leveling(
            page, atlas, verts, faces, np.array([0, 1]), np.array([True, True]), adjacency,
            **kw),
    }


@pytest.mark.parametrize("name", ["texture", "global_seam_leveling", "local_seam_leveling"])
def test_texture_entry_points_never_choose_the_cpu_by_themselves(tmp_path, monkeypatch, name):
    """The ``texture`` tool and the seam leveling solves run on the CPU when
    it is named, and without a card raise the error that names the remedy
    when it is not. The other texturing functions compute where their
    tensors or cameras are."""
    import torch
    from multiview_tpu_torch.utils import synthetic as syn
    syn.build_rig_workspace(tmp_path, 2, (32, 24), 28.0)
    syn.write_terrain_mesh(tmp_path / "terrain.ply", lo=(-1.0, -1.0), hi=(2.0, 1.0), step=0.5)
    assert sorted(_texture_entry_points(tmp_path, "cpu")) == sorted(
        ["texture", "global_seam_leveling", "local_seam_leveling"])
    out = _texture_entry_points(tmp_path, "cpu")[name]()
    assert out == 0 if name == "texture" else out is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        _texture_entry_points(tmp_path, None)[name]()
