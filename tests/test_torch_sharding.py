"""Port parity of the sharded paths (``multiview_tpu_torch/parallel``): the
Schur-LM over observations sharded on CPU shards, the 2-D meshes, TSDF slab
sharding, multi-process start-up in one process, the sharded front end and
``calibrate --sharded``, against the port unsharded and the JAX package's
sharded functions on conftest's 8 virtual CPU devices. Float64 on the CPU.

Tolerances:
- the sharded solve against the port unsharded: initial cost rtol 1e-12,
  final cost rtol 1e-9, cameras atol 1e-9 (the same arithmetic, partials
  summed over shards in another order); the LM and CG counts equal;
- against JAX's 8-device sharded solve: the bars of tests/test_sharding.py
  (initial cost 1e-10, final cost 1e-6 relative, cameras 1e-7 absolute);
- the 2-D meshes against the 1-D mesh: the same bars;
- padding rows: the residual norm rtol 1e-12;
- TSDF: the sharded grid bit for bit the port's whole grid, and within
  atol 1e-5 of JAX's sharded grid (float32, as tests/test_sharding.py);
- the front end: keypoints, descriptors, matches and tracks bit for bit the
  unsharded port's; on JAX's features and RANSAC draws the sharded matches
  equal JAX's sharded ``match_pairs_batched``;
- ``calibrate`` with an 8-shard mesh: cameras atol 1e-9 of the unsharded
  run's."""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_tpu.calib import problem as JPr
from multiview_tpu.dense import tsdf as JT
from multiview_tpu.geometry import pose as JP
from multiview_tpu.parallel import sharding as JSh
from multiview_tpu.sfm import pipeline as JPl
from multiview_tpu.solver import schur as JS
from multiview_tpu.utils import synthetic as JSyn
from multiview_tpu_torch.calib import calibrator as TCal, problem as TPr
from multiview_tpu_torch.dense import marching as TM, tsdf as TT
from multiview_tpu_torch.parallel import distributed as TDist, sharding as TSh
from multiview_tpu_torch.sfm import features as TF, pipeline as TPl, ransac as TR
from multiview_tpu_torch.sfm import tracks as TTr
from multiview_tpu_torch.solver import schur as TS
from multiview_tpu_torch.tools import calibrate as TCalTool
from torch_port_scenes import (jax_sampler, make_depth_scene, one_torch_thread, port_problem,
                               write_rig_workspace)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU8 = ["cpu"] * 8


def _cube():
    return JSyn.make_cube_scene(n_images=8, n_per_face=3, pix_noise=0.3,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4))


@pytest.fixture(scope="module")
def cube():
    """The cube scene of tests/test_sharding.py in both packages, perturbed
    as there."""
    scene = _cube()
    jstate = JSyn.perturb_state(scene.true_state)
    st, obs = port_problem(jstate, scene.observations)
    return scene, jstate, st, obs


def _port_solver(st, obs, models, **kw):
    mask = TPr.build_mask(st, TPr.FloatSpec(cam_poses=True), no_rig=True, include_points=False)
    return TS.make_schur_solver(st, obs, models, TPr.BAOptions(no_rig=True), mask, **kw)


def _same_solve(got, ref, initial, final, cam):
    np.testing.assert_allclose(float(got.initial_cost), float(ref.initial_cost), rtol=initial)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=final)
    np.testing.assert_allclose(np.asarray(got.cam), np.asarray(ref.cam), rtol=0, atol=cam)


@pytest.mark.parametrize("cg_tolerance", [1e-8, 0.1], ids=["schur_jacobi", "jacobi"])
def test_sharded_solve_equals_unsharded(cube, cg_tolerance):
    """8 CPU shards against one: the same LM and CG decisions (trap c: they
    follow from all-reduced inputs alone), the same result to summation
    order."""
    scene, _, st, obs = cube
    solver = _port_solver(st, obs, scene.models, max_iterations=8, cg_iterations=30,
                          cg_tolerance=cg_tolerance)
    cam0 = TPr.pack_state(st, include_points=False)
    ref = solver(cam0, st.points)
    mesh = TSh.make_mesh(CPU8)
    got = solver(cam0, st.points, TSh.shard_observations(obs, mesh))
    assert got.iterations == ref.iterations and int(got.cg_iters_total) == int(ref.cg_iters_total)
    np.testing.assert_allclose(float(got.lam), float(ref.lam), rtol=1e-9)
    _same_solve(got, ref, 1e-12, 1e-9, 1e-9)
    np.testing.assert_allclose(got.points.numpy(), ref.points.numpy(), rtol=0, atol=1e-9)


def test_sharded_solve_matches_jax_sharded(cube):
    """The port over 8 CPU shards against JAX's solve sharded over the 8
    virtual devices (tests/test_sharding.py::test_sharded_equals_unsharded)."""
    scene, jstate, st, obs = cube
    mesh = JSh.make_mesh()
    jobs = JSh.shard_observations(scene.observations, mesh)
    jst = JSh.replicate(jstate, mesh)
    jmask = JPr.build_mask(jst, JPr.FloatSpec(cam_poses=True), no_rig=True,
                           include_points=False)
    jsolver = JS.make_schur_solver(jst, jobs, scene.models, JPr.BAOptions(no_rig=True), jmask,
                                   max_iterations=8, cg_iterations=30)
    jres = jax.jit(jsolver)(JPr.pack_state(jst, include_points=False), jst.points, jobs)
    tmesh = TSh.make_mesh(CPU8)
    tobs = TSh.shard_observations(obs, tmesh)
    got = _port_solver(st, tobs, scene.models, max_iterations=8, cg_iterations=30)(
        TPr.pack_state(st, include_points=False), st.points, tobs)
    assert got.iterations == int(jres.iterations)
    _same_solve(got, jres, 1e-10, 1e-6, 1e-7)


@pytest.mark.parametrize("n_shards", [8, 5])
def test_sharded_solve_with_depth_rows_and_priors(n_shards):
    """Depth rows against the triangulated points and against a mesh, and a
    triangulation prior, stay whole and count once (trap b): the sharded
    solve equals the unsharded one, with padding rows on both meshes."""
    jscene = make_depth_scene(JSyn)
    jstate = JSyn.perturb_rig_state(jscene.true_state, pose_rot=0.003, pose_trans=0.005,
                                    point_sigma=0.01)
    st, obs = port_problem(jstate, jscene.observations)
    P = st.points.shape[0]
    rng = np.random.default_rng(3)
    depths = []
    for d in obs.depths:
        hit = torch.as_tensor(rng.uniform(size=len(d)) > 0.3)
        xyz = st.points[d.point_idx] + 0.01 * torch.as_tensor(rng.normal(size=(len(d), 3)))
        depths.append(dataclasses.replace(d, mesh_xyz=torch.where(hit[:, None], xyz, 0.0),
                                          mesh_mask=hit))
    obs = dataclasses.replace(obs, depths=tuple(depths), tri_prior=TPr.XyzPriorObs(
        ref_xyz=st.points.clone(), point_idx=torch.arange(P),
        mask=torch.as_tensor(np.arange(P) % 4 != 0)))
    assert any(len(o) % n_shards for o in obs.pixels)       # padding on both meshes
    opts = TPr.BAOptions(depth_tri_weight=25.0, depth_mesh_weight=7.0, tri_weight=0.5)
    mask = TPr.build_mask(st, TPr.FloatSpec(cam_poses=True, rig_transforms=True,
                                            depth_to_image=(1,), depth_scale=True),
                          include_points=False)
    solver = TS.make_schur_solver(st, obs, jscene.models, opts, mask, max_iterations=6,
                                  cg_iterations=30)
    cam0 = TPr.pack_state(st, include_points=False)
    ref = solver(cam0, st.points)
    got = solver(cam0, st.points, TSh.shard_observations(obs, TSh.make_mesh(["cpu"] * n_shards)))
    assert got.iterations == ref.iterations and int(got.cg_iters_total) == int(ref.cg_iters_total)
    _same_solve(got, ref, 1e-12, 1e-9, 1e-9)
    assert float(got.cost) < 0.5 * float(got.initial_cost)


def test_padding_rows_are_inert(cube):
    """Padding added by sharding (432 rows over 5 shards: 3 padding rows)
    contributes nothing, and gathering drops it."""
    scene, _, st, obs = cube
    sharded = TSh.shard_observations(obs, TSh.make_mesh(["cpu"] * 5)).pixels[0]
    assert len(sharded) == len(obs.pixels[0]) == 432
    assert [len(s) for s in sharded.shards] == [87] * 5
    assert sharded.row_offsets == (0, 87, 174, 261, 348)
    assert not bool(sharded.shards[-1].mask[-3:].any())
    opts = TPr.BAOptions(no_rig=True)
    whole = TPr.pixel_residuals(st, obs.pixels[0], scene.models[0], opts)
    parts = [TPr.pixel_residuals(st, s, scene.models[0], opts) for s in sharded.shards]
    np.testing.assert_allclose(float(sum((p * p).sum() for p in parts)),
                               float((whole * whole).sum()), rtol=1e-12)
    back = sharded.gather()
    for f in ("pix", "beg_idx", "end_idx", "point_idx", "dt_cam", "dt_bracket", "mask"):
        assert torch.equal(getattr(back, f), getattr(obs.pixels[0], f)), f


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_2d_mesh_solve_equals_1d_mesh(cube, shape):
    """The (host x chip) layouts against the 1-D mesh, with the bars of
    tests/test_sharding.py::TestHostChipMesh2D."""
    scene, _, st, obs = cube
    solver = _port_solver(st, obs, scene.models, max_iterations=4, cg_iterations=30)
    cam0 = TPr.pack_state(st, include_points=False)
    r1 = solver(cam0, st.points, TSh.shard_observations(obs, TSh.make_mesh(CPU8)))
    mesh2 = TSh.make_mesh_2d(shape, CPU8)
    assert mesh2.shape == shape and mesh2.size == 8 and mesh2.axis_names == ("host", "obs")
    r2 = solver(cam0, st.points, TSh.shard_observations(obs, mesh2))
    _same_solve(r2, r1, 1e-10, 1e-6, 1e-7)


def test_mask_updates_keep_the_shards(cube):
    """The calibrator's bookkeeping reads a sharded problem whole and writes
    mask updates back onto the same shards (the JAX package's
    ``_resharded_like``); a checkpoint round trip keeps them too."""
    scene, _, st, obs = cube
    sharded = TSh.shard_observations(obs, TSh.make_mesh(["cpu"] * 5))
    gmask = np.random.default_rng(0).uniform(size=432) > 0.2
    plain = TCal._scatter_mask_updates(obs, gmask)
    upd = TCal._scatter_mask_updates(sharded, gmask)
    o = upd.pixels[0]
    assert isinstance(o, TSh.ShardedPixelObs) and o.row_offsets == (0, 87, 174, 261, 348)
    assert torch.equal(o.gather().mask, plain.pixels[0].mask)
    assert not bool(o.shards[-1].mask[-3:].any())
    assert torch.equal(TCal._global_mask(upd), TCal._global_mask(plain))
    assert torch.equal(TCal._global_w2c(st, upd), TCal._global_w2c(st, plain))
    table = TCal.build_track_table(upd, st.points.shape[0])
    np.testing.assert_array_equal(table.track_obs,
                                  TCal.build_track_table(plain, st.points.shape[0]).track_obs)


def test_optimize_rig_keeps_observations_sharded(cube, tmp_path):
    """Two calibrator passes (triangulation, solve, outlier gates,
    checkpoints) on 8 shards: the result equals the unsharded run's and the
    observations come back sharded."""
    scene, _, st, obs = cube
    kw = dict(num_passes=2, num_iterations=6, cg_iterations=30)
    spec = TPr.FloatSpec(cam_poses=True)
    opts = TPr.BAOptions(no_rig=True)
    ref = TCal.optimize_rig(st, obs, scene.models, spec, opts, **kw)
    got = TCal.optimize_rig(st, TSh.shard_observations(obs, TSh.make_mesh(CPU8)), scene.models,
                            spec, opts, checkpoint_dir=str(tmp_path), **kw)
    assert all(isinstance(o, TSh.ShardedPixelObs) for o in got.observations.pixels)
    assert torch.equal(TCal._global_mask(got.observations), TCal._global_mask(ref.observations))
    for a, b in zip(got.lm_results, ref.lm_results):
        _same_solve(a, b, 1e-12, 1e-9, 1e-9)
    from multiview_tpu_torch.calib import checkpoint as ckpt
    _, back, _ = ckpt.load_checkpoint(tmp_path, st, TSh.shard_observations(obs, TSh.make_mesh(
        CPU8)))
    assert isinstance(back.pixels[0], TSh.ShardedPixelObs)
    assert torch.equal(TCal._global_mask(back), TCal._global_mask(got.observations))


# ----------------------------------------------------------------------------
# TSDF slab sharding
# ----------------------------------------------------------------------------


def _tsdf_frames():
    """tests/test_sharding.py::TestTsdfSharding's three frames."""
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        pos = np.array([0.1 * i, -0.05 * i, 2.0])
        c2w = np.array(JP.pose_inverse(jnp.asarray(JSyn.look_at_pose(pos, np.zeros(3)))))
        frames.append((2.0 + 0.05 * rng.random((48, 64)), c2w))
    return frames


@pytest.mark.parametrize("layout", ["slabs_8", "blocks_2x4"])
def test_sharded_tsdf_matches_jax(layout):
    """Integration over a sharded grid: bit for bit the port's whole grid,
    within atol 1e-5 of JAX's sharded grid over the grid's extent; padding
    (Y 30 -> 32 on the 2x4 mesh) keeps zero weight and gathering drops it;
    marching gathers the blocks first."""
    shape, origin = (40, 30, 32), (-1.0, -0.8, -0.8)
    if layout == "slabs_8":
        jmesh, tmesh = JSh.make_mesh(), TSh.make_mesh(CPU8)
    else:
        jmesh, tmesh = JSh.make_mesh_2d((2, 4)), TSh.make_mesh_2d((2, 4), CPU8)
    focal, center = (60.0, 60.0), (32.0, 24.0)
    jgrid = JSh.shard_tsdf_grid(JT.make_grid(shape, origin=origin, voxel_size=0.05), jmesh)
    whole = TT.make_grid(shape, origin=origin, voxel_size=0.05, device="cpu")
    tgrid = TSh.shard_tsdf_grid(whole, tmesh)
    step = jax.jit(JT.integrate_depth_image, static_argnames=("max_range", "max_weight"))
    for depth, c2w in _tsdf_frames():
        jgrid = step(jgrid, jnp.asarray(depth, jnp.float32), jnp.asarray(focal),
                     jnp.asarray(center), jnp.asarray(c2w, jnp.float32))
        args = (torch.as_tensor(depth, dtype=torch.float32), focal, center,
                torch.as_tensor(c2w, dtype=torch.float32))
        tgrid = TT.integrate_depth_image(tgrid, *args)
        whole = TT.integrate_depth_image(whole, *args)
    assert isinstance(tgrid, TT.ShardedTsdfGrid) and len(tgrid.blocks) == 8
    got = tgrid.gather()
    assert got.shape == shape and tgrid.shape == tuple(np.asarray(jgrid.tsdf).shape)
    assert torch.equal(got.tsdf, whole.tsdf) and torch.equal(got.weight, whole.weight)
    assert float(got.weight.sum()) > 0
    assert sum(float(b.weight.sum()) for b in tgrid.blocks) == float(got.weight.sum())
    X, Y = shape[:2]
    for name in ("tsdf", "weight"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(jgrid, name))[:X, :Y], rtol=0, atol=1e-5)
    for a, b in zip(TM.extract_mesh(tgrid), TM.extract_mesh(whole)):
        np.testing.assert_array_equal(a, b)


def test_pad_tsdf_grid_and_point_cloud_integration():
    grid = TT.make_grid((13, 8, 8), origin=(0, 0, 0), voxel_size=0.1, device="cpu")
    padded = TSh.pad_tsdf_grid(grid, 8)
    assert padded.shape == (16, 8, 8) and float(padded.weight.sum()) == 0.0
    jpad = JSh.pad_tsdf_grid(JT.make_grid((13, 8, 8), origin=(0, 0, 0), voxel_size=0.1), 8)
    assert tuple(np.asarray(jpad.tsdf).shape) == padded.shape
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-0.3, 0.3, (500, 3))
                          + [0.0, 0.0, 1.0], dtype=torch.float32)
    pose = torch.tensor([0.8, 0.4, -0.6, 0, 0, 0, 1.0])
    kw = dict(focal=(40.0, 40.0), image_size=(64, 48),
              intensities=torch.linspace(0, 1, 500))
    whole = TT.integrate_point_cloud(grid, pts, pose, **kw)
    sharded = TT.integrate_point_cloud(TSh.shard_tsdf_grid(grid, TSh.make_mesh(["cpu"] * 3)),
                                       pts, pose, **kw).gather()
    assert float(whole.weight.sum()) > 0
    for name in ("tsdf", "weight", "intensity"):
        assert torch.equal(getattr(sharded, name), getattr(whole, name))


# ----------------------------------------------------------------------------
# Multi-process start-up, one process
# ----------------------------------------------------------------------------


def test_initialize_single_process_noop(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert TDist.initialize() is False
    assert TDist.initialize() is False        # a second call changes nothing
    assert not torch.distributed.is_initialized()
    assert TDist.process_count() == 1 and TDist.process_index() == 0


def test_global_mesh_host_chip_mesh_and_process_slice():
    mesh = TDist.global_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.axis_names == (TSh.OBS_AXIS,)
    assert mesh.size == 1 and mesh.group is None
    hc = TDist.host_chip_mesh(device="cpu")
    assert hc.shape == (1, 1) and hc.axis_names == ("host", TSh.OBS_AXIS)
    assert TDist.process_slice(100) == (0, 100)
    with pytest.raises(ValueError):
        TSh.ShardMesh(tuple(CPU8), ("host", "obs"), (3, 3))


# ----------------------------------------------------------------------------
# The sharded front end
# ----------------------------------------------------------------------------


def _images(n=6, size=96, seed=0):
    """tests/test_sharding.py::TestShardedFrontend's images."""
    from scipy.signal import convolve2d
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(size + 24, size + 24)).astype(np.float32)
    sm = convolve2d(base, np.ones((5, 5)) / 25.0, mode="same")
    return [np.ascontiguousarray(sm[i * 2:i * 2 + size, i * 3:i * 3 + size]).astype(np.float32)
            for i in range(n)]


def _pairs(n, k):
    return [(i, j) for i in range(n) for j in range(i + 1, min(i + 1 + k, n))]


def test_sharded_detection_bitwise_equal():
    images = _images(n=5)
    cfg = TPl.FrontendConfig(max_features=128)
    kps1, descs1 = TPl.detect_all(images, cfg, chunk=2, device="cpu")
    kps8, descs8 = TPl.detect_all(images, cfg, chunk=2, mesh=TSh.make_mesh(["cpu"] * 3))
    for a, b in zip(kps1, kps8):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for a, b in zip(descs1, descs8):
        assert torch.equal(a, b)


def test_sharded_matching_bitwise_equal_and_matches_jax(monkeypatch):
    """Port features: 8 shards bit for bit one. JAX features and draws: the
    port's sharded matches are JAX's sharded ``match_pairs_batched``'s."""
    images = _images()
    pair_ids = _pairs(6, 3)
    cfg = TPl.FrontendConfig(max_features=128, num_overlaps=3)
    kps, descs = TPl.detect_all(images, cfg, device="cpu")
    mesh = TSh.make_mesh(CPU8)
    single = TPl.match_pairs_batched(kps, descs, pair_ids, cfg, chunk=2)
    sharded = TPl.match_pairs_batched(kps, descs, pair_ids, cfg, chunk=2, mesh=mesh)
    assert list(single) == list(sharded) == pair_ids
    for k in single:
        for a, b in zip(single[k], sharded[k]):
            np.testing.assert_array_equal(a, b)
    assert sum(len(v[0]) for v in single.values()) > 0

    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    jcfg = JPl.FrontendConfig(max_features=128, num_overlaps=3)
    kj, dj = JPl.detect_all(images, jcfg)
    ref = JPl.match_pairs_batched(kj, dj, pair_ids, jcfg, use_pallas=False,
                                  mesh=JSh.make_mesh(axis="pairs"))
    tk = [TF.Keypoints(*(torch.as_tensor(np.asarray(a)) for a in k)) for k in kj]
    td = [torch.as_tensor(np.asarray(d)) for d in dj]
    ours = TPl.match_pairs_batched(tk, td, pair_ids, cfg, mesh=mesh)
    assert set(ours) == set(ref)
    for k in ref:
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_array_equal(a, b)


def test_sharded_frontend_tracks_equal():
    images = _images()
    cfg = TPl.FrontendConfig(max_features=128, num_overlaps=2)
    mesh = TSh.make_mesh(["cpu"] * 4)
    ts_mesh = TPl.detect_match_features(images, cfg, mesh=mesh)
    kps, descs = TPl.detect_all(images, cfg, device="cpu")
    raw = TPl.match_pairs_batched(kps, descs, _pairs(6, 2), cfg)
    ts_single = TTr.build_tracks({k: v for k, v in raw.items()
                                  if len(v[0]) >= cfg.min_pair_matches}, 6)
    assert ts_mesh.tracks == ts_single.tracks and len(ts_single.tracks) > 0
    for a, b in zip(ts_mesh.keypoints, ts_single.keypoints):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------------
# calibrate --sharded
# ----------------------------------------------------------------------------


def test_calibrate_sharded_run_with_an_8_shard_mesh(tmp_path, capsys):
    """``calibrate --sharded --device cpu`` through ``run(args)`` with a mesh
    of 8 CPU shards prints the reference's sharding line and writes the
    cameras of the unsharded run, with the flags of
    tests/test_cli_tools.py::TestShardedCalibrate (no rig, the nav_cam poses
    floating, two passes of 6 iterations)."""
    ws = tmp_path / "ws"
    write_rig_workspace(ws)
    parser = argparse.ArgumentParser()
    TCalTool.add_args(parser)

    def run(out, extra, mesh=None):
        args = parser.parse_args([
            "--rig_config", str(ws / "rig_config.txt"), "--camera_poses",
            str(ws / "cameras.txt"), "--images", str(ws / "images"), "--out_dir", str(out),
            "--no_rig", "--camera_poses_to_float", "nav_cam", "--num_iterations", "6",
            "--calibrator_num_passes", "2", "--max_features", "300", "--num_overlaps", "2",
            "--device", "cpu"] + extra)
        assert TCalTool.run(args, mesh=mesh) == 0
        return capsys.readouterr().out

    plain = run(tmp_path / "plain", [])
    text = run(tmp_path / "sharded", ["--sharded"], mesh=TSh.make_mesh(CPU8))
    assert "Sharded observations" not in plain
    assert "Sharded observations over 8 devices (1 process(es))" in text
    cams = [np.loadtxt(tmp_path / d / "cameras.txt", usecols=range(1, 13))
            for d in ("plain", "sharded")]
    assert len(cams[1]) == 11
    np.testing.assert_allclose(cams[1], cams[0], rtol=0, atol=1e-9)
    for M in cams[1]:
        R = M[:9].reshape(3, 3)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)


def test_dryrun_multichip_on_8_cpu_shards():
    """The port's counterpart of __graft_entry__.dryrun_multichip(8): a BA
    step on the 1-D and (2 x 4) meshes, TSDF slabs and blocks, sharded
    matching, each checked inside (the 2-D BA to the graft entry's bars)."""
    from multiview_tpu_torch.parallel import dryrun
    out = dryrun.dryrun_multichip(8, "cpu")
    c0, c1 = out["ba_1d"]
    assert np.isfinite(c1) and c1 < c0
    assert out["tsdf_1d_hits"] > 0 and out["tsdf_2d_hits"] > 0 and out["frontend_pairs"] == 9
