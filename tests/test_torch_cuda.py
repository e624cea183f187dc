"""The CUDA kernels of multiview_tpu_torch against their plain PyTorch
versions, on the card. Skipped where there is no CUDA device. This file
imports no jax (the GPU machine has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: identical best indices on random unit descriptors (no near-ties
at these sizes); distances rtol 1e-5 / atol 1e-6 (float32 sums of the
products in different orders: the FMA kernel's chain, the tensor-core
kernel's split-TF32 chains, cuBLAS)."""

import pytest
import torch

from multiview_tpu_torch.sfm import matching as tm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,m", [(1, 300, 517), (4, 1024, 1000)])
def test_cuda_kernel_matches_plain_version(cuda_device, p, n, m):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((p, n, 128), generator=g, device=cuda_device)
    t = torch.randn((p, m, 128), generator=g, device=cuda_device)
    q = (q / q.norm(dim=-1, keepdim=True)).contiguous()
    t = (t / t.norm(dim=-1, keepdim=True)).contiguous()
    before = tm.WGMMA_LAUNCHES
    got = tm.knn2(q, t)
    torch.cuda.synchronize()
    assert tm.WGMMA_LAUNCHES == before + 1      # D = 128 goes to the tensor-core kernel
    ref = tm.knn2_plain(q, t)
    assert torch.equal(got.best_idx, ref.best_idx)
    torch.testing.assert_close(got.best_dist, ref.best_dist, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.second_dist, ref.second_dist, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError):
        tm.knn2_cuda(q.double(), t.double())


def _unit(gen, shape, device):
    x = torch.randn(shape, generator=gen, device=device).abs()
    return (x / x.norm(dim=-1, keepdim=True)).contiguous()


def _assert_close(got, ref):
    assert torch.equal(got.best_idx, ref.best_idx)
    torch.testing.assert_close(got.best_dist, ref.best_dist, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.second_dist, ref.second_dist, rtol=1e-5, atol=1e-6)
    assert torch.equal(tm.ratio_test_mask(got), tm.ratio_test_mask(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,m,d", [(1, 64, 64, 128), (1, 300, 517, 128), (3, 1000, 1037, 128),
                                     (2, 200, 1037, 64), (1, 5000, 5000, 64)])
def test_tensor_core_kernel_matches_plain_split_plain_and_fma_kernel(cuda_device, p, n, m, d):
    g = torch.Generator(device=cuda_device).manual_seed(p + n + m + d)
    q, t = _unit(g, (p, n, d), cuda_device), _unit(g, (p, m, d), cuda_device)
    before = (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES)
    got = tm.knn2_cuda(q, t)
    torch.cuda.synchronize()
    assert (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES) == (before[0] + 1, before[1])
    _assert_close(got, tm.knn2_plain(q, t))
    _assert_close(got, tm.knn2_split_plain(q, t))
    _assert_close(got, tm.knn2_cuda_fma(q, t))
    single = tm.knn2_cuda(q[0], t[0])           # [N,D] x [M,D]
    assert torch.equal(single.best_idx, got.best_idx[0])
    assert torch.equal(single.best_dist, got.best_dist[0])


@pytest.mark.cuda
def test_other_widths_go_to_the_fma_kernel(cuda_device):
    """Widths above 128 go to the FMA kernel (narrower ones are zero-padded
    for the tensor-core kernel, ``sfm/matching.py::kernel_for``)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, t = _unit(g, (2, 333, 160), cuda_device), _unit(g, (2, 517, 160), cuda_device)
    before = (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES)
    got = tm.knn2(q, t)
    torch.cuda.synchronize()
    assert (tm.WGMMA_LAUNCHES, tm.FMA_LAUNCHES) == (before[0], before[1] + 1)
    _assert_close(got, tm.knn2_plain(q, t))
    with pytest.raises(ValueError):
        tm.knn2_cuda_wgmma(q, t)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_kernel_ties_keep_the_lowest_index(cuda_device, d):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, t = _unit(g, (200, d), cuda_device), _unit(g, (1037, d), cuda_device)
    t[900] = q[3]
    t[10] = q[3]                                # duplicates in different tiles and splits
    t[1036] = q[199]
    got = tm.knn2_cuda_wgmma(q, t)
    torch.cuda.synchronize()
    assert int(got.best_idx[3]) == 10
    assert float(got.second_dist[3]) == float(got.best_dist[3]) <= 1e-6
    assert int(got.best_idx[199]) == 1036
    assert not bool(tm.ratio_test_mask(got)[3])


# ----------------------------------------------------------------------------
# The depth and mesh paths on the card (plain PyTorch there: no kernel of
# their own), held against the same functions on the CPU in float64
# ----------------------------------------------------------------------------


@pytest.mark.cuda
def test_constructors_default_to_the_card(cuda_device):
    from multiview_tpu_torch.geometry.camera import CameraParams
    from multiview_tpu_torch.utils import synthetic as syn
    assert CameraParams.create((64, 48), 50.0, (32.0, 24.0)).device.type == "cuda"
    scene = syn.add_depth_observations(syn.make_rig_scene(n_ref=4, n_per_face=2))
    assert scene.true_state.device.type == "cuda"
    assert scene.observations.depths[0].depth_xyz.device.type == "cuda"


@pytest.mark.cuda
def test_ray_cast_on_the_card_matches_the_cpu(cuda_device):
    import numpy as np
    from multiview_tpu_torch.texture import raycast
    from multiview_tpu_torch.utils import synthetic as syn
    verts, faces = syn.terrain_mesh(lo=(-1.0, -1.0), hi=(2.0, 2.0), step=0.05)
    tri = verts[faces]
    g = np.random.default_rng(0)
    o = np.column_stack([g.uniform(-0.5, 1.5, (3000, 2)), np.full(3000, 2.0)])
    d = np.column_stack([g.uniform(-0.8, 0.8, (3000, 2)), -np.ones(3000)])
    ref_t, ref_i, ref_h = raycast.ray_mesh_intersect(torch.as_tensor(o), torch.as_tensor(d),
                                                     torch.as_tensor(tri), max_dist=10.0)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        t, i, h = raycast.ray_mesh_intersect(
            torch.as_tensor(o, dtype=dtype, device=cuda_device),
            torch.as_tensor(d, dtype=dtype, device=cuda_device),
            torch.as_tensor(tri, dtype=dtype, device=cuda_device), max_dist=10.0)
        assert t.is_cuda and 0 < int(h.sum()) < 3000
        assert float((h.cpu() != ref_h).double().mean()) <= (0.0 if dtype == torch.float64
                                                             else 0.002)
        both = h.cpu() & ref_h
        torch.testing.assert_close(t.cpu().double()[both], ref_t[both], rtol=tol, atol=tol)
        if dtype == torch.float64:
            assert torch.equal(i.cpu(), ref_i)


@pytest.mark.cuda
def test_depth_calibration_on_the_card_follows_the_cpu(cuda_device):
    """Float depth_to_image and scale of the rig+depth scene in float32 on
    the card: the result is the float64 CPU result to float32 accuracy."""
    import dataclasses
    from multiview_tpu_torch.calib import calibrator as cal, problem as prob
    from multiview_tpu_torch.utils import synthetic as syn
    out = {}
    for dev, dtype in ((torch.device("cpu"), torch.float64), (cuda_device, torch.float32)):
        scene = syn.add_depth_observations(
            syn.make_rig_scene(n_ref=6, n_per_face=3, dtype=dtype, device=dev), sensors=(1,))
        st = scene.true_state
        bad = dataclasses.replace(
            st, depth_scale=st.depth_scale * torch.tensor([1.0, 0.97, 1.0], dtype=dtype,
                                                          device=dev))
        res = cal.optimize_rig(bad, scene.observations, scene.models,
                               prob.FloatSpec(depth_to_image=(1,), depth_scale=True),
                               prob.BAOptions(depth_tri_weight=100.0), num_passes=2,
                               num_iterations=30)
        assert res.state.device == st.device and "depth_tri_x_m" in res.stats_after
        out[dev.type] = res.state.depth_scale.cpu().double()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)
    assert abs(float(out["cuda"][1]) - 1.0) < 1e-3


def _terrain_pair(size=(160, 120), focal=140.0):
    """Two rendered views of the textured terrain 0.3 m apart, their
    intrinsics and the ref->neighbour pose."""
    import numpy as np
    from multiview_tpu_torch.geometry import pose as P
    from multiview_tpu_torch.geometry.camera import CameraParams
    from multiview_tpu_torch.utils import synthetic as syn
    cam = CameraParams.create(size, focal, (size[0] / 2.0, size[1] / 2.0), device="cpu")
    w2c = [syn.look_at_pose(np.array([x, 0.2, 2.0]), np.array([x + 0.15, 0.22, 1.0]))
           for x in (0.0, 0.3)]
    imgs = [syn.render_terrain(cam, w).astype(np.float64) for w in w2c]
    r2n = P.pose_compose(torch.as_tensor(w2c[1]), P.pose_inverse(torch.as_tensor(w2c[0])))
    return imgs, np.array([focal, focal]), np.array([size[0] / 2.0, size[1] / 2.0]), r2n.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("aggregate", ["none", "sgm"])
def test_plane_sweep_on_the_card_follows_the_cpu(cuda_device, aggregate):
    """float32 on the card against float64 on the CPU: the valid masks agree
    on all but a few pixels at the confidence threshold, the depths to
    float32 accuracy."""
    from multiview_tpu_torch.dense import stereo
    imgs, focal, center, r2n = _terrain_pair()
    out = {}
    for dev, dtype in ((torch.device("cpu"), torch.float64), (cuda_device, torch.float32)):
        a, b = (torch.as_tensor(i, dtype=dtype, device=dev) for i in imgs)
        res = stereo.plane_sweep(a, b, focal, center, r2n, 1.5, 3.0, num_planes=32,
                                 aggregate=aggregate)
        assert res.depth.device.type == dev.type
        out[dev.type] = [x.cpu() for x in res]
    v_gpu, v_cpu = out["cuda"][2], out["cpu"][2]
    assert int(v_cpu.sum()) > 0.3 * v_cpu.numel()
    assert float((v_gpu == v_cpu).double().mean()) > 0.99
    both = v_gpu & v_cpu
    rel = (out["cuda"][0].double() - out["cpu"][0]).abs()[both] / out["cpu"][0][both]
    assert float(rel.median()) < 1e-5


@pytest.mark.cuda
def test_knn_mean_distance_on_the_card_follows_the_cpu(cuda_device):
    import numpy as np
    from multiview_tpu_torch.dense import pc_filter
    g = np.random.default_rng(0)
    xy = g.uniform(-1.0, 1.0, (20000, 2))
    pts = np.column_stack([xy, 2.0 + 0.1 * np.sin(3 * xy[:, 0]) + g.normal(0, 0.002, 20000)])
    ref = pc_filter.knn_mean_distance(torch.as_tensor(pts), k=8)
    got = pc_filter.knn_mean_distance(torch.as_tensor(pts, dtype=torch.float32,
                                                      device=cuda_device), k=8)
    assert got.is_cuda
    torch.testing.assert_close(got.cpu().double(), ref, rtol=1e-3, atol=1e-6)
    keep_cpu = pc_filter.statistical_outlier_removal(pts, device="cpu")
    keep_gpu = pc_filter.statistical_outlier_removal(pts)          # the card by default
    assert (keep_cpu != keep_gpu).mean() < 1e-3


@pytest.mark.cuda
def test_fusion_and_mesh_on_the_card_follow_the_cpu(cuda_device):
    """A terrain cloud fused into a float64 grid on the card and on the CPU:
    the same grid to 1e-12 and the same faces, vertices to 1e-10."""
    import numpy as np
    from multiview_tpu_torch.dense import marching, stereo, tsdf
    from multiview_tpu_torch.geometry import pose as P
    imgs, focal, center, r2n = _terrain_pair()
    res = stereo.plane_sweep(*(torch.as_tensor(i) for i in imgs), focal, center, r2n, 1.5, 3.0,
                             num_planes=32)
    cloud = stereo.stereo_pair_to_cloud(res, focal, center)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        grid = tsdf.make_grid((60, 47, 27), (-0.9, -0.7, 1.6), 0.03, dtype=torch.float64,
                              device=dev)
        grid = tsdf.integrate_point_cloud(grid, torch.as_tensor(cloud, device=dev),
                                          P.pose_identity(), focal=(200.0, 200.0),
                                          image_size=(256, 192))
        out[dev.type] = (grid, marching.extract_mesh(grid))
    (gc, (vc, fc, ic)), (gg, (vg, fg, ig)) = out["cpu"], out["cuda"]
    torch.testing.assert_close(gg.tsdf.cpu(), gc.tsdf, rtol=0, atol=1e-12)
    assert len(fc) > 100 and np.array_equal(fg, fc)
    np.testing.assert_allclose(vg, vc, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ig, ic, rtol=0, atol=1e-10)


def _texture_on(dev, dtype):
    """A bumpy grid textured from three views on ``dev`` in ``dtype``: the
    view costs with both occlusion methods, the MRF labels, the rendered page
    and both seam leveling solves."""
    import numpy as np
    from multiview_tpu_torch.geometry.camera import CameraParams
    from multiview_tpu_torch.texture import texturing as TT
    from multiview_tpu_torch.utils import synthetic as syn
    verts, faces = syn.terrain_mesh(lo=(-1.0, -0.8), hi=(1.0, 0.8), step=0.1)
    poses = np.stack([syn.look_at_pose(np.array(p), np.zeros(3)) for p in
                      ((0.1, 0.05, 2.0), (0.9, 0.3, 1.6), (-0.8, -0.5, 1.8))])
    cam = CameraParams.create((160, 120), 150.0, (80.0, 60.0), (0.02, -0.01, 0.0, 0.0),
                              dtype=dtype, device=dev)
    yy, xx = np.mgrid[0:120, 0:160] / 30.0
    imgs = [np.stack([0.5 + 0.3 * np.sin(xx + k) * np.cos(yy - c) for c in range(3)], -1)
            .astype(np.float32) for k in range(3)]
    v = torch.as_tensor(verts, dtype=dtype, device=dev)
    f = torch.as_tensor(faces, device=dev).long()
    p = torch.as_tensor(poses, dtype=dtype, device=dev)
    usable = {m: TT.view_costs(v, f, p, occlusion_method=m)[1].cpu() for m in ("exact", "grid")}
    cost, ok = TT.view_costs(v, f, p)
    nbr = TT.face_neighbors(faces, TT.face_adjacency(faces))
    best, vis = TT.mrf_view_selection(cost, ok, nbr)
    best, vis = best.cpu().numpy(), vis.cpu().numpy()
    atlas = TT.build_atlas(verts, faces, pixel_size=0.02)
    adjacency = TT.face_adjacency(faces)
    face_col = np.random.default_rng(0).uniform(0.3, 0.7, (len(faces), 3)) + 0.1 * best[:, None]
    gains, info = TT.global_seam_leveling(face_col, best, adjacency, return_info=True,
                                          device=dev)
    vg = TT.vertex_gains_from_faces(len(verts), faces, gains)
    page = TT.render_atlas(atlas, verts, faces, best, vis, imgs, [cam] * 3, p, vertex_gain=vg)
    leveled = TT.local_seam_leveling(page, atlas, verts, faces, best, vis, adjacency, device=dev)
    return dict(usable=usable, best=best, vis=vis, gains=gains, info=info, page=page,
                leveled=leveled)


@pytest.mark.cuda
def test_texturing_on_the_card_follows_the_cpu(cuda_device):
    """Float32 on the card against float64 on the CPU: occlusion masks and
    labels agree on at least 99% of their entries, global gains to 1e-4 with
    sweep counts within one block, pages to 2e-3 where the labels agree."""
    import numpy as np
    gpu = _texture_on(cuda_device, torch.float32)
    cpu = _texture_on(torch.device("cpu"), torch.float64)
    for m in ("exact", "grid"):
        assert float((gpu["usable"][m] == cpu["usable"][m]).double().mean()) > 0.99, m
    assert (gpu["best"] == cpu["best"]).mean() > 0.99 and np.array_equal(gpu["vis"], cpu["vis"])
    assert abs(gpu["info"]["iterations"] - cpu["info"]["iterations"]) <= 64
    np.testing.assert_allclose(gpu["gains"], cpu["gains"], rtol=0, atol=1e-4)
    assert gpu["page"].shape == cpu["page"].shape and gpu["page"].max() > 0.5
    for key in ("page", "leveled"):
        diff = np.abs(gpu[key] - cpu[key])
        assert np.median(diff[cpu["page"] > 0]) < 2e-3, key


@pytest.mark.cuda
def test_sharded_solve_on_cuda_shards(cuda_device):
    """The Schur-LM with its observations sharded 4 ways on the card against
    the unsharded solve, float32: initial cost rtol 1e-6, final cost rtol
    1e-4, cameras atol 1e-3 (the cube's focal of 600 px has a float32 step of
    6e-5, and the poses float with a free gauge); the LM count equal."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.parallel import sharding as sh
    from multiview_tpu_torch.solver import schur
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=16, n_per_face=5, pix_noise=0.3,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), dtype=torch.float32,
                                device=cuda_device)
    state0 = syn.perturb_state(scene.true_state)
    mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                           include_points=False)
    solver = schur.make_schur_solver(state0, scene.observations, scene.models,
                                     prob.BAOptions(no_rig=True), mask, max_iterations=6,
                                     cg_iterations=30)
    cam0 = prob.pack_state(state0, include_points=False)
    ref = solver(cam0, state0.points)
    obs = sh.shard_observations(scene.observations, sh.make_mesh([cuda_device] * 4))
    assert all(s.pix.device == cuda_device for s in obs.pixels[0].shards)
    got = solver(cam0, state0.points, obs)
    assert got.iterations == ref.iterations and got.cam.device == cuda_device
    torch.testing.assert_close(got.initial_cost, ref.initial_cost, rtol=1e-6, atol=0)
    torch.testing.assert_close(got.cost, ref.cost, rtol=1e-4, atol=0)
    torch.testing.assert_close(got.cam, ref.cam, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_cg_stops_early_on_the_card(cuda_device, monkeypatch):
    """On cuda:0 CG stops at the reference's test. On one shard the test is
    taken on the device at every step of the one-launch solve: the matvecs
    run equal the CG count, far below the budget. On two logical shards (the
    per-step path, csrc/cg_step.cu after each matvec) the host reads the
    test every ``CG_CHECK_EVERY`` steps: the matvecs stay within one check
    interval of the CG count per LM iteration, and the masked loop run to
    the whole budget takes the same LM and CG counts to the same result
    (within float32 rounding: the kernels' atomics sum in no fixed order)."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.parallel import sharding as sh
    from multiview_tpu_torch.solver import schur
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=16, n_per_face=5, pix_noise=0.3,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), dtype=torch.float32,
                                device=cuda_device)
    state0 = syn.perturb_state(scene.true_state)
    mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                           include_points=False)
    cam0 = prob.pack_state(state0, include_points=False)
    sharded = sh.shard_observations(scene.observations, sh.make_mesh([cuda_device] * 2))

    def solve(obs=None):
        return schur.make_schur_solver(state0, scene.observations, scene.models,
                                       prob.BAOptions(no_rig=True), mask, max_iterations=6,
                                       cg_iterations=40, cg_tolerance=0.1)(cam0, state0.points,
                                                                           obs)

    res = solve()
    cg = int(res.cg_iters_total)
    assert res.matvecs == cg < 40 * res.iterations // 2
    assert float(res.cost) < float(res.initial_cost)

    split = solve(sharded)
    cg = int(split.cg_iters_total)
    assert cg <= split.matvecs <= cg + (schur.CG_CHECK_EVERY - 1) * split.iterations
    assert split.matvecs < 40 * split.iterations // 2
    assert float(split.cost) < float(split.initial_cost)
    monkeypatch.setattr(schur, "CG_CHECK_EVERY", 41)
    full = solve(sharded)
    assert full.matvecs == 40 * full.iterations and int(full.cg_iters_total) == cg
    assert full.iterations == split.iterations
    torch.testing.assert_close(full.cost, split.cost, rtol=1e-6, atol=0)
    torch.testing.assert_close(full.cam, split.cam, rtol=0, atol=1e-4)


# ----------------------------------------------------------------------------
# The Schur complement matvec (csrc/schur_mv.cu) against its plain version on
# the card: |kernel - plain| <= tol * max |plain| with tol 1e-4 in float32 and
# 1e-10 in float64 (atomics and the plain path sum in different orders)
# ----------------------------------------------------------------------------

_SCHUR_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _schur_system(dev, dtype, families, order, num_ref=40, num_points=300, shards=1, seed=0):
    """A random SchurSystem: ``families`` as (rows, k, B, with point block),
    rows grouped by pose ("grouped": sorted, runs of rows on one pose), in the
    cube's frame-major order ("frame": sorted, begin and end pose one pose),
    in calibrate's track-major order ("track": sorted by point) or in random
    order ("unsorted"); every family's constant columns lie after the poses,
    the depth families' shared with the one before."""
    import types
    import numpy as np
    from multiview_tpu_torch.parallel import sharding as sh
    from multiview_tpu_torch.solver import schur_matvec as smv

    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)    # noqa: E731
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)    # noqa: E731
    next_col, prev = num_ref * 7, None
    fams, jc, jp = [[] for _ in range(shards)], [[] for _ in range(shards)], \
        [[] for _ in range(shards)]
    for n, k, B, with_pt in families:
        nc = B - 14
        if prev is not None and prev == (k, nc):
            cols = fams[0][-1].const_cols.cpu().numpy()
        else:
            cols = next_col + g.permutation(nc)
            next_col += nc
        prev = (k, nc)
        beg = g.integers(0, num_ref, n)
        if order in ("grouped", "frame"):
            beg = np.sort(beg)
        end = beg if order == "frame" else np.minimum(beg + g.integers(0, 2, n), num_ref - 1)
        pidx = g.integers(0, num_points, n)
        if order == "track":
            pidx = np.sort(pidx)
        a = g.normal(size=(n, k, B))
        b = g.normal(size=(n, k, 3)) if with_pt else None
        for s, rows in enumerate(np.array_split(np.arange(n), shards)):
            fams[s].append(types.SimpleNamespace(
                beg_idx=i(beg[rows]), end_idx=i(end[rows]), const_cols=i(cols),
                point_idx=i(pidx[rows]) if with_pt else None))
            jc[s].append(t(a[rows]))
            jp[s].append(t(b[rows]) if with_pt else None)
    # an xyz prior: point blocks only
    for s in range(shards):
        fams[s].append(types.SimpleNamespace(beg_idx=None, end_idx=None, const_cols=None,
                                             point_idx=i(g.integers(0, num_points, 7))))
        jc[s].append(None)
        jp[s].append(t(g.normal(size=(7, 3, 3))))
    C = next_col + 5
    m = g.normal(size=(num_points, 3, 3))
    hpp = m @ m.transpose(0, 2, 1) + 3 * np.eye(3)
    cam_free = (g.uniform(size=C) > 0.1).astype(float)
    mesh = sh.make_mesh([dev] * shards)
    system = smv.SchurSystem(mesh, fams, list(zip(jc, jp)), t(cam_free),
                             t(g.uniform(0.5, 2.0, C) * cam_free + (1 - cam_free)),
                             t(np.linalg.inv(hpp)), num_ref)
    return system, t(g.normal(size=C))


def _schur_close(got, ref, dtype):
    err = float((got - ref).abs().max())
    assert err <= _SCHUR_TOL[dtype] * float(ref.abs().max()), err


_SCHUR_CASES = {
    "k2_B29": [(3000, 2, 29, True)],
    "k3_B30_no_point_block": [(2000, 3, 30, False)],
    "k3_B35_affine": [(1500, 3, 35, True)],
    "rig_families": [(2000, 2, 25, True), (1800, 2, 29, True), (0, 2, 30, True),
                     (900, 3, 30, True), (700, 3, 30, False)],
}


def _schur_all_close(smv, system, x, dtype, launches=1):
    """S x (``launches`` launches), the right-hand side and the
    back-substitution's products (one launch a shard each) against the plain
    version; returns the matvec's launch record."""
    shards = system.mesh.size
    before = smv.LAUNCHES
    smv.RECORD_LAUNCH = True
    try:
        got = smv.schur_matvec(system, x)
        torch.cuda.synchronize()
        record = dict(smv.LAST_LAUNCH)
    finally:
        smv.RECORD_LAUNCH = False
    assert smv.LAUNCHES == before + launches
    _schur_close(got, smv.schur_matvec_plain(system, x), dtype)
    g_c = torch.randn_like(x)
    g_p = torch.randn((system.num_points, 3), dtype=dtype, device=x.device)
    before = smv.LAUNCHES
    _schur_close(smv.schur_rhs(system, g_c, g_p), smv.schur_rhs_plain(system, g_c, g_p), dtype)
    u, jtp_u = smv.row_products(system, x)
    assert smv.LAUNCHES == before + 2 * shards
    u_ref, jtp_ref = smv.row_products_plain(system, x)
    _schur_close(torch.cat(u), torch.cat(u_ref), dtype)
    _schur_close(jtp_u, jtp_ref, dtype)
    return record


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["grouped", "unsorted", "frame", "track"])
@pytest.mark.parametrize("case", list(_SCHUR_CASES))
def test_schur_matvec_kernel_matches_plain_version(cuda_device, case, order, dtype):
    """One launch a matvec on one shard (point pass, grid barrier, camera
    pass), every row of these systems kept in shared memory between the
    passes, the pose columns summed in shared memory."""
    from multiview_tpu_torch.solver import schur_matvec as smv
    system, x = _schur_system(cuda_device, dtype, _SCHUR_CASES[case], order)
    record = _schur_all_close(smv, system, x, dtype)
    rows = sum(a.shape[0] for a in system.J[0][0] if a is not None)
    assert record["passes"] == 3 and record["resident_rows"] == rows
    assert record["window_poses"] == system.num_ref and record["x_in_shared"] == 1
    assert record["pose_copies"] == 8               # 40 poses: a copy a warp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["grouped", "unsorted"])
def test_schur_matvec_kernel_with_poses_beyond_its_shared_window(cuda_device, order, dtype):
    """8000 poses: more pose columns than a block sums in shared memory (and
    x * cam_free too long to keep there), so the poses outside a block's
    window take global atomics."""
    from multiview_tpu_torch.solver import schur_matvec as smv
    system, x = _schur_system(cuda_device, dtype, [(20000, 2, 29, True), (5000, 3, 30, True)],
                              order, num_ref=8000, num_points=3000)
    record = _schur_all_close(smv, system, x, dtype)
    assert record["window_poses"] < system.num_ref and record["x_in_shared"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["frame", "unsorted"])
def test_schur_matvec_kernel_rereads_what_shared_memory_cannot_hold(cuda_device, order, dtype):
    """More rows than the grid's shared memory holds between the passes:
    the camera pass rereads the others, in reverse order."""
    from multiview_tpu_torch.solver import schur_matvec as smv
    rows = 200000 if dtype == torch.float32 else 120000
    system, x = _schur_system(cuda_device, dtype, [(rows, 2, 29, True), (3000, 3, 30, False)],
                              order, num_ref=160, num_points=2400)
    record = _schur_all_close(smv, system, x, dtype)
    assert 0 < record["resident_rows"] < rows
    assert record["pose_copies"] == 1               # 160 poses: one copy a block


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_matvec_kernel_on_logical_shards(cuda_device, dtype):
    """Two shards on one card: a point-pass launch and a camera-pass launch a
    shard, the sums over the mesh between and after them."""
    from multiview_tpu_torch.solver import schur_matvec as smv
    system, x = _schur_system(cuda_device, dtype, _SCHUR_CASES["rig_families"], "unsorted",
                              shards=2)
    record = _schur_all_close(smv, system, x, dtype, launches=4)
    assert record["passes"] == 2


@pytest.mark.cuda
def test_schur_matvec_kernel_refuses_what_it_does_not_take(cuda_device):
    """A non-contiguous block, another dtype, a CPU index: raised, never
    computed another way."""
    import dataclasses
    from multiview_tpu_torch.solver import schur_matvec as smv
    system, x = _schur_system(cuda_device, torch.float32, _SCHUR_CASES["k2_B29"], "grouped")
    jc, jp = system.J[0]
    wide = torch.cat([jc[0], jc[0]], dim=2)[:, :, :29]       # the same values, strided
    assert not wide.is_contiguous()
    bad = dataclasses.replace(system, J=[([wide] + list(jc[1:]), jp)], _plans=None)
    with pytest.raises(ValueError, match="not contiguous"):
        smv.schur_matvec(bad, x)
    with pytest.raises(TypeError):
        smv.schur_matvec(dataclasses.replace(system, _plans=None), x.double())
    f = system.shards[0][0]
    moved = dataclasses.replace(system, shards=[[type(f)(**{**vars(f), "beg_idx":
                                                            f.beg_idx.cpu()})]
                                                + list(system.shards[0][1:])], _plans=None)
    with pytest.raises(ValueError):
        smv.schur_matvec(moved, x)


@pytest.mark.cuda
def test_cg_blocks_runs_the_schur_kernel_for_every_matvec(cuda_device):
    """A solve on the card: every LM iteration's CG, its right-hand side and
    back-substitution are one launch of csrc/schur_mv.cu's cg_solve_kernel,
    whose matvecs are its CG steps; no launch of the matvec alone or of
    csrc/cg_step.cu."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import cg, cg_solve, schur, schur_matvec as smv
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=12, n_per_face=4, pix_noise=0.3, dtype=torch.float32,
                                device=cuda_device)
    state0 = syn.perturb_state(scene.true_state)
    mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                           include_points=False)
    before = (smv.LAUNCHES, cg.LAUNCHES, cg_solve.LAUNCHES)
    res = schur.make_schur_solver(state0, scene.observations, scene.models,
                                  prob.BAOptions(no_rig=True), mask, max_iterations=6,
                                  cg_iterations=40, cg_tolerance=0.1)(
        prob.pack_state(state0, include_points=False), state0.points)
    torch.cuda.synchronize()
    after = (smv.LAUNCHES, cg.LAUNCHES, cg_solve.LAUNCHES)
    assert tuple(b - a for a, b in zip(before, after)) == (0, 0, res.iterations)
    assert 0 < res.matvecs == int(res.cg_iters_total)
    assert float(res.cost) < float(res.initial_cost)


# ----------------------------------------------------------------------------
# The per-row residuals and block Jacobians (csrc/row_blocks.cu) against their
# plain version in float64 on the same inputs, on the card: |kernel - plain| <=
# tol * max |plain| for each output (J_cam, J_pt, res), tol 1e-9 with float64
# tensors and 1e-4 with float32 ones (the kernel computes in float64 and
# rounds its outputs; forward mode against reverse mode)
# ----------------------------------------------------------------------------

_ROW_TOL = {torch.float32: 1e-4, torch.float64: 1e-9}


def _row_families():
    from multiview_tpu_torch.solver import row_blocks as rb
    kernel = {"pixel": rb.pixel_row_blocks, "depth": rb.depth_row_blocks,
              "prior": rb.prior_row_blocks}
    plain = {"pixel": rb.pixel_row_blocks_plain, "depth": rb.depth_row_blocks_plain,
             "prior": rb.prior_row_blocks_plain}
    return rb, kernel, plain


def _rows_close(label, got, ref, dtype):
    for name, g, r in zip(("J_cam", "J_pt", "res"), got, ref):
        assert (g is None) == (r is None), (label, name)
        if r is None:
            continue
        assert g.shape == r.shape and torch.isfinite(g).all(), (label, name)
        err = float((g - r).abs().max())
        assert err <= _ROW_TOL[dtype] * float(r.abs().max()), (label, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_blocks_kernel_matches_plain_version_on_the_planted_rows(cuda_device, dtype):
    """Every family, distortion model and branch of tests/row_block_scenes.py,
    one launch a family."""
    from row_block_scenes import planted_rows, row_blocks_of
    rb, kernel, plain = _row_families()
    for name, case in planted_rows(0, dtype, cuda_device).items():
        before = rb.LAUNCHES
        got = row_blocks_of(case, kernel)
        torch.cuda.synchronize()
        assert rb.LAUNCHES == before + 1, name
        _rows_close(name, got, row_blocks_of(case, plain, float64=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_blocks_kernel_matches_plain_version_on_a_cube(cuda_device, dtype):
    """The benchmark's scene at 4320 rows (tsai, dt_bracket 0 in every row)."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.utils import synthetic as syn
    from row_block_scenes import in_float64
    rb, kernel, plain = _row_families()
    scene = syn.make_cube_scene(n_images=20, n_per_face=6, pix_noise=0.5,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), dtype=dtype,
                                device=cuda_device)
    st = syn.perturb_state(scene.true_state, pose_rot=0.01, pose_trans=0.02, point_sigma=0.02)
    obs, model = scene.observations.pixels[0], scene.models[0]
    assert len(obs) == 4320
    opts = prob.BAOptions(no_rig=True)
    got = kernel["pixel"](st, obs, model, opts)
    torch.cuda.synchronize()
    _rows_close("cube", got, plain["pixel"](*in_float64((st, obs, model, opts))), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree", [2, 8])
def test_row_blocks_kernel_matches_plain_version_on_a_cube_with_rpc(cuda_device, degree, dtype):
    """The cube's rows through an rpc of degree 2 and of degree 8 (B = 381:
    in float64 the largest tile a block stages, 32 rows)."""
    import dataclasses
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.utils import synthetic as syn
    from row_block_scenes import in_float64, rpc_coeffs
    rb, kernel, plain = _row_families()
    scene = syn.make_cube_scene(n_images=20, n_per_face=6, pix_noise=0.5,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), dtype=dtype,
                                device=cuda_device)
    st = syn.perturb_state(scene.true_state, pose_rot=0.01, pose_trans=0.02, point_sigma=0.02)
    obs = scene.observations.pixels[0]
    dist = list(st.dist)
    dist[obs.sensor] = torch.tensor(rpc_coeffs(degree), dtype=dtype, device=cuda_device)
    st = dataclasses.replace(st, dist=tuple(dist))
    opts = prob.BAOptions(no_rig=True)
    before = rb.LAUNCHES
    got = kernel["pixel"](st, obs, "rpc", opts)
    torch.cuda.synchronize()
    assert rb.LAUNCHES == before + 1 and got[0].shape[2] == 25 + len(rpc_coeffs(degree))
    _rows_close(f"cube rpc {degree}", got, plain["pixel"](*in_float64((st, obs, "rpc", opts))),
                dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_blocks_kernel_matches_plain_version_on_every_family(cuda_device, dtype):
    """The rig of tests/test_torch_schur_matvec.py at the default rig
    perturbation (0.02 rad / 3 cm), where the first LM steps are rejected:
    three pixel sensors (none, tsai, fov), depth against the point and the
    mesh (with misses), the xyz prior."""
    from multiview_tpu_torch.calib import problem as prob
    from row_block_scenes import every_family_scene, in_float64
    rb, kernel, plain = _row_families()
    state0, obs, models, opts, _ = every_family_scene(dtype, cuda_device)
    calls = ([("pixel", (state0, o, models[o.sensor], opts)) for o in obs.pixels]
             + [("depth", (state0, o, opts, mesh)) for o, mesh in prob.depth_families(obs, opts)]
             + [("prior", (state0, p, w, th)) for p, w, th in prob.static_priors(obs, opts)])
    for kind, args in calls:
        got, ref = kernel[kind](*args), plain[kind](*in_float64(args))
        if kind == "prior":
            got, ref = (None,) + tuple(got), (None,) + tuple(ref)
        _rows_close(f"{kind} sensor {getattr(args[1], 'sensor', None)}", got, ref, dtype)


@pytest.mark.cuda
def test_cg_blocks_solve_on_the_card_follows_the_cpu(cuda_device, monkeypatch):
    """One ``cg_blocks`` solve of every family in float32 on the card, its
    row blocks from csrc/row_blocks.cu alone (one launch a family at the
    start and at each LM iteration's trial point; no autograd pass), against
    the float64 solve on the CPU, to the tolerances of
    test_depth_calibration_on_the_card_follows_the_cpu: both run to the
    minimum (20 LM iterations; the two paths round apart on the way), and
    the camera vectors compare with every quaternion normalised (its stored
    norm is free: the residuals read it through ``pose_q``)."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.geometry import pose as P
    from multiview_tpu_torch.solver import schur
    from row_block_scenes import every_family_scene
    rb, _, _ = _row_families()

    def canonical(cam, template):
        st = prob.unpack_state(cam.cpu().double(), template, include_points=False)
        poses = [torch.cat([x[:, :3], P.quat_normalize(x[:, 3:7]), x[:, 7:]], dim=1).reshape(-1)
                 for x in (st.world_to_ref, st.ref_to_cam, st.depth_to_image)]
        return torch.cat(poses + [st.timestamp_offsets, st.focal, st.optical_center.reshape(-1),
                                  st.depth_scale, *st.dist])

    out = {}
    for dev, dtype in ((torch.device("cpu"), torch.float64), (cuda_device, torch.float32)):
        state0, obs, models, opts, mask = every_family_scene(dtype, dev, rig_rot=0.002,
                                                             rig_trans=0.003)
        if dev.type == "cuda":
            monkeypatch.setattr(rb, "_row_jacobians",
                                lambda *a: pytest.fail("an autograd pass ran on the card"))
        before = rb.LAUNCHES
        res = schur.make_schur_solver(state0, obs, models, opts, mask, max_iterations=20,
                                      cg_iterations=40)(
            prob.pack_state(state0, include_points=False), state0.points)
        families = len(obs.pixels) + len(prob.depth_families(obs, opts)) + len(
            prob.static_priors(obs, opts))
        assert rb.LAUNCHES - before == (families * (1 + res.iterations)
                                        if dev.type == "cuda" else 0)
        assert float(res.cost) < float(res.initial_cost)
        out[dev.type] = (res, canonical(res.cam, state0))
    (cpu, cpu_cam), (card, card_cam) = out["cpu"], out["cuda"]
    torch.testing.assert_close(card.cost.cpu().double(), cpu.cost, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(card_cam, cpu_cam, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------------
# The assembly (csrc/lm_assembly.cu) and the CG step (csrc/cg_step.cu) against
# their plain versions in float64 on the same inputs, on the card: |kernel -
# plain| <= tol * max |plain| for each output, tol 1e-4 with float32 tensors
# and 1e-10 with float64 ones (the kernels compute in float64 and round their
# outputs; atomics and the plain path sum in different orders)
# ----------------------------------------------------------------------------


def _in64(x):
    """Tensors (in lists, tuples, NamedTuples) in float64; the rest as it is."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_in64(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_in64(v) for v in x)
    return x


def _assembly_inputs(system, seed=1, lam=1e-3):
    """(mesh, shards, J, r, cam_free, lam, num_ref, num_points) of a
    ``_schur_system``: residuals drawn per shard."""
    g = torch.Generator(device=system.cam_free.device).manual_seed(seed)
    r = []
    for jc, jp in system.J:
        n = sum((b if a is None else a).shape[0] * (b if a is None else a).shape[1]
                for a, b in zip(jc, jp))
        r.append(torch.randn(n, generator=g, dtype=system.cam_free.dtype,
                             device=system.cam_free.device))
    lam = torch.tensor(lam, dtype=system.cam_free.dtype, device=system.cam_free.device)
    return (system.mesh, system.shards, system.J, r, system.cam_free, lam, system.num_ref,
            system.num_points)


def _assembly_close(got, ref, dtype, label=""):
    for name, g, r in zip(got._fields, got, ref):
        assert (g is None) == (r is None), (label, name)
        if r is None:
            continue
        assert g.shape == r.shape and g.dtype == dtype and torch.isfinite(g).all(), (label, name)
        err = float((g.double() - r).abs().max())
        assert err <= _SCHUR_TOL[dtype] * float(r.abs().max()), (label, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block_precond", [False, True])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("order", ["frame", "track", "unsorted"])
def test_assembly_kernel_matches_plain_version(cuda_device, order, shards, block_precond, dtype):
    """Every output (g_c, g_p, Hpp, the Jacobi diagonal, pt_diag, Hpp^-1, dc,
    the preconditioner, the 7x7 inverses): one launch on one shard; a rows
    and a blocks launch a shard, a points and a poses launch with two."""
    from multiview_tpu_torch.solver import assembly as asm
    system, _ = _schur_system(cuda_device, dtype, _SCHUR_CASES["rig_families"], order,
                              shards=shards)
    args = _assembly_inputs(system)
    flag = asm.new_flag(cuda_device)
    before = asm.LAUNCHES
    got = asm.assemble(*args, block_precond, flag)
    torch.cuda.synchronize()
    launches = 1 if shards == 1 else (shards + 1) * (2 if block_precond else 1)
    assert asm.LAUNCHES == before + launches and int(flag) == 0
    _assembly_close(got, asm.assemble_plain(*_in64(args), block_precond), dtype)
    # without the residuals: no gradient, the rest the same
    nograd = asm.assemble_cuda(*args[:3], None, *args[4:], block_precond)
    assert nograd.g_c is None and nograd.g_p is None
    _assembly_close(nograd, asm.assemble_plain(*_in64(args[:3]), None, *_in64(args[4:]),
                                               block_precond), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_assembly_kernel_with_a_frozen_pose_and_many_poses(cuda_device, dtype):
    """A frozen pose (its 7x7 block is diag(dc) = I), then 8000 poses: more
    than the warps' window of poses in shared memory holds, so the sums of
    the poses outside it take global atomics."""
    import dataclasses
    from multiview_tpu_torch.solver import assembly as asm
    system, _ = _schur_system(cuda_device, dtype, _SCHUR_CASES["rig_families"], "track")
    cam_free = system.cam_free.clone()
    cam_free[7 * 3:7 * 4] = 0.0
    args = _assembly_inputs(dataclasses.replace(system, cam_free=cam_free))
    asm.RECORD_LAUNCH = True
    try:
        got = asm.assemble(*args, True)
        torch.cuda.synchronize()
        record = dict(asm.LAST_LAUNCH)
    finally:
        asm.RECORD_LAUNCH = False
    assert record["window_poses"] == 32 < system.num_ref       # the window's 32 of 40 poses
    torch.testing.assert_close(got.pose_inv[3].double(), torch.eye(7, dtype=torch.float64,
                                                                   device=cuda_device))
    _assembly_close(got, asm.assemble_plain(*_in64(args), True), dtype)
    system, _ = _schur_system(cuda_device, dtype, [(20000, 2, 29, True), (5000, 3, 30, True)],
                              "unsorted", num_ref=8000, num_points=3000)
    args = _assembly_inputs(system)
    asm.RECORD_LAUNCH = True
    try:
        got = asm.assemble(*args, True)
        torch.cuda.synchronize()
        record = dict(asm.LAST_LAUNCH)
    finally:
        asm.RECORD_LAUNCH = False
    assert record["window_poses"] < system.num_ref
    _assembly_close(got, asm.assemble_plain(*_in64(args), True), dtype)


@pytest.mark.cuda
def test_assembly_kernel_flags_a_singular_block_and_refuses_what_it_does_not_take(cuda_device):
    """lam = 0 and a free pose no row touches: its 7x7 block is 0. The plain
    version's torch.linalg.inv raises; the kernel sets the flag, and the LM
    loop's stop test raises on it. A CPU residual, another dtype: raised."""
    import dataclasses
    from multiview_tpu_torch.solver import assembly as asm
    system, _ = _schur_system(cuda_device, torch.float64, _SCHUR_CASES["rig_families"],
                              "unsorted")
    fams = [f if f.beg_idx is None else
            type(f)(**{**vars(f), "beg_idx": f.beg_idx.clamp_min(1),
                       "end_idx": f.end_idx.clamp_min(1)})
            for f in system.shards[0]]
    cam_free = system.cam_free.clone()
    cam_free[:7] = 1.0
    system = dataclasses.replace(system, shards=[fams], cam_free=cam_free)
    args = list(_assembly_inputs(system, lam=0.0))
    with pytest.raises(torch.linalg.LinAlgError):
        asm.assemble_plain(*args, True)
    flag = asm.new_flag(cuda_device)
    asm.assemble(*args, True, flag)
    done = torch.zeros((), dtype=torch.bool, device=cuda_device)
    assert int(flag) == 1
    with pytest.raises(torch.linalg.LinAlgError):
        asm.stop_test(done, flag)
    assert asm.stop_test(done | True, asm.new_flag(cuda_device)) is True
    bad = list(args)
    bad[3] = [args[3][0].cpu()]
    with pytest.raises(ValueError):
        asm.assemble_cuda(*bad, False)
    with pytest.raises(TypeError):
        asm.assemble_cuda(*args[:4], args[4].float(), *args[5:], False)


def _cg_problem(dev, dtype, n_poses=12, n_rest=40, seed=0):
    """A random SPD system S [C, C] (C = 7 n_poses + n_rest), its right-hand
    side, and both preconditioners from its diagonal and 7x7 blocks."""
    import numpy as np
    from multiview_tpu_torch.solver import cg
    g = np.random.default_rng(seed)
    C = 7 * n_poses + n_rest
    a = g.normal(size=(C, C)) / np.sqrt(C)
    S = a @ a.T + np.diag(g.uniform(0.5, 2.0, C))
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)    # noqa: E731
    blocks = np.stack([np.linalg.inv(S[7 * i:7 * i + 7, 7 * i:7 * i + 7])
                       for i in range(n_poses)])
    precond = 1.0 / np.diag(S)
    return (t(S), t(g.normal(size=C)), cg.Preconditioner(t(precond)),
            cg.Preconditioner(t(precond), t(blocks)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["jacobi", "schur_jacobi"])
def test_cg_step_kernel_matches_the_plain_loop(cuda_device, which, dtype):
    """30 forced steps (10 in float32, where the lost orthogonality of CG
    itself grows past 1e-4 of max |x|) and a solve to 1e-6 with the stop test
    read every 2 steps: one start launch and one launch a step; the same x
    and CG count as the plain loop in float64."""
    from multiview_tpu_torch.solver import cg
    S, rhs, jac, blk = _cg_problem(cuda_device, dtype)
    M = jac if which == "jacobi" else blk
    S64, rhs64, M64 = S.double(), rhs.double(), _in64(M)
    forced = 10 if dtype == torch.float32 else 30
    before = cg.LAUNCHES
    x, k = cg.pcg(lambda v: S @ v, M, rhs, 60, 1e-8, 2, force=forced)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 1 + forced and int(k) == forced
    ref, _ = cg.pcg_plain(lambda v: S64 @ v, M64, rhs64, 60, 1e-8, 2, force=forced)
    _schur_close(x.double(), ref, dtype)
    steps = []
    before = cg.LAUNCHES
    x, k = cg.pcg(lambda v: steps.append(1) or S @ v, M, rhs, 200, 1e-3, 2)
    ref, k_ref = cg.pcg_plain(lambda v: S64 @ v, M64, rhs64, 200, 1e-3, 2)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 1 + len(steps)
    assert int(k) == int(k_ref) and int(k) <= len(steps) <= int(k) + 1 < 200
    _schur_close(x.double(), ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_step_kernel_on_a_schur_system(cuda_device, dtype):
    """The CG of a ``_schur_system`` with its assembly: the kernels' matvec
    and steps against the plain matvec and loop in float64, 10 forced steps,
    SCHUR_JACOBI; the kernel's bits the same in two runs (its dots take a
    fixed order)."""
    from multiview_tpu_torch.solver import assembly as asm, cg, schur_matvec as smv
    system, _ = _schur_system(cuda_device, dtype, _SCHUR_CASES["rig_families"], "track")
    args = _assembly_inputs(system)
    a = asm.assemble(*args, True)
    sys_k = smv.SchurSystem(system.mesh, system.shards, system.J, system.cam_free, a.dc,
                            a.hpp_inv, system.num_ref)
    sys_p = smv.SchurSystem(system.mesh, system.shards, _in64(system.J),
                            system.cam_free.double(), a.dc.double(), a.hpp_inv.double(),
                            system.num_ref)
    M = cg.Preconditioner(a.precond, a.pose_inv)
    rhs = smv.schur_rhs(sys_k, a.g_c, a.g_p)
    x, _ = cg.pcg_cuda(lambda v: smv.schur_matvec(sys_k, v), M, rhs, 10, 1e-8, 2, force=10)
    ref, _ = cg.pcg_plain(lambda v: smv.schur_matvec_plain(sys_p, v), _in64(M), rhs.double(),
                          10, 1e-8, 2, force=10)
    _schur_close(x.double(), ref, dtype)
    # the same inputs, the same bits: the CG's matvec held fixed
    Ap = smv.schur_matvec_plain(sys_k, rhs)
    runs = []
    for _ in range(2):
        state = cg.CudaCG(M, rhs, 1e-8)
        state.start()
        for _ in range(5):
            state.step(Ap, forced=True)
        runs.append((state.x.clone(), state.p.clone(), state.state.clone()))
    assert all(torch.equal(u, v) for u, v in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cg_blocks", "cg", "cg_dense_j", "dense_schur"])
def test_every_mode_runs_the_assembly_and_cg_kernels(cuda_device, mode):
    """A solve on the card: one assembly launch an LM iteration (one shard);
    in cg_blocks one CG solve launch an LM iteration and no CG step launch;
    in cg and cg_dense_j one CG start an LM iteration and one CG launch a
    matvec; none in dense_schur. SCHUR_JACOBI at cg_tolerance 1e-3."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import assembly as asm, cg, cg_solve, schur
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=12, n_per_face=4, pix_noise=0.3, dtype=torch.float32,
                                device=cuda_device)
    state0 = syn.perturb_state(scene.true_state)
    mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                           include_points=False)
    before = (asm.LAUNCHES, cg.LAUNCHES, cg_solve.LAUNCHES)
    res = schur.make_schur_solver(state0, scene.observations, scene.models,
                                  prob.BAOptions(no_rig=True), mask, max_iterations=6,
                                  cg_iterations=40, cg_tolerance=1e-3, linear_solver=mode)(
        prob.pack_state(state0, include_points=False), state0.points)
    torch.cuda.synchronize()
    assert asm.LAUNCHES - before[0] == res.iterations
    cg_launches = 0 if mode in ("dense_schur", "cg_blocks") else res.matvecs + res.iterations
    assert cg.LAUNCHES - before[1] == cg_launches
    assert cg_solve.LAUNCHES - before[2] == (res.iterations if mode == "cg_blocks" else 0)
    assert float(res.cost) < float(res.initial_cost)


# ----------------------------------------------------------------------------
# The one-launch CG solve (cg_solve_kernel of csrc/schur_mv.cu) against the
# plain solve in float64 on the same inputs, the assembly's plan and its warp
# inversion of the 7x7 blocks
# ----------------------------------------------------------------------------


def _cg_solve_inputs(dev, dtype, block_precond, order="track"):
    """(kernel system, float64 system, gradient, float64 gradient, M, float64
    M) of a ``_schur_system`` with its assembly."""
    from multiview_tpu_torch.solver import assembly as asm, cg, schur_matvec as smv
    system, _ = _schur_system(dev, dtype, _SCHUR_CASES["rig_families"], order)
    a = asm.assemble(*_assembly_inputs(system), block_precond)
    sys_k = smv.SchurSystem(system.mesh, system.shards, system.J, system.cam_free, a.dc,
                            a.hpp_inv, system.num_ref)
    sys_p = smv.SchurSystem(system.mesh, system.shards, _in64(system.J),
                            system.cam_free.double(), a.dc.double(), a.hpp_inv.double(),
                            system.num_ref)
    M = cg.Preconditioner(a.precond, a.pose_inv)
    return sys_k, sys_p, (a.g_c, a.g_p), (a.g_c.double(), a.g_p.double()), M, _in64(M)


def _rel(got, ref):
    return float((got.double() - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block_precond", [False, True])
def test_cg_solve_kernel_matches_the_plain_solve(cuda_device, block_precond, dtype):
    """One launch a solve (no matvec or CG step launch of its own): 10
    forced steps, x, u and J_p^T u within the Schur bars of the plain solve
    in float64; the early-stopped count equal to the plain float64 loop's;
    in float32, 30 forced steps within twice the plain float32 solve's own
    drift (CG amplifies rounding; chip_smoke.py phase 3f's bar)."""
    from multiview_tpu_torch.solver import cg, cg_solve, schur_matvec as smv
    sys_k, sys_p, grad, grad64, M, M64 = _cg_solve_inputs(cuda_device, dtype, block_precond)
    before = (cg_solve.LAUNCHES, smv.LAUNCHES, cg.LAUNCHES)
    got = cg_solve.solve_cuda(sys_k, *grad, M, 60, 1e-8, force=10)
    torch.cuda.synchronize()
    after = (cg_solve.LAUNCHES, smv.LAUNCHES, cg.LAUNCHES)
    assert tuple(b - a for a, b in zip(before, after)) == (1, 0, 0) and int(got.count) == 10
    ref = cg_solve.solve_plain(sys_p, *grad64, M64, 60, 1e-8, 1, force=10)
    _schur_close(got.x.double(), ref.x, dtype)
    _schur_close(torch.cat(got.u).double(), torch.cat(ref.u), dtype)
    _schur_close(got.jtp_u.double(), ref.jtp_u, dtype)
    for tol in (1e-2, 1e-4):
        k = int(cg_solve.solve_cuda(sys_k, *grad, M, 200, tol).count)
        k_ref = int(cg_solve.solve_plain(sys_p, *grad64, M64, 200, tol, 1).count)
        assert k == k_ref < 200, tol
    assert int(cg_solve.solve_cuda(sys_k, *grad, M, 0, 1e-8).count) == 0
    if dtype == torch.float32:
        x = cg_solve.solve_cuda(sys_k, *grad, M, 60, 1e-8, force=30).x
        ref30 = cg_solve.solve_plain(sys_p, *grad64, M64, 60, 1e-8, 1, force=30).x
        own = _rel(cg_solve.solve_plain(sys_k, *grad, M, 60, 1e-8, 1, force=30).x, ref30)
        assert _rel(x, ref30) <= max(1e-4, 2.0 * own)


@pytest.mark.cuda
def test_cg_solve_kernel_rereads_what_shared_memory_cannot_hold(cuda_device):
    """More rows than the grid's shared memory holds, 160 poses: the passes
    reread the rows that did not stay, and report the bytes a step reads."""
    from multiview_tpu_torch.solver import assembly as asm, cg, cg_solve, schur_matvec as smv
    system, _ = _schur_system(cuda_device, torch.float64, [(120000, 2, 29, True)], "frame",
                              num_ref=160, num_points=2400)
    a = asm.assemble(*_assembly_inputs(system), False)
    sys_k = smv.SchurSystem(system.mesh, system.shards, system.J, system.cam_free, a.dc,
                            a.hpp_inv, system.num_ref)
    M = cg.Preconditioner(a.precond)
    cg_solve.RECORD_LAUNCH = True
    try:
        got = cg_solve.solve_cuda(sys_k, a.g_c, a.g_p, M, 60, 1e-8, force=6)
        torch.cuda.synchronize()
        record = dict(cg_solve.LAST_LAUNCH)
    finally:
        cg_solve.RECORD_LAUNCH = False
    assert 0 < record["resident_rows"] < 120000 and record["row_bytes_a_step"] > 0
    ref = cg_solve.solve_plain(sys_k, a.g_c, a.g_p, M, 60, 1e-8, 1, force=6)
    _schur_close(got.x, ref.x, torch.float64)
    _schur_close(got.jtp_u, ref.jtp_u, torch.float64)


@pytest.mark.cuda
def test_cg_solve_kernel_refuses_what_it_does_not_take(cuda_device):
    """Two shards, a gradient of another dtype or on the CPU: raised."""
    from multiview_tpu_torch.solver import cg_solve
    sys_k, _, (g_c, g_p), _, M, _ = _cg_solve_inputs(cuda_device, torch.float32, True)
    with pytest.raises(TypeError):
        cg_solve.solve_cuda(sys_k, g_c.double(), g_p, M, 10, 1e-8)
    with pytest.raises(ValueError):
        cg_solve.solve_cuda(sys_k, g_c.cpu(), g_p, M, 10, 1e-8)
    two, _ = _schur_system(cuda_device, torch.float32, _SCHUR_CASES["rig_families"], "track",
                           shards=2)
    with pytest.raises(ValueError, match="shards"):
        cg_solve.solve_cuda(two, g_c, g_p, M, 10, 1e-8)


@pytest.mark.cuda
def test_no_host_sync_inside_an_lm_iteration(cuda_device, monkeypatch):
    """From an LM iteration's assembly to the loop's read of the LM state
    nothing syncs with the host (``torch.cuda.set_sync_debug_mode("error")``
    raises on any sync): the read takes done, the counts and the singular
    flag in one sync, every ``LM_CHECK_EVERY`` iterations and after the
    last."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import assembly as asm, lm_step as lm, schur
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=12, n_per_face=4, pix_noise=0.3, dtype=torch.float32,
                                device=cuda_device)
    state0 = syn.perturb_state(scene.true_state)
    mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                           include_points=False)
    assemble, read = asm.assemble, lm.read
    syncs = []

    def guarded(*args):
        torch.cuda.set_sync_debug_mode("error")
        return assemble(*args)

    def test(*args):
        torch.cuda.set_sync_debug_mode(0)
        syncs.append(1)
        return read(*args)

    monkeypatch.setattr(asm, "assemble", guarded)
    monkeypatch.setattr(lm, "read", test)
    try:
        res = schur.make_schur_solver(state0, scene.observations, scene.models,
                                      prob.BAOptions(no_rig=True), mask, max_iterations=6,
                                      cg_iterations=40, cg_tolerance=0.1,
                                      preconditioner="schur_jacobi")(
            prob.pack_state(state0, include_points=False), state0.points)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    every = schur.LM_CHECK_EVERY
    assert len(syncs) == -(-res.iterations // every) and res.matvecs == int(res.cg_iters_total) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("block_precond", [False, True])
def test_the_assembly_plan_follows_each_iterations_blocks(cuda_device, block_precond):
    """One plan over three calls with new J and r tensors (as the LM loop
    makes them with torch.where): each call's outputs are those of its own
    blocks, and the scratch it left at 0 serves the next."""
    from multiview_tpu_torch.solver import assembly as asm
    system, _ = _schur_system(cuda_device, torch.float64, _SCHUR_CASES["rig_families"], "track")
    args = list(_assembly_inputs(system))
    plan = asm.AssemblyPlan()
    for i in range(3):
        scale = 1.0 + 0.25 * i
        J = [([None if a is None else a * scale for a in jc],
              [None if b is None else b * (2.0 - scale) for b in jp]) for jc, jp in system.J]
        r = [x * (1.0 + i) for x in args[3]]
        call = [args[0], args[1], J, r] + args[4:]
        got = plan(*call, block_precond)
        ref = asm.assemble_plain(*call, block_precond)
        _assembly_close(got, ref, torch.float64, f"call {i}")


def _pack7(blocks):
    """[R,7,7] symmetric -> [R,28] upper triangles, row by row."""
    iu = torch.triu_indices(7, 7)
    return blocks[:, iu[0], iu[1]].contiguous()


@pytest.mark.cuda
def test_the_warp_inverts_7x7_blocks_as_lu_does(cuda_device):
    """The poses pass alone (lam = 0, every column free: it inverts the
    blocks as given): ill-conditioned SPD blocks (condition to 1e10),
    indefinite ones that need row swaps (zeros on the diagonal), ties of
    pivots; within cond x 1e-13 of torch.linalg.inv in float64; a singular
    block (a zero row) sets the flag and gets a zero inverse, the others
    not touched by it."""
    import numpy as np
    from multiview_tpu_torch.solver import assembly as asm
    g = np.random.default_rng(3)
    blocks = []
    for c in (1e0, 1e3, 1e6, 1e10):
        q, _ = np.linalg.qr(g.normal(size=(7, 7)))
        blocks.append(q @ np.diag(np.logspace(0, -np.log10(c), 7)) @ q.T)
    a = g.normal(size=(7, 7))
    s = a + a.T
    np.fill_diagonal(s, 0.0)
    blocks.append(s)                                   # a zero diagonal: pivoting needed
    tie = 0.5 * (s + s.T) / 10.0 + 3.0 * np.eye(7)
    tie[0, 0], tie[3, 0], tie[0, 3] = 1.0, -1.0, -1.0
    tie[1:3, 0] = tie[0, 1:3] = tie[4:, 0] = tie[0, 4:] = 0.5
    blocks.append(tie)                                 # equal pivot candidates: rows 0 and 3
    singular = np.array(blocks[1])
    singular[4, :] = singular[:, 4] = 0.0
    blocks.append(singular)
    B = torch.as_tensor(np.stack(blocks), dtype=torch.float64, device=cuda_device)
    R = B.shape[0]
    C = 7 * R
    cam_free = torch.ones(C, dtype=torch.float64, device=cuda_device)
    lam = torch.zeros((), dtype=torch.float64, device=cuda_device)
    acc = torch.ones(2 * C, dtype=torch.float64, device=cuda_device)
    out = {"pose_inv": torch.full((R, 7, 7), float("nan"), dtype=torch.float64,
                                  device=cuda_device)}
    flag = asm.new_flag(cuda_device)
    asm._launch(asm._POSES, True, asm._EMPTY, cuda_device, cam_free, lam, 0, R, acc,
                _pack7(B).reshape(-1), None, out, flag)
    torch.cuda.synchronize()
    assert int(flag) == 1
    inv = out["pose_inv"]
    for i in range(R - 1):
        ref = torch.linalg.inv(B[i])
        cond = float(torch.linalg.cond(B[i]))
        err = float((inv[i] - ref).abs().max()) / float(ref.abs().max())
        assert err <= max(cond, 1.0) * 1e-13, (i, cond, err)
    assert not bool(inv[-1].any())
    ok = asm.new_flag(cuda_device)
    asm._launch(asm._POSES, True, asm._EMPTY, cuda_device, cam_free[:-7], lam, 0, R - 1,
                acc[:2 * (C - 7)].contiguous(), _pack7(B[:-1]).reshape(-1), None,
                {"pose_inv": out["pose_inv"][:-1].contiguous()}, ok)
    torch.cuda.synchronize()
    assert int(ok) == 0


@pytest.mark.cuda
def test_two_sharded_ranks_on_the_card_agree_bit_for_bit(cuda_device, tmp_path):
    """chip_smoke.py's phase 9d workers: two processes on cuda:0 joined by
    gloo, two shards each (the per-step path: a matvec and a csrc/cg_step.cu
    launch a step, the one-launch CG solve never), bit for bit equal."""
    import socket
    import subprocess
    import sys
    from pathlib import Path
    import numpy as np

    root = Path(__file__).resolve().parent.parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), "--phase9d-worker",
                               str(r), "2", str(port), str(outs[r])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=root)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    r0, r1 = (dict(np.load(o)) for o in outs)
    assert r0["solve_launches"] == r1["solve_launches"] == 0
    assert r0["cg_launches"] > 0 and r0["schur_launches"] > 0
    for k in r0:
        assert np.array_equal(r0[k], r1[k]) or k.endswith("_launches"), k


# ----------------------------------------------------------------------------
# The LM step (csrc/lm_step.cu: an LM iteration's trial point, model
# reduction, accept and lam update) against its plain version on the card
# ----------------------------------------------------------------------------


def _lm_inputs(device, dtype, seed=0, bounded=False):
    """Seeded inputs of one trial and accept on ``device``: three families
    (pixel-like rows with both blocks, rows without a point block, rows
    without a camera block), C = 40 camera entries, P = 30 points."""
    import types
    from multiview_tpu_torch.parallel.sharding import ShardMesh
    g = torch.Generator().manual_seed(seed)
    C, P = 40, 30

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, dtype=torch.float64)).to(dtype).to(device)

    fams, jc, jp, jc_t, jp_t = [], [], [], [], []
    for n, k, cam, pt in ((500, 2, True, True), (60, 3, True, False), (40, 3, False, True)):
        fams.append(types.SimpleNamespace(
            point_idx=torch.randint(0, P, (n,), generator=g).to(device)))
        jc.append(rnd(n, k, 20) if cam else None)
        jp.append(rnd(n, k, 3) if pt else None)
        jc_t.append(rnd(n, k, 20) if cam else None)
        jp_t.append(rnd(n, k, 3) if pt else None)
    rows = 500 * 2 + 60 * 3 + 40 * 3
    A = torch.randn((P, 3, 3), generator=g, dtype=torch.float64)
    x = dict(cam=rnd(C), points=rnd(P, 3), x=rnd(C, scale=0.1),
             cam_free=(torch.rand(C, generator=g) > 0.2).to(dtype).to(device),
             lower=None, upper=None,
             hpp_inv=(A @ A.transpose(1, 2) + 3 * torch.eye(3, dtype=torch.float64)).to(dtype)
             .to(device), g_p=rnd(P, 3), jtp_u=rnd(P, 3), g_c=rnd(C),
             cam_diag=rnd(C).abs() + 0.5, pt_diag=rnd(P, 3).abs() + 0.5, u=rnd(rows),
             r=rnd(rows), r_t=rnd(rows, scale=0.5))
    if bounded:
        x["lower"], x["upper"] = x["cam"] - 0.05, x["cam"] + 0.05
    mesh = ShardMesh((device,))
    return x, mesh, [fams], [(jc, jp)], [(jc_t, jp_t)]


def _lm_state(lm, dtype, device, C, P, cost, lam=3e-3, nu=4.0):
    st = lm.LMState(dtype, device, C, P)
    st.values[lm.COST], st.values[lm.LAM], st.values[lm.NU] = cost, lam, nu
    st.values[lm.ITER], st.values[lm.CG_TOTAL] = 5, 40
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded", "bounded"])
def test_lm_step_kernel_matches_plain_version(cuda_device, dtype, bounded):
    """The trial within 1e-6 (float32) / 1e-12 (float64) of max |plain in
    float64| (step_c of max |cam_t|); the accept at an accepted and a rejected step: good, done,
    the counters and the stop flag equal, the scalars within 1e-12 relative
    (both sum in float64, in other orders), the kept state and blocks bit
    for bit the trial's or the current ones, two launches bit for bit
    alike; then a halted state: nothing launched does anything."""
    from multiview_tpu_torch.solver import lm_step as lm
    x, mesh, shards, J, J_t = _lm_inputs(cuda_device, dtype, bounded=bounded)
    C, P = x["cam"].shape[0], x["points"].shape[0]
    targs = tuple(x[k] for k in ("cam", "points", "x", "cam_free", "lower", "upper", "hpp_inv",
                                 "g_p", "jtp_u"))
    st = _lm_state(lm, dtype, cuda_device, C, P, 1.0)
    before = lm.LAUNCHES
    t = lm.trial_cuda(st, *targs)
    assert lm.LAUNCHES == before + 1
    ref = lm.trial_plain(st, *(a.double() if a is not None else None for a in targs))
    # each output within tol of its scale: step_c = cam_t - cam carries cam_t's
    # rounding, so its scale is the cameras'
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    for a, b, scale in zip(t, ref, (ref.cam, ref.points, ref.dp, ref.cam)):
        assert float((a.double() - b).abs().max()) <= tol * float(scale.abs().max())
    t = lm.Trial(*(a.clone() for a in t))
    new_cost = 0.5 * float((x["r_t"].double() ** 2).sum())
    for cost, accepted in ((2.0 * new_cost, True), (0.5 * new_cost, False)):
        outs = []
        for fn in (lm.accept_cuda, lm.accept_cuda, lm.accept_plain):
            s = _lm_state(lm, dtype, cuda_device, C, P, cost)
            Jc = [tuple([None if a is None else a.clone() for a in side] for side in J[0])]
            cur = (x["r"].clone(), x["cam"].clone(), x["points"].clone())
            res = fn(s, mesh, shards, 0, Jc, [cur[0]], J_t, [x["r_t"]], t, cur[1], cur[2],
                     x["g_c"], x["g_p"], x["cam_diag"], x["pt_diag"], [x["u"]], None,
                     torch.tensor(7, device=cuda_device), True)
            torch.cuda.synchronize()
            outs.append((s, res))
        (k1, r1), (k2, r2), (p, rp) = outs
        v1, v2, vp = k1.values.cpu(), k2.values.cpu(), p.values.cpu()
        assert torch.equal(v1, v2) and torch.equal(k1.typed, k2.typed)
        assert bool(v1[lm.GOOD]) == bool(vp[lm.GOOD]) == accepted
        for slot in (lm.DONE, lm.ITER, lm.CG_TOTAL):
            assert float(v1[slot]) == float(vp[slot])
        assert int(v1[lm.ITER]) == 6 and int(v1[lm.CG_TOTAL]) == 47
        assert bool(k1.halt) == bool(p.halt)
        for slot in (lm.NEW_COST, lm.PRED, lm.RHO, lm.LAM, lm.NU, lm.REL, lm.COST):
            a, b = float(v1[slot]), float(vp[slot])
            assert abs(a - b) <= 1e-12 * abs(b), (slot, a, b)
        cam, pts, Jn, rn = r1
        want = (t.cam, t.points, J_t[0], x["r_t"]) if accepted else \
            (x["cam"], x["points"], J[0], x["r"])
        assert torch.equal(cam, want[0]) and torch.equal(pts, want[1])
        assert torch.equal(rn[0], want[3])
        for side, wside in zip(Jn[0], want[2]):
            for a, b in zip(side, wside):
                assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    # halted: the trial and the accept launch and do nothing
    st = _lm_state(lm, dtype, cuda_device, C, P, 2.0 * new_cost)
    st.halt.fill_(1)
    st.trial.cam.fill_(7.0)
    values = st.values.clone()
    before = lm.LAUNCHES
    lm.trial_cuda(st, *targs)
    lm.accept_cuda(st, mesh, shards, 0, J, [x["r"]], J_t, [x["r_t"]], t, x["cam"], x["points"],
                   x["g_c"], x["g_p"], x["cam_diag"], x["pt_diag"], [x["u"]], None, None, True)
    torch.cuda.synchronize()
    assert lm.LAUNCHES == before + 2
    assert torch.equal(st.values, values) and bool((st.trial.cam == 7.0).all())
    other = torch.float64 if dtype == torch.float32 else torch.float32
    with pytest.raises(TypeError):
        lm.trial_cuda(st, *(None if a is None else a.to(other) for a in targs))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cg_blocks", "dense_schur", "cg_dense_j", "cg"])
def test_the_lm_loop_on_the_card_matches_the_cpu(cuda_device, monkeypatch, mode):
    """The whole solve in float64 on the card against the plain CPU solve:
    the same LM and CG counts, cost within 1e-10 relative, cameras within
    1e-8; the LM state read every iteration and every second one on the
    card gives the same counts; every iteration launched the LM step
    kernel (a trial and an accept) and nothing after done."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import lm_step as lm, row_blocks as rb, schur
    from multiview_tpu_torch.utils import synthetic as syn

    def solve(dev):
        scene = syn.make_cube_scene(n_images=8, n_per_face=3, pix_noise=0.3,
                                    dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), dtype=torch.float64,
                                    device=dev)
        state0 = syn.perturb_state(scene.true_state, pose_rot=0.005, pose_trans=0.01,
                                   point_sigma=0.01)
        mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True, focal=(0,)),
                               no_rig=True, include_points=False)
        return schur.make_schur_solver(state0, scene.observations, scene.models,
                                       prob.BAOptions(no_rig=True), mask, max_iterations=40,
                                       cg_iterations=60, cg_tolerance=1e-2,
                                       linear_solver=mode)(
            prob.pack_state(state0, include_points=False), state0.points)

    ref = solve("cpu")
    assert ref.iterations < 40
    for every in (1, 2):
        monkeypatch.setattr(schur, "LM_CHECK_EVERY", every)
        before = (lm.LAUNCHES, rb.LAUNCHES)
        got = solve(cuda_device)
        torch.cuda.synchronize()
        assert got.iterations == ref.iterations
        assert int(got.cg_iters_total) == int(ref.cg_iters_total)
        assert abs(float(got.cost) - float(ref.cost)) <= 1e-10 * float(ref.cost)
        assert float((got.cam.cpu() - ref.cam).abs().max()) <= 1e-8
        # init, then a trial and an accept an iteration; the row blocks at
        # the start and at each trial point (one family); past done (the
        # iterations up to the next read) the launches return at once
        stepped = (lm.LAUNCHES - before[0], rb.LAUNCHES - before[1])
        extra = 0 if every == 1 or mode != "cg_blocks" else ref.iterations % 2
        assert stepped == (1 + 2 * (ref.iterations + extra), 1 + ref.iterations + extra)
