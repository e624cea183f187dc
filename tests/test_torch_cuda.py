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
    """On cuda:0 CG stops at the reference's test: the matvecs run stay
    within one check interval of the CG count per LM iteration, and the
    masked loop run to the whole budget takes the same LM and CG counts to
    the same result (within float32 rounding: ``index_add_`` sums in no
    fixed order on the card)."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import schur
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=16, n_per_face=5, pix_noise=0.3,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), dtype=torch.float32,
                                device=cuda_device)
    state0 = syn.perturb_state(scene.true_state)
    mask = prob.build_mask(state0, prob.FloatSpec(cam_poses=True, focal=(0,)), no_rig=True,
                           include_points=False)
    cam0 = prob.pack_state(state0, include_points=False)

    def solve():
        return schur.make_schur_solver(state0, scene.observations, scene.models,
                                       prob.BAOptions(no_rig=True), mask, max_iterations=6,
                                       cg_iterations=40, cg_tolerance=0.1)(cam0, state0.points)

    res = solve()
    cg = int(res.cg_iters_total)
    assert cg <= res.matvecs <= cg + (schur.CG_CHECK_EVERY - 1) * res.iterations
    assert res.matvecs < 40 * res.iterations // 2
    assert float(res.cost) < float(res.initial_cost)
    monkeypatch.setattr(schur, "CG_CHECK_EVERY", 41)
    full = solve()
    assert full.matvecs == 40 * full.iterations and int(full.cg_iters_total) == cg
    assert full.iterations == res.iterations
    torch.testing.assert_close(full.cost, res.cost, rtol=1e-6, atol=0)
    torch.testing.assert_close(full.cam, res.cam, rtol=0, atol=1e-4)
