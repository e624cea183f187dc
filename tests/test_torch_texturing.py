"""Port parity for texturing: the classes of tests/test_texturing.py run
through ``multiview_tpu.texture`` and ``multiview_tpu_torch.texture`` on the
same inputs, made from a seed with numpy; the port on the CPU (float64 where
the reference follows its inputs, float32 where it casts).

Tolerances: equal occupancy grids, blocked and usable masks, clamping keep
masks, MRF labels, adjacency tables and atlas layouts; costs and MRF energies
to 1e-12 (the same float64 formulas); rendered and leveled pages to 1e-5
absolute (float32 texel positions and projections in two libraries); global
gains to 1e-6 with the same sweep count; OBJ and MTL bytes equal, PNG pixels
within one gray level on at most 0.1% of the texels (float32 rounding at the
uint8 step)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiview_tpu.geometry.camera import CameraParams as JCam
from multiview_tpu.texture import raycast as JR, texturing as JT
from multiview_tpu_torch.geometry.camera import CameraParams as TCam
from multiview_tpu_torch.texture import raycast as TR, texturing as TT
from multiview_tpu_torch.utils import synthetic as syn
from multiview_tpu_torch.utils.images import read_png
from torch_port_scenes import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W, H = 160, 120


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def grid_mesh(n=8, half=1.0, z=0.0):
    """Planar [n x n]-quad grid with +z normals: (n+1)^2 vertices, 2n^2 faces."""
    xs = np.linspace(-half, half, n + 1)
    vx, vy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([vx.ravel(), vy.ravel(), np.full((n + 1) ** 2, z)], 1)
    faces = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            b, c = a + 1, a + n + 1
            faces += [[a, c + 1, b], [a, c, c + 1]]
    return verts, np.asarray(faces, np.int32)


def terrain(n=10, half=1.0, seed=0):
    """A grid mesh with a seeded bumpy height and a floating occluder quad
    above one corner."""
    verts, faces = grid_mesh(n, half)
    rng = np.random.default_rng(seed)
    verts[:, 2] = 0.08 * np.sin(3.0 * verts[:, 0]) * np.cos(2.0 * verts[:, 1]) \
        + 0.01 * rng.normal(size=len(verts))
    ov, of = grid_mesh(1, 0.3, z=0.6)
    ov[:, :2] += 0.5
    return np.concatenate([verts, ov]), np.concatenate([faces, of + len(verts)])


POSES = [syn.look_at_pose(np.array(p), np.array(t)) for p, t in (
    ((0.1, 0.05, 2.2), (0.0, 0.0, 0.0)), ((1.2, 0.3, 1.6), (0.2, 0.1, 0.0)),
    ((-1.0, -0.8, 1.8), (0.0, 0.0, 0.0)), ((0.4, -1.3, 1.2), (0.1, 0.0, 0.0)),
    ((0.6, 0.6, -1.5), (0.0, 0.0, 0.0)))]


def cams(dist=()):
    j = JCam.create((W, H), (150.0, 152.0), (81.0, 59.0), dist)
    t = TCam.create((W, H), (150.0, 152.0), (81.0, 59.0), dist, device="cpu")
    return j, t


def images(n, channels=3, seed=1):
    """Smooth seeded images (a low-frequency field plus a gradient)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / 40.0
    out = []
    for _ in range(n):
        a = rng.uniform(0, 6, (channels, 4))
        img = np.stack([0.5 + 0.2 * np.sin(a[c, 0] * xx + a[c, 1]) * np.cos(a[c, 2] * yy + a[c, 3])
                        + 0.05 * xx for c in range(channels)], -1)
        out.append(np.clip(img, 0, 1).astype(np.float32).squeeze())
    return out


class TestOccupancyGrid:
    def test_grid_and_blocked_mask_equal(self):
        verts, faces = terrain()
        tri = verts[faces]
        occ_j, org_j, vox_j = JR.build_occupancy_grid(tri, dim=24)
        occ_t, org_t, vox_t = TR.build_occupancy_grid(tri, dim=24)
        assert np.array_equal(occ_t, occ_j) and np.array_equal(org_t, org_j)
        assert vox_t == vox_j and occ_t.sum() > 100
        ctr_j, n_j, _ = JT.face_geometry(jnp.asarray(verts), jnp.asarray(faces))
        ctr_t, n_t, _ = TT.face_geometry(t64(verts), torch.as_tensor(faces).long())
        np.testing.assert_allclose(ctr_t.numpy(), np.asarray(ctr_j), rtol=0, atol=1e-15)
        cam_ctr = np.array([[0.6, 0.55, 2.0], [-0.9, 0.1, 1.5], [0.5, 0.5, 0.2]])
        bj = np.asarray(JR.occlusion_blocked_grid(ctr_j, n_j, jnp.asarray(cam_ctr),
                                                  jnp.asarray(tri), dim=24, steps=64))
        bt = TR.occlusion_blocked_grid(ctr_t, n_t, t64(cam_ctr), t64(tri), dim=24,
                                       steps=64).numpy()
        assert np.array_equal(bt, bj)
        assert 0 < bj.sum() < bj.size

    def test_long_triangles_mark_only_max_span_cells(self):
        """The reference's clip of a triangle's box to max_span cells per
        axis, kept for parity."""
        tri = np.array([[[0, 0, 0], [10.0, 0, 0], [0, 0.1, 0]],
                        [[0, 0, 1.0], [0.1, 0, 1.0], [0, 0.1, 1.0]]])
        occ_t, _, _ = TR.build_occupancy_grid(tri, dim=40)
        occ_j, _, _ = JR.build_occupancy_grid(tri, dim=40)
        assert np.array_equal(occ_t, occ_j)
        assert occ_t[:, :, 0].sum() == 8                  # not the 41 cells of its box


class TestViewCosts:
    @pytest.mark.parametrize("method", ["exact", "grid"])
    def test_costs_and_usable_masks_equal(self, method):
        verts, faces = terrain()
        poses = np.stack(POSES)
        cj, uj = JT.view_costs(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(poses),
                               occlusion_method=method)
        ct, ut = TT.view_costs(t64(verts), torch.as_tensor(faces).long(), t64(poses),
                               occlusion_method=method)
        uj = np.asarray(uj)
        assert np.array_equal(ut.numpy(), uj)
        assert 0.3 < uj.mean() < 0.95
        np.testing.assert_allclose(ct.numpy()[uj], np.asarray(cj)[uj], rtol=0, atol=1e-12)
        assert np.all(np.isinf(ct.numpy()[~uj]))

    def test_occlusion_and_auto(self, monkeypatch):
        verts, faces = terrain()
        poses = t64(np.stack(POSES))
        _, free = TT.view_costs(t64(verts), torch.as_tensor(faces).long(), poses,
                                occlusion=False)
        _, exact = TT.view_costs(t64(verts), torch.as_tensor(faces).long(), poses,
                                 occlusion_method="exact")
        assert (free & ~exact).sum() > 0 and not (exact & ~free).any()
        # auto: the grid above AUTO_GRID_PAIRS face-view pairs
        assert TT.resolve_occlusion_method("auto", 1_000_000, 4) == "exact"
        assert TT.resolve_occlusion_method("auto", 1_000_000, 5) == "grid"
        monkeypatch.setattr(TT, "AUTO_GRID_PAIRS", 10)
        _, auto = TT.view_costs(t64(verts), torch.as_tensor(faces).long(), poses)
        _, grid = TT.view_costs(t64(verts), torch.as_tensor(faces).long(), poses,
                                occlusion_method="grid")
        assert torch.equal(auto, grid)
        with pytest.raises(ValueError):
            TT.view_costs(t64(verts), torch.as_tensor(faces).long(), poses,
                          occlusion_method="bvh")

    def test_view_selection_and_face_colors_equal(self):
        verts, faces = terrain()
        poses = np.stack(POSES)
        (cj, ct), imgs = cams((0.05, -0.02, 0.001, 0.002)), images(len(POSES))
        bj, vj = JT.view_selection(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(poses))
        bt, vt = TT.view_selection(t64(verts), torch.as_tensor(faces).long(), t64(poses))
        assert np.array_equal(vt.numpy(), np.asarray(vj))
        assert np.array_equal(bt.numpy()[vt.numpy()], np.asarray(bj)[np.asarray(vj)])
        _, usable = JT.view_costs(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(poses))
        for gray in (False, True):
            colj = JT.sample_face_view_colors(jnp.asarray(verts), jnp.asarray(faces), imgs,
                                              [cj] * len(imgs), list(jnp.asarray(poses)),
                                              usable, grayscale=gray)
            colt = TT.sample_face_view_colors(t64(verts), torch.as_tensor(faces).long(), imgs,
                                              [ct] * len(imgs), t64(poses),
                                              torch.as_tensor(np.array(usable)),
                                              grayscale=gray)
            assert colt.shape == colj.shape
            np.testing.assert_allclose(colt.numpy(), np.asarray(colj), rtol=0, atol=1e-12)


class TestGaussClamping:
    @pytest.mark.parametrize("channels", [0, 3])
    def test_keep_masks_equal(self, channels):
        rng = np.random.default_rng(3)
        F, V = 60, 9
        shape = (F, V, channels) if channels else (F, V)
        colors = np.repeat(rng.uniform(0.3, 0.7, (F, 1) + shape[2:]), V, axis=1)
        colors = colors + rng.normal(0, 0.01, shape)
        colors[:, 2] += 0.3                                   # an outlier view
        if channels:
            colors[:, 5, 0] += 0.25                           # a chroma-only cast
            colors[:, 5, 1] -= 0.25
        usable = rng.uniform(size=(F, V)) < 0.85
        kj, wj = JT.gauss_clamping(jnp.asarray(colors), jnp.asarray(usable))
        kt, wt = TT.gauss_clamping(t64(colors), torch.as_tensor(usable))
        assert np.array_equal(kt.numpy(), np.asarray(kj))
        assert not kt.numpy()[:, 2].any() and kt.numpy().sum(1).min() >= 1
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)


class TestMrf:
    def test_adjacency_tables_equal(self):
        verts, faces = terrain()
        extra = np.array([[0, 1, 12], [0, 0, 1], [3, 4, 4]], np.int32)   # non-manifold, degenerate
        for f in (faces, np.concatenate([faces, extra])):
            aj = JT.face_adjacency(f)
            at = TT.face_adjacency(f)
            assert at.dtype == np.int32 and np.array_equal(at, aj)
            assert np.array_equal(TT.face_neighbors(f, at), JT.face_neighbors(f, aj))
            pj, ej = JT.shared_edge_vertices(f, aj)
            pt, et = TT.shared_edge_vertices(f, at)
            assert np.array_equal(pt, pj) and np.array_equal(et, ej)
        assert TT.face_adjacency(np.zeros((0, 3), np.int32)).shape == (0, 2)

    def test_labels_and_energy_equal(self):
        verts, faces = terrain()
        rng = np.random.default_rng(4)
        F, V = len(faces), 6
        cost = rng.uniform(0.5, 1.5, (F, V))
        cost[rng.uniform(size=(F, V)) < 0.3] = np.inf
        cost[7] = np.inf                                     # a face no view sees
        nbr = JT.face_neighbors(faces, JT.face_adjacency(faces))
        for smooth in (0.0, 0.2, 0.7):
            lj, vj = JT.mrf_view_selection(jnp.asarray(cost), jnp.isfinite(jnp.asarray(cost)),
                                           nbr, smoothness=smooth)
            lt, vt = TT.mrf_view_selection(t64(cost), torch.isfinite(t64(cost)), nbr,
                                           smoothness=smooth)
            assert np.array_equal(lt.numpy(), np.asarray(lj))
            assert np.array_equal(vt.numpy(), np.asarray(vj)) and not vt[7]
            ej = JT.mrf_energy(cost, np.asarray(lj), nbr, smooth)
            et = TT.mrf_energy(cost, lt.numpy(), nbr, smooth)
            assert abs(et - ej) <= 1e-12 * abs(ej)
            assert et <= TT.mrf_energy(cost, np.argmin(cost, 1), nbr, smooth) + 1e-12


def _atlas_equal(at, aj):
    assert at.size == aj.size and list(at.page_sizes) == list(aj.page_sizes)
    for name in ("face_uv0", "face_wh", "face_basis", "face_origin3d", "face_page"):
        assert np.array_equal(getattr(at, name), getattr(aj, name)), name
    assert at.pixel_size == aj.pixel_size


class TestAtlas:
    @pytest.mark.parametrize("max_page", [8192, 64])
    def test_layout_equal(self, max_page):
        verts, faces = grid_mesh(10, 0.5)
        aj = JT.build_atlas(verts, faces, pixel_size=0.01, max_page=max_page)
        at = TT.build_atlas(verts, faces, pixel_size=0.01, max_page=max_page)
        _atlas_equal(at, aj)
        assert (at.num_pages > 1) == (max_page == 64)

    def test_random_soup_and_too_large_chart(self):
        rng = np.random.default_rng(0)
        verts = rng.normal(size=(30, 3))
        faces = rng.integers(0, 30, size=(40, 3)).astype(np.int32)
        _atlas_equal(TT.build_atlas(verts, faces, 0.05), JT.build_atlas(verts, faces, 0.05))
        with pytest.raises(ValueError, match="pixel_size"):
            TT.build_atlas(*grid_mesh(1, 5.0), pixel_size=0.01, max_page=64)

    def test_chart_tiles_equal(self):
        verts, faces = grid_mesh(3, 0.5)
        atlas = TT.build_atlas(verts, faces, pixel_size=0.013)
        sel = np.array([0, 3, 5, 17])
        for mc in (8, 16, 64):
            fj, xj = JT._chart_tiles(atlas, sel, mc)
            ft, xt = TT._chart_tiles(atlas, sel, mc)
            assert np.array_equal(ft, fj) and np.array_equal(xt, xj)


def _render_scene(n_views=2, channels=3, max_page=8192, pixel_size=0.02):
    verts, faces = grid_mesh(4, 0.5)
    poses = [POSES[0], syn.look_at_pose(np.array([0.3, 0.2, 2.1]), np.zeros(3))][:n_views]
    cj, ct = cams((0.03, -0.01, 0.001, 0.0005))
    imgs = images(n_views, channels)
    best, vis = JT.view_selection(jnp.asarray(verts), jnp.asarray(faces),
                                  jnp.asarray(np.stack(poses)), occlusion=False)
    atlas = JT.build_atlas(verts, faces, pixel_size=pixel_size, max_page=max_page)
    return dict(verts=verts, faces=faces, poses=poses, cj=[cj] * n_views, ct=[ct] * n_views,
                imgs=imgs, best=np.asarray(best), vis=np.asarray(vis), atlas=atlas)


def _render_both(s, **kw):
    pj = JT.render_atlas(s["atlas"], s["verts"], s["faces"], s["best"], s["vis"], s["imgs"],
                         s["cj"], [jnp.asarray(p) for p in s["poses"]], **kw)
    pt = TT.render_atlas(s["atlas"], s["verts"], s["faces"], s["best"], s["vis"], s["imgs"],
                         s["ct"], [t64(p) for p in s["poses"]], **kw)
    return pj, pt


def _pages_close(pt, pj, atol=1e-5):
    pt, pj = TT._as_pages(pt), JT._as_pages(pj)
    assert len(pt) == len(pj)
    for a, b in zip(pt, pj):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


class TestRender:
    @pytest.mark.parametrize("max_chart", [None, 16, 64])
    @pytest.mark.parametrize("gain", ["none", "face", "vertex"])
    def test_pages_equal(self, max_chart, gain):
        s = _render_scene()
        F, V = len(s["faces"]), len(s["verts"])
        rng = np.random.default_rng(5)
        kw = {"face": dict(face_gain=rng.normal(0, 0.05, (F, 3))),
              "vertex": dict(vertex_gain=rng.normal(0, 0.05, (V, 3))),
              "none": {}}[gain]
        assert s["atlas"].face_wh.max() > 16                    # 16 tiles a chart
        pj, pt = _render_both(s, max_chart=max_chart, **kw)
        _pages_close(pt, pj)
        assert pt.max() > 0.3

    def test_gray_multipage_and_scalar_gains(self):
        s = _render_scene(channels=1, max_page=64, pixel_size=0.01)
        assert s["atlas"].num_pages > 1
        rng = np.random.default_rng(6)
        for kw in (dict(face_gain=rng.normal(0, 0.05, len(s["faces"]))),
                   dict(vertex_gain=rng.normal(0, 0.05, len(s["verts"])))):
            pj, pt = _render_both(s, max_chart=16, **kw)
            assert isinstance(pt, list) and pt[0].ndim == 2
            _pages_close(pt, pj)


class TestSeamLeveling:
    def test_global_gains_equal(self):
        verts, faces = terrain(12)
        adjacency = JT.face_adjacency(faces)
        rng = np.random.default_rng(7)
        best = (np.arange(len(faces)) * 7 // len(faces)).astype(np.int32)
        colors = rng.uniform(0.2, 0.8, (len(faces), 3)) + 0.1 * best[:, None]
        for fc, it in ((colors, 2000), (colors[:, 1], 2000), (colors, 128)):
            gj, ij = JT.global_seam_leveling(fc, best, adjacency, iterations=it,
                                             return_info=True)
            gt, it_ = TT.global_seam_leveling(fc, best, adjacency, iterations=it,
                                              return_info=True, device="cpu")
            assert it_["iterations"] == ij["iterations"] and gt.shape == gj.shape
            np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-6)
            assert abs(it_["rel_residual"] - ij["rel_residual"]) <= 1e-3 * ij["rel_residual"]
        assert ij["iterations"] == 128 and ij["rel_residual"] > 1e-4    # the cap
        g, info = TT.global_seam_leveling(colors, best, np.zeros((0, 2), np.int32),
                                          return_info=True, device="cpu")
        assert info["iterations"] == 0 and not g.any()

    def test_vertex_gains_equal(self):
        verts, faces = terrain()
        g = np.random.default_rng(8).normal(size=(len(faces), 3))
        for fg in (g, g[:, 0]):
            np.testing.assert_array_equal(TT.vertex_gains_from_faces(len(verts), faces, fg),
                                          JT.vertex_gains_from_faces(len(verts), faces, fg))

    @pytest.mark.parametrize("channels,max_page", [(3, 8192), (1, 64)])
    def test_local_leveling_and_seam_stats_equal(self, channels, max_page):
        s = _render_scene(channels=channels, max_page=max_page, pixel_size=0.01)
        # force a view seam down the middle, with a brightness offset
        s["best"] = (s["atlas"].face_origin3d[:, 0] > 0).astype(np.int32)
        s["imgs"][1] = np.clip(s["imgs"][1] * 1.2 + 0.05, 0, 1)
        page = _render_both(s, max_chart=16)[0]
        adjacency = JT.face_adjacency(s["faces"])
        args = (s["atlas"], s["verts"], s["faces"], s["best"], s["vis"], adjacency)
        sj = JT.seam_step_stats(page, *args)
        st = TT.seam_step_stats(page, *args)
        assert st == sj and st["num_seam_edges"] > 0
        before = [np.array(p) for p in TT._as_pages(page)]
        lj = JT.local_seam_leveling(page, *args)
        lt = TT.local_seam_leveling(page, *args, device="cpu")
        _pages_close(lt, lj)
        assert all(np.array_equal(a, b) for a, b in zip(TT._as_pages(page), before))  # not in place
        after = TT.seam_step_stats(lt, *args)
        assert after["seam_mean"] < st["seam_mean"]
        for key, val in JT.seam_step_stats(lj, *args).items():
            assert abs(after[key] - val) <= 1e-5, key


class TestObjOutput:
    @pytest.mark.parametrize("max_page", [8192, 64])
    def test_obj_mtl_bytes_and_png_pixels(self, tmp_path, max_page):
        s = _render_scene(max_page=max_page, pixel_size=0.01)
        pj, pt = _render_both(s, max_chart=16)
        JT.write_textured_obj(tmp_path / "jax" / "model", s["verts"], s["faces"], s["atlas"], pj)
        TT.write_textured_obj(tmp_path / "torch" / "model", s["verts"], s["faces"], s["atlas"],
                              pt)
        for ext in ("obj", "mtl"):
            assert ((tmp_path / "torch" / f"model.{ext}").read_bytes()
                    == (tmp_path / "jax" / f"model.{ext}").read_bytes())
        pngs = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
        assert sorted(p.name for p in (tmp_path / "torch").glob("*.png")) == pngs
        assert len(pngs) == s["atlas"].num_pages
        from PIL import Image
        for name in pngs:
            a = read_png(tmp_path / "torch" / name).astype(int)
            b = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1
            assert (a != b).mean() <= 1e-3
