"""Port parity: the cloud filter (``dense/pc_filter.py``), TSDF fusion
(``dense/tsdf.py``) and marching tetrahedra (``dense/marching.py``) against
the JAX package on the CPU in float64.

The port's k-NN sums squared coordinate differences, the reference's forms
|x|^2 + |y|^2 - 2 x.y: they agree to 1e-12 on these clouds in float64. The
reference's ``statistical_outlier_removal`` rounds the cloud to float32, so
the port's kept mask is held to the reference's rule applied to the JAX
``knn_mean_distance`` in float64. Bars: k-NN mean distances 1e-12; kept
masks equal; rasterized depth and intensity exact; ``integrate_depth_image``
and ``integrate_point_cloud`` 1e-12; ``extract_mesh`` faces equal and
vertices 1e-10."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.dense import marching as JM, pc_filter as JPF, tsdf as JT
from multiview_tpu.geometry import pose as JP
from multiview_tpu.utils import synthetic as jsyn
from multiview_tpu_torch.dense import marching as TM, pc_filter as TPF, tsdf as TT
from torch_port_scenes import one_torch_thread
from test_tsdf_mesh import render_sphere_depth

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FOCAL, CENTER, IMAGE = (200.0, 200.0), (160.0, 120.0), (320, 240)


def _cloud(seed, n=1000, n_out=20):
    """A noisy patch of surface 2 m in front of a camera, with far outliers."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.6, 0.6, (n, 2))
    z = 2.0 + 0.1 * np.sin(3 * xy[:, 0]) + rng.normal(0, 0.002, n)
    pts = np.column_stack([xy, z])
    pts[rng.choice(n, n_out, replace=False)] += rng.normal(0, 0.3, (n_out, 3))
    return pts


def test_knn_mean_distance_matches_jax():
    pts = _cloud(0)
    ref = np.asarray(JPF.knn_mean_distance(jnp.asarray(pts), k=8, chunk=256))  # padded chunks
    for chunk in (300, 512):
        got = TPF.knn_mean_distance(torch.as_tensor(pts), k=8, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    dup = np.concatenate([pts, pts[:5]])                 # duplicates: a neighbour at 0
    np.testing.assert_allclose(TPF.knn_mean_distance(torch.as_tensor(dup), k=4).numpy(),
                               np.asarray(JPF.knn_mean_distance(jnp.asarray(dup), k=4)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [3, 8, 9])
def test_knn_mean_distance_of_k_or_fewer_neighbours_matches_jax(n):
    """With k or fewer other points the reference's padding rows at 1e15 are
    the missing neighbours (a mean near 1e15); relative 1e-12."""
    pts = _cloud(1)[:n]
    got = TPF.knn_mean_distance(torch.as_tensor(pts), k=8).numpy()
    ref = np.asarray(JPF.knn_mean_distance(jnp.asarray(pts), k=8))
    assert got.shape == (n,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert (got > 1e14).all() == (n <= 8)


@pytest.mark.parametrize("gate", [0.0, 2.2])
def test_pc_filter_keeps_what_the_reference_rule_keeps(gate):
    pts = _cloud(1)
    pts[3] = np.nan
    keep = np.isfinite(pts).all(axis=1)
    if gate > 0:
        keep &= np.linalg.norm(pts, axis=1) <= gate
    md = np.asarray(JPF.knn_mean_distance(jnp.asarray(pts[keep]), k=8))
    ref = np.zeros(len(pts), bool)
    ref[np.nonzero(keep)[0][md <= md.mean() + 2.0 * md.std()]] = True
    filt, got = TPF.pc_filter(pts, max_distance_from_camera=gate, device="cpu")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(filt, pts[ref])
    assert 0.9 * len(pts) < ref.sum() < len(pts) - 5
    assert TPF.statistical_outlier_removal(pts[:9], k=8, device="cpu").all()


def test_rasterize_cloud_matches_jax_exactly():
    rng = np.random.default_rng(2)
    pts = _cloud(2, n=3000)
    pts = np.concatenate([pts, pts[:40] + [0, 0, 0.05], [[0.1, 0.1, -1.0]]])  # z-fights, behind
    inten = rng.uniform(size=len(pts))
    for fill in (0, 2):
        dj, ij = JT.rasterize_cloud_to_depth(jnp.asarray(pts), jnp.asarray(FOCAL),
                                             jnp.asarray(CENTER), IMAGE, jnp.asarray(inten),
                                             fill_rounds=fill)
        dt, it = TT.rasterize_cloud_to_depth(torch.as_tensor(pts), FOCAL, CENTER, IMAGE,
                                             torch.as_tensor(inten), fill_rounds=fill)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (np.asarray(dj) > 0).mean() > 0.05


def _sphere_views(n_views=6):
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        w2c = jsyn.look_at_pose(np.array([3 * np.cos(a), 3 * np.sin(a), 0.5]), np.zeros(3))
        c2w = np.array(JP.pose_inverse(jnp.asarray(w2c)))
        yield c2w, render_sphere_depth(c2w, np.array(FOCAL), np.array(CENTER), IMAGE)


@pytest.fixture(scope="module")
def sphere_grids():
    """A sphere fused from six depth images (with intensities) and from
    three of its clouds, in both packages: {name: (jax grid, port grid)}."""
    shape, origin, vs = (24, 24, 24), (-1.5, -1.5, -1.5), 3.0 / 24
    gj = JT.make_grid(shape, origin, vs, dtype=jnp.float64)
    gt = TT.make_grid(shape, origin, vs, dtype=torch.float64, device="cpu")
    cj = JT.make_grid(shape, origin, vs, dtype=jnp.float64)
    ct = TT.make_grid(shape, origin, vs, dtype=torch.float64, device="cpu")
    us, vs_ = np.meshgrid(np.arange(IMAGE[0]), np.arange(IMAGE[1]))
    for k, (c2w, depth) in enumerate(_sphere_views()):
        depth = depth.astype(np.float64)
        inten = (np.sin(0.1 * us) * np.cos(0.07 * vs_) + k) / 10.0
        gj = JT.integrate_depth_image(gj, jnp.asarray(depth), jnp.asarray(FOCAL),
                                      jnp.asarray(CENTER), jnp.asarray(c2w),
                                      intensity_img=jnp.asarray(inten))
        gt = TT.integrate_depth_image(gt, torch.as_tensor(depth), FOCAL, CENTER, c2w,
                                      intensity_img=torch.as_tensor(inten))
        if k % 2:
            continue
        z = depth[::2, ::2]
        ok = z > 0
        cloud = np.stack([(us[::2, ::2] - CENTER[0]) / FOCAL[0] * z,
                          (vs_[::2, ::2] - CENTER[1]) / FOCAL[1] * z, z], -1)[ok]
        ci = inten[::2, ::2][ok]
        # a virtual focal off the grid's ratio: at 150 px the points of the
        # regular grid project onto exact half pixels, which XLA's fused
        # division rounds one ulp away from torch's and numpy's
        cj = JT.integrate_point_cloud(cj, jnp.asarray(cloud), jnp.asarray(c2w),
                                      focal=(151.3, 151.3), image_size=(200, 150),
                                      intensities=jnp.asarray(ci))
        ct = TT.integrate_point_cloud(ct, torch.as_tensor(cloud), c2w, focal=(151.3, 151.3),
                                      image_size=(200, 150), intensities=torch.as_tensor(ci))
    return {"depth": (gj, gt), "cloud": (cj, ct)}


@pytest.mark.parametrize("name", ["depth", "cloud"])
def test_integration_matches_jax(sphere_grids, name):
    gj, gt = sphere_grids[name]
    assert (np.asarray(gj.weight) > 0).mean() > 0.2
    for field in ("tsdf", "weight", "intensity"):
        np.testing.assert_allclose(getattr(gt, field).numpy(), np.asarray(getattr(gj, field)),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(TT.voxel_centers(gt).numpy(), np.asarray(JT.voxel_centers(gj)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["depth", "cloud"])
def test_extract_mesh_matches_jax(sphere_grids, name):
    gj, _ = sphere_grids[name]
    grid = TT.TsdfGrid.from_numpy(gj.tsdf, gj.weight, gj.intensity, gj.origin, gj.voxel_size,
                                  gj.truncation, device="cpu")
    vj, fj, ij = JM.extract_mesh(gj)
    vt, ft, it = TM.extract_mesh(grid)
    assert len(fj) > 500
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(it, ij, rtol=0, atol=1e-10)
    r = np.linalg.norm(vt, axis=-1)
    assert abs(np.median(r) - 1.0) < 0.05


def test_extract_mesh_of_an_empty_grid():
    g = TT.make_grid((4, 4, 4), (0, 0, 0), 0.1, dtype=torch.float64, device="cpu")
    v, f, i = TM.extract_mesh(g)
    assert v.shape == (0, 3) and f.shape == (0, 3) and i.shape == (0,)
