"""Port parity: plane-sweep stereo (``dense/stereo.py``) against the JAX
package on the CPU in float64.

The port's box filter is an exact window sum (``avg_pool2d`` over an
edge-padded image), the reference's a difference of cumulative sums; in
float64 the two agree to 1e-12. Bars: box filter, bilinear sampling (edge
values outside the image included) and ``sgm_aggregate`` to 1e-12;
``plane_sweep`` at 96x72 with 16 planes, winner-take-all and SGM: valid masks
equal, depth and confidence to 1e-9; ``left_right_check`` masks equal;
``stereo_pair_to_cloud`` equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.dense import stereo as JS
from multiview_tpu.geometry import pose as JP
from multiview_tpu_torch.dense import stereo as TS
from torch_port_scenes import FOCAL, SIZE, one_torch_thread, ref_pose, render_plane_image

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cumsum_box(x, radius):
    """The reference's box mean (differences of cumulative sums), in torch."""
    k = 2 * radius + 1
    xp = torch.nn.functional.pad(x[None, None], (radius,) * 4, mode="replicate")[0, 0]
    c = torch.cumsum(xp, 0)
    c = torch.cat([c[k - 1:k], c[k:] - c[:-k]], 0)
    c = torch.cumsum(c, 1)
    c = torch.cat([c[:, k - 1:k], c[:, k:] - c[:, :-k]], 1)
    return c / (k * k)


@pytest.mark.parametrize("radius", [1, 3])
def test_box_filter_is_the_cumsum_form(radius):
    x = np.random.default_rng(radius).uniform(size=(37, 53))
    got = TS._box_filter(torch.as_tensor(x), radius)
    np.testing.assert_allclose(got.numpy(), _cumsum_box(torch.as_tensor(x), radius).numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(JS._box_filter(jnp.asarray(x), radius)),
                               rtol=0, atol=1e-12)
    batch = torch.as_tensor(np.stack([x, 2 * x]))
    np.testing.assert_allclose(TS._box_filter(batch, radius)[1].numpy(), 2 * got.numpy(),
                               rtol=0, atol=1e-12)


def test_bilinear_sampling_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(30, 40))
    x = rng.uniform(-5, 45, 500)
    y = rng.uniform(-5, 35, 500)
    vj, ij = JS._bilinear_gray(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    vt, it = TS._bilinear_gray(torch.as_tensor(img), torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (~it.numpy()).sum() > 50                  # edge values outside the image too
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-12)


def test_sgm_aggregate_matches_jax():
    cost = np.random.default_rng(1).uniform(size=(23, 31, 9))
    got = TS.sgm_aggregate(torch.as_tensor(cost), 0.05, 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(JS.sgm_aggregate(jnp.asarray(cost),
                                                                       0.05, 0.4)),
                               rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def pair():
    """Two views of the textured terrain at 96x72 (a central 192x144 crop of
    the 200x150 renders, 2x2 block means), their intrinsics and ref->nbr."""
    def small(i):
        img = render_plane_image(ref_pose(i)).astype(np.float64)[3:147, 4:196] / 255.0
        return img.reshape(72, 2, 96, 2).mean(axis=(1, 3))

    focal = np.array([FOCAL / 2.0, FOCAL / 2.0])
    center = (np.array([SIZE[0] / 2.0 - 4.0, SIZE[1] / 2.0 - 3.0]) - 0.5) / 2.0
    wa, wb = jnp.asarray(ref_pose(1)), jnp.asarray(ref_pose(2))
    r2n = np.array(JP.pose_compose(wb, JP.pose_inverse(wa)))
    return small(1), small(2), focal, center, r2n


def _sweeps(pair, **kw):
    a, b, focal, center, r2n = pair
    rj = JS.plane_sweep(jnp.asarray(a), jnp.asarray(b), jnp.asarray(focal), jnp.asarray(center),
                        jnp.asarray(r2n), 1.0, 4.0, **kw)
    rt = TS.plane_sweep(torch.as_tensor(a), torch.as_tensor(b), focal, center, r2n, 1.0, 4.0,
                        **kw)
    return rj, rt


@pytest.mark.parametrize("aggregate", ["none", "sgm"])
def test_plane_sweep_matches_jax(pair, aggregate):
    rj, rt = _sweeps(pair, num_planes=16, aggregate=aggregate)
    vj = np.asarray(rj.valid)
    assert 0.3 * vj.size < vj.sum() < vj.size
    np.testing.assert_array_equal(rt.valid.numpy(), vj)
    np.testing.assert_allclose(rt.depth.numpy(), np.asarray(rj.depth), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.confidence.numpy(), np.asarray(rj.confidence), rtol=0,
                               atol=1e-9)


def test_left_right_check_and_cloud_match_jax(pair):
    a, b, focal, center, r2n = pair
    left_j, left_t = _sweeps(pair, num_planes=16)
    n2r = np.array(JP.pose_inverse(jnp.asarray(r2n)))
    right_j, right_t = _sweeps((b, a, focal, center, n2r), num_planes=16)
    cj = JS.left_right_check(left_j, right_j, jnp.asarray(focal), jnp.asarray(center),
                             jnp.asarray(r2n))
    ct = TS.left_right_check(left_t, right_t, focal, center, r2n)
    vj = np.asarray(cj.valid)
    assert 0 < vj.sum() < np.asarray(left_j.valid).sum()
    np.testing.assert_array_equal(ct.valid.numpy(), vj)
    np.testing.assert_allclose(ct.depth.numpy(), np.asarray(cj.depth), rtol=0, atol=1e-9)
    same = TS.StereoResult(*(torch.as_tensor(np.array(x)) for x in cj))
    for sub in (1, 2):
        pj = JS.stereo_pair_to_cloud(cj, focal, center, subsample=sub)
        np.testing.assert_array_equal(TS.stereo_pair_to_cloud(same, focal, center, sub), pj)
        pt = TS.stereo_pair_to_cloud(ct, focal, center, subsample=sub)
        assert pt.shape == pj.shape
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-9)
