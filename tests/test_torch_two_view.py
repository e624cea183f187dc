"""Port parity for the two-view and absolute-pose estimators, the batched
triangulation and the track helpers of the ``sfm-init`` slice.

The same inputs, made from a seed with numpy, go through the JAX functions
(CPU, x64) and their counterparts in the port (CPU tensors, float64), with
the JAX package's own hypothesis draws handed to the port through
``samples=``. Bars: inlier masks and counts equal; rotations, translations
and PnP poses within 1e-8; models up to the sign of their null vector within
1e-8; triangulated points within 1e-10; the track helpers exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.geometry import triangulation as JTri
from multiview_tpu.sfm import ransac as JR
from multiview_tpu.sfm import tracks as JT
from multiview_tpu_torch.geometry import pose as TP
from multiview_tpu_torch.geometry import triangulation as TTri
from multiview_tpu_torch.sfm import ransac as TR
from multiview_tpu_torch.sfm import tracks as TT
from torch_port_scenes import jax_sampler, one_torch_thread, two_view_scene

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-8


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _up_to_sign(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_essential_and_decomposition_match_jax(seed):
    x1, x2, valid = two_view_scene(seed)
    rj = JR.ransac_essential(jnp.asarray(x1), jnp.asarray(x2), valid=jnp.asarray(valid))
    Rj, tj = JR.decompose_essential(rj.model, jnp.asarray(x1), jnp.asarray(x2), rj.inliers)
    samples = jax_sampler(_t(valid), 512, 1, size=8)
    rt = TR.ransac_essential(_t(x1), _t(x2), valid=_t(valid), samples=samples)
    Rt, tt = TR.decompose_essential(rt.model, _t(x1), _t(x2), rt.inliers)
    assert 90 < int(rj.num_inliers) == int(rt.num_inliers)
    assert np.array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    assert not rt.inliers.numpy()[~valid].any()
    assert _up_to_sign(rj.model, rt.model.numpy()) < TOL
    assert np.abs(np.asarray(Rj) - Rt.numpy()).max() < TOL
    assert np.abs(np.asarray(tj) - tt.numpy()).max() < TOL


@pytest.mark.parametrize("seed", [0, 2])
def test_ransac_homography_and_decomposition_match_jax(seed):
    x1, x2, valid = two_view_scene(seed, planar=True)
    rj = JR.ransac_homography(jnp.asarray(x1), jnp.asarray(x2), valid=jnp.asarray(valid),
                              threshold=1e-5)
    Rj, tj, nj = JR.decompose_homography(rj.model, jnp.asarray(x1), jnp.asarray(x2), rj.inliers)
    samples = jax_sampler(_t(valid), 512, 5, size=4)
    rt = TR.ransac_homography(_t(x1), _t(x2), valid=_t(valid), threshold=1e-5, samples=samples)
    Rt, tt, nt = TR.decompose_homography(rt.model, _t(x1), _t(x2), rt.inliers)
    assert 100 < int(rj.num_inliers) == int(rt.num_inliers)
    assert np.array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    scale = np.abs(np.asarray(rj.model)).max()
    assert _up_to_sign(rj.model, rt.model.numpy()) < TOL * scale
    for a, b in ((Rj, Rt), (tj, tt), (nj, nt)):
        assert np.abs(np.asarray(a) - b.numpy()).max() < TOL


def _homography_candidates(H):
    """The 8 (R, unit t) of the Faugeras-Lustman decomposition of H, in
    numpy: the candidate set both packages vote over (its order follows the
    SVD's signs)."""
    U, S, Vt = np.linalg.svd(H)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = S
    den = max(d1 * d1 - d3 * d3, 1e-12)
    a1 = np.sqrt(max(d1 * d1 - d2 * d2, 0.0) / den)
    a3 = np.sqrt(max(d2 * d2 - d3 * d3, 0.0) / den)
    cross = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    out = []
    for e1, e3 in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        st, c = e1 * e3 * cross / ((d1 + d3) * d2), (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
        out.append((np.array([[c, 0, -st], [0, 1, 0], [st, 0, c]]),
                    (d1 - d3) * np.array([e1 * a1, 0, -e3 * a3])))
        sp, c = e1 * e3 * cross / (abs(d1 - d3) * d2), (d1 * d3 - d2 * d2) / (abs(d1 - d3) * d2)
        out.append((np.array([[c, 0, sp], [0, -1, 0], [sp, 0, -c]]),
                    (d1 + d3) * np.array([e1 * a1, 0, e3 * a3])))
    return [(s * U @ Rp @ Vt, U @ tp / np.linalg.norm(U @ tp)) for Rp, tp in out]


@pytest.mark.parametrize("seed,spread,n_valid", [(6, 1.0, 2), (1, 3.0, 1)],
                         ids=["both_valid", "one_valid"])
def test_homography_decomposition_on_planar_pairs(seed, spread, n_valid):
    """The SVD-convention cases: on a planar pair seen over a narrow field
    (every point in front of both cameras under both physical
    decompositions) the cheirality vote ties, and which of the two each
    package returns follows its SVD's signs (on the card another library's);
    the port's must be one of the reference's two. Over a wide field one
    decomposition is valid and the two packages return it."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-spread, spread, (120, 2)), np.full((120, 1), 2.0)], 1)
    R = TP.quat_to_matrix(TP.quat_exp(torch.as_tensor(rng.normal(0, 0.1, 3)))).numpy()
    t = rng.normal(0, 0.3, 3)
    p2 = pts @ R.T + t
    x1, x2 = pts[:, :2] / pts[:, 2:], p2[:, :2] / p2[:, 2:]
    H = R + np.outer(t, [0.0, 0.0, 0.5])          # the plane z = 2 of the first camera
    inl = np.ones(len(x1), bool)
    cands = _homography_candidates(H)
    counts = [int(JR._cheirality_count(jnp.asarray(Rc), jnp.asarray(tc), jnp.asarray(x1),
                                       jnp.asarray(x2), jnp.asarray(inl))) for Rc, tc in cands]
    valid = []
    for (Rc, tc), c in zip(cands, counts):
        if c == max(counts) == len(x1) and not any(
                np.abs(Rc - a).max() < TOL and np.abs(tc - b).max() < TOL for a, b in valid):
            valid.append((Rc, tc))
    assert len(valid) == n_valid
    Rj, tj, _ = JR.decompose_homography(jnp.asarray(H), jnp.asarray(x1), jnp.asarray(x2),
                                        jnp.asarray(inl))
    Rt, tt, _ = TR.decompose_homography(_t(H), _t(x1), _t(x2), _t(inl))

    def which(Rx, tx):
        return [i for i, (a, b) in enumerate(valid)
                if np.abs(np.asarray(Rx) - a).max() < TOL and np.abs(np.asarray(tx) - b).max() < TOL]

    assert len(which(Rj, tj)) == 1 and len(which(Rt, tt)) == 1
    if n_valid == 1:
        assert which(Rt, tt) == which(Rj, tj)
        assert np.abs(Rt.numpy() - R).max() < TOL


@pytest.mark.parametrize("planar", [False, True], ids=["dlt", "planar"])
def test_ransac_pnp_matches_jax(planar):
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (200, 3))
    X[:, 2] = 5.0 + (0.1 * X[:, 0] if planar else X[:, 2])
    q = TP.quat_exp(_t([0.3, -0.2, 0.1]))
    R = TP.quat_to_matrix(q).numpy()
    t = np.array([0.4, -0.1, 0.6])
    Xc = X @ R.T + t
    x = Xc[:, :2] / Xc[:, 2:3]
    out = rng.random(200) < 0.3
    x[out] += rng.uniform(0.05, 0.3, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    rj = JR.ransac_pnp(jnp.asarray(X), jnp.asarray(x), threshold=2e-3)
    samples = jax_sampler(torch.ones(200, dtype=torch.bool), 512, 2, size=6)
    rt = TR.ransac_pnp(_t(X), _t(x), threshold=2e-3, samples=samples)
    assert int(rt.num_inliers) == int(rj.num_inliers) >= 0.9 * (200 - out.sum())
    assert np.array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    assert np.abs(np.asarray(rj.pose) - rt.pose.numpy()).max() < TOL
    assert np.abs(rt.pose.numpy()[:3] - t).max() < 1e-3


def test_short_inputs_return_the_identity_model_as_jax_does():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 2))
    for fj, ft, kw in ((JR.ransac_essential, TR.ransac_essential, {}),
                       (JR.ransac_homography, TR.ransac_homography, {})):
        rj, rt = fj(jnp.asarray(x), jnp.asarray(x)), ft(_t(x), _t(x))
        assert np.array_equal(np.asarray(rj.model), rt.model.numpy())
        assert int(rt.num_inliers) == int(rj.num_inliers) == 0 and not rt.inliers.any()
    X = rng.normal(size=(5, 3))
    rj, rt = JR.ransac_pnp(jnp.asarray(X), jnp.asarray(X[:, :2])), TR.ransac_pnp(_t(X), _t(X[:, :2]))
    assert np.array_equal(np.asarray(rj.pose), rt.pose.numpy()) and int(rt.num_inliers) == 0


def test_batched_two_view_ransacs_equal_the_single_calls():
    """Leading dimensions are independent point sets: a batch of two pairs
    gives what the two single calls give, decompositions included."""
    scenes = [two_view_scene(4), two_view_scene(5, planar=True)]
    x1 = _t(np.stack([s[0] for s in scenes]))
    x2 = _t(np.stack([s[1] for s in scenes]))
    valid = _t(np.stack([s[2] for s in scenes]))
    for fit, dec, size, seed in ((TR.ransac_essential, TR.decompose_essential, 8, 1),
                                 (TR.ransac_homography, TR.decompose_homography, 4, 5)):
        samples = TR.sample_hypotheses(valid, 256, seed, size=size)
        assert samples.shape == (2, 256, size)
        assert bool(torch.gather(valid, 1, samples.reshape(2, -1)).all())
        res = fit(x1, x2, valid=valid, samples=samples)
        outs = dec(res.model, x1, x2, res.inliers)
        for b in range(2):
            one = fit(x1[b], x2[b], valid=valid[b], samples=samples[b])
            assert torch.equal(one.inliers, res.inliers[b])
            assert int(one.num_inliers) == int(res.num_inliers[b]) > 60
            for a, c in zip(dec(one.model, x1[b], x2[b], one.inliers), outs):
                assert torch.allclose(a, c[b], atol=1e-9)
    assert torch.equal(TR.sample_hypotheses(valid[0], 64, 7, size=6),
                       TR.sample_hypotheses(valid[0], 64, 7, size=6))


def test_triangulate_tracks_matches_jax():
    rng = np.random.default_rng(2)
    T, V = 40, 5
    poses = np.concatenate([rng.normal(0, 0.2, (V, 3)) + [0, 0, 4.0],
                            TP.quat_exp(_t(rng.normal(0, 0.1, (V, 3)))).numpy()], 1)
    pts = rng.uniform(-1, 1, (T, 3))
    focal = np.full(V, 300.0)
    Pj = JTri.projection_matrix(jnp.asarray(focal), jnp.asarray(poses))
    Pt = TTri.projection_matrix(_t(focal), _t(poses))
    assert np.abs(np.asarray(Pj) - Pt.numpy()).max() < 1e-12
    Xc = np.einsum("vij,tj->tvi", np.asarray(Pj)[:, :, :3], pts) + np.asarray(Pj)[None, :, :, 3]
    pix = Xc[..., :2] / Xc[..., 2:] + rng.normal(0, 0.3, (T, V, 2))
    mask = rng.random((T, V)) < 0.7
    mask[0] = False                                       # a track with no view
    mask[1] = [True, False, False, False, False]          # and one with a single view
    Pj_t = jnp.broadcast_to(Pj[None], (T, V, 3, 4))
    xj, dj, vj = JTri.triangulate_tracks(Pj_t, jnp.asarray(pix), jnp.asarray(mask), 3)
    xt, dt, vt = TTri.triangulate_tracks(Pt.expand(T, V, 3, 4), _t(pix), _t(mask), 3)
    ok = np.asarray(vj)
    assert np.array_equal(ok, vt.numpy()) and not ok[0] and not ok[1] and ok.sum() > 30
    assert np.abs(np.asarray(xj)[ok] - xt.numpy()[ok]).max() < 1e-10
    assert np.abs(np.asarray(dj)[ok] - dt.numpy()[ok]).max() < 1e-10


def test_tracks_to_arrays_and_subset_views_exact():
    rng = np.random.default_rng(1)
    kps = [rng.uniform(0, 100, (6, 2)) for _ in range(4)]
    tracks = [{0: 1, 1: 2, 3: 0}, {1: 0, 2: 5}, {0: 3, 2: 2, 3: 4}, {2: 1, 3: 3}]
    tj, tt = JT.TrackSet(kps, tracks), TT.TrackSet(kps, tracks)
    for a, b in zip(JT.tracks_to_arrays(tj), TT.tracks_to_arrays(tt)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sj, st = JT.subset_views(tj, [0, 2, 3]), TT.subset_views(tt, [0, 2, 3])
    assert sj.tracks == st.tracks == [{0: 1, 2: 0}, {0: 3, 1: 2, 2: 4}, {1: 1, 2: 3}]
    assert all(np.array_equal(a, b) for a, b in zip(sj.keypoints, st.keypoints))
