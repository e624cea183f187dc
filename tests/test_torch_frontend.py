"""Port parity: the SfM front end of multiview_tpu_torch against the JAX
package — DoG features on rendered frames, affine RANSAC with the JAX
package's own hypothesis draws, track building, and the batched pair
matcher.

Feature tolerances (measured, both in float32): keypoint xy within 1e-4 px
on at least 99% of the valid slots. The two frameworks sum the separable
Gaussian blur in different orders (2e-7 apart), which the sub-pixel fit
amplifies to up to 3e-4 px on a few keypoints; a shifted sample now and
then crosses an orientation or spatial bin of the descriptor (a discrete
jump), so end to end descriptors agree within 1e-3 on 93% of the slots
(94.4% measured), and to 1e-6 in the median. Given the JAX package's
pyramid the rest of the chain is held tighter, down to every slot (see
test_description_matches_jax_given_its_pyramid)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_tpu.sfm import features as JF, pipeline as JPl, ransac as JR, tracks as JTr
from multiview_tpu_torch.sfm import features as TF, pipeline as TPl, ransac as TR
from multiview_tpu_torch.sfm import tracks as TTr
from torch_port_scenes import jax_sampler, ref_pose, render_plane_image


@pytest.fixture(scope="module")
def frames():
    return [render_plane_image(ref_pose(i)).astype(np.float32) / 255.0 for i in range(3)]


def test_features_match_jax_on_rendered_frames(frames):
    xy_ok, desc_ok, n_valid, med = 0, 0, 0, []
    for img in frames:
        kj, dj = JF.detect_and_describe_dynamic(jnp.asarray(img), max_features=300)
        kp, d = TF.detect_and_describe_dynamic(torch.as_tensor(img), max_features=300)
        vj = np.asarray(kj.valid)
        np.testing.assert_array_equal(kp.valid.numpy(), vj)
        xe = np.abs(np.asarray(kj.xy) - kp.xy.numpy()).max(-1)[vj]
        de = np.abs(np.asarray(dj) - d.numpy()).max(-1)[vj]
        n_valid += vj.sum()
        xy_ok += (xe < 1e-4).sum()
        desc_ok += ((xe < 1e-4) & (de < 1e-3)).sum()
        med.append(np.median(de))
        # invalid rows are zeroed in both
        assert not d.numpy()[~vj].any()
    assert n_valid > 500
    assert xy_ok >= 0.99 * n_valid, (xy_ok, n_valid)
    assert desc_ok >= 0.93 * n_valid, (desc_ok, n_valid)
    assert max(med) < 1e-6


def _jax_atan2(y, x):
    return torch.as_tensor(np.asarray(jnp.arctan2(jnp.asarray(y.numpy()), jnp.asarray(x.numpy()))))


def _jax_resample(patches, pcx, pcy, step, m):
    return torch.as_tensor(np.asarray(JF._resample(
        *(jnp.asarray(a.numpy()) for a in (patches, pcx, pcy, step)), m)))


def test_description_matches_jax_given_its_pyramid(frames, monkeypatch):
    """Locates the end-to-end descriptor differences in the blur. Given the
    JAX package's DoG maps, the port selects bitwise the same keypoints.
    Given its pyramid and keypoints, the port's orientations are identical
    and its descriptors agree within 1e-3 on at least 99% of the slots. The
    exceptions are one-ulp differences at a sample whose gradient angle sits
    on an orientation-bin edge, from two sources: the float32 summation
    order of the bilinear resample (a matmul), and XLA's float32 atan2, which
    is not correctly rounded (the port rounds a float64 atan2). With those
    two taken from the JAX package, every slot agrees within 1e-6."""
    th, mf, mr = 0.015, 30, 5          # detect_and_describe_dynamic's defaults at 300
    shared, exact, n_valid = 0, [], 0
    for img in frames:
        bases, sc, ce = jax.jit(JF.detect_scores, static_argnums=(1, 2, 3, 4, 5, 6, 7, 8))(
            jnp.asarray(img), 3, 4, 1.6, th, 10.0, "sift", mf, mr)
        xy, scale, resp, valid = JF.select_keypoints(sc, ce, 3, 1.6, 300)
        valid = JF._adaptive_valid(resp, valid, th, mf, mr)
        v = np.asarray(valid)
        sel = TF.select_keypoints([torch.as_tensor(np.array(s))[None] for s in sc],
                                  [torch.as_tensor(np.array(c))[None] for c in ce], 3, 1.6, 300)
        np.testing.assert_array_equal(TF.adaptive_valid(sel[2], sel[3], th, mf, mr)[0], v)
        for a, b in zip(sel[:3], (xy, scale, resp)):
            np.testing.assert_array_equal(a[0].numpy()[v], np.asarray(b)[v])
        kj, dj = JF.describe_keypoints(bases, xy, scale, resp, valid, 1.6, "sift")
        args = ([torch.as_tensor(np.array(b)) for b in bases],
                *(torch.as_tensor(np.array(a)) for a in (xy, scale, resp, valid)))
        kp, d = TF.describe_keypoints(*args, 1.6)
        np.testing.assert_array_equal(kp.angle.numpy()[v], np.asarray(kj.angle)[v])
        shared += (np.abs(np.asarray(dj) - d.numpy()).max(-1)[v] < 1e-3).sum()
        n_valid += v.sum()
        with monkeypatch.context() as m:
            m.setattr(TF, "_resample", _jax_resample)
            m.setattr(TF, "_atan2", _jax_atan2)
            _, d = TF.describe_keypoints(*args, 1.6)
        exact.append(np.abs(np.asarray(dj) - d.numpy())[v].max())
    assert shared >= 0.99 * n_valid, (shared, n_valid)
    assert max(exact) < 1e-6, exact


def _affine_problem(seed, n=200, n_bad=60):
    rng = np.random.default_rng(seed)
    A = np.array([[1.1, -0.2, 30.0], [0.15, 0.9, -12.0]])
    src = rng.uniform(0, 500, size=(n, 2)).astype(np.float32)
    dst = (src @ A[:, :2].T + A[:, 2]).astype(np.float32)
    dst += rng.normal(scale=2.0, size=dst.shape).astype(np.float32)
    bad = rng.choice(n, n_bad, replace=False)
    dst[bad] += rng.uniform(15, 400, size=(n_bad, 2)).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("seed", [5, 1003])
def test_ransac_with_jax_draws_gives_identical_inliers(seed, monkeypatch):
    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    src, dst = _affine_problem(seed)
    ref = JR.ransac_affine2d(jnp.asarray(src), jnp.asarray(dst), threshold=20.0,
                             key=jax.random.PRNGKey(seed))
    ours = TR.ransac_affine2d(torch.as_tensor(src), torch.as_tensor(dst), threshold=20.0,
                              seed=seed)
    np.testing.assert_array_equal(ours.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(ours.model.numpy(), np.asarray(ref.model), rtol=1e-4, atol=1e-3)


def test_batched_ransac_with_valid_mask_matches_jax():
    """The batched path: padded match sets with validity masks, one pair
    per leading row, hypotheses drawn among the valid rows."""
    srcs, dsts, valids, samples, refs = [], [], [], [], []
    for p, seed in enumerate((11, 12, 13)):
        src, dst = _affine_problem(seed)
        valid = np.random.default_rng(seed).uniform(size=len(src)) > 0.25
        samples.append(jax_sampler(torch.as_tensor(valid), 512, seed))
        refs.append(JR.ransac_affine2d(jnp.asarray(src), jnp.asarray(dst),
                                       valid=jnp.asarray(valid), threshold=20.0,
                                       key=jax.random.PRNGKey(seed)))
        srcs.append(src)
        dsts.append(dst)
        valids.append(valid)
    ours = TR.ransac_affine2d(torch.as_tensor(np.stack(srcs)), torch.as_tensor(np.stack(dsts)),
                              valid=torch.as_tensor(np.stack(valids)), threshold=20.0,
                              samples=torch.stack(samples))
    for p, ref in enumerate(refs):
        np.testing.assert_array_equal(ours.inliers[p].numpy(), np.asarray(ref.inliers))


def test_tracks_from_identical_matches_are_identical():
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 200, size=(5, 80, 2)).round(2)   # 5 images, 80 features each
    pair_matches = {}
    for i in range(5):
        for j in range(i + 1, min(i + 3, 5)):
            sel = rng.choice(80, 50, replace=False)
            sel2 = sel.copy()
            sel2[:3] = rng.choice(80, 3)                       # some conflicting links
            pair_matches[(i, j)] = (pts[i][sel], pts[j][sel2])
    ours = TTr.build_tracks(pair_matches, 5)
    ref = JTr.build_tracks(pair_matches, 5)
    assert ours.tracks == ref.tracks and len(ours.tracks) > 20
    for a, b in zip(ours.keypoints, ref.keypoints):
        np.testing.assert_array_equal(a, b)


def test_batched_pair_matching_matches_jax(frames, monkeypatch):
    """The matcher path the card runs (match_pairs_batched: padded [P,K]
    match sets, hypotheses drawn among the valid rows) against the JAX
    package's match_pairs_batched on the same detected features, with the
    JAX package's RANSAC draws: identical inlier correspondences per pair."""
    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    cfg = JPl.FrontendConfig(max_features=300)
    kj, dj = JPl.detect_all(frames, cfg)
    pairs = [(0, 1), (0, 2), (1, 2)]
    ref = JPl.match_pairs_batched(kj, dj, pairs, cfg)
    kps = [TF.Keypoints(*(torch.as_tensor(np.asarray(a)) for a in k)) for k in kj]
    descs = [torch.as_tensor(np.asarray(d)) for d in dj]
    ours = TPl.match_pairs_batched(kps, descs, pairs, TPl.FrontendConfig(max_features=300))
    for p in pairs:
        assert len(ref[p][0]) > 20
        for a, b in zip(ours[p], ref[p]):
            np.testing.assert_array_equal(a, b)


def test_batched_pair_matching_equals_per_pair_matching(frames):
    """On the CPU the batched path (the CUDA path's structure: padded match
    sets, hypotheses drawn among valid rows) and the per-pair path (compacted
    matches) keep the same inlier matches, up to 2% from their different
    hypothesis draws."""
    cfg = TPl.FrontendConfig(max_features=300)
    kps, descs = TPl.detect_all(frames, cfg, device="cpu")
    pairs = [(0, 1), (0, 2), (1, 2)]
    batched = TPl.match_pairs_batched(kps, descs, pairs, cfg)
    for i, j in pairs:
        per_pair = TPl.match_pair(kps[i], descs[i], kps[j], descs[j], cfg, seed=i * 1000 + j)
        assert len(per_pair[0]) > 20
        a = {tuple(r) for r in np.concatenate(batched[(i, j)], axis=1).tolist()}
        b = {tuple(r) for r in np.concatenate(per_pair, axis=1).tolist()}
        assert len(a ^ b) <= 0.02 * len(b)
