"""Port parity for global SfM (``multiview_tpu_torch/sfm/global_sfm.py``) on
the graphs of tests/test_global_sfm.py: rings, collinear trajectories and
corrupted direction edges go through the JAX functions (CPU, x64) and their
counterparts in the port (``device="cpu"``, float64).

Bars: discrete outputs (kept-edge sets, judged masks, view-graph edges and
weights, registered masks) equal; averaged rotations within 1e-10; relative
rotations and directions of the view graph within 1e-8; edge scales within
1e-10; centres from full baseline vectors within 1e-8; poses of
``run_global_sfm`` within 1e-6 after fixing the gauge (first camera at the
identity, unit mean baseline), the JAX package's hypothesis draws handed to
the port. Direction-only ``position_estimation`` agrees within 1e-6 in that
gauge as well: the JAX package solves its Laplacian systems by conjugate
gradients to a relative residual of 1e-10, the port solves them directly, and
the scale of the raw centres differs by up to 3e-5 for that reason."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_global_sfm as ref_tests
from multiview_tpu.sfm import global_sfm as JG
from multiview_tpu_torch.geometry import pose as TP
from multiview_tpu_torch.sfm import global_sfm as TG
from multiview_tpu_torch.sfm import ransac as TR
from torch_port_scenes import jax_sampler, one_torch_thread, torch_view_graph

pytestmark = pytest.mark.usefixtures("one_torch_thread")

corrupt = ref_tests.TestDirectionOutlierFiltering._corrupt_directions


def _edges(graph):
    return np.asarray(graph.edges if not isinstance(graph.edges, torch.Tensor)
                      else graph.edges.numpy())


def _gauge(poses):
    """world->cam poses [V,7] as [V,3,4] matrices with the first camera at
    the identity and unit mean distance between consecutive centres."""
    p = torch.as_tensor(np.array(poses))
    p = TP.pose_compose(p, TP.pose_inverse(p[0]))
    c = TP.pose_t(TP.pose_inverse(p))
    s = torch.linalg.norm(c[1:] - c[:-1], dim=-1).mean()
    M = TP.pose_to_matrix(p)[:, :3].clone()
    M[:, :, 3] /= s
    return M.numpy()


def _unit_baseline(c):
    c = np.asarray(c)
    return c / np.linalg.norm(c[1:] - c[:-1], axis=-1).mean()


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_rotation_averaging_matches_jax(noise):
    graph, _, q_true, _ = ref_tests.make_graph(12, noise=noise)
    tg = torch_view_graph(graph)
    init_j = JG.spanning_tree_rotations(graph, 12)
    init_t = TG.spanning_tree_rotations(tg, 12)
    assert np.abs(init_j - init_t).max() < 1e-14
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    assert np.abs(JG.spanning_tree_rotations(graph, 12, rng=rng_j)
                  - TG.spanning_tree_rotations(tg, 12, rng=rng_t)).max() < 1e-14
    qj = JG.rotation_averaging(graph, 12)
    qt = TG.rotation_averaging(tg, 12)
    assert np.abs(np.asarray(qj) - qt.numpy()).max() < 1e-10
    errs = ref_tests.rot_errors_deg(jnp.asarray(qt.numpy()), q_true)
    assert errs.max() < (1e-6 if noise == 0.0 else 1.5)


def test_robust_rotation_averaging_keeps_the_same_edges():
    graph, _, q_true, _ = ref_tests.make_graph(14, noise=0.005, outlier_frac=0.15, seed=3)
    qj, fj = JG.robust_rotation_averaging(graph, 14)
    qt, ft = TG.robust_rotation_averaging(torch_view_graph(graph), 14)
    assert np.array_equal(_edges(fj), _edges(ft))
    assert _edges(ft).shape[0] < _edges(graph).shape[0]
    assert np.abs(np.asarray(qj) - qt.numpy()).max() < 1e-10
    for a, b in ((fj.rel_rot, ft.rel_rot), (fj.rel_dir, ft.rel_dir), (fj.weight, ft.weight)):
        assert np.array_equal(np.asarray(a), b.numpy())
    f10j = JG.filter_graph_by_rotation(graph, qj, 10.0)
    f10t = TG.filter_graph_by_rotation(torch_view_graph(graph), qt, 10.0)
    assert np.array_equal(_edges(f10j), _edges(f10t))


def test_rotation_filter_that_disconnects_keeps_the_unfiltered_graph(monkeypatch):
    """The port alone: when dropping the inconsistent edges leaves a view
    without a path to the rest, the unfiltered graph comes back with the
    multi-tree solution (the JAX package returns the disconnected graph
    there, a known fault of it)."""
    graph, _, q_true, _ = ref_tests.make_graph(10, noise=0.005)
    tg = torch_view_graph(graph)
    cut = np.nonzero((_edges(tg) != 9).all(axis=1))[0]          # strands view 9
    monkeypatch.setattr(TG, "filter_graph_by_rotation",
                        lambda g, q, max_deg=10.0: TG._subgraph(g, cut))
    q, out = TG.robust_rotation_averaging(tg, 10)
    assert np.array_equal(_edges(out), _edges(tg))
    assert ref_tests.rot_errors_deg(jnp.asarray(q.numpy()), q_true).max() < 1.5
    q_all, _ = TG._rotation_averaging_multi(
        tg.edges, tg.rel_rot, tg.weight,
        torch.as_tensor(TG.spanning_tree_rotations(tg, 10))[None], 10, 30, 0.1)
    assert torch.allclose(q, q_all[0], atol=1e-12)


def test_triplet_filter_keeps_the_same_edges():
    graph, *_ = ref_tests.make_graph(16, noise=0.005, overlap=4)
    bad_graph, bad = corrupt(graph, 0.18)
    fj, kj, jj = JG.filter_directions_triplet(bad_graph, return_judged=True)
    ft, kt, jt = TG.filter_directions_triplet(torch_view_graph(bad_graph), return_judged=True)
    assert np.array_equal(kj, kt) and np.array_equal(jj, jt)
    assert np.array_equal(_edges(fj), _edges(ft))
    assert (~kt[bad]).mean() >= 0.9 and kt[~bad].mean() >= 0.85
    kj2 = JG.filter_directions_triplet(bad_graph)[1]
    assert np.array_equal(kj2, TG.filter_directions_triplet(torch_view_graph(bad_graph))[1])


def _triangle_free_graph():
    V = 16
    ctr = np.stack([np.arange(V, dtype=float), np.sin(np.arange(V) * 0.7),
                    np.cos(np.arange(V) * 0.5)], 1)
    edges, dirs = [], []
    for i in range(V):
        for gap in (2, 3, 8):
            if i + gap < V:
                d = ctr[i + gap] - ctr[i]
                edges.append((i, i + gap))
                dirs.append(d / np.linalg.norm(d) * (-1.0 if gap == 8 and i % 3 == 0 else 1.0))
    E = len(edges)
    return JG.ViewGraph(jnp.asarray(np.asarray(edges, np.int32)),
                        jnp.tile(jnp.asarray([0.0, 0, 0, 1]), (E, 1)),
                        jnp.asarray(np.stack(dirs)), jnp.ones(E) * 100), ctr


def _filter_cases():
    clean, *_ = ref_tests.make_graph(12, noise=0.01)
    rich, *_ = ref_tests.make_graph(24, noise=0.005, overlap=6)
    cycle, *_ = ref_tests.make_graph(8, noise=0.0, overlap=1)
    return {"clean": (clean, {}),
            "corrupted": (corrupt(rich, 0.18)[0], {}),
            "triangle_free": (_triangle_free_graph()[0], {}),
            "bare_cycle": (corrupt(cycle, 0.5, seed=2, reversals_only=True)[0],
                           {"threshold": 0.01}),
            "only": (corrupt(rich, 0.18)[0],
                     {"threshold": 0.45, "only": np.arange(_edges(rich).shape[0]) % 3 == 0})}


@pytest.mark.parametrize("case", ["clean", "corrupted", "triangle_free", "bare_cycle", "only"])
def test_1dsfm_filter_keeps_the_same_edges(case):
    graph, kw = _filter_cases()[case]
    fj, kj = JG.filter_directions_1dsfm(graph, **kw)
    ft, kt = TG.filter_directions_1dsfm(torch_view_graph(graph), **kw)
    assert np.array_equal(kj, kt)
    assert np.array_equal(_edges(fj), _edges(ft))
    assert np.array_equal(np.asarray(fj.rel_dir), ft.rel_dir.numpy())


@pytest.mark.parametrize("case", ["exact", "noisy", "after_filters", "triangle_free"])
def test_position_estimation_matches_jax(case):
    if case == "triangle_free":
        graph, ctr = _triangle_free_graph()
        graph, _ = JG.filter_directions_1dsfm(graph)
        n = 16
    else:
        n = 24 if case == "after_filters" else 12
        graph, _, _, ctr = ref_tests.make_graph(
            n, noise={"exact": 0.0, "noisy": 0.01, "after_filters": 0.005}[case],
            overlap=6 if case == "after_filters" else 3)
        if case == "after_filters":
            graph, _ = JG.filter_directions_triplet(corrupt(graph, 0.18)[0])
            graph, _ = JG.filter_directions_1dsfm(graph)
    cj = JG.position_estimation(graph, None, n)
    ct = TG.position_estimation(torch_view_graph(graph), None, n)
    assert np.abs(np.asarray(cj) - ct.numpy()).max() < 1e-4
    assert np.abs(_unit_baseline(cj) - _unit_baseline(ct.numpy())).max() < 1e-6
    if case == "exact":
        c = ct.numpy()
        s = np.linalg.norm(ctr[1] - ctr[0]) / np.linalg.norm(c[1] - c[0])
        assert np.abs(s * (c - c[0]) - (ctr - ctr[0])).max() < 1e-8


def _pairs(case):
    if case == "collinear":
        return ref_tests.TestCollinearTrajectories._collinear_pair_data()
    if case == "nonuniform":
        return ref_tests.TestCollinearTrajectories._collinear_pair_data(
            step=np.array([0.0, 0.2, 1.0, 1.2, 2.4, 2.6]))
    from multiview_tpu.geometry import pose as P
    from multiview_tpu.utils import synthetic as syn
    rng = np.random.default_rng(7)
    n_views = 8
    w2c = syn.ring_poses(n_views, radius=3.0)
    pts = syn.cube_points(5) * 2.0
    pair_data = {}
    for i in range(n_views):
        for j in (i + 1, i + 2):
            if j >= n_views or (case == "two_components" and (i < 5) != (j < 5)):
                continue
            Xi = np.asarray(P.pose_apply(jnp.asarray(w2c[i]), jnp.asarray(pts)))
            Xj = np.asarray(P.pose_apply(jnp.asarray(w2c[j]), jnp.asarray(pts)))
            vis = (Xi[:, 2] > 0.1) & (Xj[:, 2] > 0.1)
            noise = 5e-4 if case == "noisy_ring" else 0.0
            if vis.sum() >= 16:
                pair_data[(i, j)] = (
                    Xi[vis, :2] / Xi[vis, 2:] + rng.normal(size=(vis.sum(), 2)) * noise,
                    Xj[vis, :2] / Xj[vis, 2:] + rng.normal(size=(vis.sum(), 2)) * noise)
    if case == "two_components":
        # a bridge below the 8-match gate: connected pair_data, disconnected graph
        pair_data[(4, 5)] = (rng.uniform(-0.5, 0.5, (4, 2)), rng.uniform(-0.5, 0.5, (4, 2)))
    return w2c, pair_data, None


def test_view_graph_edge_scales_and_scaled_positions_match_jax(monkeypatch):
    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    w2c, pair_data, pair_pids = _pairs("nonuniform")
    gj, rj = JG.view_graph_from_matches(pair_data, len(w2c), pair_pids=pair_pids)
    gt, rt = TG.view_graph_from_matches(pair_data, len(w2c), pair_pids=pair_pids, device="cpu")
    assert np.array_equal(_edges(gj), _edges(gt)) and len(_edges(gt)) == len(pair_data)
    assert np.array_equal(np.asarray(gj.weight), gt.weight.numpy())
    assert np.abs(np.asarray(gj.rel_rot) - gt.rel_rot.numpy()).max() < 1e-8
    assert np.abs(np.asarray(gj.rel_dir) - gt.rel_dir.numpy()).max() < 1e-8
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        assert a.keys() == b.keys()
        for v in a:
            assert a[v].keys() == b[v].keys()
            assert all(abs(a[v][p] - b[v][p]) < 1e-8 for p in a[v])
    assert np.array_equal(JG.largest_component_views(pair_data, len(w2c)),
                          TG.largest_component_views(pair_data, len(w2c)))
    sj, st = JG.edge_scales_from_ranges(gj, rj), TG.edge_scales_from_ranges(gt, rt)
    assert np.abs(sj - st).max() < 1e-10 and sj.max() / sj.min() > 2.0
    qj = JG.rotation_averaging(gj, len(w2c))
    wj, wt = JG.rel_dir_to_world(gj, qj), TG.rel_dir_to_world(gt, torch.as_tensor(np.array(qj)))
    assert np.abs(np.asarray(wj.rel_dir) - wt.rel_dir.numpy()).max() < 1e-8
    cj = JG.position_estimation_with_scales(wj, sj / sj.mean())
    ct = TG.position_estimation_with_scales(wt, sj / sj.mean())
    assert np.abs(np.asarray(cj) - ct.numpy()).max() < 1e-8


def test_edge_scales_from_ranges_known_ratio():
    graph = TG.make_view_graph([[0, 1], [1, 2]], np.tile([0.0, 0, 0, 1.0], (2, 1)),
                               [[1.0, 0, 0], [1.0, 0, 0]], np.ones(2), device="cpu")
    ranges = [{0: {}, 1: {10: 2.0, 11: 4.0, 12: 6.0}}, {1: {10: 1.0, 11: 2.0, 12: 3.0}, 2: {}}]
    s = TG.edge_scales_from_ranges(graph, ranges)
    np.testing.assert_allclose(s[1] / s[0], 2.0, rtol=1e-6)
    np.testing.assert_allclose(s, JG.edge_scales_from_ranges(None, ranges), rtol=1e-12)


@pytest.mark.parametrize("case", ["collinear", "noisy_ring", "two_components"])
def test_run_global_sfm_matches_jax(case, monkeypatch):
    monkeypatch.setattr(TR, "sample_hypotheses", jax_sampler)
    w2c, pair_data, pair_pids = _pairs(case)
    pj, mj = JG.run_global_sfm(pair_data, len(w2c), pair_pids=pair_pids, return_mask=True)
    pt, mt = TG.run_global_sfm(pair_data, len(w2c), pair_pids=pair_pids, return_mask=True,
                               device="cpu")
    assert np.array_equal(mj, mt)
    assert mt.tolist() == ([True] * 5 + [False] * 3 if case == "two_components"
                           else [True] * len(w2c))
    pj, pt = np.asarray(pj), pt.numpy()
    assert np.array_equal(pj[~mj], pt[~mt])                # identity poses
    assert np.abs(_gauge(pj[mj]) - _gauge(pt[mt])).max() < 1e-6
    # and against the truth, in that gauge (tests/test_global_sfm.py holds the
    # JAX package to an ATE of 0.02 to 0.1 after a similarity alignment)
    est, true = _gauge(pt[mt]), _gauge(np.asarray(w2c)[mt])
    assert np.abs(est - true).max() < 0.1


def test_global_poses_matches_jax():
    graph, *_ = ref_tests.make_graph(12, noise=0.01)
    pj = JG.global_poses(graph, 12)
    pt = TG.global_poses(torch_view_graph(graph), 12)
    assert np.abs(_gauge(pj) - _gauge(pt.numpy())).max() < 1e-6
