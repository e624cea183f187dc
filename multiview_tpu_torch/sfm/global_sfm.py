"""Global SfM pose initialization: rotation averaging + position estimation.
Port of ``multiview_tpu/sfm/global_sfm.py`` (the role of TheiaSfM's global
pipeline as the reference pins it, theia_flags.txt:26-165: robust rotation
averaging, then least-unsquared-deviation position estimation).

- two-view geometry: essential and homography RANSAC with their
  decompositions, all pairs of one padded match-count bucket as one batch on
  the device the caller names (``sfm/ransac.py``); model selection and the
  scale bookkeeping stay on the host, one device-to-host copy per bucket;
- rotation averaging: spanning-tree initialisation (host), then iteratively
  re-weighted Gauss-Newton in the tangent space with soft-L1 weights, all
  candidate trees as one batch of tensors;
- relative-translation filtering: triplet closure and 1DSfM projection
  consensus (host numpy, as in the reference);
- position estimation: the LUD alternation on the weighted graph Laplacian,
  or, with per-edge baseline scales from shared tracks, a robust fit of full
  baseline vectors. The Laplacian systems are solved directly (the reference
  runs conjugate gradients to a relative tolerance of 1e-10 on the same
  regularised system).

Convention: world->cam poses; an edge (i,j) carries the relative transform
cam_i -> cam_j: R_ij = R_j R_i^T, and the translation direction of the
camera-j centre seen from i in world coordinates.
"""

from __future__ import annotations

import collections
import os
import sys
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.utils.device import resolve_device
from multiview_tpu_torch.utils.padding import next_pow2, pad_rows_pow2

# elements of one [pairs, hypotheses, matches] scoring array: a bucket with
# more is run in several batches of pairs
_MAX_SCORE_ELEMENTS = 1 << 25


class ViewGraph(NamedTuple):
    """Pairwise relative rotations/directions between views (tensors on one
    device)."""

    edges: torch.Tensor     # [E,2] int64 (i,j)
    rel_rot: torch.Tensor   # [E,4] quaternion q_ij: R_ij = R_j R_i^T (xyzw)
    rel_dir: torch.Tensor   # [E,3] unit direction of (c_j - c_i) in WORLD frame
                            # (only used by position estimation; can be zeros)
    weight: torch.Tensor    # [E] edge confidence (e.g. inlier counts)


def make_view_graph(edges, rel_rot, rel_dir, weight, dtype=torch.float64,
                    device=None) -> ViewGraph:
    """A ViewGraph from host arrays, on ``device`` (the first CUDA card when
    None; pass ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
    return ViewGraph(
        torch.as_tensor(np.array(edges, np.int64).reshape(-1, 2), device=device),
        torch.as_tensor(np.array(rel_rot, np.float64), dtype=dtype, device=device),
        torch.as_tensor(np.array(rel_dir, np.float64), dtype=dtype, device=device),
        torch.as_tensor(np.array(weight, np.float64), dtype=dtype, device=device))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _subgraph(graph: ViewGraph, keep_idx: np.ndarray) -> ViewGraph:
    idx = torch.as_tensor(np.asarray(keep_idx, np.int64), device=graph.edges.device)
    return ViewGraph(graph.edges[idx], graph.rel_rot[idx], graph.rel_dir[idx],
                     graph.weight[idx])


def _quat_mul_np(a, b):
    """Hamilton product of two xyzw quaternions on the host."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz])


def spanning_tree_rotations(graph: ViewGraph, num_views: int,
                            rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Initial global rotations by composing relative rotations over a
    max-weight spanning tree (host-side traversal). With ``rng``, edge
    priorities are randomized (for multi-tree robust initialization)."""
    edges = _np(graph.edges)
    w = _np(graph.weight).astype(float)
    if rng is not None:
        w = w * rng.uniform(0.1, 1.0, size=w.shape)
    order = np.argsort(-w)
    adj = {}
    for e in order:
        i, j = int(edges[e, 0]), int(edges[e, 1])
        adj.setdefault(i, []).append((j, e, False))
        adj.setdefault(j, []).append((i, e, True))

    q = np.tile([0.0, 0.0, 0.0, 1.0], (num_views, 1))
    seen = np.zeros(num_views, bool)
    seen[0] = True
    stack = [0]
    rel = _np(graph.rel_rot).astype(float)
    conj = np.array([-1.0, -1.0, -1.0, 1.0])
    while stack:
        i = stack.pop()
        for j, e, flipped in adj.get(i, []):
            if seen[j]:
                continue
            seen[j] = True
            qij = rel[e] * conj if flipped else rel[e]
            q[j] = _quat_mul_np(qij, q[i])          # R_j = R_ij R_i
            stack.append(j)
    if not seen.all():
        raise ValueError("View graph is disconnected")
    return q


def _edge_residuals(edges, rel, q):
    """r_e = log(R_j^-1 R_ij R_i) for q [...,V,4] -> [...,E,3]."""
    qi = q[..., edges[:, 0], :]
    qj = q[..., edges[:, 1], :]
    return pose_mod.quat_log(
        pose_mod.quat_mul(pose_mod.quat_conj(qj), pose_mod.quat_mul(rel, qi)))


def _rotation_averaging_multi(edges, rel, base_w, inits, num_views: int,
                              iterations: int, loss_scale: float):
    """IRLS Gauss-Newton rotation averaging from every candidate
    initialisation at once: inits [T,V,4] -> (qs [T,V,4], scores [T]), the
    score being the median edge residual (immune to outliers)."""
    q = inits
    T = q.shape[0]
    i_idx, j_idx = edges[:, 0], edges[:, 1]
    with torch.no_grad():
        for _ in range(iterations):
            r = _edge_residuals(edges, rel, q)                       # [T,E,3]
            nrm = torch.linalg.norm(r, dim=-1)
            w = base_w / torch.sqrt(1.0 + (nrm / loss_scale) ** 2)   # soft-L1
            # normal equations for the per-view increments d: r_e ~ d_i - d_j
            # to first order, so minimize sum w |r + d_i - d_j|^2 with a few
            # Jacobi sweeps (diagonal = sum of the adjacent weights)
            denom = q.new_zeros((T, num_views))
            denom.index_add_(1, i_idx, w).index_add_(1, j_idx, w)
            denom = torch.clamp_min(denom, 1e-12)[..., None]
            wr = w[..., None] * r
            d = q.new_zeros((T, num_views, 3))
            for _ in range(12):
                rhs = q.new_zeros((T, num_views, 3))
                rhs.index_add_(1, i_idx, w[..., None] * d[:, j_idx] - wr)
                rhs.index_add_(1, j_idx, w[..., None] * d[:, i_idx] + wr)
                d = rhs / denom
                d[:, 0] = 0.0                                        # gauge: view 0 fixed
            q = pose_mod.quat_normalize(pose_mod.quat_mul(q, pose_mod.quat_exp(d)))
        # the median as numpy's: the mean of the two middle values of an even count
        scores = torch.quantile(torch.linalg.norm(_edge_residuals(edges, rel, q), dim=-1),
                                0.5, dim=-1)
    return q, scores


def rotation_averaging(graph: ViewGraph, num_views: int, iterations: int = 30,
                       loss_scale: float = 0.1, init: Optional[np.ndarray] = None
                       ) -> torch.Tensor:
    """Robust rotation averaging -> global quaternions [V,4] (view 0 pinned).

    IRLS Gauss-Newton in so(3): residual per edge r_e = log(R_j^T R_ij R_i),
    Jacobian wrt (w_i, w_j) approximated by (I, -I) near convergence, weights
    soft-L1 in |r|."""
    if init is None:
        init = spanning_tree_rotations(graph, num_views)
    dtype, device = graph.rel_rot.dtype, graph.rel_rot.device
    inits = torch.as_tensor(np.asarray(init, np.float64), dtype=dtype, device=device)[None]
    qs, _ = _rotation_averaging_multi(graph.edges, graph.rel_rot, graph.weight.to(dtype),
                                      inits, num_views, iterations, loss_scale)
    return qs[0]


def filter_graph_by_rotation(graph: ViewGraph, rotations: torch.Tensor,
                             max_deg: float = 10.0) -> ViewGraph:
    """Drop edges whose relative rotation disagrees with the global solution
    by more than max_deg (the role of Theia's view-pair filtering after
    rotation averaging)."""
    r = _edge_residuals(graph.edges, graph.rel_rot, rotations)
    err_deg = np.degrees(np.linalg.norm(_np(r), axis=-1))
    keep = err_deg <= max_deg
    if keep.sum() < len(keep):
        graph = _subgraph(graph, np.nonzero(keep)[0])
    return graph


def robust_rotation_averaging(graph: ViewGraph, num_views: int,
                              num_trees: int = 16, iterations: int = 30,
                              loss_scale: float = 0.1,
                              filter_deg: float = 15.0, seed: int = 0
                              ) -> Tuple[torch.Tensor, ViewGraph]:
    """Rotation averaging robust to outlier edges.

    A single outlier edge in the spanning-tree init poisons everything
    downstream of it, and the IRLS consensus then keeps the outlier (the
    inlier edges look wrong). So: try several randomized spanning trees, run
    the IRLS from each, keep the solution with the smallest median edge
    residual, then drop edges inconsistent with it and do a final averaging
    round. Returns (rotations, filtered graph). When the filtering leaves the
    graph disconnected, the unfiltered graph is returned with its solution."""
    rng = np.random.default_rng(seed)
    inits = np.stack([
        spanning_tree_rotations(graph, num_views, rng=None if k == 0 else rng)
        for k in range(num_trees)])
    dtype, device = graph.rel_rot.dtype, graph.rel_rot.device
    qs, scores = _rotation_averaging_multi(
        graph.edges, graph.rel_rot, graph.weight.to(dtype),
        torch.as_tensor(inits, dtype=dtype, device=device), num_views, iterations,
        loss_scale)
    scores = _np(scores)
    best = int(np.argmin(scores))
    best_q, best_score = qs[best], float(scores[best])

    filtered = filter_graph_by_rotation(graph, best_q, filter_deg)
    if filtered.edges.shape[0] < graph.edges.shape[0]:
        try:
            init = spanning_tree_rotations(filtered, num_views)
        except ValueError:
            return best_q, graph      # the filtering disconnected the graph
        q2, score2 = _rotation_averaging_multi(
            filtered.edges, filtered.rel_rot, filtered.weight.to(dtype),
            torch.as_tensor(init, dtype=dtype, device=device)[None], num_views,
            iterations, loss_scale)
        if float(score2[0]) <= best_score:
            best_q = q2[0]
    return best_q, filtered


def _eades_order(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 num_views: int) -> np.ndarray:
    """Greedy Eades-Lin-Smyth ordering minimizing backward-edge weight of a
    weighted directed graph (the minimum-feedback-arc-set heuristic 1DSfM
    uses per projection subproblem). Returns a permutation [V] of node ids
    in left-to-right order."""
    V = num_views
    out_w = np.zeros(V)
    in_w = np.zeros(V)
    np.add.at(out_w, src, w)
    np.add.at(in_w, dst, w)
    adj_out: list = [[] for _ in range(V)]
    adj_in: list = [[] for _ in range(V)]
    for s, t, ww in zip(src, dst, w):
        adj_out[s].append((t, ww))
        adj_in[t].append((s, ww))
    alive = np.ones(V, bool)
    head: list = []
    tail: list = []
    score = out_w - in_w
    for _ in range(V):
        sinks = np.nonzero(alive & (out_w <= 1e-12))[0]
        if sinks.size:
            v = int(sinks[0])
            tail.append(v)
        else:
            sources = np.nonzero(alive & (in_w <= 1e-12))[0]
            if sources.size:
                v = int(sources[0])
            else:
                v = int(np.argmax(np.where(alive, score, -np.inf)))
            head.append(v)
        alive[v] = False
        for t, ww in adj_out[v]:
            if alive[t]:
                in_w[t] -= ww
                score[t] = out_w[t] - in_w[t]
        for s, ww in adj_in[v]:
            if alive[s]:
                out_w[s] -= ww
                score[s] = out_w[s] - in_w[s]
    return np.asarray(head + tail[::-1], np.int64)


def _keep_if_connected(graph: ViewGraph, keep: np.ndarray,
                       quality: Optional[np.ndarray] = None
                       ) -> Tuple[ViewGraph, np.ndarray]:
    """Apply a keep mask, then repair it so no touched view is stranded and
    the kept subgraph stays one component: flagged edges are restored
    best-quality-first until both hold.

    quality: per-edge score, higher = restore first (default: edge weight)."""
    edges = _np(graph.edges)
    E = len(edges)
    if keep.all() or not keep.any():
        return graph, np.ones(E, bool)
    keep = keep.copy()
    q = _np(graph.weight).astype(float) if quality is None else np.asarray(quality, float)
    V = int(edges.max()) + 1
    touched = np.zeros(V, bool)
    touched[edges.reshape(-1)] = True

    # 1) stranded views: restore each one's best flagged edge
    deg = np.zeros(V, np.int64)
    np.add.at(deg, edges[keep].reshape(-1), 1)
    for v in np.nonzero(touched & (deg == 0))[0]:
        cand = np.nonzero(((edges[:, 0] == v) | (edges[:, 1] == v)) & ~keep)[0]
        best = cand[np.argmax(q[cand])]
        keep[best] = True
        deg[edges[best, 0]] += 1
        deg[edges[best, 1]] += 1

    # 2) connectivity: Kruskal-restore flagged edges (best first) until the
    # kept subgraph of touched views is one component
    parent = np.arange(V)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in edges[keep]:
        parent[find(int(i))] = find(int(j))
    n_comp = len({find(int(v)) for v in np.nonzero(touched)[0]})
    if n_comp > 1:
        for e in np.argsort(-q):
            if keep[e]:
                continue
            ri, rj = find(int(edges[e, 0])), find(int(edges[e, 1]))
            if ri != rj:
                parent[ri] = rj
                keep[e] = True
                n_comp -= 1
                if n_comp == 1:
                    break

    return _subgraph(graph, np.nonzero(keep)[0]), keep


def filter_directions_triplet(graph: ViewGraph, resid_tol: float = 0.05,
                              bad_frac: float = 0.5, min_tri: int = 2,
                              return_judged: bool = False):
    """Triplet-closure filtering of world-frame translation directions.

    Every triangle (a,b,c) of edges must admit positive scales x with
    x1 d_ab + x2 d_bc - x3 d_ac ~= 0 (the centres close the loop). The
    smallest-singular-vector solve of the 3x3 direction matrix gives the
    best closure: a triangle is inconsistent when its residual (smallest
    singular value) exceeds ``resid_tol`` or any scale is non-positive;
    reversed or random outlier directions fail the positivity test with a
    wide margin. Edges whose inconsistent-triangle fraction exceeds
    ``bad_frac`` (given >= ``min_tri`` triangles) are rejected.

    The sharper half of the reference recipe's relative-translation
    filtering (theia_flags.txt:93); ``filter_directions_1dsfm`` covers
    triangle-poor graphs. Returns (filtered graph, keep mask [E])."""
    edges = _np(graph.edges)
    d = _np(graph.rel_dir).astype(float)
    E = len(edges)
    if E == 0:
        return graph, np.ones(0, bool)
    emap = {}
    for e, (i, j) in enumerate(edges):
        emap[(int(i), int(j))] = e
    nbrs = collections.defaultdict(set)
    for i, j in edges:
        nbrs[int(i)].add(int(j))
        nbrs[int(j)].add(int(i))

    def get(i, j):
        if (i, j) in emap:
            return emap[(i, j)], 1.0
        return emap[(j, i)], -1.0

    tri_edges = []
    tri_mats = []
    seen = set()
    for (i, j) in emap:
        for k in (nbrs[i] & nbrs[j]):
            tri = tuple(sorted((i, j, k)))
            if tri in seen:
                continue
            seen.add(tri)
            a, b, c = tri
            e1, s1 = get(a, b)
            e2, s2 = get(b, c)
            e3, s3 = get(a, c)
            tri_edges.append((e1, e2, e3))
            tri_mats.append(np.stack([s1 * d[e1], s2 * d[e2], -s3 * d[e3]], axis=1))
    if not tri_mats:
        if return_judged:
            return graph, np.ones(E, bool), np.zeros(E, bool)
        return graph, np.ones(E, bool)
    M = np.stack(tri_mats)                       # [T,3,3]
    _, S, Vt = np.linalg.svd(M)                  # batched
    x = Vt[:, -1, :]                             # [T,3] null-ish vector
    x = np.where(x[:, 2:3] < 0, -x, x)
    ok = (S[:, -1] < resid_tol) & (x > 1e-6).all(axis=1)
    # near-collinear triangles are closure-degenerate (rank<2 direction
    # matrix: any sign pattern closes with positive scales): they carry
    # no information either way, so they vote in neither bad nor tot
    informative = S[:, 1] > 0.1
    te = np.asarray(tri_edges)                   # [T,3]

    # iterative explain-away attribution: a failing triangle containing an
    # already-marked edge is explained by it and votes against nobody else
    # (without this, every bad edge's failing triangles implicate two good
    # members each)
    fail = informative & ~ok
    passing = informative & ok
    marked = np.zeros(E, bool)
    frac = np.zeros(E)
    tot = np.zeros(E)
    for _ in range(4):
        mk = marked[te]                          # [T,3]
        bad = np.zeros(E)
        tot = np.zeros(E)
        for c in range(3):
            others = [i for i in range(3) if i != c]
            other_marked = mk[:, others].any(axis=1)
            vote_bad = fail & ~other_marked
            counted = passing | vote_bad
            np.add.at(bad, te[:, c], vote_bad.astype(float))
            np.add.at(tot, te[:, c], counted.astype(float))
        frac = bad / np.maximum(tot, 1e-12)
        new_marked = (tot >= min_tri) & (frac > bad_frac)
        if (new_marked == marked).all():
            break
        marked = new_marked
    keep = (tot < min_tri) | (frac <= bad_frac)
    # repair restores least-inconsistent edges first
    out_graph, out_keep = _keep_if_connected(graph, keep, quality=-frac)
    if return_judged:
        # judged = enough informative triangles to assess this edge
        return out_graph, out_keep, tot >= min_tri
    return out_graph, out_keep


def filter_directions_1dsfm(graph: ViewGraph, num_axes: int = 48,
                            threshold: float = 0.25, min_proj: float = 0.15,
                            seed: int = 0,
                            only: Optional[np.ndarray] = None
                            ) -> Tuple[ViewGraph, np.ndarray]:
    """1DSfM relative-translation outlier filtering (Wilson & Snavely,
    ECCV'14), the role of Theia's
    ``--filter_relative_translations_with_1dsfm=true`` in the pinned recipe
    (theia_flags.txt:93).

    World-frame pairwise directions are projected onto ``num_axes`` random
    unit axes (numpy's generator seeded with ``seed``); each projection
    induces a weighted ordering problem (edge i->j if d_e.u > 0, weight
    |d_e.u|) solved by the greedy minimum-feedback-arc heuristic; edges that
    land backward in the consensus ordering accumulate inconsistency weight.
    An edge whose weighted backward fraction exceeds ``threshold`` is
    rejected; ``only`` restricts removals to the edges it marks.

    Call after rotation averaging + ``rel_dir_to_world`` (directions must
    be in a common frame). Returns (filtered graph, keep mask [E])."""
    edges = _np(graph.edges)
    d = _np(graph.rel_dir).astype(float)
    E = len(edges)
    if E == 0:
        return graph, np.ones(0, bool)
    V = int(edges.max()) + 1
    rng = np.random.default_rng(seed)
    bad_acc = np.zeros(E)
    tot_acc = np.zeros(E)
    for _ in range(num_axes):
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        p = d @ u
        active = np.abs(p) > min_proj
        if int(active.sum()) < 2:
            continue
        src = np.where(p > 0, edges[:, 0], edges[:, 1])[active]
        dst = np.where(p > 0, edges[:, 1], edges[:, 0])[active]
        w = np.abs(p)[active]
        order = _eades_order(src, dst, w, V)
        pos = np.empty(V, np.int64)
        pos[order] = np.arange(V)
        back = (pos[dst] < pos[src]).astype(float)
        idx = np.nonzero(active)[0]
        bad_acc[idx] += w * back
        tot_acc[idx] += w
    frac = bad_acc / np.maximum(tot_acc, 1e-12)
    keep = frac <= threshold
    if only is not None:
        keep = keep | ~np.asarray(only, bool)
    # repair restores least-backward edges first
    return _keep_if_connected(graph, keep, quality=-frac)


def _masked_median(x, mask):
    """Upper median of x over mask (masked entries sort to +inf)."""
    v = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    n = mask.sum()
    return v[torch.clamp(n // 2, 0, x.shape[0] - 1)]


def _laplacian_solve(i_idx, j_idx, w, b, V: int):
    """Minimizer c [V,3] of sum_e w_e |c_j - c_i - b_e|^2 + 1e-9 |c|^2: the
    weighted graph-Laplacian system, solved directly."""
    L = w.new_zeros((V, V))
    L.index_put_((i_idx, i_idx), w, accumulate=True)
    L.index_put_((j_idx, j_idx), w, accumulate=True)
    L.index_put_((i_idx, j_idx), -w, accumulate=True)
    L.index_put_((j_idx, i_idx), -w, accumulate=True)
    L = L + 1e-9 * torch.eye(V, dtype=w.dtype, device=w.device)
    rhs = w.new_zeros((V, 3))
    rhs.index_add_(0, i_idx, -w[:, None] * b)
    rhs.index_add_(0, j_idx, w[:, None] * b)
    return torch.linalg.solve(L, rhs)


def position_estimation(graph: ViewGraph, rotations: torch.Tensor, num_views: int,
                        irls_rounds: int = 24, trim_stages: int = 0,
                        floor_frac: float = 0.1, k_scale: float = 2.0,
                        trim_at: float = 5.0) -> torch.Tensor:
    """Camera centres [V,3] from pairwise world-frame baseline directions:
    the LUD alternation (Ozyesil & Singer CVPR'15), the role of Theia's
    least-unsquared-deviation position estimator pinned by the reference
    recipe (theia_flags.txt:26-165).

    Alternate (a) per-edge scales s_e = max(<c_j - c_i, d_e>, floor) with a
    positive relative floor (an edge cannot invert or vanish), and (b) a
    robustly weighted graph-Laplacian least-squares solve for c with targets
    s_e d_e (soft-L1 weights scaled by the median residual per round).
    ``trim_stages`` outer stages permanently drop edges whose residual
    exceeds ``trim_at`` x median and re-converge (off by default: trimming
    guts sparse graphs). A final projected-eigenvector solve with hard-gated
    weights is accepted only if it does not worsen the robust objective.
    ``rotations`` is not read (directions are in the world frame already)."""
    edges = graph.edges
    d = graph.rel_dir
    base_w0 = graph.weight.to(d.dtype)
    V = num_views
    i_idx, j_idx = edges[:, 0], edges[:, 1]

    def solve(w, b):
        return _laplacian_solve(i_idx, j_idx, w, b, V)

    def scales_resid(c, bw):
        diff = c[j_idx] - c[i_idx]
        proj = torch.sum(diff * d, dim=-1)
        med_s = torch.clamp_min(_masked_median(torch.abs(proj), bw > 0), 1e-9)
        s = torch.maximum(proj, floor_frac * med_s)
        rres = torch.linalg.norm(diff - s[:, None] * d, dim=-1) / med_s
        medr = torch.clamp_min(_masked_median(rres, bw > 0), 0.02)
        return s, rres, medr

    with torch.no_grad():
        c = solve(base_w0, d)
        bw = base_w0
        for t in range(trim_stages + 1):
            for _ in range(irls_rounds):
                s, rres, medr = scales_resid(c, bw)
                w = bw / torch.sqrt(1.0 + (rres / (k_scale * medr)) ** 2)
                c = solve(w, s[:, None] * d)
            if t < trim_stages:
                s, rres, medr = scales_resid(c, bw)
                # absolute floor: only grossly wrong edges (about 17 deg of
                # angular equivalent) are ever cut; relative-only trimming on
                # sparse graphs cuts structurally necessary good edges
                cut = torch.clamp_min(trim_at * medr, 0.3)
                bw = bw * (rres < cut)
                c = solve(bw, s[:, None] * d)

        # exactness polish: one projected-eigen solve with hard-gated final
        # weights (outliers beyond trim_at x median get weight zero). The
        # alternation converges only linearly; the eigen form is exact in one
        # shot on the cleaned graph. It is accepted only if it does not worsen
        # the robust objective, the safety net against a collapse mode.
        s, rres, medr = scales_resid(c, bw)
        w_fin = (bw * (rres < torch.clamp_min(trim_at * medr, 0.3))
                 / torch.sqrt(1.0 + (rres / (k_scale * medr)) ** 2))
        P = torch.eye(3, dtype=d.dtype, device=d.device) - d[:, :, None] * d[:, None, :]
        wP = w_fin[:, None, None] * P
        M = d.new_zeros((V, V, 3, 3))
        M.index_put_((i_idx, i_idx), wP, accumulate=True)
        M.index_put_((j_idx, j_idx), wP, accumulate=True)
        M.index_put_((i_idx, j_idx), -wP, accumulate=True)
        M.index_put_((j_idx, i_idx), -wP, accumulate=True)
        Mfull = M.permute(0, 2, 1, 3).reshape(3 * V, 3 * V)
        _, vecs = torch.linalg.eigh(Mfull[3:, 3:])
        c_e = torch.cat([d.new_zeros((1, 3)), vecs[:, 0].reshape(V - 1, 3)])
        # align the eigenvector (free in sign and scale) with the LUD solution
        c_e = c_e * (torch.sum(c_e * c) / torch.clamp_min(torch.sum(c_e * c_e), 1e-12))

        def robust_cost(cc):
            # sign-free angular residual (sine of the angle between the edge
            # and its direction line): direction reversals are harmless to
            # positions (P is sign-invariant) but would dominate a
            # sign-sensitive cost
            diff = cc[j_idx] - cc[i_idx]
            nrm = torch.clamp_min(torch.linalg.norm(diff, dim=-1), 1e-12)
            perp = diff - torch.sum(diff * d, dim=-1, keepdim=True) * d
            rr = torch.linalg.norm(perp, dim=-1) / nrm
            return torch.sum(base_w0 * torch.sqrt(1.0 + (rr / 0.05) ** 2))

        if bool(robust_cost(c_e) <= robust_cost(c)):
            c = c_e
    return c - c[0]


def global_poses(graph: ViewGraph, num_views: int) -> torch.Tensor:
    """Full init: rotations + positions -> world->cam poses [V,7]."""
    q = rotation_averaging(graph, num_views)
    c = position_estimation(graph, q, num_views)
    # world->cam: t = -R c
    return pose_mod.make_pose(-pose_mod.quat_rotate(q, c), q)


def _pair_track_ranges(x1, x2, R_ij, t_ij, inliers):
    """Two-view midpoint triangulation with unit baseline: per-correspondence
    ranges (distance from each camera centre) in a common metric where
    ||c_j - c_i|| = 1. Returns (range_i [K], range_j [K], valid [K])."""
    d1 = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = np.concatenate([x2, np.ones((len(x2), 1))], axis=1)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    R = np.asarray(R_ij)
    c = -R.T @ np.asarray(t_ij)              # camera-j centre in frame i
    d2i = d2 @ R                             # R^T d2, per row
    # min || a d1 - (c + b d2i) ||^2 over (a, b)
    d11 = np.sum(d1 * d1, axis=1)
    d22 = np.sum(d2i * d2i, axis=1)
    d12 = np.sum(d1 * d2i, axis=1)
    c1 = d1 @ c
    c2 = d2i @ c
    det = d11 * d22 - d12 * d12
    det = np.where(np.abs(det) > 1e-12, det, 1e-12)
    a = (c1 * d22 - c2 * d12) / det
    b = (c1 * d12 - c2 * d11) / det
    pt = 0.5 * (a[:, None] * d1 + (c[None, :] + b[:, None] * d2i))
    r_i = np.linalg.norm(pt, axis=1)
    r_j = np.linalg.norm(pt - c[None, :], axis=1)
    valid = np.asarray(inliers, bool) & (a > 1e-6) & (b > 1e-6)
    return r_i, r_j, valid


def two_view_ransac(x1, x2, valid, threshold: float = 1e-3):
    """Essential and homography RANSAC with their decompositions for a batch
    of pairs: x1, x2 [...,K,2], valid [...,K]. ``threshold`` is the (squared,
    unit-plane) inlier gate of both models. The caller selects the model: on
    near-planar scenes the linear 8-point problem is degenerate and its
    rotation can be ten degrees off while fitting every correspondence; the
    homography decomposition is the stable estimate there. Returns (inliers,
    count, R, t) of the essential model, then of the homography."""
    from multiview_tpu_torch.sfm import ransac as ransac_mod

    with torch.no_grad():
        res = ransac_mod.ransac_essential(x1, x2, valid=valid, threshold=threshold)
        R, t = ransac_mod.decompose_essential(res.model, x1, x2, res.inliers)
        res_h = ransac_mod.ransac_homography(x1, x2, valid=valid, threshold=threshold)
        R_h, t_h, _ = ransac_mod.decompose_homography(res_h.model, x1, x2, res_h.inliers)
    return (res.inliers, res.num_inliers, R, t,
            res_h.inliers, res_h.num_inliers, R_h, t_h)


def select_two_view_model(inl, n_inl, R_e, t_e, inl_h, n_inl_h, R_h, t_h):
    """Model selection between the essential and the homography estimate of
    one pair (host values). When one homography explains (almost) as many
    correspondences as the essential matrix, the pair is planar-dominated and
    the H decomposition is the reliable (R, t). Only the pose comes from H:
    the inlier set is the union of both models', so legitimate off-plane
    inliers still seed tracks and the scale estimation. Returns
    (R, t, inliers, count)."""
    if int(n_inl) > 0 and int(n_inl_h) > 0.8 * int(n_inl):
        inl = inl | inl_h
        return R_h, t_h, inl, int(inl.sum())
    return R_e, t_e, inl, int(n_inl)


def two_view_results(items, dtype, device, threshold: float = 1e-3):
    """``two_view_ransac`` for every pair of ``items`` (tuples of pair key,
    match count K, x1 [K,2], x2 [K,2]) on ``device``: one batch per
    power-of-two bucket of K (padded rows are invalid and change no result),
    split where a bucket's scoring arrays would grow too large, and one
    device-to-host copy per batch and output. Returns {pair key: the eight
    host arrays of that pair, at the padded length}."""
    buckets = {}
    for it in items:
        buckets.setdefault(next_pow2(it[1]), []).append(it)
    results = {}
    for size, group in buckets.items():
        # 512 hypotheses score [pairs, 512, size] arrays: bound their size
        step = max(1, _MAX_SCORE_ELEMENTS // (512 * size))
        for g0 in range(0, len(group), step):
            part = group[g0:g0 + step]
            x1 = np.stack([pad_rows_pow2(g[2]) for g in part])
            x2 = np.stack([pad_rows_pow2(g[3]) for g in part])
            valid = np.stack([pad_rows_pow2(np.ones(g[1], bool), fill=False) for g in part])
            outs = two_view_ransac(torch.as_tensor(x1, dtype=dtype, device=device),
                                   torch.as_tensor(x2, dtype=dtype, device=device),
                                   torch.as_tensor(valid, device=device), threshold)
            outs = [_np(o) for o in outs]
            for r, g in enumerate(part):
                results[g[0]] = tuple(o[r] for o in outs)
    return results


def view_graph_from_matches(pair_data, num_views: int, dtype=torch.float64,
                            pair_pids=None, device=None):
    """Build a ViewGraph from per-pair unit-plane correspondences, on
    ``device`` (the first CUDA card when None; pass ``"cpu"`` for the CPU).

    pair_data: {(i,j): (x1 [K,2], x2 [K,2])} normalized (unit-plane) coords.
    The two-view RANSACs run as one batch per padded match-count bucket
    (power-of-two buckets; padded rows are invalid and change no result);
    each bucket's outputs come back to the host in one copy, where model
    selection and the scale bookkeeping happen.

    With ``pair_pids`` ({(i,j): [K] track ids}), also returns per-edge track
    ranges ``[{view: {pid: range}}]`` in the edge's unit-baseline metric, the
    raw material for baseline-scale recovery (edge_scales_from_ranges)."""
    device = resolve_device(device)
    items = [((i, j), len(x1), np.asarray(x1, float), np.asarray(x2, float))
             for (i, j), (x1, x2) in pair_data.items() if len(x1) >= 8]
    results = two_view_results(items, dtype, device)

    edges, rots, dirs, weights, ranges = [], [], [], [], []
    for (i, j), K, x1, x2 in items:
        R_ij, t_ij, inl, n_inl = select_two_view_model(*results[(i, j)])
        if n_inl < 16:
            continue
        edges.append((i, j))
        rots.append(R_ij)
        # direction of c_j - c_i in world: needs global rotations, which we
        # don't have yet; store the direction in cam-i frame and fix it up in
        # rel_dir_to_world() after rotation averaging.
        # camera-j centre in cam-i frame: c_j^(i) = -R_ij^T t_ij
        cji = -R_ij.T @ t_ij
        dirs.append(cji / max(np.linalg.norm(cji), 1e-12))
        weights.append(float(n_inl))
        if pair_pids is not None:
            r_i, r_j, valid = _pair_track_ranges(x1, x2, R_ij, t_ij, inl[:K])
            pids = np.asarray(pair_pids[(i, j)])
            ranges.append({
                i: {int(p): float(r) for p, r, v in zip(pids, r_i, valid) if v},
                j: {int(p): float(r) for p, r, v in zip(pids, r_j, valid) if v},
            })

    if edges:
        quats = pose_mod.matrix_to_quat(torch.as_tensor(np.stack(rots), dtype=torch.float64))
        graph = make_view_graph(edges, quats.numpy(), np.stack(dirs), weights, dtype, device)
    else:
        graph = make_view_graph(np.zeros((0, 2)), np.zeros((0, 4)), np.zeros((0, 3)),
                                np.zeros(0), dtype, device)
    if pair_pids is not None:
        return graph, ranges
    return graph


def edge_scales_from_ranges(graph: ViewGraph, ranges) -> np.ndarray:
    """Per-edge baseline lengths (up to one global scale) from shared tracks.

    Two edges sharing a view see common tracks at ranges inversely
    proportional to their baseline scales: s_e * range_e(p, v) =
    s_f * range_f(p, v) = the true range. Each shared (edge, edge, view)
    triple contributes log s_e - log s_f = median_p log(range_f / range_e);
    the log-scale least-squares system is solved on the host (E x E).
    Returns scales [E] with geometric mean 1. Edges with no shared-track
    constraint keep scale 1 (the direction-only behavior)."""
    E = len(ranges)
    rows, rhs = [], []
    for e in range(E):
        for f in range(e + 1, E):
            for v in ranges[e]:
                if v not in ranges[f]:
                    continue
                common = set(ranges[e][v]) & set(ranges[f][v])
                if len(common) < 3:
                    continue
                logs = [np.log(ranges[f][v][p] / ranges[e][v][p])
                        for p in common
                        if ranges[f][v][p] > 1e-9 and ranges[e][v][p] > 1e-9]
                if not logs:
                    continue
                row = np.zeros(E)
                row[e] = 1.0
                row[f] = -1.0
                rows.append(row)
                rhs.append(np.median(logs))
    if not rows:
        return np.ones(E)
    # gauge: mean log scale = 0
    rows.append(np.ones(E) / E)
    rhs.append(0.0)
    A = np.stack(rows)
    b = np.asarray(rhs)
    logs, *_ = np.linalg.lstsq(A, b, rcond=None)
    return np.exp(logs - logs.mean())


def position_estimation_with_scales(graph: ViewGraph, scales,
                                    irls_rounds: int = 8,
                                    loss_scale: float = 0.05) -> torch.Tensor:
    """Camera centres from full baseline vectors b_e = s_e d_e (world frame):
    min sum_e w_e |c_j - c_i - b_e|^2, IRLS soft-L1 (the LUD role with known
    per-edge scales: determined even for collinear trajectories, where
    direction-only averaging is degenerate). Gauge fixed by centring on c_0."""
    edges = graph.edges
    i_idx, j_idx = edges[:, 0], edges[:, 1]
    d = graph.rel_dir
    b = torch.as_tensor(np.asarray(scales, np.float64), dtype=d.dtype,
                        device=d.device)[:, None] * d            # [E,3]
    base_w = graph.weight.to(d.dtype)
    V = int(edges.max()) + 1
    with torch.no_grad():
        c = _laplacian_solve(i_idx, j_idx, base_w, b, V)
        scale_norm = torch.clamp_min(torch.mean(torch.linalg.norm(b, dim=-1)), 1e-12)
        for _ in range(irls_rounds):
            resid = torch.linalg.norm(c[j_idx] - c[i_idx] - b, dim=-1)
            w = base_w / torch.sqrt(1.0 + (resid / (loss_scale * scale_norm)) ** 2)
            c = _laplacian_solve(i_idx, j_idx, w, b, V)
    return c - c[0]


def rel_dir_to_world(graph: ViewGraph, rotations: torch.Tensor) -> ViewGraph:
    """Rotate per-edge baseline directions from cam-i frame into world frame
    using the averaged global rotations: d_world = R_i^T d_cam_i."""
    qi = rotations[graph.edges[:, 0]]
    d_world = pose_mod.quat_rotate(pose_mod.quat_conj(qi), graph.rel_dir)
    return graph._replace(rel_dir=d_world)


def largest_component_views(pair_data, num_views: int) -> np.ndarray:
    """Boolean [V] membership mask of the largest connected component of the
    view graph (host union-find). Views with no edges form singletons."""
    return _largest_component_from_edges(
        np.asarray([k for k in pair_data.keys()], np.int64), num_views)


def _largest_component_from_edges(edges: np.ndarray, num_views: int) -> np.ndarray:
    from multiview_tpu_torch import native

    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    if len(edges) == 0:
        out = np.zeros(num_views, bool)
        out[:1] = True
        return out
    roots = native.union_find_roots(num_views, edges)
    vals, counts = np.unique(roots, return_counts=True)
    # among components that have edges, pick the largest
    has_edge = np.zeros(num_views, bool)
    has_edge[edges.reshape(-1)] = True
    sizes = {int(v): int(c) for v, c in zip(vals, counts)}
    best = max((r for r in vals if has_edge[int(r)] or sizes[int(r)] > 1),
               key=lambda r: sizes[int(r)], default=int(roots[0]))
    return roots == best


def run_global_sfm(pair_data, num_views: int, dtype=torch.float64,
                   pair_pids=None, return_mask: bool = False, device=None):
    """pair correspondences -> initial world->cam poses [V,7] (up to scale),
    computed on ``device`` (the first CUDA card when None; pass ``"cpu"`` for
    the CPU).

    With ``pair_pids`` (track ids per pair correspondence), per-edge baseline
    scales are recovered from shared-track range ratios and positions come
    from full baseline vectors, robust to collinear trajectories.

    A disconnected view graph is reconstructed on its largest connected
    component (views outside it get identity poses and a False entry in the
    mask). With ``return_mask`` returns (poses [V,7], registered [V] bool).
    With MV_PROFILE set in the environment, prints its stage times."""
    device = resolve_device(device)
    member = largest_component_views(pair_data, num_views)

    def _reconstruct_component(member):
        print(f"Warning: view graph is disconnected; reconstructing the "
              f"largest connected component ({int(member.sum())}/{num_views} "
              f"views)", file=sys.stderr)
        remap = -np.ones(num_views, np.int64)
        remap[member] = np.arange(int(member.sum()))
        sub_pairs = {(int(remap[i]), int(remap[j])): v
                     for (i, j), v in pair_data.items()
                     if member[i] and member[j]}
        sub_pids = None
        if pair_pids is not None:
            sub_pids = {(int(remap[i]), int(remap[j])): v
                        for (i, j), v in pair_pids.items()
                        if member[i] and member[j]}
        sub = run_global_sfm(sub_pairs, int(member.sum()), dtype, pair_pids=sub_pids,
                             device=device)
        poses = pose_mod.pose_identity(dtype, device).repeat(num_views, 1)
        poses[torch.as_tensor(member, device=device)] = sub
        return (poses, member) if return_mask else poses

    if not member.all():
        return _reconstruct_component(member)

    prof = bool(os.environ.get("MV_PROFILE"))
    t_last = [time.perf_counter()]

    def _mk(name):
        if prof:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            print(f"[global-sfm] {name}: {now - t_last[0]:.2f} s")
            t_last[0] = now

    ranges = None
    if pair_pids is not None:
        graph, ranges = view_graph_from_matches(pair_data, num_views, dtype,
                                                pair_pids=pair_pids, device=device)
    else:
        graph = view_graph_from_matches(pair_data, num_views, dtype, device=device)
    _mk("view_graph")
    # pair_data connectivity (checked above) is necessary but not
    # sufficient: view_graph_from_matches drops edges (min-match and
    # two-view gates), so the built graph can still be disconnected.
    # Reconstruct the largest component of the kept edges.
    gmember = _largest_component_from_edges(_np(graph.edges), num_views)
    if not gmember.all():
        return _reconstruct_component(gmember)
    full_edges = _np(graph.edges)
    q, graph = robust_rotation_averaging(graph, num_views)
    _mk("rotation_averaging")
    graph = rel_dir_to_world(graph, q)
    # relative-translation outlier rejection before position estimation
    # (theia_flags.txt:93): triplet closure (sharp where triangles exist)
    # then 1DSfM projection consensus, which judges only the edges the
    # triplet could not (too few informative triangles), at a higher
    # threshold: on triangle-rich graphs its ordering-based vote is far
    # noisier than triplet closure. Triangle-free graphs (judged empty) still
    # get the full-graph sweep.
    graph, keep_tri, judged = filter_directions_triplet(graph, return_judged=True)
    graph, _ = filter_directions_1dsfm(
        graph, seed=0, threshold=0.45, only=~judged[np.asarray(keep_tri, bool)])
    _mk("direction_filters")
    if ranges is not None:
        if graph.edges.shape[0] < len(full_edges):
            kept = {tuple(e) for e in _np(graph.edges)}
            ranges = [r for e, r in zip(full_edges, ranges) if tuple(e) in kept]
        scales = edge_scales_from_ranges(graph, ranges)
        _mk("edge_scales")
        # mean baseline 1 (same normalization as the direction-only path)
        c = position_estimation_with_scales(graph, scales / scales.mean())
        _mk("positions")
    else:
        c = position_estimation(graph, q, num_views)
        _mk("positions")
    poses = pose_mod.make_pose(-pose_mod.quat_rotate(q, c), q)
    if return_mask:
        return poses, np.ones(num_views, bool)
    return poses
