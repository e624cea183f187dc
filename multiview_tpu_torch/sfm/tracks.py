"""Track building: merge pairwise matches into multi-view tracks.

Host-side union-find, the role of openMVG's TracksBuilder
(openMVG/tracks/tracks.hpp:59-230) as used by
``detectMatchFeatures`` (interest_point.cc:527-647): keypoints are
deduplicated per image by exact (x,y), pairwise matches union (image,feature)
nodes, tracks observing the same image twice are dropped (conflict filter),
and short tracks are culled. This is irregular pointer-chasing work —
deliberately numpy/host, feeding padded tensors to the device side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


class UnionFind:
    """Path-compressing union-find over dense int nodes (on the host; the
    track builder itself merges through ``native.union_find_roots``)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


@dataclasses.dataclass
class TrackSet:
    """Tracks over deduplicated keypoints.

    keypoints[cid] : [n_cid, 2] float pixel positions
    tracks         : list of dict cid->fid
    """

    keypoints: List[np.ndarray]
    tracks: List[Dict[int, int]]


def dedup_keypoints(pair_matches: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]],
                    num_images: int):
    """Assign a feature id per unique (x,y) in each image
    (interest_point.cc:527-556), native hash-map core. Returns (keypoints
    per image, match index pairs per image pair)."""
    from multiview_tpu_torch import native

    # gather every coordinate row per image, remembering where it came from
    coords: List[List[np.ndarray]] = [[] for _ in range(num_images)]
    slots: List[List[Tuple[Tuple[int, int], int]]] = [[] for _ in range(num_images)]
    for (ci, cj), (left, right) in pair_matches.items():
        coords[ci].append(np.asarray(left, np.float64).reshape(-1, 2))
        slots[ci].append(((ci, cj), 0))
        coords[cj].append(np.asarray(right, np.float64).reshape(-1, 2))
        slots[cj].append(((ci, cj), 1))

    keypoints: List[np.ndarray] = []
    ids_of: Dict[Tuple[Tuple[int, int], int], np.ndarray] = {}
    for cid in range(num_images):
        if coords[cid]:
            allc = np.concatenate(coords[cid])
            ids, uniq = native.dedup_keypoints_array(allc)
            keypoints.append(uniq)
            off = 0
            for block, key in zip(coords[cid], slots[cid]):
                ids_of[key] = ids[off:off + len(block)]
                off += len(block)
        else:
            keypoints.append(np.zeros((0, 2)))

    indexed: Dict[Tuple[int, int], np.ndarray] = {}
    for (ci, cj) in pair_matches:
        indexed[(ci, cj)] = np.stack(
            [ids_of[((ci, cj), 0)], ids_of[((ci, cj), 1)]], axis=1)
    return keypoints, indexed


def build_tracks(pair_matches: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]],
                 num_images: int, min_track_len: int = 2) -> TrackSet:
    """Union-find merge + conflict filter (TracksBuilder::Build/Filter),
    native union-find core + vectorized grouping.

    pair_matches: {(cid_i, cid_j): (left_xy [K,2], right_xy [K,2])}.
    """
    from multiview_tpu_torch import native

    keypoints, indexed = dedup_keypoints(pair_matches, num_images)

    offsets = np.zeros(num_images + 1, np.int64)
    for cid in range(num_images):
        offsets[cid + 1] = offsets[cid] + len(keypoints[cid])
    total = int(offsets[-1])

    edge_rows = []
    for (ci, cj), rows in indexed.items():
        e = rows.copy()
        e[:, 0] += offsets[ci]
        e[:, 1] += offsets[cj]
        edge_rows.append(e)
    if not edge_rows:
        return TrackSet(keypoints, [])
    edges = np.concatenate(edge_rows)
    roots = native.union_find_roots(total, edges)

    # vectorized grouping: node -> (root, cid, fid)
    cid_of = np.repeat(np.arange(num_images),
                       np.diff(offsets).astype(int))
    fid_of = np.arange(total) - offsets[cid_of]
    order = np.argsort(roots, kind="stable")
    r_sorted = roots[order]
    starts = np.nonzero(np.r_[True, r_sorted[1:] != r_sorted[:-1]])[0]
    bounds = np.r_[starts, total]

    tracks = []
    for k in range(len(starts)):
        members = order[bounds[k]:bounds[k + 1]]
        if len(members) < min_track_len:
            continue
        cids = cid_of[members]
        if len(np.unique(cids)) != len(cids):
            continue  # conflict: same image twice (TracksBuilder::Filter)
        srt = np.argsort(cids)
        tracks.append({int(cids[m]): int(fid_of[members[m]]) for m in srt})
    return TrackSet(keypoints, tracks)



def tracks_to_arrays(ts: TrackSet):
    """Flatten tracks into the observation-row arrays the BA layer wants:
    (cam_idx [N], fid [N], pix [N,2], point_idx [N])."""
    cam_idx, fid_arr, pix, pid_arr = [], [], [], []
    for pid, track in enumerate(ts.tracks):
        for cid, fid in track.items():
            cam_idx.append(cid)
            fid_arr.append(fid)
            pix.append(ts.keypoints[cid][fid])
            pid_arr.append(pid)
    return (np.asarray(cam_idx, np.int32), np.asarray(fid_arr, np.int32),
            np.asarray(pix, float), np.asarray(pid_arr, np.int32))


def subset_views(ts: TrackSet, keep) -> TrackSet:
    """Restrict a TrackSet to a subset of views (e.g. the views incremental
    SfM actually registered): keypoints are re-indexed to the new cid order
    and tracks drop unkept views (tracks left with <2 views are removed)."""
    remap = {int(old): new for new, old in enumerate(keep)}
    kps = [ts.keypoints[int(c)] for c in keep]
    tracks = []
    for t in ts.tracks:
        nt = {remap[c]: f for c, f in t.items() if c in remap}
        if len(nt) >= 2:
            tracks.append(nt)
    return TrackSet(kps, tracks)
