"""Front-end orchestration: detect + match + verify + track-build across an
image sequence. Port of ``multiview_tpu/sfm/pipeline.py`` (the role of
``detectMatchFeatures``, interest_point.cc:453-647): detect features in
every image, match each image against the next ``num_overlaps`` images,
RANSAC-filter each pair (affine2D, 20 px), optionally filter by
reprojection against known cameras (matchFeaturesWithCams, :181-301), then
merge pairwise matches into tracks.

On CUDA the pairs of a chunk are matched by ONE launch of the fused
distance + top-2 kernel over [P,K,128] descriptor stacks, and verified by
one batched RANSAC. On the CPU each pair is matched on its compacted
matches, as the reference does on the CPU.

Pairs come from the temporal ``num_overlaps`` scheme or, with
``retrieval_neighbors`` > 0, from global-descriptor retrieval
(``sfm/retrieval.py``). With ``match_out_of_core`` the features of each
image are written to disk as they are detected and read back through an LRU
cache (``FeatureStore``).

With a shard mesh (``parallel/sharding.py::ShardMesh``), detection chunks
and match-pair chunks go to the mesh's devices in turn, one round of chunks
queued on every device before any result is read back; each device runs the
code of the unsharded path on the same chunks, and the results come back in
image and pair order, bit for bit the unsharded ones (RANSAC is seeded per
pair). Each chunk's matcher launch goes through ``knn2``, so on the card
every shard chunk launches the matcher kernel once.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry import camera as cam_mod
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.geometry import triangulation as tri_mod
from multiview_tpu_torch.sfm import features as feat_mod
from multiview_tpu_torch.sfm import matching as match_mod
from multiview_tpu_torch.sfm import ransac as ransac_mod
from multiview_tpu_torch.sfm import tracks as tracks_mod
from multiview_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class FrontendConfig:
    max_features: int = 1000          # reference SIFT default is 10000
    ratio: float = 0.8                # FLANN ratio test (matching.cc:205-210)
    ransac_threshold: float = 20.0    # estimateAffine2D thresh (interest_point.cc:134)
    num_overlaps: int = 2             # pair set: each image vs next k (ip.cc:498-502)
    min_pair_matches: int = 8
    cam_filter_reproj_px: Optional[float] = None  # matchFeaturesWithCams gate
    feature_detector: str = "sift"
    num_scales: int = 3               # --sift_nOctaveLayers
    num_octaves: int = 4
    sigma0: float = 1.6               # --sift_sigma
    contrast_threshold: Optional[float] = None  # --sift_contrastThreshold
    edge_threshold: float = 10.0      # --sift_edgeThreshold
    # >0: select match pairs by global-descriptor retrieval (each image vs
    # its K most similar) instead of temporal num_overlaps: Theia's
    # num_nearest_neighbors_for_global_descriptor_matching (theia_flags.txt:57-62)
    retrieval_neighbors: int = 0
    retrieval_clusters: int = 16      # num_gmm_clusters_for_fisher_vector
    # out-of-core matching (Theia's --match_out_of_core /
    # --matching_working_directory / --matching_max_num_images_in_cache,
    # theia_flags.txt:30-46): features spill to disk per image and are read
    # back through an LRU cache
    match_out_of_core: bool = False
    matching_working_directory: Optional[str] = None
    matching_max_num_images_in_cache: int = 128

    @property
    def detect_threshold(self) -> float:
        if self.contrast_threshold is not None:
            return self.contrast_threshold
        return feat_mod.default_threshold(self.feature_detector)


class FeatureStore:
    """Disk-backed per-image feature store with an LRU read cache (Theia's
    out-of-core matching, theia_flags.txt:30-46). Each image's features are
    written once as ``feat_<idx>.npz`` and read back on demand onto
    ``device``; at most ``max_in_cache`` images stay resident."""

    def __init__(self, workdir, max_in_cache: int = 128, device=None):
        self.dir = str(workdir)
        os.makedirs(self.dir, exist_ok=True)
        self.max_in_cache = max(1, int(max_in_cache))
        self.device = resolve_device(device)
        self._cache: OrderedDict = OrderedDict()
        self.n = 0

    def _path(self, idx: int) -> str:
        return os.path.join(self.dir, f"feat_{idx:06d}.npz")

    def put(self, idx: int, kp: feat_mod.Keypoints, desc: torch.Tensor):
        np.savez(self._path(idx), desc=desc.cpu().numpy(),
                 **{f: getattr(kp, f).cpu().numpy() for f in kp._fields})
        self.n = max(self.n, idx + 1)
        self._insert(idx, (kp, desc))

    def _load(self, idx: int):
        with np.load(self._path(idx)) as z:
            def t(name):
                return torch.as_tensor(z[name], device=self.device)
            return feat_mod.Keypoints(*(t(f) for f in feat_mod.Keypoints._fields)), t("desc")

    def _insert(self, idx, item):
        self._cache[idx] = item
        self._cache.move_to_end(idx)
        while len(self._cache) > self.max_in_cache:
            self._cache.popitem(last=False)

    def get(self, idx: int):
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        item = self._load(idx)
        self._insert(idx, item)
        return item

    class _View:
        def __init__(self, store, which):
            self._store, self._which = store, which

        def __len__(self):
            return self._store.n

        def __getitem__(self, idx):
            return self._store.get(idx)[self._which]

        def __iter__(self):
            return (self[i] for i in range(len(self)))

    @property
    def kps(self):
        return FeatureStore._View(self, 0)

    @property
    def descs(self):
        return FeatureStore._View(self, 1)


def _mesh_devices(mesh, device) -> Tuple[torch.device, list]:
    """(device of the results, devices that take the chunks in turn)."""
    if mesh is None:
        device = resolve_device(device)
        return device, [device]
    return mesh.lead, list(mesh.devices)


def detect_all(images: Sequence[np.ndarray], cfg: FrontendConfig, chunk: int = 8,
               device=None, store: Optional[FeatureStore] = None, mesh=None):
    """Detect + describe every image on ``device`` (the first CUDA card when
    None; pass ``"cpu"`` for the CPU). Returns (keypoints list, descriptor
    list) of device tensors; with ``store``, each image's features go to the
    store as they come and the store's views are returned. With ``mesh`` the
    chunks go to the mesh's devices in turn and the features come back to
    its lead device.

    Same-shape images are detected as one batch per ``chunk``; an image of
    a batch that comes back under the adaptive floor (``max_features//10``
    survivors) is re-run alone with a 256x lower starting threshold, as the
    reference's batched path does. A lone image of its shape is detected
    alone with no such retry (the reference's per-image path)."""
    device, devices = _mesh_devices(mesh, device)
    n = len(images)
    kps: list = [None] * n
    descs: list = [None] * n
    min_features = max(8, cfg.max_features // 10)
    groups: Dict[Tuple[int, ...], list] = {}
    for i, img in enumerate(images):
        groups.setdefault(np.asarray(img).shape, []).append(i)
    jobs = [(len(ids) > 1, ids[c0:c0 + chunk]) for ids in groups.values()
            for c0 in range(0, len(ids), chunk)]

    def run(stack, threshold):
        return feat_mod.detect_and_describe(
            stack, cfg.max_features, cfg.num_scales, cfg.num_octaves, cfg.sigma0,
            threshold, cfg.edge_threshold, cfg.feature_detector,
            min_features=min_features)

    for r0 in range(0, len(jobs), len(devices)):
        # one round: a chunk queued on every device, then the results read
        queued = []
        for (retry, sel), dev in zip(jobs[r0:r0 + len(devices)], devices):
            stack = torch.as_tensor(
                np.stack([np.asarray(images[i], np.float32) for i in sel]), device=dev)
            queued.append((retry, sel, stack, run(stack, cfg.detect_threshold)))
        for retry, sel, stack, outs in queued:
            counts = torch.stack([kp.valid.sum() for kp, _ in outs]).cpu().numpy()
            for row, i in enumerate(sel):
                if retry and counts[row] < min_features:
                    outs[row] = run(stack[row:row + 1], cfg.detect_threshold * 0.25 ** 4)[0]
                kp, desc = outs[row]
                if kp.xy.device != device:
                    kp, desc = feat_mod.Keypoints(*(t.to(device) for t in kp)), desc.to(device)
                if store is not None:
                    store.put(i, kp, desc)
                else:
                    kps[i], descs[i] = kp, desc
    if store is not None:
        return store.kps, store.descs
    return kps, descs


def match_pair(kp_i, d_i, kp_j, d_j, cfg: FrontendConfig, seed: int = 0):
    """Descriptor match + ratio test + affine RANSAC for one image pair, on
    the compacted surviving matches. Returns (xy_i [M,2], xy_j [M,2]) numpy
    inlier correspondences."""
    pairs, keep = match_mod.match_descriptors(d_i, d_j, ratio=cfg.ratio)
    tgt = pairs[:, 1].long()
    keep = keep & kp_i.valid & kp_j.valid[tgt]
    if int(keep.sum()) < 3:
        return np.zeros((0, 2)), np.zeros((0, 2))
    p1 = kp_i.xy[keep]
    p2 = kp_j.xy[tgt[keep]]
    res = ransac_mod.ransac_affine2d(p1, p2, threshold=cfg.ransac_threshold, seed=seed)
    inl = res.inliers
    return p1[inl].cpu().numpy(), p2[inl].cpu().numpy()


def _match_chunk(kps, descs, sel, cfg: FrontendConfig, num_hypotheses: int, dev):
    """Matcher + ratio test + RANSAC of one chunk of pairs on ``dev`` (None:
    where the features are). Returns device tensors (inliers [P,K], match
    targets [P,K])."""
    def stack(ts):
        t = torch.stack(ts)
        return t if dev is None else t.to(dev)

    di = stack([descs[i] for i, _ in sel])
    dj = stack([descs[j] for _, j in sel])
    xyi = stack([kps[i].xy for i, _ in sel])
    xyj = stack([kps[j].xy for _, j in sel])
    vi = stack([kps[i].valid for i, _ in sel])
    vj = stack([kps[j].valid for _, j in sel])
    pairs, keep = match_mod.match_descriptors(di, dj, ratio=cfg.ratio)
    tgt = torch.clamp_min(pairs[..., 1].long(), 0)
    keep = keep & vi & torch.gather(vj, 1, tgt)
    dst = torch.gather(xyj, 1, tgt[..., None].expand(-1, -1, 2))
    samples = torch.stack([
        ransac_mod.sample_hypotheses(keep[r], num_hypotheses, i * 1000 + j)
        for r, (i, j) in enumerate(sel)])
    res = ransac_mod.ransac_affine2d(xyi, dst, valid=keep,
                                     threshold=cfg.ransac_threshold, samples=samples)
    return res.inliers, tgt


def match_pairs_batched(kps, descs, pair_ids, cfg: FrontendConfig, chunk: int = 8,
                        num_hypotheses: int = 512, mesh=None):
    """Descriptor match + ratio test + affine RANSAC for many pairs, ``chunk``
    pairs at a time: one matcher launch over the stacked [P,K,D] descriptors
    and one batched RANSAC over the padded [P,K] match sets (validity masks
    end to end, one device->host copy per chunk). Hypotheses of pair (i, j)
    are seeded with i*1000+j. With ``mesh`` the chunks go to the mesh's
    devices in turn, a round queued on every device before any is read.
    Returns {(i, j): (xy_i [M,2], xy_j [M,2])} in pair order."""
    devices = [None] if mesh is None else list(mesh.devices)
    chunks = [pair_ids[c0:c0 + chunk] for c0 in range(0, len(pair_ids), chunk)]
    out = {}
    xy_host: Dict[int, np.ndarray] = {}
    for r0 in range(0, len(chunks), len(devices)):
        queued = [(sel, _match_chunk(kps, descs, sel, cfg, num_hypotheses, dev))
                  for sel, dev in zip(chunks[r0:r0 + len(devices)], devices)]
        for sel, (inl, tgt) in queued:
            inl = inl.cpu().numpy()
            tgt_np = tgt.cpu().numpy()
            for i in {im for p in sel for im in p}:
                if i not in xy_host:
                    xy_host[i] = kps[i].xy.cpu().numpy()
            for row, (i, j) in enumerate(sel):
                m = inl[row]
                out[(i, j)] = (xy_host[i][m], xy_host[j][tgt_np[row][m]])
    return out


def cam_guided_filter(xy_i, xy_j, cam_i: cam_mod.CameraParams,
                      cam_j: cam_mod.CameraParams, w2c_i, w2c_j,
                      max_reproj_px: float):
    """Reject matches whose two-view triangulation reprojects worse than
    ``max_reproj_px`` in either image (matchFeaturesWithCams,
    interest_point.cc:181-301), all matches of the pair at once."""
    if len(xy_i) == 0:
        return xy_i, xy_j
    dev, dt = cam_i.device, cam_i.dtype
    xi = torch.as_tensor(np.asarray(xy_i), dtype=dt, device=dev)
    xj = torch.as_tensor(np.asarray(xy_j), dtype=dt, device=dev)
    wi = torch.as_tensor(np.asarray(w2c_i), dtype=dt, device=dev)
    wj = torch.as_tensor(np.asarray(w2c_j), dtype=dt, device=dev)
    ui = cam_i.convert(xi, cam_mod.DISTORTED, cam_mod.UNDISTORTED_C)
    uj = cam_j.convert(xj, cam_mod.DISTORTED, cam_mod.UNDISTORTED_C)
    focal2 = torch.stack([cam_i.mean_focal, cam_j.mean_focal])
    Pm = tri_mod.projection_matrix(focal2, torch.stack([wi, wj]))    # [2,3,4]
    K = xi.shape[0]
    pix = torch.stack([ui, uj], dim=1)                               # [K,2,2]
    X, _, ok = tri_mod.triangulate_track(
        Pm.expand(K, 2, 3, 4), pix, torch.ones((K, 2), dtype=torch.bool, device=dev))
    for cam, w2c, meas in ((cam_i, wi, xi), (cam_j, wj, xj)):
        pred = cam.project_cam_to_dist_pix(pose_mod.pose_apply(w2c, X))
        ok = ok & (torch.linalg.norm(pred - meas, dim=-1) <= max_reproj_px)
    keep = ok.cpu().numpy()
    return xy_i[keep], xy_j[keep]


def detect_match_features(images: Sequence[np.ndarray],
                          cfg: FrontendConfig = FrontendConfig(),
                          cam_params: Optional[Sequence[cam_mod.CameraParams]] = None,
                          world_to_cam: Optional[np.ndarray] = None,
                          cams_of_image: Optional[Sequence[int]] = None,
                          device=None, mesh=None) -> tracks_mod.TrackSet:
    """Full front end: images -> TrackSet, on ``device`` (the first CUDA card
    when None; pass ``"cpu"`` for the CPU). With cam_params/world_to_cam
    given, applies the camera-guided reprojection filter per pair. With
    ``mesh`` the detection and match chunks shard over its devices (the
    batched matcher then runs on the CPU too, as the reference's sharded
    path does)."""
    device, _ = _mesh_devices(mesh, device)
    store = None
    if cfg.match_out_of_core:
        workdir = cfg.matching_working_directory
        if not workdir:
            import tempfile
            workdir = tempfile.mkdtemp(prefix="mv_features_")
            print(f"match_out_of_core: no matching_working_directory set, "
                  f"spilling features to {workdir}")
        store = FeatureStore(workdir, cfg.matching_max_num_images_in_cache, device)
    kps, descs = detect_all(images, cfg, device=device, store=store, mesh=mesh)
    n = len(images)
    if cfg.retrieval_neighbors > 0:
        from multiview_tpu_torch.sfm import retrieval
        pair_ids = retrieval.select_pairs(
            descs, [k.valid for k in kps], cfg.retrieval_neighbors,
            num_clusters=cfg.retrieval_clusters)
    else:
        pair_ids = [(i, j) for i in range(n)
                    for j in range(i + 1, min(i + 1 + cfg.num_overlaps, n))]
    if device.type == "cpu" and mesh is None:
        raw = {(i, j): match_pair(kps[i], descs[i], kps[j], descs[j], cfg,
                                  seed=i * 1000 + j) for i, j in pair_ids}
    else:
        raw = match_pairs_batched(kps, descs, pair_ids, cfg, mesh=mesh)
    pair_matches: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
    for (i, j), (xi, xj) in raw.items():
        if cfg.cam_filter_reproj_px is not None and cam_params is not None:
            xi, xj = cam_guided_filter(xi, xj, cam_params[cams_of_image[i]],
                                       cam_params[cams_of_image[j]],
                                       world_to_cam[i], world_to_cam[j],
                                       cfg.cam_filter_reproj_px)
        if len(xi) >= cfg.min_pair_matches:
            pair_matches[(i, j)] = (xi, xj)
    return tracks_mod.build_tracks(pair_matches, n)
