"""Global-descriptor image retrieval for match-pair selection. Port of
``multiview_tpu/sfm/retrieval.py``.

The role of Theia's global-descriptor preselection
(theia_flags.txt:57-62: ``num_nearest_neighbors_for_global_descriptor_matching``,
``num_gmm_clusters_for_fisher_vector``): instead of matching every image
against its temporal neighbours (the ``num_overlaps`` scheme,
interest_point.cc:498-502), aggregate each image's local descriptors into one
global vector and match each image only against its K most similar images.

The codebook is a small k-means (matmul distances, one-hot sums), the
aggregation is VLAD (sum of residuals to the assigned centroid, power and L2
normalized: the Fisher-vector role with 16 clusters), and similarity is one
[N,N] matmul. The k-means seeds are drawn by ``sample_codebook_rows`` from a
``torch.Generator``; the parity tests hand over JAX's own draws through
``init_rows=``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def sample_codebook_rows(valid: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """[k] distinct row indices among the ``valid`` rows, uniformly, from a
    generator seeded with ``seed``."""
    gen = torch.Generator(device=valid.device)
    gen.manual_seed(int(seed))
    return torch.multinomial(valid.to(torch.float32), k, replacement=False, generator=gen)


def _sq_dists(desc, cent):
    """Squared distances [...,K,C] in the expanded form (one matmul)."""
    return (torch.sum(desc * desc, -1, keepdim=True) - 2.0 * desc @ cent.T
            + torch.sum(cent * cent, -1))


def kmeans_codebook(desc: torch.Tensor, valid: torch.Tensor, k: int = 16,
                    iters: int = 10, seed: int = 0,
                    init_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-means over pooled local descriptors. desc [M,D], valid [M] ->
    centroids [k,D]. Empty clusters re-seed to the overall mean. The first
    centroids are the rows ``init_rows`` when given, else ``k`` valid rows
    drawn with ``seed``."""
    if init_rows is None:
        init_rows = sample_codebook_rows(valid, k, seed)
    cent = desc[init_rows.to(desc.device)]
    vf = valid.to(desc.dtype)[:, None]
    mean_all = torch.sum(desc * vf, dim=0) / torch.clamp_min(torch.sum(vf), 1.0)
    ar = torch.arange(k, device=desc.device)
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(desc, cent), dim=-1)
        onehot = (assign[:, None] == ar[None, :]).to(desc.dtype) * vf
        sums = onehot.T @ desc                                   # [k,D]
        cnts = torch.sum(onehot, dim=0)[:, None]
        cent = torch.where(cnts > 0, sums / torch.clamp_min(cnts, 1.0), mean_all)
    return cent


def vlad_descriptors(desc: torch.Tensor, valid: torch.Tensor,
                     centroids: torch.Tensor) -> torch.Tensor:
    """VLAD aggregation per image. desc [N,K,D], valid [N,K],
    centroids [C,D] -> [N, C*D] power- and L2-normalized."""
    n, _, d = desc.shape
    c = centroids.shape[0]
    assign = torch.argmin(_sq_dists(desc, centroids), dim=-1)     # [N,K]
    onehot = (assign[..., None] == torch.arange(c, device=desc.device)).to(desc.dtype)
    onehot = onehot * valid[..., None].to(desc.dtype)
    # sum over the assigned rows of (desc - centroid), as two sums: the
    # [N,K,C,D] residual tensor is never formed
    v = (torch.einsum("nkc,nkd->ncd", onehot, desc)
         - onehot.sum(1)[..., None] * centroids[None])
    v = v.reshape(n, c * d)
    # signed square-root (power) normalization then L2
    v = torch.sign(v) * torch.sqrt(torch.abs(v))
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)


def select_pairs(descs: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                 num_neighbors: int, num_clusters: int = 16, max_train: int = 20000,
                 seed: int = 0, init_rows: Optional[torch.Tensor] = None
                 ) -> List[Tuple[int, int]]:
    """Retrieval-based pair selection: each image proposes its
    ``num_neighbors`` most similar images (by VLAD cosine similarity) as
    match candidates. Returns sorted unique (i, j) pairs with i < j.

    descs: per-image [K,D] local descriptors; valids: per-image [K] masks,
    tensors on the device the work runs on."""
    n = len(descs)
    # pass 1: subsample training descriptors per image
    per = max(8, max_train // max(n, 1))
    train = []
    for i in range(n):
        rows = torch.nonzero(valids[i])[:, 0]
        if len(rows) > per:  # strided, not top-N: unbiased codebook sample
            rows = rows[:: max(1, len(rows) // per)][:per]
        train.append(descs[i][rows])
    train = torch.cat(train)
    cent = kmeans_codebook(train, torch.ones(len(train), dtype=torch.bool, device=train.device),
                           k=num_clusters, seed=seed, init_rows=init_rows)
    # pass 2: VLAD per chunk of images -> small [N, C*D] global matrix
    gs = []
    for c0 in range(0, n, 64):
        sel = range(c0, min(c0 + 64, n))
        gs.append(vlad_descriptors(torch.stack([descs[i] for i in sel]),
                                   torch.stack([valids[i] for i in sel]), cent))
    g = torch.cat(gs)
    sim = (g @ g.T).cpu().numpy().astype(np.float64)
    np.fill_diagonal(sim, -np.inf)
    kq = min(num_neighbors, n - 1)
    nn = np.argpartition(-sim, kq - 1, axis=1)[:, :kq]
    pairs = set()
    for i in range(n):
        for j in nn[i]:
            pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)
