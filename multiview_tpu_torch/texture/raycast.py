"""Batched ray-mesh intersection. Port of ``ray_mesh_intersect`` and
``mesh_tri_verts`` of ``multiview_tpu/texture/raycast.py`` (the BVH role of
the reference's ray_mesh_intersect, texture_processing.cc:1436-1479).

Brute-force Moller-Trumbore over [rays x triangles] tiles with a running
nearest hit per ray, in plain PyTorch: ray blocks and triangle chunks are
visited in index order, so the hit of a ray is the triangle of lowest index
among those at its smallest distance, whatever the tile sizes. The tile is
sized from the memory that is free on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

# about this many [rays, triangles, 3] temporaries of one tile are alive at once
_LIVE_TEMPORARIES = 8
_CPU_TILE_BYTES = 256 << 20


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _ray_block_intersect(o, d, tv, min_dist, max_dist, chunk: int):
    """Nearest hit of one ray block [rc,3] against a triangle soup [T,3,3],
    ``chunk`` triangles at a time. min_dist: [rc] per-ray lower bound.
    Returns (best_t [rc], inf where missed; best_i [rc] int64, -1 where
    missed). Within a chunk the first smallest index wins; a later chunk
    replaces only with a strictly smaller t."""
    rc = o.shape[0]
    eps = 1e-12
    best_t = torch.full((rc,), float("inf"), dtype=o.dtype, device=o.device)
    best_i = torch.full((rc,), -1, dtype=torch.int64, device=o.device)
    inf = torch.full((), float("inf"), dtype=o.dtype, device=o.device)
    dd = d[:, None, :]
    for c0 in range(0, tv.shape[0], chunk):
        tri = tv[c0:c0 + chunk]                                   # [C,3,3]
        v0 = tri[:, 0]
        e1 = (tri[:, 1] - v0)[None]
        e2 = (tri[:, 2] - v0)[None]
        pvec = _cross(dd, e2)                                     # [rc,C,3]
        det = torch.sum(pvec * e1, dim=-1)                        # [rc,C]
        live = torch.abs(det) > eps
        inv_det = torch.where(live, 1.0 / det, torch.zeros_like(det))
        tvec = o[:, None, :] - v0[None]
        u = torch.sum(tvec * pvec, dim=-1) * inv_det
        qvec = _cross(tvec, e1)
        v = torch.sum(qvec * dd, dim=-1) * inv_det
        t = torch.sum(qvec * e2, dim=-1) * inv_det
        ok = (live & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t >= min_dist[:, None]) & (t <= max_dist))
        ct, ci = torch.min(torch.where(ok, t, inf), dim=-1)       # first minimum
        better = ct < best_t
        best_i = torch.where(better, ci + c0, best_i)
        best_t = torch.minimum(best_t, ct)
    return best_t, best_i


def _ray_block_size(n_rays: int, chunk: int, ray_chunk: int, like: torch.Tensor) -> int:
    """Rays per tile: at most ``ray_chunk``, and few enough that the tile's
    temporaries fit a quarter of the free device memory (a fixed budget on
    the CPU)."""
    if like.device.type == "cuda":
        budget = torch.cuda.mem_get_info(like.device)[0] // 4
    else:
        budget = _CPU_TILE_BYTES
    per_ray = _LIVE_TEMPORARIES * chunk * 3 * like.element_size()
    return int(max(1, min(ray_chunk, n_rays, budget // per_ray)))


def ray_mesh_intersect(origins, dirs, tri_verts, min_dist=0.0, max_dist: float = 100.0,
                       chunk: int = 2048, ray_chunk: int = 16384):
    """Nearest intersection of each ray with a triangle soup.

    origins, dirs: [R,3] tensors (dirs need not be unit). tri_verts:
    [T,3,3]. min_dist: scalar or per-ray [R]/[R,1]. Returns (t [R], tri_idx
    [R] int64, hit [R] bool); t in units of |dirs|, within [min_dist,
    max_dist] inclusive; a miss has t = 0, tri_idx = -1.

    ``chunk`` triangles by at most ``ray_chunk`` rays are tested at a time;
    peak memory is that of one tile.
    """
    R = origins.shape[0]
    dtype, device = origins.dtype, origins.device
    if R == 0:
        return (torch.zeros(0, dtype=dtype, device=device),
                torch.zeros(0, dtype=torch.int64, device=device),
                torch.zeros(0, dtype=torch.bool, device=device))
    tv = torch.as_tensor(tri_verts, dtype=dtype, device=device)
    md = torch.as_tensor(min_dist, dtype=dtype, device=device).reshape(-1).expand(R)
    rc = _ray_block_size(R, min(chunk, max(tv.shape[0], 1)), ray_chunk, origins)
    ts, idxs = [], []
    for r0 in range(0, R, rc):
        bt, bi = _ray_block_intersect(origins[r0:r0 + rc], dirs[r0:r0 + rc], tv,
                                      md[r0:r0 + rc], max_dist, chunk)
        ts.append(bt)
        idxs.append(bi)
    best_t = torch.cat(ts)
    best_i = torch.cat(idxs)
    hit = torch.isfinite(best_t)
    return torch.where(hit, best_t, torch.zeros_like(best_t)), best_i, hit


def mesh_tri_verts(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """[T,3,3] triangle soup from an indexed mesh (host numpy)."""
    return np.asarray(vertices)[np.asarray(faces)]
