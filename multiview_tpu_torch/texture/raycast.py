"""Batched ray-mesh intersection and the occupancy-grid occlusion test.
Port of ``multiview_tpu/texture/raycast.py``: ``ray_mesh_intersect`` and
``mesh_tri_verts`` (the BVH role of the reference's ray_mesh_intersect,
texture_processing.cc:1436-1479), and ``build_occupancy_grid`` /
``_march_blocked_chunk`` / ``occlusion_blocked_grid`` (view selection's
occlusion for large face x view problems).

Brute-force Moller-Trumbore over [rays x triangles] tiles with a running
nearest hit per ray, in plain PyTorch: ray blocks and triangle chunks are
visited in index order, so the hit of a ray is the triangle of lowest index
among those at its smallest distance, whatever the tile sizes. The tile is
sized from the memory that is free on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

from multiview_tpu_torch.utils.device import rows_that_fit

# about this many [rays, triangles, 3] temporaries of one tile are alive at once
_LIVE_TEMPORARIES = 8


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
    per_ray = _LIVE_TEMPORARIES * chunk * 3 * like.element_size()
    return rows_that_fit(min(ray_chunk, n_rays), per_ray, like.device)


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


# ----------------------------------------------------------------------------
# Occupancy-grid occlusion (large face x view problems)
# ----------------------------------------------------------------------------


def build_occupancy_grid(tri_verts, dim: int = 192, max_span: int = 8):
    """Conservative voxel occupancy of a triangle soup (host numpy).

    Each triangle marks every cell its axis-aligned box touches, with each
    axis span clipped to ``max_span`` cells. The clip is kept for parity with
    the JAX package: a triangle longer than ``max_span`` voxels marks only
    the first ``max_span`` cells of its box along that axis. Returns (occ
    [X,Y,Z] uint8, origin [3] float32, voxel float).

    Occlusion for view selection needs only blocked / not blocked, so a
    fixed-step march through this grid replaces the exact per-ray triangle
    test where the face x view count is large (``view_costs``).
    """
    tv = np.asarray(tri_verts)
    lo = tv.min(axis=(0, 1))
    hi = tv.max(axis=(0, 1))
    extent = np.maximum(hi - lo, 1e-9)
    voxel = float(extent.max() / dim)
    dims = np.minimum(np.ceil(extent / voxel).astype(int) + 2, dim + 2)
    occ = np.zeros(tuple(dims), np.uint8)
    tlo = np.clip(np.floor((tv.min(axis=1) - lo) / voxel).astype(int), 0, dims - 1)
    thi = np.clip(np.floor((tv.max(axis=1) - lo) / voxel).astype(int), 0, dims - 1)
    thi = np.minimum(thi, tlo + max_span - 1)
    span = (thi - tlo).max(axis=0)
    for dx in range(int(span[0]) + 1):
        for dy in range(int(span[1]) + 1):
            for dz in range(int(span[2]) + 1):
                sel = ((tlo[:, 0] + dx <= thi[:, 0])
                       & (tlo[:, 1] + dy <= thi[:, 1])
                       & (tlo[:, 2] + dz <= thi[:, 2]))
                occ[tlo[sel, 0] + dx, tlo[sel, 1] + dy, tlo[sel, 2] + dz] = 1
    return occ, lo.astype(np.float32), voxel


def _march_blocked_chunk(ctr, cam_ctr, occ_flat, occ_dims, origin, inv_voxel: float,
                         skip: float, steps: int):
    """Blocked mask [Fc,V] of face centres ctr [Fc,3] against camera centres
    [V,3]: ``steps`` samples of the occupancy grid strictly inside (skip,
    dist - skip) along each face->camera segment. The order of operations is
    the JAX package's (a sample near a cell wall must fall in the same cell):
    t = skip + span * ((s + 0.5) / steps), then floor((pos - origin) *
    inv_voxel)."""
    to_cam = cam_ctr[None, :, :] - ctr[:, None, :]                 # [Fc,V,3]
    dist = torch.linalg.norm(to_cam, dim=-1)
    d = to_cam / torch.clamp_min(dist[..., None], 1e-30)
    span = dist - 2.0 * skip
    valid = span > 0
    sx, sy, sz = occ_dims
    hi = torch.tensor([sx - 1, sy - 1, sz - 1], device=ctr.device)
    stride = torch.tensor([sy * sz, sz, 1], device=ctr.device)
    blocked = torch.zeros(dist.shape, dtype=torch.bool, device=ctr.device)
    c = ctr[:, None, :]
    for s in range(steps):
        t = skip + span * ((s + 0.5) / steps)
        pos = c + t[..., None] * d
        idx = torch.floor((pos - origin) * inv_voxel).long()
        idx = torch.minimum(torch.clamp_min(idx, 0), hi)
        lin = (idx * stride).sum(dim=-1)
        blocked |= occ_flat[lin] & valid
    return blocked


def occlusion_blocked_grid(face_ctr, face_normal, cam_ctr, tri_verts, dim: int = 192,
                           steps: int = 256, skip_voxels: float = 1.5):
    """[F,V] blocked mask by the occupancy-grid march (``build_occupancy_grid``)
    on the device of ``face_ctr``. ``skip_voxels`` voxels are excluded at both
    ends of each segment (the face's own surface cell and the camera's cell),
    and each face centre is first moved one voxel along its normal, off its
    own cell layer. The faces are marched in chunks sized from the free
    memory of the device (a fixed budget on the CPU)."""
    device, dtype = face_ctr.device, face_ctr.dtype
    occ, origin, voxel = build_occupancy_grid(torch.as_tensor(tri_verts).cpu().numpy(), dim=dim)
    occ_flat = torch.as_tensor(occ.reshape(-1) > 0, device=device)
    # the grid's origin, 1/voxel and the skip enter the march rounded to float32
    origin_t = torch.as_tensor(origin, device=device).to(dtype)
    inv_voxel = float(np.float32(1.0 / voxel))
    skip = float(np.float32(skip_voxels * voxel))
    ctr = face_ctr + voxel * face_normal
    cam = cam_ctr.to(dtype)
    F, V = ctr.shape[0], cam.shape[0]
    # about a dozen [Fc,V,3] temporaries of one step are alive at once
    fc = rows_that_fit(F, 12 * V * 3 * 8, device)
    out = [_march_blocked_chunk(ctr[f0:f0 + fc], cam, occ_flat, occ.shape, origin_t,
                                inv_voxel, skip, steps) for f0 in range(0, F, fc)]
    return torch.cat(out) if out else torch.zeros((0, V), dtype=torch.bool, device=device)
