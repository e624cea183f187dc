"""Iso-surface extraction from a TSDF volume by marching tetrahedra (the
mesh half of the voxblox role, fused_mesh.ply). Port of
``multiview_tpu/dense/marching.py``: each cell splits into 6 tetrahedra
around its 0-6 diagonal, each tetrahedron emits up to 2 triangles from a
16-case table, and the triangles' vertices are welded.

The sign cases of all cells are computed at once; the triangles are then
built only for the (tet, triangle, cell) slots that emit one, taken in the
reference's (tet, tri, x, y, z) order, so faces and vertices come out in the
reference's order. The weld sorts the rounded vertex keys with
``torch.unique(dim=0)``, lexicographically as ``np.unique(axis=0)`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multiview_tpu_torch.dense.tsdf import ShardedTsdfGrid

# cube corner offsets (x,y,z)
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int64)

# 6-tet decomposition of the cube around the 0-6 diagonal
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], np.int64)

# tet edges: pairs of local tet-corner indices
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)

# case -> up to 2 triangles of tet-edge indices (-1 = unused);
# bit k set <=> tet corner k is inside (tsdf < 0)
_T = -np.ones((16, 2, 3), np.int64)
_T[1] = [[0, 1, 2], [-1, -1, -1]]                 # corner 0
_T[14] = [[0, 2, 1], [-1, -1, -1]]
_T[2] = [[0, 3, 4], [-1, -1, -1]]                 # corner 1
_T[13] = [[0, 4, 3], [-1, -1, -1]]
_T[4] = [[1, 5, 3], [-1, -1, -1]]                 # corner 2
_T[11] = [[1, 3, 5], [-1, -1, -1]]
_T[8] = [[2, 4, 5], [-1, -1, -1]]                 # corner 3
_T[7] = [[2, 5, 4], [-1, -1, -1]]
_T[3] = [[1, 3, 4], [1, 4, 2]]                    # corners 0,1
_T[12] = [[1, 4, 3], [1, 2, 4]]
_T[5] = [[0, 3, 5], [0, 5, 2]]                    # corners 0,2
_T[10] = [[0, 5, 3], [0, 2, 5]]
_T[9] = [[0, 4, 5], [0, 5, 1]]                    # corners 0,3
_T[6] = [[0, 5, 4], [0, 1, 5]]
_TRI_TABLE = _T


def extract_mesh(grid, min_weight: float = 1e-6
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TSDF -> triangle mesh: (vertices [M,3] world coordinates, faces [F,3]
    int32, vertex intensity [M]) as numpy. Cells touching an unobserved voxel
    (weight < min_weight) are skipped. A ``ShardedTsdfGrid`` is gathered
    first (its zero-weight padding emits nothing)."""
    if isinstance(grid, ShardedTsdfGrid):
        grid = grid.gather()
    tsdf = grid.tsdf
    dev, dtype = tsdf.device, tsdf.dtype
    X, Y, Z = tsdf.shape
    Xc, Yc, Zc = X - 1, Y - 1, Z - 1
    corners = torch.as_tensor(_CORNERS, device=dev)
    tets = torch.as_tensor(_TETS, device=dev)
    table = torch.as_tensor(_TRI_TABLE, device=dev)
    tet_edges = torch.as_tensor(_TET_EDGES, device=dev)

    def corner_slabs(arr):                                          # [8,Xc,Yc,Zc]
        return torch.stack([arr[dx:Xc + dx, dy:Yc + dy, dz:Zc + dz]
                            for dx, dy, dz in _CORNERS])

    observed = torch.all(corner_slabs(grid.weight) >= min_weight, dim=0)
    inside = (corner_slabs(tsdf) < 0.0)[tets].to(torch.int64)       # [6,4,Xc,Yc,Zc]
    case = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2] + 8 * inside[:, 3]
    emits = (table[:, :, 0] >= 0)[case].movedim(-1, 1) & observed   # [6,2,Xc,Yc,Zc]
    tet, tri, cx, cy, cz = torch.nonzero(emits, as_tuple=True)      # reference order
    if len(tet) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32), np.zeros(0)

    edges = table[case[tet, cx, cy, cz], tri]                       # [F,3] tet edges
    ends = tets[tet[:, None, None], tet_edges[edges]]               # [F,3,2] cube corners
    vox = torch.stack([cx, cy, cz], -1)[:, None, None, :] + corners[ends]  # [F,3,2,3]
    vi, vj, vk = vox.unbind(-1)
    val = tsdf[vi, vj, vk]
    inten = grid.intensity[vi, vj, vk]
    pos = (vox.to(dtype) + 0.5) * grid.voxel_size + grid.origin
    va, vb = val[..., 0], val[..., 1]
    denom = va - vb
    t = torch.clamp(va / torch.where(torch.abs(denom) > 1e-12, denom,
                                     torch.full_like(denom, 1e-12)), 0.0, 1.0)
    pa, pb = pos[..., 0, :], pos[..., 1, :]
    tri_verts = pa + t[..., None] * (pb - pa)                       # [F,3,3]
    tri_int = inten[..., 0] + t * (inten[..., 1] - inten[..., 0])   # [F,3]

    # weld duplicate vertices, their sums in float64 as the reference's
    flat = tri_verts.reshape(-1, 3)
    key = torch.round(flat / (grid.voxel_size * 1e-4)).to(torch.int64)
    _, inv = torch.unique(key, dim=0, return_inverse=True)
    m = int(inv.max()) + 1
    f64 = torch.float64
    counts = torch.zeros(m, dtype=f64, device=dev).index_add_(
        0, inv, torch.ones(len(inv), dtype=f64, device=dev))
    verts = torch.zeros((m, 3), dtype=f64, device=dev).index_add_(0, inv, flat.to(f64))
    vint = torch.zeros(m, dtype=f64, device=dev).index_add_(0, inv, tri_int.reshape(-1).to(f64))
    verts = verts / counts[:, None]
    vint = vint / counts
    faces = inv.reshape(-1, 3)
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return (verts.cpu().numpy(), faces[good].to(torch.int32).cpu().numpy(),
            vint.cpu().numpy())
