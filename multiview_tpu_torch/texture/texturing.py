"""Texture projection: view selection, atlas charts, sampling, seam leveling,
OBJ/MTL/PNG output. Port of ``multiview_tpu/texture/texturing.py`` (the
ISAAC texturing variant, texture_processing.cc: ``formModel`` :687-882,
``projectTexture`` :991-1433, IsaacTextureAtlas :72-206, and texrecon's
seam leveling).

Per-face costs, occlusion, colour sampling, photometric clamping, the MRF
labeling, atlas rendering and both seam-leveling solves are tensor work on
the device of their inputs; shelf packing, adjacency, edge sampling, the
seam statistics and the file output stay on the host, as numpy copies of the
reference's host code.

Dtypes: the stages the reference computes in float32 whatever its inputs
(``gauss_clamping``, the chart render of ``render_atlas``, both seam
leveling solves and the field application) run in float32 on every device;
the rest follows its inputs' dtype (float64 in the CPU tests, float32 on the
card).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.geometry.camera import CameraParams
from multiview_tpu_torch.texture import raycast
from multiview_tpu_torch.utils.device import resolve_device, rows_that_fit
from multiview_tpu_torch.utils.images import write_png

# face x view pairs above which occlusion_method="auto" marches the grid
AUTO_GRID_PAIRS = 4_000_000


def _cam32(cam: CameraParams) -> CameraParams:
    return dataclasses.replace(cam, focal=cam.focal.float(),
                               optical_offset=cam.optical_offset.float(),
                               dist_coeffs=cam.dist_coeffs.float())


# ----------------------------------------------------------------------------
# View selection
# ----------------------------------------------------------------------------


def face_geometry(vertices, faces):
    """Centers [F,3], unit normals [F,3], areas [F]."""
    tri = vertices[faces]                                       # [F,3,3]
    ctr = torch.mean(tri, dim=1)
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * torch.linalg.norm(n, dim=-1)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-30)
    return ctr, n, area


def resolve_occlusion_method(method: str, num_faces: int, num_views: int) -> str:
    """"exact" or "grid": ``method``, with "auto" choosing the grid above
    ``AUTO_GRID_PAIRS`` face-view pairs."""
    if method not in ("exact", "grid", "auto"):
        raise ValueError(f"unknown occlusion_method {method!r}")
    if method == "auto":
        return "grid" if num_faces * num_views > AUTO_GRID_PAIRS else "exact"
    return method


def view_costs(vertices, faces, world_to_cam_poses, occlusion: bool = True,
               max_dist: float = 100.0, max_angle_deg: float = 90.0,
               occlusion_method: str = "auto"):
    """Per-(face, view) cost = view angle + distance, with the facing /
    in-front / angle / distance / occlusion usability tests (projectTexture's
    cost, texture_processing.cc:1044-1087), on the device of ``vertices``.

    occlusion_method: "exact" (a ray from each usable face centre to each
    camera against the whole soup, ``raycast.ray_mesh_intersect``), "grid"
    (the occupancy-grid march, ``raycast.occlusion_blocked_grid``) or "auto"
    (the grid above 4M face-view pairs). The exact test casts only the
    entries that pass the geometric gates, selected on the device.

    Returns (cost [F,V] with +inf at unusable entries, usable [F,V] bool).
    """
    ctr, normal, _ = face_geometry(vertices, faces)
    w2c = torch.as_tensor(world_to_cam_poses, device=ctr.device).to(ctr.dtype)
    cam_ctr = pose_mod.pose_t(pose_mod.pose_inverse(w2c))          # [V,3]

    to_cam = cam_ctr[None, :, :] - ctr[:, None, :]                  # [F,V,3]
    dist = torch.linalg.norm(to_cam, dim=-1)
    dir_to_cam = to_cam / torch.clamp_min(dist[..., None], 1e-30)
    cosang = torch.sum(dir_to_cam * normal[:, None, :], dim=-1)
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    cost = ang + dist
    facing = cosang > 0.0
    angle_ok = ang <= math.radians(max_angle_deg)
    Xc = pose_mod.pose_apply(w2c[None, :, :], ctr[:, None, :])
    in_front = Xc[..., 2] > 1e-6
    usable = facing & angle_ok & in_front & (dist < max_dist)

    if occlusion:
        F, V = dist.shape
        method = resolve_occlusion_method(occlusion_method, F, V)
        tri_soup = vertices[faces]
        if method == "grid":
            blocked = raycast.occlusion_blocked_grid(ctr, normal, cam_ctr, tri_soup)
        else:
            # a ray from just off each face centre toward each camera it may
            # use; hit before the camera means occluded
            sel = torch.nonzero(usable.reshape(-1)).squeeze(1)
            org = (ctr + 1e-4 * normal)[sel // V]
            t, _, hit = raycast.ray_mesh_intersect(
                org, dir_to_cam.reshape(-1, 3)[sel], tri_soup, min_dist=1e-3,
                max_dist=max_dist)
            blocked = torch.zeros(F * V, dtype=torch.bool, device=usable.device)
            blocked[sel] = hit & (t < dist.reshape(-1)[sel] - 1e-3)
            blocked = blocked.reshape(F, V)
        usable = usable & ~blocked

    cost = torch.where(usable, cost, torch.full_like(cost, float("inf")))
    return cost, usable


def view_selection(vertices, faces, world_to_cam_poses, occlusion: bool = True,
                   max_dist: float = 100.0, max_angle_deg: float = 90.0):
    """Best view per face by cost (``view_costs``). Returns (best_view [F]
    int64, visible [F] bool)."""
    cost, _ = view_costs(vertices, faces, world_to_cam_poses, occlusion=occlusion,
                         max_dist=max_dist, max_angle_deg=max_angle_deg)
    return torch.argmin(cost, dim=-1), torch.isfinite(torch.amin(cost, dim=-1))


def _bilinear(img, x, y):
    """Bilinear sample of img [H,W(,C)] at coordinates x, y (clamped to the
    image's last full cell)."""
    H, W = img.shape[:2]
    x0 = torch.clamp(torch.floor(x), 0, W - 2).long()
    y0 = torch.clamp(torch.floor(y), 0, H - 2).long()
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    c00 = img[y0, x0]
    c10 = img[y0, x0 + 1]
    c01 = img[y0 + 1, x0]
    c11 = img[y0 + 1, x0 + 1]
    if img.dim() == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def _face_view_color(cam: CameraParams, img, w2c, ctr):
    """One view's face-centre colors."""
    Xc = pose_mod.pose_apply(w2c, ctr)
    safe = torch.where(Xc[:, 2:3] > 1e-6, Xc,
                       torch.tensor([0.0, 0.0, 1.0], dtype=Xc.dtype, device=Xc.device))
    pix = cam.project_cam_to_dist_pix(safe)
    return _bilinear(img, pix[:, 0], pix[:, 1])


def sample_face_view_colors(vertices, faces, images: Sequence, cams: Sequence[CameraParams],
                            world_to_cam_poses, usable, grayscale: bool = False):
    """Color of each face centre as seen in each view, through the full
    distortion model and bilinear sampling: [F,V,C] per channel ([F,V] for
    gray images or ``grayscale=True``), 0 at unusable entries — the
    per-face-per-view colors of texrecon's photometric outlier removal.
    Images (numpy or tensors) are sampled as float32 values in the dtype of
    ``vertices``, on its device."""
    ctr, _, _ = face_geometry(vertices, faces)
    cols = []
    for v in range(len(images)):
        img = torch.as_tensor(images[v], device=ctr.device).float()
        if grayscale and img.dim() == 3:
            img = img.mean(dim=-1)
        w2c = torch.as_tensor(world_to_cam_poses[v], device=ctr.device).to(ctr.dtype)
        cols.append(_face_view_color(cams[v], img.to(ctr.dtype), w2c, ctr))
    colors = torch.stack(cols, dim=1)
    mask = usable[..., None] if colors.dim() == 3 else usable
    return torch.where(mask, colors, torch.zeros_like(colors))


def _masked_median(x, mask):
    """Row-wise median over masked entries; 0 where a row is empty."""
    big = torch.where(mask, x, torch.full_like(x, float("inf")))
    s = torch.sort(big, dim=1).values
    n = torch.sum(mask, dim=1)
    lo = torch.gather(s, 1, torch.clamp_min((n - 1) // 2, 0)[:, None])
    hi = torch.gather(s, 1, torch.clamp_min(n // 2, 0)[:, None])
    med = 0.5 * (lo + hi)
    return torch.where(n[:, None] > 0, med, torch.zeros_like(med))


def gauss_clamping(face_view_colors, usable, iterations: int = 4,
                   reject_threshold: float = 6e-3, min_sigma: float = 1e-3):
    """Photometric outlier removal (texrecon's ``-o gauss_clamping``): per
    face, the views' colors are modeled as a per-channel Gaussian with
    median / MAD as centre and spread; a view whose product of channel
    densities falls below ``reject_threshold ** C`` is dropped, ``iterations``
    times, never leaving a face without a view. Computed in float32 on the
    device of the inputs. face_view_colors: [F,V] or [F,V,C]. Returns (usable
    [F,V], weights [F,V]: the mean channel density, 0 where dropped)."""
    colors = face_view_colors.float()
    keep = usable
    chans = colors[..., None] if colors.dim() == 2 else colors
    F, V, C = chans.shape
    flat = chans.permute(0, 2, 1).reshape(F * C, V)

    def gauss_of(keep):
        keep_fc = keep[:, None, :].expand(F, C, V).reshape(F * C, V)
        med = _masked_median(flat, keep_fc)
        mad = _masked_median(torch.abs(flat - med), keep_fc)
        sigma = torch.clamp_min(1.4826 * mad, min_sigma)
        g = torch.exp(-0.5 * ((flat - med) / sigma) ** 2)
        return g.reshape(F, C, V).permute(0, 2, 1)                 # [F,V,C]

    for _ in range(iterations):
        new_keep = keep & (torch.prod(gauss_of(keep), dim=-1) >= reject_threshold ** C)
        enough = torch.sum(new_keep, dim=1, keepdim=True) >= 1
        keep = torch.where(enough, new_keep, keep)
    weights = torch.mean(gauss_of(keep), dim=-1)
    return keep, torch.where(keep, weights, torch.zeros_like(weights))


def face_neighbors(faces: np.ndarray, adjacency: np.ndarray) -> np.ndarray:
    """Padded per-face neighbor table [F,3] int32, -1 where absent: each
    face's first three neighbors in the order of the adjacency pairs, the
    first face of a pair before the second (host numpy; the reference's loop,
    vectorized)."""
    F = len(faces)
    adj = np.asarray(adjacency).reshape(-1, 2).astype(np.int64)
    owner = adj.reshape(-1)                   # a0, b0, a1, b1, ...: the loop's order
    other = adj[:, ::-1].reshape(-1)
    order = np.argsort(owner, kind="stable")
    owner, other = owner[order], other[order]
    first = np.searchsorted(owner, owner, side="left")
    rank = np.arange(len(owner)) - first
    keep = rank < 3
    nbr = np.full((F, 3), -1, np.int32)
    nbr[owner[keep], rank[keep]] = other[keep]
    return nbr


def mrf_view_selection(cost, usable, neighbors, smoothness: float = 0.1,
                       iterations: int = 20):
    """View labels minimizing sum_f cost[f, l_f] + smoothness * sum_adj
    [l_a != l_b] (a Potts MRF on the face graph, mapmap's role in texrecon)
    by checkerboard ICM from the argmin: each sweep moves the faces of one
    index parity to their best response. On the device of ``cost``;
    ``neighbors`` is ``face_neighbors``' table. Returns (best_view [F]
    int64, visible [F] bool)."""
    F, V = cost.shape
    nbr = torch.as_tensor(np.asarray(neighbors), device=cost.device).long()
    nbr_valid = nbr >= 0
    nbr_safe = torch.clamp_min(nbr, 0)
    visible = torch.isfinite(torch.amin(cost, dim=-1))
    labels = torch.argmin(cost, dim=-1)
    parity = torch.arange(F, device=cost.device) % 2
    views = torch.arange(V, device=cost.device)
    for i in range(iterations):
        nl = labels[nbr_safe]                                       # [F,3]
        mismatch = torch.sum((nl[:, :, None] != views) & nbr_valid[:, :, None], dim=1)
        total = cost + smoothness * mismatch.to(cost.dtype)
        new = torch.argmin(total, dim=-1)
        labels = torch.where((parity == (i % 2)) & visible, new, labels)
    return labels, visible


# ----------------------------------------------------------------------------
# Charts + atlas (host)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class Atlas:
    """Per-face axis-aligned charts shelf-packed into texture pages, which
    spill into as many ``max_page``-bounded pages as needed (the reference's
    vector of texture atlases, texture_processing.cc:209-365)."""

    size: Tuple[int, int]            # (W, H) of the largest page
    face_uv0: np.ndarray             # [F,2] texel origin of each chart
    face_wh: np.ndarray              # [F,2] chart size in texels
    face_basis: np.ndarray           # [F,2,3] in-plane axes (u,v) world dirs
    face_origin3d: np.ndarray        # [F,3] world point of chart texel (0,0)
    pixel_size: float
    face_page: np.ndarray = None     # [F] page index of each chart
    page_sizes: Sequence[Tuple[int, int]] = None   # [(W,H)] per page

    def __post_init__(self):
        if self.face_page is None:
            self.face_page = np.zeros(len(self.face_uv0), np.int32)
        if self.page_sizes is None:
            self.page_sizes = [self.size]

    @property
    def num_pages(self) -> int:
        return len(self.page_sizes)


def _as_pages(page_or_pages) -> list:
    """Normalize a rendered texture (single array or list of pages)."""
    if isinstance(page_or_pages, (list, tuple)):
        return list(page_or_pages)
    return [page_or_pages]


def _from_pages(pages: list):
    """Single page -> bare array; else the list."""
    return pages[0] if len(pages) == 1 else pages


def build_atlas(vertices: np.ndarray, faces: np.ndarray, pixel_size: float,
                max_page: int = 8192, pad: int = 1) -> Atlas:
    """Per-face planar parametrization at a fixed pixel_size and shelf
    packing by descending chart height (formModel + IsaacTextureAtlas roles),
    host numpy. Pages are bounded at ``max_page`` in both dimensions; a shelf
    that would overflow a page's height opens a new page. A single chart
    larger than max_page is an error: choose a coarser ``pixel_size``."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    tri = vertices[faces]                                  # [F,3,3]
    e1 = tri[:, 1] - tri[:, 0]
    n = np.cross(e1, tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    u = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-30)
    v = np.cross(n, u)

    # face-local 2D coords of the 3 vertices
    rel = tri - tri[:, :1]
    pu = np.einsum("fij,fj->fi", rel, u)
    pv = np.einsum("fij,fj->fi", rel, v)
    umin, vmin = pu.min(1), pv.min(1)
    w_tex = np.maximum(1, np.ceil((pu.max(1) - umin) / pixel_size).astype(int) + 1)
    h_tex = np.maximum(1, np.ceil((pv.max(1) - vmin) / pixel_size).astype(int) + 1)

    if int(w_tex.max(initial=0)) + pad > max_page or \
            int(h_tex.max(initial=0)) + pad > max_page:
        f_big = int(np.argmax(np.maximum(w_tex, h_tex)))
        raise ValueError(
            f"chart of face {f_big} is {int(w_tex[f_big])}x{int(h_tex[f_big])}"
            f" texels, larger than max_page={max_page}; use a coarser"
            f" pixel_size (>= {pixel_size * (max(int(w_tex[f_big]), int(h_tex[f_big])) + pad) / max_page:.3g})")

    origin3d = tri[:, 0] + umin[:, None] * u + vmin[:, None] * v

    # shelf packing by descending height, spilling into bounded pages
    order = np.argsort(-h_tex)
    page_w = min(max_page, int(np.ceil(np.sqrt(np.sum((w_tex + pad) *
                                                      (h_tex + pad))))) * 2)
    x = y = shelf_h = 0
    page = 0
    placed = []                                  # (x, y, page) in packing order
    page_heights = []
    for fw, fh in zip((w_tex[order] + pad).tolist(), (h_tex[order] + pad).tolist()):
        if x + fw > page_w:
            x = 0
            y += shelf_h
            shelf_h = 0
        if y + fh > max_page:
            # charts come in descending height, so an overflow follows a
            # shelf wrap: the finished page's used height is exactly y
            page_heights.append(y)
            page += 1
            x = y = shelf_h = 0
        placed.append((x, y, page))
        x += fw
        shelf_h = max(shelf_h, fh)
    page_heights.append(y + shelf_h)
    uv0 = np.zeros((len(faces), 2), int)
    face_page = np.zeros(len(faces), np.int32)
    if placed:
        placed = np.asarray(placed)
        uv0[order] = placed[:, :2]
        face_page[order] = placed[:, 2]
    page_sizes = [(page_w, h) for h in page_heights]
    size = (page_w, max(h for _, h in page_sizes))
    return Atlas(size=size, face_uv0=uv0,
                 face_wh=np.stack([w_tex, h_tex], 1),
                 face_basis=np.stack([u, v], 1), face_origin3d=origin3d,
                 pixel_size=pixel_size, face_page=face_page,
                 page_sizes=page_sizes)


# ----------------------------------------------------------------------------
# Sampling the selected views into the atlas
# ----------------------------------------------------------------------------


def _auto_max_chart(atlas: Atlas) -> int:
    """The power of two covering the 95th-percentile chart dimension, in
    [8, 64]."""
    F = len(atlas.face_wh)
    p95 = float(np.percentile(atlas.face_wh.max(axis=1), 95)) if F else 8.0
    return int(min(64, max(8, 1 << int(np.ceil(np.log2(max(p95, 1)))))))


def _render_charts(cam: CameraParams, basis, org, w2c, img, pixel_size, max_chart: int):
    """Texel grid -> 3D -> distorted pixels -> bilinear colors for a batch of
    charts: basis [S,2,3], origins [S,3] -> [S,mc,mc(,C)] colors."""
    ar = torch.arange(max_chart, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    pts = (org[:, None, None, :]
           + (gx[None, ..., None] * pixel_size) * basis[:, None, None, 0, :]
           + (gy[None, ..., None] * pixel_size) * basis[:, None, None, 1, :])
    Xc = pose_mod.pose_apply(w2c, pts.reshape(-1, 3))
    pix = cam.project_cam_to_dist_pix(Xc)
    colors = _bilinear(img, pix[:, 0], pix[:, 1])
    return colors.reshape((basis.shape[0], max_chart, max_chart) + tuple(img.shape[2:]))


def _chart_tiles(atlas: Atlas, sel: np.ndarray, max_chart: int):
    """Decompose the charts of ``sel`` into [max_chart]^2 tiles: a chart
    larger than max_chart becomes several tiles, row by row, with shifted
    origins, so no chart is truncated. Returns (tile_face [T], tile_xy [T,2]
    texel offsets within the chart)."""
    sel = np.asarray(sel)
    nx = (atlas.face_wh[sel, 0] + max_chart - 1) // max_chart
    ny = (atlas.face_wh[sel, 1] + max_chart - 1) // max_chart
    n_tiles = (nx * ny).astype(np.int64)
    tile_face = np.repeat(sel, n_tiles)
    start = np.repeat(np.cumsum(n_tiles) - n_tiles, n_tiles)
    j = np.arange(int(n_tiles.sum()), dtype=np.int64) - start
    nx_t = np.repeat(nx, n_tiles)
    tile_xy = np.stack([(j % nx_t) * max_chart, (j // nx_t) * max_chart], 1).astype(np.int64)
    return tile_face, tile_xy


def _tile_texels(atlas: Atlas, tile_face, tile_xy, max_chart: int):
    """Per tile texel: (valid [T,mc,mc] inside its chart, page x, page y)."""
    gy, gx = np.meshgrid(np.arange(max_chart), np.arange(max_chart), indexing="ij")
    tx_off = tile_xy[:, 0, None, None] + gx[None]
    ty_off = tile_xy[:, 1, None, None] + gy[None]
    valid = ((tx_off < atlas.face_wh[tile_face, 0][:, None, None])
             & (ty_off < atlas.face_wh[tile_face, 1][:, None, None]))
    px = atlas.face_uv0[tile_face, 0][:, None, None] + tx_off
    py = atlas.face_uv0[tile_face, 1][:, None, None] + ty_off
    return valid, px, py


def _vertex_gain_corr(atlas: Atlas, vertices, faces, tile_face, tile_xy, vertex_gain,
                      max_chart: int, channels, dt, dev):
    """Barycentric interpolation of per-vertex gains over each tile's texels
    ([T,mc,mc] or [T,mc,mc,C]) in the chart plane, in dtype ``dt`` on
    ``dev``."""

    def t(x):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt)

    tri = t(vertices[faces[tile_face]])                             # [T,3,3]
    org = t(atlas.face_origin3d[tile_face])
    bas = t(atlas.face_basis[tile_face])
    e = tri - org[:, None, :]
    tu = torch.einsum("sij,sj->si", e, bas[:, 0])
    tv = torch.einsum("sij,sj->si", e, bas[:, 1])
    ar = torch.arange(max_chart, dtype=dt, device=dev)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    txy = t(tile_xy)
    px = (txy[:, 0, None, None] + gx[None]) * atlas.pixel_size
    py = (txy[:, 1, None, None] + gy[None]) * atlas.pixel_size
    d = ((tu[:, 1] - tu[:, 0]) * (tv[:, 2] - tv[:, 0])
         - (tu[:, 2] - tu[:, 0]) * (tv[:, 1] - tv[:, 0]))
    d = torch.where(torch.abs(d) > 1e-12, d, torch.full_like(d, 1e-12))[:, None, None]
    w1 = ((px - tu[:, 0, None, None]) * (tv[:, 2] - tv[:, 0])[:, None, None]
          - (py - tv[:, 0, None, None]) * (tu[:, 2] - tu[:, 0])[:, None, None]) / d
    w2 = ((py - tv[:, 0, None, None]) * (tu[:, 1] - tu[:, 0])[:, None, None]
          - (px - tu[:, 0, None, None]) * (tv[:, 1] - tv[:, 0])[:, None, None]) / d
    w0 = 1.0 - w1 - w2
    vg = t(np.asarray(vertex_gain)[faces[tile_face]])               # [T,3] or [T,3,C]
    if vg.dim() == 3:
        return (w0[..., None] * vg[:, 0, None, None, :] + w1[..., None] * vg[:, 1, None, None, :]
                + w2[..., None] * vg[:, 2, None, None, :])
    corr = w0 * vg[:, 0, None, None] + w1 * vg[:, 1, None, None] + w2 * vg[:, 2, None, None]
    return corr[..., None] if channels else corr


def render_atlas(atlas: Atlas, vertices, faces, best_view, visible, images: Sequence,
                 cams: Sequence[CameraParams], world_to_cam_poses,
                 face_gain: Optional[np.ndarray] = None,
                 vertex_gain: Optional[np.ndarray] = None,
                 max_chart: Optional[int] = None):
    """Fill the atlas: every chart texel is lifted to 3D, projected into its
    face's chosen view through the full distortion model and bilinearly
    sampled (projectTexture's atlas variant, texture_processing.cc:1165-1433),
    on the device of ``cams``.

    Charts are rendered as [max_chart]^2 tiles (several for a larger chart),
    each view's tiles at once or in chunks sized from the free memory; the
    texel positions and the projection are float32 whatever the cameras'
    dtype. ``max_chart=None`` takes the power of two covering the
    95th-percentile chart dimension, in [8, 64]. Gains are per face [F] /
    [F,C] or per vertex [V] / [V,C] (interpolated barycentrically), added in
    the cameras' dtype. Returns the page [H,W(,C)] float32 in [0,1] of a
    single-page atlas, or the list of pages.
    """
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    if max_chart is None:
        max_chart = _auto_max_chart(atlas)
    dev, dt = cams[0].device, cams[0].dtype
    channels = tuple(images[0].shape[2:])
    pages = [torch.zeros((h, w) + channels, dtype=torch.float32, device=dev)
             for w, h in atlas.page_sizes]
    best_view = np.asarray(best_view)
    visible = np.asarray(visible)
    per_tile = max_chart * max_chart * 4 * 64        # ~64 float32 temporaries a texel
    pixel_size = torch.tensor(atlas.pixel_size, dtype=torch.float32, device=dev)
    for v in range(len(images)):
        sel = np.nonzero(visible & (best_view == v))[0]
        if len(sel) == 0:
            continue
        tile_face, tile_xy = _chart_tiles(atlas, sel, max_chart)
        basis_t = atlas.face_basis[tile_face]                       # [T,2,3]
        org_t = (atlas.face_origin3d[tile_face]
                 + tile_xy[:, 0:1] * atlas.pixel_size * basis_t[:, 0]
                 + tile_xy[:, 1:2] * atlas.pixel_size * basis_t[:, 1])
        w2c = torch.as_tensor(world_to_cam_poses[v], device=dev).float()
        img = torch.as_tensor(images[v], device=dev).float()
        cam32 = _cam32(cams[v])
        valid, px, py = _tile_texels(atlas, tile_face, tile_xy, max_chart)
        pg = atlas.face_page[tile_face]
        step = rows_that_fit(len(tile_face), per_tile, dev)
        for c0 in range(0, len(tile_face), step):
            part = slice(c0, c0 + step)
            colors = _render_charts(
                cam32, torch.as_tensor(basis_t[part], device=dev).float(),
                torch.as_tensor(org_t[part], device=dev).float(), w2c, img, pixel_size,
                max_chart)
            tf = tile_face[part]
            if vertex_gain is not None:
                colors = colors + _vertex_gain_corr(
                    atlas, vertices, faces, tf, tile_xy[part], vertex_gain, max_chart,
                    channels, dt, dev)
            elif face_gain is not None:
                fg = torch.as_tensor(np.asarray(face_gain)[tf], device=dev).to(dt)
                if fg.dim() == 2:
                    colors = colors + fg[:, None, None, :]
                else:
                    fg = fg[:, None, None]
                    colors = colors + (fg[..., None] if channels else fg)
            _scatter_tiles_into_pages(pages, valid[part], px[part], py[part], pg[part],
                                      colors.float())
    return _from_pages([torch.clamp(p, 0.0, 1.0).cpu().numpy() for p in pages])


def _scatter_tiles_into_pages(pages, valid, px, py, pg, colors):
    """Write the valid texels of [T,mc,mc(,C)] tile colors into their pages
    (tile regions never overlap)."""
    dev = colors.device
    for p in np.unique(pg):
        m = valid & (pg == p)[:, None, None]
        mt = torch.as_tensor(m, device=dev)
        pages[p][torch.as_tensor(py[m], device=dev),
                 torch.as_tensor(px[m], device=dev)] = colors[mt]


# ----------------------------------------------------------------------------
# Global seam leveling
# ----------------------------------------------------------------------------


def vertex_gains_from_faces(num_vertices: int, faces: np.ndarray,
                            face_gains: np.ndarray) -> np.ndarray:
    """Average per-face gains onto vertices ([F] or [F,C] -> [V] or [V,C]),
    host numpy: the interpolated per-vertex field is continuous across every
    edge."""
    face_gains = np.asarray(face_gains)
    squeeze = face_gains.ndim == 1
    fg = face_gains[:, None] if squeeze else face_gains
    sums = np.zeros((num_vertices, fg.shape[1]))
    counts = np.zeros(num_vertices)
    for k in range(3):
        np.add.at(sums, faces[:, k], fg)
        np.add.at(counts, faces[:, k], 1.0)
    out = sums / np.maximum(counts, 1.0)[:, None]
    return out[:, 0] if squeeze else out


def face_adjacency(faces: np.ndarray) -> np.ndarray:
    """[E,2] int32 pairs of faces sharing an edge, host numpy: each later
    face on an edge is paired with the first face on it, in the order of
    (face, edge slot) of the later face (the reference's loop, vectorized)."""
    faces = np.asarray(faces).astype(np.int64)
    if len(faces) == 0:
        return np.zeros((0, 2), np.int32)
    a = faces[:, [0, 1, 2]].reshape(-1)
    b = faces[:, [1, 2, 0]].reshape(-1)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = lo * (int(faces.max()) + 1) + hi
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    owner = first[inverse]                       # slot of the edge's first face
    later = np.nonzero(owner != np.arange(len(key)))[0]
    return np.stack([owner[later] // 3, later // 3], 1).astype(np.int32).reshape(-1, 2)


def global_seam_leveling(face_colors: np.ndarray, best_view: np.ndarray,
                         adjacency: np.ndarray, reg: float = 1e-3,
                         iterations: int = 2000, tol: float = 1e-4,
                         return_info: bool = False, device=None):
    """Per-face additive gain g minimizing
    sum_adj w (g_a - g_b + c_a - c_b)^2 [seam edges w = 1] + sum_adj w
    (g_a - g_b)^2 [same-view edges w = 0.25] + reg * sum g^2 (texrecon's
    global seam leveling on the face graph), by damped Jacobi sweeps in
    float32 on ``device`` (the first CUDA card when None). The residual
    max|A g - b| is checked every 64 sweeps; the solve stops when it is
    below ``tol`` * max|b| or after ``iterations`` (rounded up to a block),
    so the sweep count equals the reference's.

    face_colors: [F] or [F,C] (each channel solved independently). Returns
    the gains in face_colors' shape; with ``return_info`` also
    {"iterations", "rel_residual"}."""
    face_colors = np.asarray(face_colors)
    if len(adjacency) == 0:
        z = np.zeros(face_colors.shape)
        return (z, dict(iterations=0, rel_residual=0.0)) if return_info else z
    device = resolve_device(device)
    squeeze = face_colors.ndim == 1
    fc = face_colors[:, None] if squeeze else face_colors
    adjacency = np.asarray(adjacency)
    a = torch.as_tensor(adjacency[:, 0], device=device).long()
    b = torch.as_tensor(adjacency[:, 1], device=device).long()
    bv = torch.as_tensor(np.asarray(best_view), device=device)
    seam = (bv[a] != bv[b]).float()
    # seam edges demand g_a - g_b = c_b - c_a; same-view edges act as
    # smoothness (target 0, lower weight) so corrections diffuse into charts
    w = torch.where(seam > 0, 1.0, 0.25)[:, None]
    c = torch.as_tensor(fc, device=device).float()                  # [F,C]
    target = (c[b] - c[a]) * seam[:, None]
    denom = torch.full((fc.shape[0], 1), reg, dtype=torch.float32, device=device)
    denom.index_add_(0, a, w).index_add_(0, b, w)
    omega = 0.7  # damped Jacobi: plain Jacobi oscillates on seam pairs

    def rhs_of(g):
        rhs = torch.zeros_like(c)
        rhs.index_add_(0, a, w * (g[b] + target))
        rhs.index_add_(0, b, w * (g[a] - target))
        return rhs

    # The reference's compiled sweep multiplies by 1/denom and fuses the
    # damping into one float32 multiply-add, as does its residual; both are
    # kept (a float32 fma is the float64 product, exact, plus the addend,
    # rounded to float32), so the iterates follow the reference's.
    inv_denom = 1.0 / denom
    keep = float(np.float32(1.0 - omega))
    denom64 = denom.double()

    def residual(g):
        return float(torch.max(torch.abs((rhs_of(g).double() - denom64 * g.double()).float())))

    b_norm = max(residual(torch.zeros_like(c)), 1e-30)
    g = torch.zeros_like(c)
    it = 0
    res = float("inf")
    while it < iterations and res > tol * b_norm:
        for _ in range(64):
            g = (keep * g.double() + (omega * rhs_of(g) * inv_denom).double()).float()
        res = residual(g)
        it += 64
    info = dict(iterations=int(it), rel_residual=float(res) / b_norm)
    g = g.cpu().numpy()
    g = g[:, 0] if squeeze else g
    return (g, info) if return_info else g


# ----------------------------------------------------------------------------
# Local (Poisson) seam leveling + seam metrics
# ----------------------------------------------------------------------------


def shared_edge_vertices(faces: np.ndarray, adjacency: np.ndarray):
    """For each adjacency pair, the two shared vertex ids. Returns (pairs
    [E',2] rows of ``adjacency`` that share exactly one edge, verts [E',2]
    the edge's endpoint vertex ids). Host numpy."""
    faces = np.asarray(faces)
    adjacency = np.asarray(adjacency).reshape(-1, 2)
    A = faces[adjacency[:, 0]]                      # [E,3]
    B = faces[adjacency[:, 1]]
    shared = (A[:, :, None] == B[:, None, :]).any(axis=2)   # [E,3]
    ok = shared.sum(axis=1) == 2
    e_idx, slot = np.nonzero(shared & ok[:, None])
    verts = A[e_idx, slot].reshape(-1, 2)
    return adjacency[ok], verts


def _bilinear_np(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Host bilinear sample of [H,W(,C)] at float coords (x,y)."""
    H, W = img.shape[:2]
    x0 = np.clip(np.floor(x).astype(np.int64), 0, W - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, H - 2)
    fx = np.clip(x - x0, 0.0, 1.0)
    fy = np.clip(y - y0, 0.0, 1.0)
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def _edge_samples(page, atlas: Atlas, vertices, faces, pairs: np.ndarray,
                  edge_verts: np.ndarray, samples_per_edge: int = 8,
                  inset_texels: float = 0.75):
    """Sample the rendered page(s) on both sides of each shared face edge, at
    K interior points pulled ``inset_texels`` toward each face's centroid,
    each face read from its own page (host numpy). Returns (chart_xy
    [E,2,K,2] chart-local texel coords, colors [E,2,K(,C)] float32)."""
    pages = _as_pages(page)
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    K = samples_per_edge
    t = (np.arange(K) + 0.5) / K
    v0 = vertices[edge_verts[:, 0]]
    v1 = vertices[edge_verts[:, 1]]
    P = v0[:, None, :] + t[None, :, None] * (v1 - v0)[:, None, :]  # [E,K,3]

    chart_xy = np.empty((len(pairs), 2, K, 2))
    cols_shape = (len(pairs), 2, K) + pages[0].shape[2:]
    colors = np.empty(cols_shape, np.float32)
    for side in range(2):
        f = pairs[:, side]
        ctr = vertices[faces[f]].mean(axis=1)       # [E,3]
        d = ctr[:, None, :] - P
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
        Pf = P + inset_texels * atlas.pixel_size * d
        rel = Pf - atlas.face_origin3d[f][:, None, :]
        cx = np.einsum("ekj,ej->ek", rel, atlas.face_basis[f, 0]) / atlas.pixel_size
        cy = np.einsum("ekj,ej->ek", rel, atlas.face_basis[f, 1]) / atlas.pixel_size
        cx = np.clip(cx, 0.0, atlas.face_wh[f, 0:1] - 1.0)
        cy = np.clip(cy, 0.0, atlas.face_wh[f, 1:2] - 1.0)
        chart_xy[:, side, :, 0] = cx
        chart_xy[:, side, :, 1] = cy
        pgs = atlas.face_page[f]
        for p in np.unique(pgs):
            m = pgs == p
            colors[m, side] = _bilinear_np(
                pages[p],
                atlas.face_uv0[f[m], 0:1] + cx[m],
                atlas.face_uv0[f[m], 1:2] + cy[m])
    return chart_xy, colors


def _visible_shared_edges(faces, visible, adjacency):
    pairs, edge_verts = shared_edge_vertices(faces, adjacency)
    keep = visible[pairs[:, 0]] & visible[pairs[:, 1]]
    return pairs[keep], edge_verts[keep]


def seam_step_stats(page, atlas: Atlas, vertices, faces, best_view, visible,
                    adjacency: np.ndarray, samples_per_edge: int = 8):
    """Per-edge color step statistics of a rendered page (the texturing
    quality metric: mean |color difference| across each shared edge of two
    visible faces, at texel resolution), host numpy. Returns a dict with
    seam-edge (different views) and interior-edge (same view) stats."""
    best_view = np.asarray(best_view)
    visible = np.asarray(visible)
    pairs, edge_verts = _visible_shared_edges(faces, visible, adjacency)
    if len(pairs) == 0:
        return dict(num_seam_edges=0, num_interior_edges=0)
    _, colors = _edge_samples(page, atlas, vertices, faces, pairs, edge_verts,
                              samples_per_edge)
    diff = np.abs(colors[:, 0] - colors[:, 1])      # [E,K(,C)]
    step = diff.reshape(len(pairs), -1).mean(axis=1)
    seam = best_view[pairs[:, 0]] != best_view[pairs[:, 1]]
    out = dict(num_seam_edges=int(seam.sum()),
               num_interior_edges=int((~seam).sum()))
    for name, m in (("seam", seam), ("interior", ~seam)):
        if m.any():
            out[f"{name}_mean"] = float(step[m].mean())
            out[f"{name}_median"] = float(np.median(step[m]))
            out[f"{name}_max"] = float(step[m].max())
    return out


def _jacobi_dirichlet(corr, dval, dmask, iterations: int):
    """Jacobi harmonic fill of [N,G,G,C] rasters from ``corr`` (overwritten):
    each sweep replaces every free cell by the mean of its four neighbours
    (replicated borders) and holds the Dirichlet cells (dmask [N,G,G,1]) at
    dval. Two buffers and the masks: no shifted copy of the raster is made."""
    c = corr
    out = torch.empty_like(c)
    free = (~dmask).to(c.dtype) * 0.25                          # x 0.25 of the neighbour sum
    held = dval * dmask.to(c.dtype)
    for _ in range(iterations):
        # ((up + down) + left) + right, in the reference's order
        torch.add(c[:, :-2], c[:, 2:], out=out[:, 1:-1])
        torch.add(c[:, 0], c[:, 1], out=out[:, 0])
        torch.add(c[:, -2], c[:, -1], out=out[:, -1])
        out[:, :, 1:] += c[:, :, :-1]
        out[:, :, 0] += c[:, :, 0]
        out[:, :, :-1] += c[:, :, 1:]
        out[:, :, -1] += c[:, :, -1]
        out.mul_(free).add_(held)
        c, out = out, c
    return c


def _apply_field_to_page(page, fields, tile_face, tile_xy, fw, fh, atlas: Atlas,
                         page_idx: int, max_chart: int):
    """Bilinearly upsample each tile's [G,G,C] field over its chart texels
    and add it to the texels of page ``page_idx`` (a tensor, in place; tiles
    never overlap), in float32."""
    G = fields.shape[1]
    dev = fields.device
    on_page = atlas.face_page[tile_face] == page_idx
    tile_face, tile_xy = tile_face[on_page], tile_xy[on_page]
    if len(tile_face) == 0:
        return
    valid, px, py = _tile_texels(atlas, tile_face, tile_xy, max_chart)
    step = rows_that_fit(len(tile_face), max_chart * max_chart * fields.shape[3] * 4 * 40, dev)
    ar = torch.arange(max_chart, device=dev)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    for c0 in range(0, len(tile_face), step):
        part = slice(c0, c0 + step)
        tf = torch.as_tensor(tile_face[part], device=dev).long()
        txy = torch.as_tensor(tile_xy[part], device=dev)
        tx_off = txy[:, 0, None, None] + gx[None]                 # [T,mc,mc]
        ty_off = txy[:, 1, None, None] + gy[None]
        gxn = torch.clamp(tx_off.float() / fw[tf][:, None, None] * (G - 1), 0, G - 1)
        gyn = torch.clamp(ty_off.float() / fh[tf][:, None, None] * (G - 1), 0, G - 1)
        x0 = torch.floor(gxn).long()
        y0 = torch.floor(gyn).long()
        x1 = torch.clamp_max(x0 + 1, G - 1)
        y1 = torch.clamp_max(y0 + 1, G - 1)
        fx = (gxn - x0)[..., None]
        fy = (gyn - y0)[..., None]
        fidx = tf[:, None, None]
        corr = (fields[fidx, y0, x0] * (1 - fx) * (1 - fy)
                + fields[fidx, y0, x1] * fx * (1 - fy)
                + fields[fidx, y1, x0] * (1 - fx) * fy
                + fields[fidx, y1, x1] * fx * fy)                   # [T,mc,mc,C]
        m = valid[part]
        mt = torch.as_tensor(m, device=dev)
        vals = corr[mt] if page.dim() == 3 else corr[..., 0][mt]
        page.index_put_((torch.as_tensor(py[part][m], device=dev),
                         torch.as_tensor(px[part][m], device=dev)), vals, accumulate=True)


def local_seam_leveling(page, atlas: Atlas, vertices, faces, best_view, visible,
                        adjacency: np.ndarray, grid: int = 32, iterations: int = 60,
                        samples_per_edge: int = 8, max_chart: Optional[int] = None,
                        chunk: int = 8192, device=None):
    """Per-texel local seam leveling (the role of texrecon's Poisson texel
    editing): every shared edge of two visible faces is sampled on both
    sides; each face gets Dirichlet constraints along the edge pulling its
    colors to the two-side mean, a harmonic correction field is solved on a
    [grid]^2 raster per face (coarse to fine from 8, ``iterations`` Jacobi
    sweeps a level) and bilinearly upsampled onto the chart texels, so the
    corrections of two faces meet along their edge.

    The rasters and fields stay in float32 on ``device`` (the first CUDA
    card when None); the edge sampling is host numpy. ``chunk`` is accepted
    for signature parity with the JAX package and does nothing. Accepts a
    single page or the list of pages and returns the same form, each page
    clipped to [0,1]."""
    device = resolve_device(device)
    pages = _as_pages(page)
    best_view = np.asarray(best_view)
    visible = np.asarray(visible)
    faces = np.asarray(faces)
    F = len(faces)
    channels = pages[0].shape[2] if pages[0].ndim == 3 else 1
    pairs, edge_verts = _visible_shared_edges(faces, visible, adjacency)
    if len(pairs) == 0:
        return page
    chart_xy, colors = _edge_samples(page, atlas, vertices, faces, pairs, edge_verts,
                                     samples_per_edge)
    colors = colors.reshape(len(pairs), 2, samples_per_edge, channels)
    targets = colors.mean(axis=1, keepdims=True) - colors          # [E,2,K,C]

    fw = torch.as_tensor(np.maximum(atlas.face_wh[:, 0] - 1.0, 1.0), device=device).float()
    fh = torch.as_tensor(np.maximum(atlas.face_wh[:, 1] - 1.0, 1.0), device=device).float()
    targets_t = torch.as_tensor(targets, device=device).float()
    chart_t = torch.as_tensor(chart_xy, device=device).float()
    pairs_t = torch.as_tensor(pairs, device=device).long()

    def constraints(G):
        """(dval [F,G,G,C], dmask [F,G,G,1]): the mean pull of the samples
        that land in each raster cell."""
        tsum = torch.zeros((F * G * G, channels), dtype=torch.float32, device=device)
        wcnt = torch.zeros((F * G * G, 1), dtype=torch.float32, device=device)
        for side in range(2):
            f = pairs_t[:, side]
            cgx = torch.round(chart_t[:, side, :, 0] / fw[f, None] * (G - 1)).long()
            cgy = torch.round(chart_t[:, side, :, 1] / fh[f, None] * (G - 1)).long()
            lin = ((f[:, None] * G + cgy) * G + cgx).reshape(-1)
            tsum.index_add_(0, lin, targets_t[:, side].reshape(-1, channels))
            wcnt.index_add_(0, lin, torch.ones((len(lin), 1), device=device))
        dmask = (wcnt > 0).reshape(F, G, G, 1)
        dval = (tsum / torch.clamp_min(wcnt, 1.0)).reshape(F, G, G, channels)
        return dval, dmask

    # coarse-to-fine harmonic fill (Jacobi alone needs O(G^2) sweeps)
    levels = []
    G = grid
    while G >= 8:
        levels.append(G)
        G //= 2
    fields = None
    for G in levels[::-1]:
        dval, dmask = constraints(G)
        if fields is None:
            cur = torch.zeros((F, G, G, channels), dtype=torch.float32, device=device)
        else:
            cur = fields.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :G, :G]
        del fields
        fields = _jacobi_dirichlet(cur, dval, dmask, int(iterations))
        del cur, dval, dmask

    if max_chart is None:
        max_chart = _auto_max_chart(atlas)
    tile_face, tile_xy = _chart_tiles(atlas, np.nonzero(visible)[0], max_chart)
    out_pages = []
    for p, pg in enumerate(pages):
        pg_t = torch.tensor(np.asarray(pg), dtype=torch.float32, device=device)   # a copy
        _apply_field_to_page(pg_t, fields, tile_face, tile_xy, fw, fh, atlas, p, max_chart)
        out_pages.append(torch.clamp(pg_t, 0.0, 1.0).cpu().numpy())
    return out_pages if isinstance(page, (list, tuple)) else out_pages[0]


def mrf_energy(cost, labels, neighbors, smoothness: float) -> float:
    """Potts MRF energy of a labeling: the data term (faces with an infinite
    cost count 0) + smoothness x the number of disagreeing adjacent pairs
    (half the directed count of the neighbor table). Host numpy."""
    cost = np.asarray(cost)
    labels = np.asarray(labels)
    nbr = np.asarray(neighbors)
    F = cost.shape[0]
    data = cost[np.arange(F), labels]
    data = np.where(np.isfinite(data), data, 0.0).sum()
    valid = nbr >= 0
    nl = labels[np.maximum(nbr, 0)]
    mismatch = ((nl != labels[:, None]) & valid).sum() / 2.0
    return float(data + smoothness * mismatch)


# ----------------------------------------------------------------------------
# OBJ/MTL/PNG output
# ----------------------------------------------------------------------------


def write_textured_obj(prefix, vertices: np.ndarray, faces: np.ndarray, atlas: Atlas,
                       texture_page):
    """OBJ + MTL + PNG output (formObjCustomUV / formMtl / isaac_save_model,
    texture_processing.cc:884-988, 492-535) with per-face UVs from the atlas.
    A multi-page model writes one PNG and one material per page and groups
    the faces under one ``usemtl`` block per page. The PNGs are 8-bit
    (``(clip(page, 0, 1) * 255).astype(uint8)``), written by
    ``utils.images.write_png``; the OBJ and MTL text is the reference's, byte
    for byte."""
    prefix = Path(prefix)
    prefix.parent.mkdir(parents=True, exist_ok=True)
    obj_path = prefix.with_suffix(".obj")
    mtl_path = prefix.with_suffix(".mtl")
    pages = _as_pages(texture_page)
    multi = len(pages) > 1
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)

    png_names = []
    for p, pg in enumerate(pages):
        png_path = (prefix.parent / f"{prefix.name}_{p}.png" if multi
                    else prefix.with_suffix(".png"))
        write_png(png_path, (np.clip(pg, 0, 1) * 255).astype(np.uint8))
        png_names.append(png_path.name)

    # per-face UVs normalized by the face's own page size
    tri = vertices[faces]
    rel = tri - atlas.face_origin3d[:, None, :]
    pu = np.einsum("fij,fj->fi", rel, atlas.face_basis[:, 0]) / atlas.pixel_size
    pv = np.einsum("fij,fj->fi", rel, atlas.face_basis[:, 1]) / atlas.pixel_size
    sizes = np.asarray(atlas.page_sizes, float)          # [P,2] (W,H)
    Wf = sizes[atlas.face_page, 0][:, None]
    Hf = sizes[atlas.face_page, 1][:, None]
    us = (atlas.face_uv0[:, 0:1] + pu) / Wf
    vs = 1.0 - (atlas.face_uv0[:, 1:2] + pv) / Hf

    with open(mtl_path, "w") as m:
        for p, name in enumerate(png_names):
            mat = f"textured_{p}" if multi else "textured"
            m.write(f"newmtl {mat}\nmap_Kd {name}\n")
    # float64 values print as numpy's float64 scalars do (the shortest
    # repr), so the Python floats of .tolist() give the same text faster;
    # other dtypes print as their numpy scalars, as in the reference
    lines = [f"mtllib {mtl_path.name}"]
    rows = vertices.tolist() if vertices.dtype == np.float64 else vertices
    lines += [f"v {x} {y} {z}" for x, y, z in rows]
    lines += [f"vt {u} {v}" for u, v in zip(us.reshape(-1).tolist(), vs.reshape(-1).tolist())]
    # faces grouped by page -> one usemtl block per page
    order = (np.argsort(atlas.face_page, kind="stable") if multi
             else np.arange(len(faces)))
    pages_of = atlas.face_page[order].tolist()
    cur_page = -1
    for f, pg, (i0, i1, i2) in zip(order.tolist(), pages_of, faces[order].tolist()):
        if multi and pg != cur_page:
            cur_page = pg
            lines.append(f"usemtl textured_{cur_page}")
        elif not multi and cur_page < 0:
            cur_page = 0
            lines.append("usemtl textured")
        t0 = 3 * f + 1
        lines.append(f"f {i0 + 1}/{t0} {i1 + 1}/{t0 + 1} {i2 + 1}/{t0 + 2}")
    obj_path.write_text("\n".join(lines) + "\n")
    return obj_path
