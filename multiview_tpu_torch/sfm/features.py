"""Feature detection + description: DoG (SIFT-like) and determinant of
Hessian (SURF-like). Port of ``multiview_tpu/sfm/features.py`` (the role of
OpenCV's SIFT and SURF in the reference front end, interest_point.cc:51-106,
with the DynamicDetector retry of matching.cc:48-183).

The Gaussian pyramid is separable convolutions, extrema detection a
vectorized 3x3x3 neighborhood test over whole scale slabs, and descriptors
are computed for all keypoints of an image at once from fixed 64x64 windows
with separable bilinear resampling and histogram binning by ``scatter_add_``.
Everything is statically shaped: selection pads to ``max_features`` with a
validity mask. Detection runs on a batch of same-size images [B,H,W].

Two detector families, selected by ``detector=``: ``"sift"`` (DoG extrema,
128-d gradient histograms) and ``"surf"`` (scale-normalized determinant-of-
Hessian maxima from exact Gaussian second derivatives, 64-d per-cell
[sum dx, sum dy, sum |dx|, sum |dy|] descriptors zero-padded to 128, so both
families match through the same D = 128 kernel).

Computed in float32 (as the reference is), with the histogram weights of the
SIFT descriptor and the cell sums' terms of the SURF descriptor rounded to
bfloat16 as the reference rounds them, so descriptors agree with it up to
float32 summation order.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    xy: torch.Tensor        # [...,K,2] (x,y) in input-image pixels
    scale: torch.Tensor     # [...,K] blur sigma at detection
    response: torch.Tensor  # [...,K] |DoG| response
    angle: torch.Tensor     # [...,K] dominant orientation (radians)
    valid: torch.Tensor     # [...,K] bool


def default_threshold(detector: str = "sift") -> float:
    """Detection-response threshold default per detector family (SIFT's is a
    DoG contrast, SURF's a scale-normalized determinant of Hessian)."""
    return 1e-6 if detector == "surf" else 0.015


def _check_detector(detector: str):
    if detector not in ("sift", "surf"):
        raise ValueError(f"unknown detector {detector!r}")


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding over the last two dims
    of img [...,H,W] (cuDNN TF32 is disabled at package import)."""
    radius = max(1, int(np.ceil(3.0 * sigma)))
    k = torch.as_tensor(_gauss_kernel1d(sigma, radius), device=img.device,
                        dtype=img.dtype)
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    x = img.reshape(-1, 1, H, W)
    x = F.conv2d(F.pad(x, (0, 0, radius, radius), mode="reflect"), k.view(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (radius, radius, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    return x.reshape(lead + (H, W))


def _neighbors26(x: torch.Tensor):
    """The 26 rolled copies of x [B,S,H,W], trimmed to the inner S-2 slabs,
    one at a time."""
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                yield torch.roll(x, (ds, dy, dx), dims=(1, 2, 3))[:, 1:-1]


def _octave_scores_dog(base, num_scales, sigma0, contrast_threshold, edge_threshold):
    """DoG extrema response maps of one octave, base [B,H,W]. Returns
    (score, center) [B,S,H,W]: |DoG| at extrema passing the contrast, edge
    and border tests (0 elsewhere), and the raw signed DoG slabs."""
    k = 2.0 ** (1.0 / num_scales)
    sigmas = [sigma0 * k ** s for s in range(num_scales + 3)]
    gauss = [gaussian_blur(base, s) for s in sigmas]
    D = torch.stack([gauss[i + 1] - gauss[i] for i in range(len(gauss) - 1)], dim=1)
    center = D[:, 1:-1]

    is_max = torch.ones_like(center, dtype=torch.bool)
    is_min = torch.ones_like(center, dtype=torch.bool)
    for n in _neighbors26(D):
        is_max &= center > n
        is_min &= center < n
    extremum = (is_max | is_min) & (torch.abs(center) > contrast_threshold)

    # edge rejection via Hessian trace^2/det ratio
    dxx = torch.roll(center, -1, 3) + torch.roll(center, 1, 3) - 2 * center
    dyy = torch.roll(center, -1, 2) + torch.roll(center, 1, 2) - 2 * center
    dxy = 0.25 * (torch.roll(center, (-1, -1), (2, 3)) + torch.roll(center, (1, 1), (2, 3))
                  - torch.roll(center, (-1, 1), (2, 3)) - torch.roll(center, (1, -1), (2, 3)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    extremum &= (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    Hc, Wc = base.shape[-2:]
    border = 8
    ys = torch.arange(Hc, device=base.device)[:, None]
    xs = torch.arange(Wc, device=base.device)[None, :]
    inside = (xs >= border) & (xs < Wc - border) & (ys >= border) & (ys < Hc - border)
    extremum &= inside
    return torch.where(extremum, torch.abs(center), torch.zeros_like(center)), center


def _octave_scores_hessian(base, num_scales, sigma0, hessian_threshold):
    """Scale-normalized determinant-of-Hessian response maps of one octave,
    base [B,H,W] (the role of SURF's Fast Hessian, with exact Gaussian second
    derivatives; the rolls wrap as the DoG path's do). Returns (score,
    center) [B,S,H,W]: the response at 26-neighbour maxima above the
    threshold and the border (0 elsewhere), and the raw DoH slabs."""
    k = 2.0 ** (1.0 / num_scales)
    sigmas = [sigma0 * k ** s for s in range(num_scales + 2)]
    L = torch.stack([gaussian_blur(base, s) for s in sigmas], dim=1)  # [B,S,H,W]
    lxx = torch.roll(L, -1, 3) + torch.roll(L, 1, 3) - 2 * L
    lyy = torch.roll(L, -1, 2) + torch.roll(L, 1, 2) - 2 * L
    lxy = 0.25 * (torch.roll(L, (-1, -1), (2, 3)) + torch.roll(L, (1, 1), (2, 3))
                  - torch.roll(L, (-1, 1), (2, 3)) - torch.roll(L, (1, -1), (2, 3)))
    signorm = torch.tensor(sigmas, dtype=torch.float32, device=base.device)[:, None, None] ** 4
    doh = (lxx * lyy - lxy * lxy) * signorm
    center = doh[:, 1:-1]

    is_max = torch.ones_like(center, dtype=torch.bool)
    for n in _neighbors26(doh):
        is_max &= center > n
    extremum = is_max & (center > hessian_threshold)
    Hc, Wc = base.shape[-2:]
    border = 8
    ys = torch.arange(Hc, device=base.device)[:, None]
    xs = torch.arange(Wc, device=base.device)[None, :]
    extremum &= (xs >= border) & (xs < Wc - border) & (ys >= border) & (ys < Hc - border)
    return torch.where(extremum, center, torch.zeros_like(center)), center


def detect_scores(img, num_scales: int = 3, num_octaves: int = 4,
                  sigma0: float = 1.6, contrast_threshold: float = 0.015,
                  edge_threshold: float = 10.0, detector: str = "sift",
                  min_features: Optional[int] = None, max_retries: int = 5):
    """Score-map half of detection on img [B,H,W]: pyramid + extrema tests.
    Returns (bases, scores, centers) per octave. With ``min_features`` the
    maps are thresholded at the adaptive schedule's floor."""
    _check_detector(detector)
    img = img.to(torch.float32)
    floor = (contrast_threshold if min_features is None
             else contrast_threshold * 0.25 ** (max_retries - 1))
    bases, scores, centers = [], [], []
    base = img
    for _ in range(num_octaves):
        bases.append(base)
        if detector == "surf":
            sc, ce = _octave_scores_hessian(base, num_scales, sigma0, floor)
        else:
            sc, ce = _octave_scores_dog(base, num_scales, sigma0, floor, edge_threshold)
        scores.append(sc)
        centers.append(ce)
        H, W = base.shape[-2:]
        if min(H, W) // 2 < 16:
            break
        base = gaussian_blur(base, sigma0)[..., ::2, ::2]
    return bases, scores, centers


def _octave_select(score, center, octave, num_scales, sigma0, per_octave_k,
                   detector: str = "sift"):
    """Top-``per_octave_k`` selection + sub-pixel refinement over one octave
    ([B,S,H,W] maps). Returns (xy, sigma, resp, valid) in original-resolution
    coordinates, each [B,k]."""
    B, Sc, Hc, Wc = center.shape
    vals, flat_idx = torch.topk(score.reshape(B, -1), per_octave_k, dim=-1)
    s_idx = flat_idx // (Hc * Wc)
    y_idx = (flat_idx % (Hc * Wc)) // Wc
    x_idx = flat_idx % Wc
    valid = vals > 0.0

    cflat = center.reshape(B, -1)

    def at(s, y, x):
        return torch.gather(cflat, 1, s * (Hc * Wc) + y * Wc + x)

    # quadratic fit of the response around the extremum, offset = -g/h per
    # axis, clipped to half a pixel
    c00 = at(s_idx, y_idx, x_idx)
    cxm = at(s_idx, y_idx, torch.clamp_min(x_idx - 1, 0))
    cxp = at(s_idx, y_idx, torch.clamp_max(x_idx + 1, Wc - 1))
    cym = at(s_idx, torch.clamp_min(y_idx - 1, 0), x_idx)
    cyp = at(s_idx, torch.clamp_max(y_idx + 1, Hc - 1), x_idx)
    gx = 0.5 * (cxp - cxm)
    gy = 0.5 * (cyp - cym)
    hxx = cxp + cxm - 2 * c00
    hyy = cyp + cym - 2 * c00
    tiny = torch.full_like(hxx, 1e-12)
    dx = torch.clamp(-gx / torch.where(torch.abs(hxx) > 1e-12, hxx, tiny), -0.5, 0.5)
    dy = torch.clamp(-gy / torch.where(torch.abs(hyy) > 1e-12, hyy, tiny), -0.5, 0.5)

    k = 2.0 ** (1.0 / num_scales)
    factor = float(2 ** octave)
    xy = (torch.stack([x_idx, y_idx], dim=-1).to(torch.float32)
          + torch.stack([dx, dy], dim=-1)) * factor
    if detector == "surf":
        sigmas = [sigma0 * k ** s for s in range(num_scales + 2)]
        table = torch.tensor(sigmas[1:num_scales + 1], dtype=torch.float32,
                             device=score.device)
        sig = table[torch.clamp(s_idx, 0, num_scales - 1)] * factor
    else:
        sigmas = [sigma0 * k ** s for s in range(num_scales + 3)]
        table = torch.tensor([sigmas[1 + s] for s in range(num_scales + 1)],
                             dtype=torch.float32, device=score.device)
        sig = table[torch.clamp(s_idx, 0, num_scales)] * factor
    return xy, sig, vals, valid


def select_keypoints(scores, centers, num_scales: int, sigma0: float,
                     max_features: int, detector: str = "sift"):
    """Per-octave top-k + sub-pixel refinement + global top-``max_features``
    by response among valid rows, padded to ``max_features`` rows. Rows come
    response-sorted; invalid rows sort last."""
    parts = []
    for octave, (sc, ce) in enumerate(zip(scores, centers)):
        k_o = min(max_features, int(np.prod(sc.shape[1:])))
        parts.append(_octave_select(sc, ce, octave, num_scales, sigma0, k_o, detector))
    xy = torch.cat([p[0] for p in parts], dim=1)
    scale = torch.cat([p[1] for p in parts], dim=1)
    resp = torch.cat([p[2] for p in parts], dim=1)
    valid = torch.cat([p[3] for p in parts], dim=1)

    k_fin = min(max_features, xy.shape[1])
    score = torch.where(valid, resp, torch.full_like(resp, -math.inf))
    top = torch.topk(score, k_fin, dim=1).indices
    xy = torch.gather(xy, 1, top[..., None].expand(-1, -1, 2))
    scale = torch.gather(scale, 1, top)
    resp = torch.gather(resp, 1, top)
    valid = torch.gather(valid, 1, top)
    if k_fin < max_features:
        n = max_features - k_fin
        xy = F.pad(xy, (0, 0, 0, n))
        scale = F.pad(scale, (0, n))
        resp = F.pad(resp, (0, n))
        valid = F.pad(valid, (0, n))
    return xy, scale, resp, valid


def adaptive_valid(resp, valid, th0: float, min_features: int, max_retries: int):
    """The DynamicDetector retry schedule in one pass: given responses
    detected at the floor threshold ``th0 * 0.25**(max_retries-1)``, keep
    those above the FIRST threshold of [th0, th0*0.25, ...] with at least
    ``min_features`` survivors (or the floor when none reaches it)."""
    ks = torch.arange(max_retries, dtype=resp.dtype, device=resp.device)
    ths = th0 * torch.pow(0.25, ks)                                  # [R]
    counts = torch.sum((resp[..., None, :] > ths[:, None]) & valid[..., None, :], dim=-1)
    ok = counts >= min_features                                      # [...,R]
    first = torch.argmax(ok.to(torch.int32), dim=-1)
    idx = torch.where(torch.any(ok, dim=-1), first, torch.full_like(first, max_retries - 1))
    return valid & (resp > ths[idx][..., None])


def detect_keypoints(img, max_features: int = 1000, num_scales: int = 3,
                     num_octaves: int = 4, sigma0: float = 1.6,
                     contrast_threshold: float = 0.015,
                     edge_threshold: float = 10.0, detector: str = "sift",
                     min_features: Optional[int] = None, max_retries: int = 5):
    """Detection half on img [B,H,W]: pyramid + extrema + top-K (+ the
    adaptive threshold with ``min_features``). Returns (bases, xy, scale,
    resp, valid), response-sorted."""
    bases, scores, centers = detect_scores(
        img, num_scales, num_octaves, sigma0, contrast_threshold,
        edge_threshold, detector, min_features=min_features,
        max_retries=max_retries)
    xy, scale, resp, valid = select_keypoints(scores, centers, num_scales, sigma0,
                                              max_features, detector)
    if min_features is not None:
        valid = adaptive_valid(resp, valid, contrast_threshold, min_features,
                               max_retries)
    return bases, xy, scale, resp, valid


_PATCH = 64  # static upright window side, in octave-level pixels


def _extract_patches(bases: Sequence[torch.Tensor], xy, scale, sigma0):
    """Per-keypoint upright [64,64] windows from one image's pyramid
    (bases: per-octave [H_o,W_o]; xy [K,2]). Each keypoint reads the octave
    where its local scale falls in [sigma0, 2*sigma0); octave images are
    edge-padded onto a full-resolution canvas so out-of-bounds reads clamp.
    Returns (patches [K,P,P], cx, cy patch-local centers, sloc)."""
    H = max(bases[0].shape[0], _PATCH)
    W = max(bases[0].shape[1], _PATCH)
    canvas = torch.stack([
        F.pad(b[None, None], (0, W - b.shape[1], 0, H - b.shape[0]),
              mode="replicate")[0, 0] for b in bases])               # [O,H,W]
    o = torch.clamp(torch.floor(torch.log2(torch.clamp_min(scale, 1e-6) / sigma0))
                    .to(torch.int64), 0, len(bases) - 1)
    f = torch.exp2(o.to(torch.float32))
    cx = xy[:, 0] / f
    cy = xy[:, 1] / f
    oy = torch.clamp(torch.round(cy).to(torch.int64) - _PATCH // 2, 0, H - _PATCH)
    ox = torch.clamp(torch.round(cx).to(torch.int64) - _PATCH // 2, 0, W - _PATCH)
    ar = torch.arange(_PATCH, device=xy.device)
    rows = (o[:, None] * H + oy[:, None] + ar[None, :]) * W          # [K,P]
    idx = rows[:, :, None] + (ox[:, None, None] + ar[None, None, :])  # [K,P,P]
    patches = canvas.reshape(-1)[idx]
    return patches, cx - ox.to(torch.float32), cy - oy.to(torch.float32), scale / f


def _resample(patches, pcx, pcy, step, m: int):
    """Axis-aligned bilinear resampling inside each patch as two batched
    matmuls (separable hat-function weights, samples clamped into the
    window). patches [K,P,P]; step [K]. Returns [K,m,m] with rows = y."""
    lin = torch.arange(m, dtype=torch.float32, device=patches.device) - (m - 1) / 2.0
    rows = torch.clamp(pcy[:, None] + lin[None, :] * step[:, None], 0.0, _PATCH - 1.0)
    cols = torch.clamp(pcx[:, None] + lin[None, :] * step[:, None], 0.0, _PATCH - 1.0)
    idx = torch.arange(_PATCH, dtype=torch.float32, device=patches.device)
    wr = torch.clamp(1.0 - torch.abs(rows[:, :, None] - idx), 0.0, 1.0)   # [K,m,P]
    wc = torch.clamp(1.0 - torch.abs(cols[:, :, None] - idx), 0.0, 1.0)
    t = torch.bmm(wr, patches)
    return torch.bmm(t, wc.transpose(1, 2))


def _atan2(y, x):
    """Gradient angle, computed in float64 and rounded to y's dtype. The
    float32 atan2 of the CPU and of CUDA can land one ulp below an angle
    that sits exactly on a bin edge (gy = -gx gives 3*pi/4), which drops the
    sample into the neighbouring orientation bin; the rounded float64 angle
    does not, and agrees with the reference's."""
    return torch.arctan2(y.double(), x.double()).to(y.dtype)


def _orientations(patches, pcx, pcy, sloc, n: int = 16):
    """Dominant gradient orientation per keypoint (36-bin histogram with
    float32 weights, circularly smoothed) from the upright patch."""
    K = patches.shape[0]
    p = _resample(patches, pcx, pcy, 0.75 * sloc, n)
    gy = torch.gradient(p, dim=1)[0]
    gx = torch.gradient(p, dim=2)[0]
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = _atan2(gy, gx)
    bins = torch.floor((ang + math.pi) / (2 * math.pi) * 36).to(torch.int64) % 36
    lin = torch.arange(n, dtype=torch.float32, device=patches.device) - (n - 1) / 2.0
    wy, wx = torch.meshgrid(lin, lin, indexing="ij")
    w = torch.exp(-(wx * wx + wy * wy) / (2 * (n / 3.0) ** 2))
    hist = torch.zeros((K, 36), dtype=torch.float32, device=patches.device)
    hist.scatter_add_(1, bins.reshape(K, -1), (mag * w[None]).reshape(K, -1))
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, dim=-1)
    return (peak.to(torch.float32) + 0.5) / 36.0 * 2 * math.pi - math.pi


def _keypoint_frame_grads(patches, pcx, pcy, sloc, angle, m: int):
    """Upright m x m resample at the keypoint scale, its gradients rotated
    into the keypoint frame, each sample's descriptor-frame coordinates
    (u, v) and the Gaussian window weight."""
    dev = patches.device
    p = _resample(patches, pcx, pcy, sloc, m)
    gy_up = torch.gradient(p, dim=1)[0]
    gx_up = torch.gradient(p, dim=2)[0]
    # cos/sin rounded from float64, as _atan2: the float32 ones err by an ulp
    ca = torch.cos(angle.double()).to(angle.dtype)[:, None, None]
    sa = torch.sin(angle.double()).to(angle.dtype)[:, None, None]
    gx = ca * gx_up + sa * gy_up
    gy = -sa * gx_up + ca * gy_up
    lin = torch.arange(m, dtype=torch.float32, device=dev) - (m - 1) / 2.0
    py, px = torch.meshgrid(lin, lin, indexing="ij")
    u = ca * px[None] + sa * py[None]
    v = -sa * px[None] + ca * py[None]
    wg = torch.exp(-(px * px + py * py) / (2 * (16 / 3.0) ** 2))[None]
    return gx, gy, u, v, wg


def _cell_bins(u, v):
    """4x4 spatial cell of each descriptor-frame sample, and whether it lies
    inside the 16 x 16 descriptor square."""
    half = 8.0
    inside = (torch.abs(u) < half) & (torch.abs(v) < half)
    cx = torch.clamp(torch.floor((u + half) / 4), 0, 3).to(torch.int64)
    cy = torch.clamp(torch.floor((v + half) / 4), 0, 3).to(torch.int64)
    return cy * 4 + cx, inside


def _descriptors(patches, pcx, pcy, sloc, angle, valid, m: int = 24):
    """SIFT-like 4x4x8 descriptors -> [K,128], L2-normalized, 0.2-clipped.
    Gradients are rotated into the keypoint frame and binned by rotated
    (u,v) coordinates of an upright m x m window (m=24 covers the rotated
    16x16 descriptor square at every orientation)."""
    K = patches.shape[0]
    gx, gy, u, v, wg = _keypoint_frame_grads(patches, pcx, pcy, sloc, angle, m)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = _atan2(gy, gx)
    obin = torch.floor((ang + math.pi) / (2 * math.pi) * 8).to(torch.int64) % 8
    cell, inside = _cell_bins(u, v)

    s = m * m
    wt = (mag * wg * inside).reshape(K, s)
    # the reference rounds the histogram weights to bfloat16 (features.py:575-578)
    wt = wt.to(torch.bfloat16).to(torch.float32)
    desc = torch.zeros((K, 128), dtype=torch.float32, device=patches.device)
    desc.scatter_add_(1, (cell * 8 + obin).reshape(K, s), wt)
    desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-8)
    desc = torch.clamp_max(desc, 0.2)
    desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-8)
    return desc * valid[:, None]


def _surf_descriptors(patches, pcx, pcy, sloc, angle, valid, m: int = 24):
    """SURF-style descriptors -> [K,128], 64 real dimensions zero-padded:
    per 4x4 cell [sum dx, sum dy, sum |dx|, sum |dy|] of the keypoint-frame
    gradients (SURF's Haar responses), Gaussian-weighted, L2-normalized."""
    K = patches.shape[0]
    dx, dy, u, v, wg = _keypoint_frame_grads(patches, pcx, pcy, sloc, angle, m)
    cell, inside = _cell_bins(u, v)
    s = m * m
    w = (wg * inside).reshape(K, s, 1)
    feats = torch.stack([dx.reshape(K, s), dy.reshape(K, s),
                         torch.abs(dx).reshape(K, s), torch.abs(dy).reshape(K, s)], -1) * w
    # the reference rounds these terms to bfloat16 (features.py:606-609)
    feats = feats.to(torch.bfloat16).to(torch.float32)
    idx = cell.reshape(K, s, 1) * 4 + torch.arange(4, device=patches.device)
    desc = torch.zeros((K, 64), dtype=torch.float32, device=patches.device)
    desc.scatter_add_(1, idx.reshape(K, 4 * s), feats.reshape(K, 4 * s))
    desc = desc / torch.clamp_min(torch.linalg.norm(desc, dim=-1, keepdim=True), 1e-8)
    return F.pad(desc, (0, 64)) * valid[:, None]


def describe_keypoints(bases: Sequence[torch.Tensor], xy, scale, resp, valid,
                       sigma0: float = 1.6, detector: str = "sift"):
    """Description half for ONE image: bases per-octave [H_o,W_o], keypoint
    rows [K]. Returns (Keypoints, descriptors [K,128])."""
    _check_detector(detector)
    patches, pcx, pcy, sloc = _extract_patches(bases, xy, scale, sigma0)
    angle = _orientations(patches, pcx, pcy, sloc)
    describe = _surf_descriptors if detector == "surf" else _descriptors
    desc = describe(patches, pcx, pcy, sloc, angle, valid)
    return Keypoints(xy, scale, resp, angle, valid), desc


def detect_and_describe(img, max_features: int = 1000, num_scales: int = 3,
                        num_octaves: int = 4, sigma0: float = 1.6,
                        contrast_threshold: float = 0.015,
                        edge_threshold: float = 10.0, detector: str = "sift",
                        min_features: Optional[int] = None,
                        max_retries: int = 5) -> List[Tuple[Keypoints, torch.Tensor]]:
    """Detect keypoints and compute 128-d descriptors for a batch of
    same-size images img [B,H,W] (float grayscale in [0,1]). Returns one
    (Keypoints [max_features], descriptors [max_features,128]) per image;
    invalid rows are zeroed and masked."""
    bases, xy, scale, resp, valid = detect_keypoints(
        img, max_features, num_scales, num_octaves, sigma0, contrast_threshold,
        edge_threshold, detector, min_features=min_features,
        max_retries=max_retries)
    return [describe_keypoints([b[i] for b in bases], xy[i], scale[i], resp[i],
                               valid[i], sigma0, detector)
            for i in range(img.shape[0])]


def detect_and_describe_dynamic(img, max_features: int = 1000,
                                min_features: Optional[int] = None,
                                contrast_threshold: Optional[float] = None,
                                max_retries: int = 5, num_scales: int = 3,
                                num_octaves: int = 4, sigma0: float = 1.6,
                                edge_threshold: float = 10.0,
                                detector: str = "sift"):
    """Adaptive-threshold detection of ONE image [H,W] (DynamicDetector,
    matching.cc:48-183): the threshold is lowered 4x at a time until at least
    ``min_features`` keypoints survive, evaluated in one pass."""
    if min_features is None:
        min_features = max(8, max_features // 10)
    th = contrast_threshold if contrast_threshold is not None else default_threshold(detector)
    return detect_and_describe(
        torch.as_tensor(img, dtype=torch.float32)[None], max_features, num_scales,
        num_octaves, sigma0, th, edge_threshold, detector,
        min_features=min_features, max_retries=max_retries)[0]
