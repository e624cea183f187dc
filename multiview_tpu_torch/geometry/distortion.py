"""Lens distortion models on *centered* pixels. Port of
``multiview_tpu/geometry/distortion.py``.

Behavioral parity with the reference camera model
(camera_model/camera_params.cc:260-355):

- ``none``  : pure offset shuffle between centered frames
- ``fov``   : 1-coefficient FOV/fisheye model (atan radial warp)
- ``tsai``  : 4/5-coefficient OpenCV radtan model (k1,k2,p1,p2[,k3]);
              undistortion is the cv::undistortPoints fixed-point iteration
- ``rpc``   : rational-polynomial distortion of arbitrary degree with a
              separately fitted rational inverse; coefficients are stored
              as ``concat(distort, undistort)`` halves

The model is chosen by coefficient count (``model_from_num_coeffs``).
All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import numpy as np
import torch


def model_from_num_coeffs(n: int) -> str:
    """Reference's coeff-length dispatch (camera_params.cc:181-207)."""
    if n == 0:
        return "none"
    if n == 1:
        return "fov"
    if n in (4, 5):
        return "tsai"
    if n > 5 and n % 2 == 0:
        return "rpc"
    raise ValueError(f"Irregular distortion vector size: {n}")


def rpc_degree_from_num_params(num_dist_params: int) -> int:
    """rpc_distortion.cc:43-45."""
    return int(round(np.sqrt(2.0 * num_dist_params + 5.0) / 2.0 - 1.5))


def rpc_num_params_from_degree(deg: int) -> int:
    """rpc_distortion.cc:47-49: 2*(d+1)*(d+2)-2."""
    return 2 * (deg + 1) * (deg + 2) - 2


def _monomial_exponents(deg: int, start: int) -> np.ndarray:
    """Exponent pairs (px, py) for monomials x^(d-i) y^i, d=start..deg, i=0..d,
    in the reference's coefficient order (rpc_distortion.cc:143-154)."""
    out = []
    for d in range(start, deg + 1):
        for i in range(d + 1):
            out.append((d - i, i))
    return np.asarray(out, dtype=np.int64)


def compute_rpc(p, coeffs):
    """Evaluate the RPC map at centered pixel(s) p [...,2] with `coeffs` [n]
    laid out [num_x | den_x | num_y | den_y] (rpc_distortion.cc:116-195)."""
    n = coeffs.shape[-1]
    deg = rpc_degree_from_num_params(n)
    if rpc_num_params_from_degree(deg) != n or deg <= 0:
        raise ValueError(f"Incorrect number of RPC coefficients: {n}")

    num_len = (n + 2) // 4
    den_len = num_len - 1
    num_exp = _monomial_exponents(deg, 0)
    den_exp = _monomial_exponents(deg, 1)

    x = p[..., 0:1]
    y = p[..., 1:2]

    def monomials(exps):
        max_d = int(exps.max()) if len(exps) else 0
        xpows = torch.cat([torch.ones_like(x)] + [x ** k for k in range(1, max_d + 1)], dim=-1)
        ypows = torch.cat([torch.ones_like(y)] + [y ** k for k in range(1, max_d + 1)], dim=-1)
        return xpows[..., list(exps[:, 0])] * ypows[..., list(exps[:, 1])]

    mon_num = monomials(num_exp)
    mon_den = monomials(den_exp)

    num_x = coeffs[..., 0:num_len]
    den_x = coeffs[..., num_len:num_len + den_len]
    num_y = coeffs[..., num_len + den_len:2 * num_len + den_len]
    den_y = coeffs[..., 2 * num_len + den_len:]

    vx = torch.sum(mon_num * num_x, dim=-1)
    wx = 1.0 + torch.sum(mon_den * den_x, dim=-1)
    vy = torch.sum(mon_num * num_y, dim=-1)
    wy = 1.0 + torch.sum(mon_den * den_y, dim=-1)
    return torch.stack([vx / wx, vy / wy], dim=-1)


def rpc_identity_params(deg: int, dtype=np.float64) -> np.ndarray:
    """Coefficients of the identity RPC transform of the given degree
    (rpc_distortion.cc:301-318); host numpy."""
    n = rpc_num_params_from_degree(deg)
    num_len = (n + 2) // 4
    den_len = num_len - 1
    num_x = np.zeros(num_len, dtype)
    num_y = np.zeros(num_len, dtype)
    den = np.zeros(den_len, dtype)
    num_x[1] = 1.0  # coefficient of x
    num_y[2] = 1.0  # coefficient of y
    return np.concatenate([num_x, den, num_y, den])


def rpc_increment_degree(params: np.ndarray) -> np.ndarray:
    """Raise each of the four polynomials by one degree with zero-filled new
    coefficients (rpc_distortion.cc:336-356). Host-side helper of the
    progressive RPC fit."""
    params = np.asarray(params)
    n = params.shape[0]
    deg = rpc_degree_from_num_params(n)
    num_len = (n + 2) // 4
    den_len = num_len - 1
    num_x = params[:num_len]
    den_x = params[num_len:num_len + den_len]
    num_y = params[num_len + den_len:2 * num_len + den_len]
    den_y = params[2 * num_len + den_len:]
    z = np.zeros(deg + 2, params.dtype)  # the new monomials of degree deg+1
    return np.concatenate([num_x, z, den_x, z, num_y, z, den_y, z])


def distort_centered(model: str, coeffs, undist_c, focal, optical_offset, dist_half_size):
    """UNDISTORTED_C -> DISTORTED_C (``DistortCentered``, camera_params.cc:260-314)."""
    if model == "none":
        return undist_c + optical_offset - dist_half_size

    if model == "fov":
        c0 = coeffs[..., 0]
        precalc1 = 1.0 / c0
        precalc2 = 2.0 * torch.tan(c0 / 2.0)
        norm = undist_c / focal
        # sqrt has an infinite gradient at 0; clamp inside (center pixel case)
        ru = torch.sqrt(torch.clamp_min(torch.sum(norm * norm, dim=-1), 1e-24))
        rd = torch.arctan(ru * precalc2) * precalc1
        conv = torch.where(ru > 1e-5, rd / ru, torch.ones_like(ru))
        return (optical_offset - dist_half_size) + conv[..., None] * norm * focal

    if model == "tsai":
        k1 = coeffs[..., 0]
        k2 = coeffs[..., 1]
        p1 = coeffs[..., 2]
        p2 = coeffs[..., 3]
        k3 = coeffs[..., 4] if coeffs.shape[-1] == 5 else torch.zeros_like(k1)
        norm = undist_c / focal
        nx, ny = norm[..., 0], norm[..., 1]
        r2 = nx * nx + ny * ny
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = radial * nx + 2 * p1 * nx * ny + p2 * (r2 + 2 * nx * nx)
        dy = radial * ny + p1 * (r2 + 2 * ny * ny) + 2 * p2 * nx * ny
        d = torch.stack([dx, dy], dim=-1)
        return d * focal + (optical_offset - dist_half_size)

    if model == "rpc":
        n = coeffs.shape[-1] // 2
        return compute_rpc(undist_c, coeffs[..., :n])

    raise ValueError(f"Unknown distortion model: {model}")


def undistort_centered(model: str, coeffs, dist_c, focal, optical_offset, dist_half_size,
                       tsai_iters: int = 20):
    """DISTORTED_C -> UNDISTORTED_C (``UndistortCentered``,
    camera_params.cc:316-355); Tsai is the cv::undistortPoints fixed-point
    iteration with 20 steps."""
    if model == "none":
        return dist_c - (optical_offset - dist_half_size)

    if model == "fov":
        c0 = coeffs[..., 0]
        precalc2 = 2.0 * torch.tan(c0 / 2.0)
        norm = (dist_c - (optical_offset - dist_half_size)) / focal
        rd = torch.sqrt(torch.clamp_min(torch.sum(norm * norm, dim=-1), 1e-24))
        ru = torch.tan(rd * c0) / precalc2
        conv = torch.where(rd > 1e-5, ru / rd, torch.ones_like(rd))
        return conv[..., None] * norm * focal

    if model == "tsai":
        k1 = coeffs[..., 0]
        k2 = coeffs[..., 1]
        p1 = coeffs[..., 2]
        p2 = coeffs[..., 3]
        k3 = coeffs[..., 4] if coeffs.shape[-1] == 5 else torch.zeros_like(k1)
        xy0 = (dist_c - (optical_offset - dist_half_size)) / focal
        xy = xy0
        for _ in range(tsai_iters):
            x, y = xy[..., 0], xy[..., 1]
            r2 = x * x + y * y
            icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            xy = (xy0 - torch.stack([dx, dy], dim=-1)) * icdist[..., None]
        return xy * focal

    if model == "rpc":
        n = coeffs.shape[-1] // 2
        return compute_rpc(dist_c, coeffs[..., n:])

    raise ValueError(f"Unknown distortion model: {model}")
