"""Image helpers: ``depth_value`` / ``depth_values_batch`` and
``adjust_image_size`` (copied from ``multiview_tpu/utils/images.py``) and
binary PGM (P5) and PPM (P6) read/write with numpy alone, the port's image
formats on machines without imageio."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def depth_value(depth_cloud: Optional[np.ndarray], dist_ip) -> Optional[np.ndarray]:
    """Depth xyz at the rounded pixel, None when absent/invalid
    (``depthValue``, dense_map_utils.cc:1364-1391).

    depth_cloud: [H,W,3] xyz-image or None; dist_ip: (x, y) pixel.
    (0,0,0) entries are invalid measurements.
    """
    if depth_cloud is None or depth_cloud.size == 0:
        return None
    h, w = depth_cloud.shape[:2]
    col = int(round(float(dist_ip[0])))
    row = int(round(float(dist_ip[1])))
    if col < 0 or row < 0 or col > w or row > h:
        raise ValueError("Out of range in the depth cloud.")
    if col == w or row == h:
        return None
    xyz = depth_cloud[row, col]
    if np.all(xyz == 0.0):
        return None
    return np.asarray(xyz, float)


def depth_values_batch(depth_cloud: Optional[np.ndarray], dist_ips: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized depth_value over [N,2] pixels -> (xyz [N,3], valid [N])."""
    n = len(dist_ips)
    if depth_cloud is None or depth_cloud.size == 0:
        return np.zeros((n, 3)), np.zeros(n, bool)
    h, w = depth_cloud.shape[:2]
    cols = np.round(dist_ips[:, 0]).astype(int)
    rows = np.round(dist_ips[:, 1]).astype(int)
    inb = (cols >= 0) & (rows >= 0) & (cols < w) & (rows < h)
    xyz = np.zeros((n, 3))
    xyz[inb] = depth_cloud[rows[inb], cols[inb]]
    valid = inb & ~np.all(xyz == 0.0, axis=-1)
    return xyz, valid


def adjust_image_size(calib_size: Tuple[int, int], image: np.ndarray
                      ) -> np.ndarray:
    """Resize a raw image down to the calibrated dimensions
    (``dense_map::adjustImageSize``, dense_map_utils.cc:1404-1431): the raw
    size must be an integer multiple of the calibrated (W, H); the reduction
    is area averaging (cv::INTER_AREA is exactly the block mean for integer
    factors)."""
    W, H = int(calib_size[0]), int(calib_size[1])
    h, w = image.shape[:2]
    factor = w // max(W, 1)
    if w != W * factor or h != H * factor or factor < 1:
        raise ValueError(
            f"Image width and height are: {w} {h}\n"
            f"Calibrated image width and height are: {W} {H}\n"
            "These must be equal up to an integer factor.")
    if factor == 1:
        return image
    trail = image.shape[2:]
    out = image[:H * factor, :W * factor].reshape(
        (H, factor, W, factor) + trail).mean(axis=(1, 3))
    return out.astype(image.dtype) if np.issubdtype(image.dtype, np.integer) \
        else out


def _pgm_tokens(data: bytes, count: int):
    """The first ``count`` header tokens of a PNM file and the offset just
    past the single whitespace byte that ends the header."""
    toks, pos = [], 2
    while len(toks) < count:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] not in (b"\n", b"\r", b""):
                pos += 1
            continue
        start = pos
        while not data[pos:pos + 1].isspace():
            pos += 1
        toks.append(int(data[start:pos]))
    return toks, pos + 1


def read_pgm(path) -> np.ndarray:
    """Binary PGM (P5, 8 or 16 bit) -> [H,W] uint8/uint16 array."""
    data = Path(path).read_bytes()
    if data[:2] != b"P5":
        raise ValueError(f"{path}: not a binary PGM (P5) file")
    (w, h, maxval), off = _pgm_tokens(data, 3)
    dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    img = np.frombuffer(data, dt, count=w * h, offset=off).reshape(h, w)
    return img.astype(np.uint16) if dt.itemsize == 2 else img.copy()


def write_pgm(path, img: np.ndarray) -> None:
    """[H,W] uint8 array -> binary PGM (P5)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError("write_pgm takes a [H,W] uint8 array")
    h, w = img.shape
    Path(path).write_bytes(f"P5\n{w} {h}\n255\n".encode() + img.tobytes())


def read_ppm(path) -> np.ndarray:
    """Binary PPM (P6, 8 bit) -> [H,W,3] uint8 array."""
    data = Path(path).read_bytes()
    if data[:2] != b"P6":
        raise ValueError(f"{path}: not a binary PPM (P6) file")
    (w, h, maxval), off = _pgm_tokens(data, 3)
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PPM is not supported")
    return np.frombuffer(data, np.uint8, count=w * h * 3, offset=off).reshape(h, w, 3).copy()


def write_ppm(path, img: np.ndarray) -> None:
    """[H,W,3] uint8 array -> binary PPM (P6)."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("write_ppm takes a [H,W,3] uint8 array")
    h, w = img.shape[:2]
    Path(path).write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
