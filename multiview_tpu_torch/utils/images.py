"""Image helpers: ``depth_value`` / ``depth_values_batch``, the sRGB
transfer and exposure helpers, ``pick_timestamps_in_bounds`` and
``adjust_image_size`` (copied from ``multiview_tpu/utils/images.py``),
binary PGM (P5) and PPM (P6) read/write with numpy alone, the port's image
formats on machines without imageio, and an 8-bit PNG writer in the
standard library alone (the texture pages; the reference writes them with
PIL) with a reader for its own output."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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


_GAMMA = 2.2


def srgb_gamma(x: np.ndarray) -> np.ndarray:
    """sRGB forward transfer for x in [0,1] (``dense_map::gamma``,
    dense_map_utils.cc:572-579): 12.92x below 0.0031308, else
    1.055 x^(1/2.4) - 0.055."""
    x = np.asarray(x, float)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(np.maximum(x, 1e-12), 1.0 / 2.4) - 0.055)


def srgb_inv_gamma(x: np.ndarray) -> np.ndarray:
    """sRGB inverse transfer (``dense_map::inv_gamma``,
    dense_map_utils.cc:581-587)."""
    x = np.asarray(x, float)
    return np.where(x <= 0.04045, x / 12.92,
                    np.power(np.maximum((x + 0.055) / 1.055, 0.0), 2.4))


def exposure_correction(max_iso_times_exposure: float, iso: float, exposure: float,
                        image: np.ndarray) -> np.ndarray:
    """Brightness normalization in linear light: undo the sRGB gamma, scale
    by max_iso_times_exposure / (iso * exposure), re-apply the gamma
    (``dense_map::exposureCorrection``, dense_map_utils.cc:590-615). image:
    uint8, or float in [0,1]."""
    scale = max_iso_times_exposure / iso / exposure
    img = np.asarray(image, float)
    was_u8 = image.dtype == np.uint8
    if was_u8:
        img = img / 255.0
    out = srgb_gamma(srgb_inv_gamma(img) * scale)
    if was_u8:
        return np.clip(np.round(out * 255.0), 0.0, 255.0).astype(np.uint8)
    return np.clip(out, 0.0, 1.0)


def scale_image(max_iso_times_exposure: float, iso: float, exposure: float,
                image: np.ndarray) -> np.ndarray:
    """The cheap variant: one global multiply by scale^(1/gamma)
    (scaleImage, dense_map_utils.cc:620-628)."""
    scale = (max_iso_times_exposure / iso / exposure) ** (1.0 / _GAMMA)
    img = np.asarray(image, float) * scale
    if image.dtype == np.uint8:
        return np.clip(np.round(img), 0, 255).astype(np.uint8)
    return img


def pick_timestamps_in_bounds(timestamps: Sequence[float], left_bound: float,
                              right_bound: float, offset: float) -> List[float]:
    """The timestamps (after +offset) closest to each bound within
    [left_bound, right_bound) (pickTimestampsInBounds): one or two."""
    inside = [t for t in timestamps if left_bound <= t + offset < right_bound]
    if not inside:
        return []
    lo = min(inside, key=lambda t: abs(t + offset - left_bound))
    hi = min(inside, key=lambda t: abs(t + offset - right_bound))
    return [lo] if lo == hi else [lo, hi]


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


def write_png(path, img: np.ndarray, compress_level: int = 6) -> None:
    """[H,W] or [H,W,3] uint8 array -> 8-bit gray or RGB PNG, written with
    the standard library alone (zlib, struct): one IDAT chunk, no filtering,
    no interlace. Stands in for PIL's ``Image.fromarray(img).save(path)``."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError("write_png takes a [H,W] or [H,W,3] uint8 array")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)      # filter byte 0 (None) per row
    rows[:, 1:] = img.reshape(h, -1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color_type = 0 if img.ndim == 2 else 2
    Path(path).write_bytes(
        _PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), compress_level))
        + chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """The PNGs ``write_png`` writes (8-bit gray or RGB, unfiltered rows, no
    interlace) -> [H,W] or [H,W,3] uint8 array; other PNGs raise ValueError."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in (0, 2) or interlace:
        raise ValueError(f"{path}: only 8-bit gray or RGB PNGs without interlace are read")
    ch = 1 if color_type == 0 else 3
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered PNG rows are not read")
    img = rows[:, 1:].reshape((h, w) if ch == 1 else (h, w, 3))
    return img.copy()
