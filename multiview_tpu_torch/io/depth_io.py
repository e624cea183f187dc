"""Depth-cloud I/O: .pc xyz-images, PCD clouds, voxblox export layout,
registration control-point files. The port's own copy of
``multiview_tpu/io/depth_io.py`` (host numpy; same bytes for the same arrays).

Format parity:
- .pc xyz-image: 3 little-endian int32 (rows, cols, channels=3) then
  row-major float32 xyz triples (saveXyzImage/readXyzImage,
  `interest_point.cc:1537-1609`)
- PCD: PointNormal layout with intensity in normal_x, weight in normal_y,
  intersection-err in normal_z — the ISAAC voxblox fork's convention
  (exportToVoxblox, `dense_map_utils.cc:1185-1291`)
- voxblox export: per-sensor dir with index.txt listing
  (cam2world.txt, cloud.pcd) pairs
- Hugin .pto control points + plain xyz files for registration
  (ParseHuginControlPoints/ParseXYZ, `interest_point.cc:891-992`)
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------------------------
# .pc xyz images
# ----------------------------------------------------------------------------


def write_xyz_image(path, img: np.ndarray):
    """img: [H,W,3] float32 xyz per pixel; zeros mark invalid."""
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    if c != 3:
        raise ValueError("Expecting 3 channels.")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<iii", h, w, c))
        f.write(img.tobytes())


def read_xyz_image(path) -> np.ndarray:
    raw = Path(path).read_bytes()
    h, w, c = struct.unpack_from("<iii", raw, 0)
    img = np.frombuffer(raw, "<f4", h * w * c, 12).reshape(h, w, c)
    return img.copy()


# ----------------------------------------------------------------------------
# PCD (PointNormal, voxblox convention)
# ----------------------------------------------------------------------------


def write_pcd(path, xyz: np.ndarray, intensity: Optional[np.ndarray] = None,
              weight: Optional[np.ndarray] = None,
              error: Optional[np.ndarray] = None, binary: bool = True):
    """PointNormal PCD: fields x y z normal_x(intensity) normal_y(weight)
    normal_z(error), the ISAAC voxblox interchange layout."""
    n = len(xyz)
    intensity = np.zeros(n) if intensity is None else intensity
    weight = np.ones(n) if weight is None else weight
    error = np.zeros(n) if error is None else error
    data = np.column_stack([xyz, intensity, weight, error]).astype("<f4")
    # PCL PointNormal has padding (curvature + alignment), but the minimal
    # 6-field layout is what the reference's reader needs
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS x y z normal_x normal_y normal_z",
        "SIZE 4 4 4 4 4 4",
        "TYPE F F F F F F",
        "COUNT 1 1 1 1 1 1",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {'binary' if binary else 'ascii'}",
    ]) + "\n"
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(data.tobytes())
        else:
            for row in data:
                f.write((" ".join(repr(float(v)) for v in row) + "\n").encode())


def read_pcd(path):
    """Read the PCD subset written above. Returns (xyz [N,3], normals [N,3])."""
    raw = Path(path).read_bytes()
    lines = []
    pos = 0
    while True:
        nl = raw.find(b"\n", pos)
        line = raw[pos:nl].decode()
        lines.append(line)
        pos = nl + 1
        if line.startswith("DATA"):
            break
    meta = {l.split()[0]: l.split()[1:] for l in lines if l and not l.startswith("#")}
    n = int(meta["POINTS"][0])
    nfields = len(meta["FIELDS"])
    if meta["DATA"][0] == "binary":
        arr = np.frombuffer(raw, "<f4", n * nfields, pos).reshape(n, nfields)
    else:
        arr = np.asarray(raw[pos:].split(), float)[:n * nfields].reshape(n, nfields)
    return arr[:, :3].copy(), (arr[:, 3:6].copy() if nfields >= 6 else None)


# ----------------------------------------------------------------------------
# voxblox export layout
# ----------------------------------------------------------------------------


def export_to_voxblox(out_dir, sensor_names: Sequence[str], entries,
                      depth_to_image: np.ndarray, world_to_cam: np.ndarray):
    """Write per-sensor index.txt + (cam2world, pcd) pairs.

    entries: list of (camera_type, timestamp, depth_xyz_image [H,W,3],
    intensity_image [H,W] or None). depth points are mapped through the
    sensor's depth_to_image transform into camera coordinates, invalid
    (0,0,0) pixels dropped — exportToVoxblox parity
    (dense_map_utils.cc:1185-1291).
    """
    out_dir = Path(out_dir) / "voxblox"
    for cam_type, name in enumerate(sensor_names):
        sub = out_dir / name
        sub.mkdir(parents=True, exist_ok=True)
        index_lines = []
        for eid, (ct, timestamp, depth_img, inten_img) in enumerate(entries):
            if ct != cam_type or depth_img is None:
                continue
            ts = f"{timestamp:10.7f}".strip()
            xyz = depth_img.reshape(-1, 3)
            ok = ~np.all(xyz == 0.0, axis=-1)
            D = depth_to_image[cam_type]
            pts = xyz[ok] @ D[:3, :3].T + D[:3, 3]
            inten = (inten_img.reshape(-1)[ok] if inten_img is not None
                     else np.zeros(ok.sum()))
            pose_file = sub / f"{ts}_cam2world.txt"
            cloud_file = sub / f"{ts}.pcd"
            c2w = np.linalg.inv(world_to_cam[eid])
            np.savetxt(pose_file, c2w, fmt="%.17g")
            write_pcd(cloud_file, pts, intensity=inten,
                      error=np.full(ok.sum(), 0.0))
            index_lines += [str(pose_file), str(cloud_file)]
        (sub / "index.txt").write_text("\n".join(index_lines) + "\n")


# ----------------------------------------------------------------------------
# Registration control points
# ----------------------------------------------------------------------------


def parse_hugin_control_points(path) -> Tuple[List[str], np.ndarray]:
    """Hugin .pto: image list + control-point rows
    [left_idx, right_idx, lx, ly, rx, ry] (ParseHuginControlPoints,
    interest_point.cc:891-953)."""
    images: List[str] = []
    points = []
    for line in Path(path).read_text().splitlines():
        if line.startswith("i "):
            k = line.find('n"')
            if k < 0:
                raise ValueError(f"Invalid image line: {line}")
            images.append(line[k + 2:line.find('"', k + 2)])
        elif line.startswith("c "):
            clean = "".join(ch if not ch.isalpha() else " " for ch in line)
            vals = [float(v) for v in clean.split()]
            if len(vals) < 6:
                raise ValueError(f"Could not scan line: {line}")
            if vals[0] == vals[1]:
                raise ValueError("The left and right images must be distinct.")
            points.append(vals[:6])
    return images, np.asarray(points)


def parse_xyz(path) -> np.ndarray:
    """Plain xyz rows, comments/commas tolerated (ParseXYZ,
    interest_point.cc:961-992)."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or len(line) == 1:
            continue
        vals = [float(v) for v in line.replace(",", " ").split()]
        if len(vals) < 3:
            raise ValueError(f"Could not scan line: '{line}'")
        rows.append(vals[:3])
    return np.asarray(rows)


# ----------------------------------------------------------------------------
# Transformed-cloud exports (saveTransformedDepthClouds/saveTransformedMesh,
# dense_map_utils.cc:1114-1360)
# ----------------------------------------------------------------------------


def save_transformed_depth_clouds(out_dir, entries, depth_to_image: np.ndarray,
                                  world_to_cam: np.ndarray):
    """Write each entry's depth cloud as a world-frame PLY
    (saveTransformedDepthClouds role): depth points -> depth_to_image ->
    cam frame -> world frame."""
    from multiview_tpu_torch.io import ply as ply_io

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for eid, (cam_type, timestamp, depth_img, _inten) in enumerate(entries):
        if depth_img is None:
            continue
        xyz = np.asarray(depth_img).reshape(-1, 3)
        ok = ~np.all(xyz == 0.0, axis=-1)
        D = depth_to_image[cam_type]
        pts_cam = xyz[ok] @ D[:3, :3].T + D[:3, 3]
        c2w = np.linalg.inv(world_to_cam[eid])
        pts_world = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
        ts = f"{timestamp:10.7f}".strip()
        path = out_dir / f"{ts}_trans.ply"
        ply_io.write_ply(path, pts_world)
        written.append(path)
    return written


def save_transformed_mesh(path, vertices: np.ndarray, faces: np.ndarray,
                          transform: np.ndarray):
    """Apply a 4x4 transform to a mesh and save (saveTransformedMesh role)."""
    from multiview_tpu_torch.io import ply as ply_io

    T = np.asarray(transform, float)
    v = np.asarray(vertices) @ T[:3, :3].T + T[:3, 3]
    ply_io.write_ply(path, v, faces)
    return path
