"""PLY mesh/cloud I/O (the vendored-happly role, `happly.h`). The port's own
copy of ``multiview_tpu/io/ply.py`` (host numpy; same bytes for the same
arrays, with the binary triangle list written and read in one piece).

Supports ASCII and binary_little_endian, vertices with optional
normal/color/intensity properties, and triangular faces — enough for
fused_mesh.ply round-trips with the reference toolchain.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def write_ply(path, vertices: np.ndarray, faces: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None,
              intensity: Optional[np.ndarray] = None,
              binary: bool = True):
    """Write a mesh/cloud. colors: [N,3] uint8; intensity: [N] float."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vertices = np.asarray(vertices, np.float32)
    n = len(vertices)

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    cols = [vertices]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
        cols.append(np.asarray(normals, np.float32))
    if intensity is not None:
        header += ["property float intensity"]
        cols.append(np.asarray(intensity, np.float32).reshape(-1, 1))
    color_arr = None
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        color_arr = np.asarray(colors, np.uint8)
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        vert_f = np.concatenate(cols, axis=1).astype(np.float32)
        if binary:
            if color_arr is None:
                f.write(vert_f.tobytes())
            else:
                for i in range(n):
                    f.write(vert_f[i].tobytes())
                    f.write(color_arr[i].tobytes())
            if faces is not None:
                rec = np.empty(len(faces), np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
                rec["n"] = 3
                rec["idx"] = np.asarray(faces, np.int32).reshape(-1, 3)
                f.write(rec.tobytes())
        else:
            for i in range(n):
                row = " ".join(repr(float(v)) for v in vert_f[i])
                if color_arr is not None:
                    row += " " + " ".join(str(int(v)) for v in color_arr[i])
                f.write((row + "\n").encode())
            if faces is not None:
                for face in np.asarray(faces, np.int64):
                    f.write((f"3 {face[0]} {face[1]} {face[2]}\n").encode())


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read a PLY file. Returns dict with 'vertices' [N,3], optional
    'normals'/'colors'/'intensity', and 'faces' [F,3] when present."""
    raw = Path(path).read_bytes()
    end = raw.find(b"end_header\n")
    if end < 0:
        raise ValueError("Missing PLY end_header")
    header = raw[:end].decode().splitlines()
    body = raw[end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, dtype, is_list)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], (_DTYPES[parts[2]],
                                                   _DTYPES[parts[3]]), True))
            else:
                elements[-1][2].append((parts[2], _DTYPES[parts[1]], False))

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        toks = body.decode().split()
        pos = 0
        for name, count, props in elements:
            if any(p[2] for p in props):  # list property (faces)
                faces = []
                for _ in range(count):
                    k = int(toks[pos]); pos += 1
                    faces.append([int(toks[pos + i]) for i in range(k)])
                    pos += k
                out["faces"] = np.asarray(faces, np.int32)
            else:
                width = len(props)
                arr = np.asarray(toks[pos:pos + count * width], float).reshape(
                    count, width)
                pos += count * width
                _store_vertex_props(out, props, arr)
    else:
        if fmt != "binary_little_endian":
            raise ValueError(f"Unsupported PLY format: {fmt}")
        pos = 0
        for name, count, props in elements:
            if any(p[2] for p in props):
                (cnt_t, idx_t) = props[0][1]
                tri = np.dtype([("n", "<" + cnt_t), ("idx", "<" + idx_t, (3,))])
                if len(body) - pos >= count * tri.itemsize:
                    rec = np.frombuffer(body, tri, count, pos)
                    if np.all(rec["n"] == 3):       # all triangles: one read
                        out["faces"] = rec["idx"].astype(np.int32)
                        pos += count * tri.itemsize
                        continue
                faces = []
                for _ in range(count):
                    k = int(np.frombuffer(body, "<" + cnt_t, 1, pos)[0])
                    pos += np.dtype(cnt_t).itemsize
                    idx = np.frombuffer(body, "<" + idx_t, k, pos)
                    pos += k * np.dtype(idx_t).itemsize
                    faces.append(idx)
                out["faces"] = np.asarray(faces, np.int32)
            else:
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                arr_s = np.frombuffer(body, dt, count, pos)
                pos += count * dt.itemsize
                arr = np.stack([arr_s[p[0]].astype(float) for p in props], axis=1)
                _store_vertex_props(out, props, arr)
    return out


def _store_vertex_props(out, props, arr):
    names = [p[0] for p in props]

    def grab(keys):
        idx = [names.index(k) for k in keys if k in names]
        return arr[:, idx] if len(idx) == len(keys) else None

    xyz = grab(["x", "y", "z"])
    if xyz is not None:
        out["vertices"] = xyz
    nrm = grab(["nx", "ny", "nz"])
    if nrm is not None:
        out["normals"] = nrm
    rgb = grab(["red", "green", "blue"])
    if rgb is not None:
        out["colors"] = rgb.astype(np.uint8)
    if "intensity" in names:
        out["intensity"] = arr[:, names.index("intensity")]
