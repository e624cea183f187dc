"""NVM_V3 and cameras.txt pose-list I/O, format-compatible with the reference
(`rig_calibrator/src/interest_point.cc:1248-1475,1673-1738`,
`src/dense_map_utils.cc:752-776`).

NVM conventions (as Theia writes them): per-camera line holds
``filename focal qw qx qy qz cx cy cz dist 0`` where (cx,cy,cz) is the camera
*center* (t = -R c); keypoints in the file are offset by the optical center
(writeNvm, interest_point.cc:1384-1386).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class NvmData:
    """In-memory NVM content (the reference's nvmData, interest_point.h:283-289)."""

    cid_to_filename: List[str]
    focal_lengths: np.ndarray          # [C]
    cid_to_keypoint: List[np.ndarray]  # per-cam [n_i, 2]
    pid_to_cid_fid: List[Dict[int, int]]
    pid_to_xyz: np.ndarray             # [P, 3]
    world_to_cam: np.ndarray           # [C, 4, 4]


def read_nvm(path) -> NvmData:
    """Mirror of ReadNVM (interest_point.cc:1248-1329)."""
    toks = Path(path).read_text().split()
    it = iter(toks)

    def nxt():
        return next(it)

    magic = nxt()
    if not magic.startswith("NVM_V3"):
        raise ValueError("File doesn't start with NVM token")

    n_cams = int(nxt())
    if n_cams < 1:
        raise ValueError("NVM file is missing cameras")
    filenames, focals, w2c = [], [], []
    for _ in range(n_cams):
        filenames.append(nxt())
        focals.append(float(nxt()))
        qw, qx, qy, qz = (float(nxt()) for _ in range(4))
        c = np.array([float(nxt()) for _ in range(3)])
        _d1, _d2 = nxt(), nxt()
        # quaternion (w,x,y,z) -> R ; t = -R c
        x, y, z, w = qx, qy, qz, qw
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = -R @ c
        w2c.append(M)

    n_pts = int(nxt())
    if n_pts < 1:
        raise ValueError("The NVM file has no triangulated points.")
    keypoints: List[Dict[int, np.ndarray]] = [dict() for _ in range(n_cams)]
    pid_to_cid_fid: List[Dict[int, int]] = []
    xyz = np.zeros((n_pts, 3))
    for pid in range(n_pts):
        xyz[pid] = [float(nxt()) for _ in range(3)]
        _rgb = [nxt() for _ in range(3)]
        n_meas = int(nxt())
        cid_fid = {}
        for _ in range(n_meas):
            cid = int(nxt())
            fid = int(nxt())
            pt = np.array([float(nxt()), float(nxt())])
            cid_fid[cid] = fid
            keypoints[cid][fid] = pt
        pid_to_cid_fid.append(cid_fid)

    cid_to_keypoint = []
    for cid in range(n_cams):
        n_f = (max(keypoints[cid]) + 1) if keypoints[cid] else 0
        arr = np.zeros((n_f, 2))
        for fid, pt in keypoints[cid].items():
            arr[fid] = pt
        cid_to_keypoint.append(arr)

    return NvmData(filenames, np.asarray(focals), cid_to_keypoint, pid_to_cid_fid,
                   xyz, np.stack(w2c))


def write_nvm(path, data: NvmData):
    """Mirror of WriteNVM (interest_point.cc:1409-1475)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = ["NVM_V3", str(len(data.cid_to_filename))]
    for cid, name in enumerate(data.cid_to_filename):
        M = data.world_to_cam[cid]
        R = M[:3, :3]
        t = M[:3, 3]
        c = -R.T @ t
        # rotation matrix -> quaternion (w,x,y,z)
        qw = 0.5 * np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2]))
        if qw > 1e-8:
            qx = (R[2, 1] - R[1, 2]) / (4 * qw)
            qy = (R[0, 2] - R[2, 0]) / (4 * qw)
            qz = (R[1, 0] - R[0, 1]) / (4 * qw)
        else:  # fall back for 180-degree rotations
            d = np.diag(R)
            k = int(np.argmax(d))
            i, j = (k + 1) % 3, (k + 2) % 3
            qv = np.zeros(3)
            qv[k] = 0.5 * np.sqrt(max(0.0, 1.0 + d[k] - d[i] - d[j]))
            qv[i] = (R[i, k] + R[k, i]) / (4 * qv[k])
            qv[j] = (R[j, k] + R[k, j]) / (4 * qv[k])
            qw = (R[j, i] - R[i, j]) / (4 * qv[k])
            qx, qy, qz = qv
        r = lambda v: repr(float(v))  # noqa: E731 — plain-float repr, not np.float64(...)
        lines.append(f"{name} {r(data.focal_lengths[cid])} {r(qw)} {r(qx)} {r(qy)} "
                     f"{r(qz)} {r(c[0])} {r(c[1])} {r(c[2])} 0 0")

    lines.append(str(len(data.pid_to_cid_fid)))
    for pid, cid_fid in enumerate(data.pid_to_cid_fid):
        if len(cid_fid) <= 1:
            raise ValueError(f"PID {pid} has {len(cid_fid)} measurements")
        parts = [repr(float(v)) for v in data.pid_to_xyz[pid]] + ["0", "0", "0",
                                                                 str(len(cid_fid))]
        for cid in sorted(cid_fid):
            fid = cid_fid[cid]
            kp = data.cid_to_keypoint[cid][fid]
            parts += [str(cid), str(fid), repr(float(kp[0])), repr(float(kp[1]))]
        lines.append(" ".join(parts))
    path.write_text("\n".join(lines) + "\n")


# ----------------------------------------------------------------------------
# cameras.txt pose lists
# ----------------------------------------------------------------------------


def write_camera_poses(path, image_names: List[str], world_to_cam: np.ndarray):
    """Mirror of saveCameraPoses (dense_map_utils.cc:752-776): per line,
    image name + 12-value world_to_cam (row-major linear then translation)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("# image_file world_to_image_transform\n")
        for name, M in zip(image_names, world_to_cam):
            T = np.asarray(M, float)
            vals = [T[0, 0], T[0, 1], T[0, 2], T[1, 0], T[1, 1], T[1, 2],
                    T[2, 0], T[2, 1], T[2, 2], T[0, 3], T[1, 3], T[2, 3]]
            f.write(name + " " + " ".join(repr(float(v)) for v in vals) + "\n")


def read_camera_poses(path):
    """Mirror of readCameraPoses (interest_point.cc:1673-1738)."""
    names, mats = [], []
    for line in Path(path).read_text().splitlines():
        line = line.split("#")[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) != 13:
            raise ValueError(f"Expecting 13 fields on line: {line}")
        names.append(parts[0])
        v = [float(p) for p in parts[1:]]
        M = np.eye(4)
        M[0, :3] = v[0:3]
        M[1, :3] = v[3:6]
        M[2, :3] = v[6:9]
        M[:3, 3] = v[9:12]
        mats.append(M)
    return names, np.stack(mats) if mats else np.zeros((0, 4, 4))
