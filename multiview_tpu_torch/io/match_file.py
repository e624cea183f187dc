"""ASP binary .match interest-point files. Port of
``multiview_tpu/io/match_file.py`` (numpy alone; the same bytes).

Byte-format parity with the reference's writer
(`rig_calibrator/src/interest_point.cc:303-335`): two uint64
counts then per-point records (x,y float32; ix,iy int32; orientation, scale,
interest float32; polarity uint8; octave, scale_lvl uint32; uint64 descriptor
length; float64 descriptor entries). These files open in ASP's match viewer
(`bin/rig_calibrator.cc:303-305`), which is the reference's match-debugging
workflow; saveInlinerMatchPairs exports the post-BA inlier matches this way.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

_REC = struct.Struct("<ffiifffBII")


def write_match_file(path, ip1_xy: np.ndarray, ip2_xy: np.ndarray,
                     desc1: np.ndarray = None, desc2: np.ndarray = None):
    """Write matched point lists [N,2] (+ optional descriptors [N,D])."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def pack_side(xy, desc):
        out = bytearray()
        for i in range(len(xy)):
            x, y = float(xy[i, 0]), float(xy[i, 1])
            out += _REC.pack(x, y, int(round(x)), int(round(y)),
                             0.0, 1.0, 0.0, 0, 0, 0)
            d = desc[i] if desc is not None else np.zeros(0)
            out += struct.pack("<Q", len(d))
            out += np.asarray(d, "<f8").tobytes()
        return bytes(out)

    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", len(ip1_xy), len(ip2_xy)))
        f.write(pack_side(np.asarray(ip1_xy), desc1))
        f.write(pack_side(np.asarray(ip2_xy), desc2))


def read_match_file(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read back the two matched point lists -> (xy1 [N,2], xy2 [M,2])."""
    raw = Path(path).read_bytes()
    n1, n2 = struct.unpack_from("<QQ", raw, 0)
    pos = 16

    def read_side(count):
        nonlocal pos
        xy = np.zeros((count, 2))
        for i in range(count):
            vals = _REC.unpack_from(raw, pos)
            pos += _REC.size
            xy[i] = vals[:2]
            (dlen,) = struct.unpack_from("<Q", raw, pos)
            pos += 8 + 8 * dlen
        return xy

    return read_side(n1), read_side(n2)


def match_file_name(match_dir, left_image: str, right_image: str) -> Path:
    """<dir>/<leftcam>__<leftstem>__<rightcam>__<rightstem>.match — keeps the
    camera names in the file name to disambiguate equal stems
    (matchFileName, interest_point.cc:427-447)."""
    left = Path(left_image)
    right = Path(right_image)
    name = "__".join([left.parent.name, left.stem, right.parent.name, right.stem])
    return Path(match_dir) / f"{name}.match"


def save_inlier_match_pairs(match_dir, cams_image_names: Sequence[str],
                            num_overlaps: int, trackset, inlier_of) -> List[Path]:
    """Export surviving matches of each nearby image pair
    (saveInlinerMatchPairs, interest_point.cc:727-828).

    inlier_of: callable (pid, cid) -> bool.
    """
    pair_pts: Dict[Tuple[int, int], Tuple[list, list]] = {}
    for pid, track in enumerate(trackset.tracks):
        cids = sorted(track)
        for a in range(len(cids)):
            for b in range(a + 1, len(cids)):
                i, j = cids[a], cids[b]
                if j > i + num_overlaps:
                    continue
                if not (inlier_of(pid, i) and inlier_of(pid, j)):
                    continue
                pair_pts.setdefault((i, j), ([], []))
                pair_pts[(i, j)][0].append(trackset.keypoints[i][track[i]])
                pair_pts[(i, j)][1].append(trackset.keypoints[j][track[j]])

    written = []
    for (i, j), (l, r) in pair_pts.items():
        path = match_file_name(match_dir, cams_image_names[i], cams_image_names[j])
        write_match_file(path, np.stack(l), np.stack(r))
        written.append(path)
    return written
